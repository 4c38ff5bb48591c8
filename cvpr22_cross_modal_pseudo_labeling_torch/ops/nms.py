"""Exact greedy NMS over padded boxes.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/ops/nms.py``
(``nms`` :35, ``batched_nms`` :133) and of the Pallas kernel
``ops/nms_pallas.py::nms_pallas`` (:125, ``_nms_kernel`` :47), which
share one contract:

* boxes are sorted by ``where(valid, score, -inf)``, descending and
  stable (ties keep the lower index first);
* box ``i`` is kept iff it is valid and no kept box before it in that
  order has the same label and IoU > threshold (legacy +1 IoU, union
  floored at 1e-10, strict ``>``);
* the output is ``[max_outputs]`` int32 indices into the input in score
  order plus a valid mask; padded slots hold index 0, also when
  ``max_outputs`` exceeds the number of boxes.

The sort and the final gather stay torch ops around the kernel, as XLA
ops sit around the Pallas call.  The kept set itself comes from
``csrc/nms.cu`` for CUDA tensors and from :func:`_keep_plain` (the JAX
package's tiled fixpoint formulation) for CPU tensors.

Every function takes an optional leading batch axis: ``boxes [B, N, 4]``
runs B independent NMS problems (one kernel launch for all of them).
"""

from typing import Optional, Tuple

import torch

from ..core.boxes import box_iou
from . import kernels

_PLAIN_TILE = 256


def _sorted_inputs(boxes, scores, valid, labels):
    key = torch.where(valid, scores, torch.full_like(scores, -float("inf")))
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    sboxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    return (
        order,
        sboxes.contiguous(),
        torch.gather(valid, 1, order).contiguous(),
        torch.gather(labels, 1, order).contiguous(),
    )


def _keep_plain(sboxes, svalid, slabels, iou_threshold, max_outputs):
    """Kept sorted positions ``[B, max_outputs]`` (-1 padded) and their
    count ``[B]``: the greedy recurrence resolved tile by tile, each tile
    first suppressed by the boxes kept before it, then iterated to the
    fixpoint of ``keep[i] = alive[i] & !any(keep[j<i] & over[j, i])``."""
    b, n, _ = sboxes.shape
    kept = torch.zeros((b, n), dtype=torch.bool, device=sboxes.device)
    for start in range(0, n, _PLAIN_TILE):
        end = min(start + _PLAIN_TILE, n)
        tboxes = sboxes[:, start:end]
        tlabels = slabels[:, start:end]
        alive = svalid[:, start:end]
        if start > 0:
            over = box_iou(sboxes[:, :start], tboxes) > iou_threshold
            over &= slabels[:, :start, None] == tlabels[:, None, :]
            alive = alive & ~(kept[:, :start, None] & over).any(dim=1)
        t = end - start
        over = box_iou(tboxes, tboxes) > iou_threshold
        over &= torch.ones((t, t), dtype=torch.bool, device=sboxes.device).triu(1)
        over &= tlabels[:, :, None] == tlabels[:, None, :]
        keep = alive
        while True:
            new = alive & ~(keep[:, :, None] & over).any(dim=1)
            if torch.equal(new, keep):
                break
            keep = new
        kept[:, start:end] = keep
    pos = torch.arange(n, device=sboxes.device)
    sel = torch.where(kept, pos, n)
    k = min(max_outputs, n)
    first = torch.sort(sel, dim=1, stable=True).values[:, :k]
    keep_pos = torch.full((b, max_outputs), -1, dtype=torch.int32, device=sboxes.device)
    keep_pos[:, :k] = torch.where(first < n, first, -1).to(torch.int32)
    count = kept.sum(dim=1).clamp(max=max_outputs).to(torch.int32)
    return keep_pos, count


def _keep_cuda(sboxes, svalid, slabels, iou_threshold, max_outputs):
    """The same kept positions and count from ``csrc/nms.cu``."""
    b, n, _ = sboxes.shape
    if n < 1 or max_outputs < 1:
        raise ValueError(f"nms kernel needs N >= 1 and max_outputs >= 1, got {n}, {max_outputs}")
    # the scan keeps one removed-word per 64 boxes in 48 KB of shared memory
    if n > 64 * 6144:
        raise ValueError(f"nms kernel takes at most {64 * 6144} boxes, got {n}")
    col_blocks = (n + 63) // 64
    dev = sboxes.device
    boxes = sboxes.to(torch.float32).contiguous()
    valid = svalid.to(torch.uint8).contiguous()
    labels = slabels.to(torch.int32).contiguous()
    mask = torch.empty((b, n, col_blocks), dtype=torch.int64, device=dev)
    keep_pos = torch.empty((b, max_outputs), dtype=torch.int32, device=dev)
    count = torch.empty((b,), dtype=torch.int32, device=dev)
    kernels.NMS.call(
        "nms_forward",
        boxes.data_ptr(), valid.data_ptr(), labels.data_ptr(),
        keep_pos.data_ptr(), count.data_ptr(), mask.data_ptr(),
        b, n, max_outputs, float(iou_threshold),
    )
    kernels.NMS.launches += 1
    return keep_pos, count


def _nms(boxes, scores, valid, iou_threshold, max_outputs, labels, keep_fn):
    single = boxes.dim() == 2
    if single:
        boxes, scores, valid = boxes[None], scores[None], valid[None]
        labels = None if labels is None else labels[None]
    boxes = boxes.to(torch.float32)
    scores = scores.to(torch.float32)
    valid = valid.to(torch.bool)
    if labels is None:
        labels = torch.zeros(valid.shape, dtype=torch.int32, device=valid.device)
    labels = labels.to(torch.int32)
    order, sboxes, svalid, slabels = _sorted_inputs(boxes, scores, valid, labels)
    keep_pos, count = keep_fn(sboxes, svalid, slabels, iou_threshold, max_outputs)
    out_valid = (
        torch.arange(max_outputs, device=boxes.device)[None, :] < count[:, None]
    )
    idx = torch.gather(order, 1, keep_pos.clamp(min=0).to(torch.int64))
    idx = torch.where(out_valid, idx, 0).to(torch.int32)
    if single:
        return idx[0], out_valid[0]
    return idx, out_valid


def nms_plain(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    max_outputs: int,
    labels: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`nms`, on any device."""
    return _nms(boxes, scores, valid, iou_threshold, max_outputs, labels, _keep_plain)


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    max_outputs: int,
    labels: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over ``[(B,) N, 4]`` boxes (see the module docstring).

    ``labels`` ``[(B,) N]``: when given, only boxes of the same label
    suppress each other.  Returns ``(indices [(B,) max_outputs] int32,
    valid [(B,) max_outputs] bool)``.  CPU tensors run the plain version;
    CUDA tensors launch ``csrc/nms.cu``.
    """
    if boxes.device.type == "cpu":
        return nms_plain(boxes, scores, valid, iou_threshold, max_outputs, labels)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms runs on cpu or cuda tensors, not {boxes.device}")
    out = _nms(boxes, scores, valid, iou_threshold, max_outputs, labels, _keep_cuda)
    hook = kernels.NMS.on_launch
    if hook is not None:
        hook((boxes, scores, valid, iou_threshold, max_outputs, labels), out)
    return out


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    labels: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    max_outputs: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class NMS as one pass: :func:`nms` with the same-label gate
    (argument order of the JAX ``batched_nms``)."""
    return nms(boxes, scores, valid, iou_threshold, max_outputs, labels=labels)
