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

The sort stays a torch op before the kernel, as XLA sorts around the
Pallas call.  For CUDA tensors ``csrc/nms.cu`` takes the sort's indices,
reads the boxes, labels and validity through them, and writes the final
indices and valid mask itself: nothing is gathered or copied between the
sort and the kernel, nor after it.  CPU tensors run :func:`nms_plain`:
the sorted gathers, :func:`_keep_plain` (the JAX package's tiled
fixpoint formulation) and the final gather.

Every function takes an optional leading batch axis: ``boxes [B, N, 4]``
runs B independent NMS problems (one kernel launch for all of them).
"""

import threading
from typing import Dict, Optional, Tuple

import torch

from ..core.boxes import box_iou
from . import kernels

_PLAIN_TILE = 256
# (device index, N, max_outputs) -> pinned int32: how many 64-box column
# blocks the last finished kernel call of that shape needed (csrc/nms.cu
# sizes its first band from it and copies it back asynchronously, so a
# word is kept for the life of the process).  It sets the band schedule,
# never a result.
_STOP_HINTS: Dict[Tuple[int, int, int], torch.Tensor] = {}
_STOP_HINTS_LOCK = threading.Lock()


def _stop_hint(device: torch.device, n: int, max_outputs: int) -> torch.Tensor:
    with _STOP_HINTS_LOCK:
        shape = (device.index, n, max_outputs)
        if shape not in _STOP_HINTS:
            _STOP_HINTS[shape] = torch.zeros((1,), dtype=torch.int32, pin_memory=True)
        return _STOP_HINTS[shape]


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


def _nms_cuda(boxes, scores, valid, iou_threshold, max_outputs, labels):
    """Indices and valid mask ``[B, max_outputs]`` from ``csrc/nms.cu``:
    the key, the sort, and one call that launches the mask and the scan
    kernels.  Takes contiguous float32 boxes (16-byte aligned) and
    scores, bool valid and int32 or int64 labels (or None)."""
    b, n, _ = boxes.shape
    if n < 1 or max_outputs < 1:
        raise ValueError(f"nms kernel needs N >= 1 and max_outputs >= 1, got {n}, {max_outputs}")
    # the scan lists the kept positions in shared memory
    if n > 64 * 6144 or b > 65535 or min(n, max_outputs) > 49152:
        raise ValueError(
            f"nms kernel takes at most 65535 x {64 * 6144} boxes and keeps at most "
            f"49152, got {b} x {n} -> {max_outputs}"
        )
    dev = boxes.device
    key = torch.where(valid, scores, float("-inf"))
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    cb = (n + 63) // 64
    # the layout is the kernel's (csrc/nms.cu::nms_forward), which checks
    # the size
    words = b * cb * (64 * cb + 65) + 2 * (b + 1) + (b * min(n, max_outputs) + 1) // 2
    scratch = torch.empty((words,), dtype=torch.int64, device=dev)
    idx = torch.empty((b, max_outputs), dtype=torch.int32, device=dev)
    out_valid = torch.empty((b, max_outputs), dtype=torch.bool, device=dev)
    kernels.NMS.call(
        "nms_forward",
        boxes.data_ptr(), valid.data_ptr(),
        0 if labels is None else labels.data_ptr(),
        0 if labels is None else labels.element_size(),
        order.data_ptr(), scratch.data_ptr(), words, _stop_hint(dev, n, max_outputs).data_ptr(),
        idx.data_ptr(), out_valid.data_ptr(),
        b, n, max_outputs, float(iou_threshold),
    )
    kernels.NMS.launches += 1
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
    keep_pos, count = _keep_plain(sboxes, svalid, slabels, iou_threshold, max_outputs)
    out_valid = (
        torch.arange(max_outputs, device=boxes.device)[None, :] < count[:, None]
    )
    idx = torch.gather(order, 1, keep_pos.clamp(min=0).to(torch.int64))
    idx = torch.where(out_valid, idx, 0).to(torch.int32)
    if single:
        return idx[0], out_valid[0]
    return idx, out_valid


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
    inputs = (boxes, scores, valid, iou_threshold, max_outputs, labels)
    single = boxes.dim() == 2
    if single:
        boxes, scores, valid = boxes[None], scores[None], valid[None]
        labels = None if labels is None else labels[None]
    if labels is not None and labels.dtype not in (torch.int32, torch.int64):
        labels = labels.to(torch.int32)
    boxes = boxes.to(torch.float32).contiguous()
    if boxes.data_ptr() % 16 != 0:  # the kernels read a box as one float4
        boxes = boxes.clone()
    out = _nms_cuda(
        boxes,
        scores.to(torch.float32).contiguous(),
        valid.to(torch.bool).contiguous(),
        iou_threshold, max_outputs,
        None if labels is None else labels.contiguous(),
    )
    if single:
        out = (out[0][0], out[1][0])
    hook = kernels.NMS.on_launch
    if hook is not None:
        hook(inputs, out)
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
