"""Box-frame mask resampling.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/ops/masks.py``
(``_axis_tap_matrix`` :28, ``crop_resize_from_box_frame`` :49 with its
batched form :84, ``project_masks_on_boxes`` :89).  A mask defined over
one box's frame is resampled onto an ``out x out`` grid over another box
as ``W_y @ mask @ W_x^T``: two-tap bilinear rows per axis
(``align_corners=False``, legacy +1 box extents, out-of-range taps
contribute zero).  Two small batched matmuls per call; the results are
training targets and carry no gradient.
"""

from typing import Tuple

import torch


def _axis_tap_matrix(coords: torch.Tensor, size: int) -> torch.Tensor:
    """``[..., K]`` sample positions -> ``[..., K, size]`` two-tap
    bilinear weight rows."""
    i0 = torch.floor(coords).to(torch.int64)
    l = coords - i0.to(coords.dtype)
    zero = torch.zeros((), dtype=coords.dtype, device=coords.device)
    w0 = torch.where((i0 >= 0) & (i0 <= size - 1), 1.0 - l, zero)
    w1 = torch.where((i0 + 1 >= 0) & (i0 + 1 <= size - 1), l, zero)
    i0c = i0.clamp(0, size - 1)
    i1c = (i0 + 1).clamp(0, size - 1)
    pos = torch.arange(size, device=coords.device)
    return (
        w0[..., None] * (pos == i0c[..., None]).to(coords.dtype)
        + w1[..., None] * (pos == i1c[..., None]).to(coords.dtype)
    )


def crop_resize_from_box_frame(
    src_mask: torch.Tensor,
    src_box: torch.Tensor,
    dst_box: torch.Tensor,
    out_size: Tuple[int, int],
) -> torch.Tensor:
    """Resamples ``src_mask [R, M, M]``, defined over ``src_box [R, 4]``
    (xyxy, image pixels), onto an ``out_size`` grid over ``dst_box
    [R, 4]``; returns ``[R, oh, ow]`` in float32."""
    oh, ow = out_size
    m_h, m_w = src_mask.shape[-2:]
    src_w = src_box[:, 2] - src_box[:, 0] + 1.0
    src_h = src_box[:, 3] - src_box[:, 1] + 1.0
    dst_w = dst_box[:, 2] - dst_box[:, 0] + 1.0
    dst_h = dst_box[:, 3] - dst_box[:, 1] + 1.0

    def centers(n, extent):
        # a tensor divisor: CUDA divides by a Python int as a
        # multiplication by its reciprocal, and an ulp here can flip a
        # target pixel at the >= 0.5 binarization
        grid = torch.arange(n, device=extent.device, dtype=extent.dtype) + 0.5
        divisor = torch.full((), float(n), dtype=extent.dtype, device=extent.device)
        return grid[None, :] * extent[:, None] / divisor

    ys_img = dst_box[:, 1, None] + centers(oh, dst_h)
    xs_img = dst_box[:, 0, None] + centers(ow, dst_w)
    ys = (ys_img - src_box[:, 1, None]) / src_h[:, None] * m_h - 0.5
    xs = (xs_img - src_box[:, 0, None]) / src_w[:, None] * m_w - 0.5
    w_y = _axis_tap_matrix(ys, m_h)  # [R, oh, m_h]
    w_x = _axis_tap_matrix(xs, m_w).transpose(1, 2)  # [R, m_w, ow]
    return w_y @ src_mask.to(w_y.dtype) @ w_x


def project_masks_on_boxes(
    gt_masks: torch.Tensor,
    gt_boxes: torch.Tensor,
    proposal_boxes: torch.Tensor,
    matched_idx: torch.Tensor,
    out_size: int,
) -> torch.Tensor:
    """Each proposal's matched gt mask, cropped to the proposal and
    resized.  gt_masks ``[B, G, M, M]`` rasterized over gt_boxes ``[B, G,
    4]``; proposal_boxes ``[B, S, 4]``; matched_idx ``[B, S]`` into G.
    Returns ``[B, S, out_size, out_size]`` targets in [0, 1]."""
    b, s = matched_idx.shape
    m = gt_masks.shape[-1]
    idx = matched_idx.to(torch.int64)
    src_masks = torch.gather(gt_masks, 1, idx[:, :, None, None].expand(b, s, m, m))
    src_boxes = torch.gather(gt_boxes, 1, idx[:, :, None].expand(b, s, 4))
    out = crop_resize_from_box_frame(
        src_masks.reshape(b * s, m, m),
        src_boxes.reshape(b * s, 4).to(torch.float32),
        proposal_boxes.reshape(b * s, 4).to(torch.float32),
        (out_size, out_size),
    )
    return out.reshape(b, s, out_size, out_size)
