"""Detectron box encoding and decoding.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/core/box_coder.py``
(``encode_boxes`` :17, ``decode_boxes`` :51), with the same legacy
numerics: +1 widths/heights, dw/dh clipped at ``log(1000/16)`` and the
asymmetric ``-1`` on x2/y2.
"""

import math
from typing import Tuple

import torch

BBOX_XFORM_CLIP = math.log(1000.0 / 16)


def encode_boxes(
    reference_boxes: torch.Tensor,
    proposals: torch.Tensor,
    weights: Tuple[float, float, float, float],
) -> torch.Tensor:
    """Regression targets ``[..., 4]`` (dx, dy, dw, dh) of gt
    ``reference_boxes`` against ``proposals``, both ``[..., 4]`` xyxy.
    Zero-size (padded) slots are floored at 1e-8; callers mask them."""
    wx, wy, ww, wh = weights
    ex_w = proposals[..., 2] - proposals[..., 0] + 1.0
    ex_h = proposals[..., 3] - proposals[..., 1] + 1.0
    ex_cx = proposals[..., 0] + 0.5 * ex_w
    ex_cy = proposals[..., 1] + 0.5 * ex_h

    gt_w = reference_boxes[..., 2] - reference_boxes[..., 0] + 1.0
    gt_h = reference_boxes[..., 3] - reference_boxes[..., 1] + 1.0
    gt_cx = reference_boxes[..., 0] + 0.5 * gt_w
    gt_cy = reference_boxes[..., 1] + 0.5 * gt_h

    ex_w = ex_w.clamp(min=1e-8)
    ex_h = ex_h.clamp(min=1e-8)
    gt_w = gt_w.clamp(min=1e-8)
    gt_h = gt_h.clamp(min=1e-8)

    dx = wx * (gt_cx - ex_cx) / ex_w
    dy = wy * (gt_cy - ex_cy) / ex_h
    dw = ww * torch.log(gt_w / ex_w)
    dh = wh * torch.log(gt_h / ex_h)
    return torch.stack([dx, dy, dw, dh], dim=-1)


def decode_boxes(
    rel_codes: torch.Tensor,
    boxes: torch.Tensor,
    weights: Tuple[float, float, float, float],
    bbox_xform_clip: float = BBOX_XFORM_CLIP,
) -> torch.Tensor:
    """Decodes ``[..., K*4]`` codes against ``[..., 4]`` boxes."""
    boxes = boxes.to(rel_codes.dtype)
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    codes = rel_codes.reshape(rel_codes.shape[:-1] + (-1, 4))
    # a tensor divisor keeps true division on CUDA, where a Python scalar
    # divisor becomes a multiplication by its reciprocal
    codes = codes / torch.tensor(weights, dtype=codes.dtype, device=codes.device)
    dx = codes[..., 0]
    dy = codes[..., 1]
    dw = codes[..., 2].clamp(max=bbox_xform_clip)
    dh = codes[..., 3].clamp(max=bbox_xform_clip)

    pred_ctr_x = dx * widths[..., None] + ctr_x[..., None]
    pred_ctr_y = dy * heights[..., None] + ctr_y[..., None]
    pred_w = torch.exp(dw) * widths[..., None]
    pred_h = torch.exp(dh) * heights[..., None]

    out = torch.stack(
        [
            pred_ctr_x - 0.5 * pred_w,
            pred_ctr_y - 0.5 * pred_h,
            # "-1 is correct; don't be fooled by the asymmetry"
            pred_ctr_x + 0.5 * pred_w - 1.0,
            pred_ctr_y + 0.5 * pred_h - 1.0,
        ],
        dim=-1,
    )
    return out.reshape(rel_codes.shape)
