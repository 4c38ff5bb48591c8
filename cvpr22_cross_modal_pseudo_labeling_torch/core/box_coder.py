"""Detectron box decoding.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/core/box_coder.py``
(``decode_boxes``), with the same legacy numerics: +1 widths/heights,
dw/dh clipped at ``log(1000/16)`` and the asymmetric ``-1`` on x2/y2.
Encoding belongs to training and is not ported yet.
"""

import math
from typing import Tuple

import torch

BBOX_XFORM_CLIP = math.log(1000.0 / 16)


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
