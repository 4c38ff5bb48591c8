"""RoI feature pooling over one or more feature levels.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/
roi_heads/pooler.py`` (``assign_fpn_levels`` :29, ``pool_rois`` :47): the
single-level path (``roi_align_mxu``, :66-75) and the multi-level FPN
path (:86-100), where each roi takes the level of the LevelMapper and is
pooled from that level only (``ops/roi_align.py::roi_align_levels``).
"""

import math
from typing import Sequence, Tuple

import torch

from ...ops.roi_align import roi_align, roi_align_levels


def assign_fpn_levels(
    boxes: torch.Tensor,
    k_min: int,
    k_max: int,
    canonical_scale: int = 224,
    canonical_level: int = 4,
    eps: float = 1e-6,
) -> torch.Tensor:
    """The LevelMapper: ``floor(k0 + log2(sqrt(area) / s0 + eps))``
    clipped to ``[k_min, k_max]``, minus ``k_min``, as int32, for
    ``[..., 4]`` xyxy boxes (legacy +1 widths).  float32 in JAX's order of
    operations; the divisor is a tensor, since CUDA divides by a Python
    scalar as a multiplication by its reciprocal."""
    boxes = boxes.to(torch.float32)
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    s = torch.sqrt((w * h).clamp(min=0.0))
    lvl = torch.floor(canonical_level + torch.log2(s / torch.full_like(s, canonical_scale) + eps))
    return lvl.clamp(k_min, k_max).to(torch.int32) - k_min


def pool_rois(
    features: Sequence[torch.Tensor],
    boxes: torch.Tensor,
    output_size: Tuple[int, int],
    scales: Sequence[float],
    sampling_ratio: int,
    bin_stride: int = 1,
) -> torch.Tensor:
    """Pools ``[B, S, 4]`` boxes from ``[B, H, W, C]`` feature levels.
    Returns ``[B*S, P', Q', C]`` in the features' dtype; the arithmetic
    is float32 whatever the dtype.

    One level: every box from it, with ``P' = ceil(P / bin_stride)``.
    Several (FPN): each box from the level ``assign_fpn_levels`` gives it
    over the levels of ``scales`` (a level of ``features`` past them, P6,
    is not pooled), at every bin: the JAX multi-level path ignores
    ``bin_stride``, and so does this one."""
    b, s = boxes.shape[:2]
    if len(features) == 1:
        out = roi_align(
            features[0], boxes, output_size, scales[0], sampling_ratio,
            bin_stride=bin_stride,
        )
        return out.reshape(b * s, *out.shape[2:])
    k_a = -int(round(math.log2(scales[0])))
    k_b = -int(round(math.log2(scales[-1])))
    levels = assign_fpn_levels(boxes, min(k_a, k_b), max(k_a, k_b))
    out = roi_align_levels(
        list(features[: len(scales)]), boxes, levels, output_size, scales, sampling_ratio,
    )
    return out.reshape(b * s, *out.shape[2:])
