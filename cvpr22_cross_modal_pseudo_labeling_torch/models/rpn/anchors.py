"""Anchor generation.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/rpn/
anchors.py`` (``generate_cell_anchors`` :40, ``grid_anchors`` :68,
``anchor_visibility`` :83, ``build_anchors_for_levels`` :102).
Anchors are a numpy precompute in float32; one level's anchors are
ordered (y, x, a), the order in which ``flatten_rpn_outputs`` flattens
an NHWC head output.
"""

from typing import List, Sequence, Tuple

import numpy as np
import torch


def _whctrs(anchor):
    w = anchor[2] - anchor[0] + 1
    h = anchor[3] - anchor[1] + 1
    return w, h, anchor[0] + 0.5 * (w - 1), anchor[1] + 0.5 * (h - 1)


def _mkanchors(ws, hs, x_ctr, y_ctr):
    ws = ws[:, None]
    hs = hs[:, None]
    return np.hstack(
        (
            x_ctr - 0.5 * (ws - 1),
            y_ctr - 0.5 * (hs - 1),
            x_ctr + 0.5 * (ws - 1),
            y_ctr + 0.5 * (hs - 1),
        )
    )


def generate_cell_anchors(
    stride: int, sizes: Sequence[float], aspect_ratios: Sequence[float]
) -> np.ndarray:
    """Base anchors ``[A, 4]`` float32 on the (0, 0) cell: a
    ``(0, 0, stride-1, stride-1)`` window enumerated over ratios (with
    the Detectron rounding), then scales."""
    scales = np.array(sizes, np.float64) / stride
    ratios = np.array(aspect_ratios, np.float64)
    base = np.array([1, 1, stride, stride], np.float64) - 1

    w, h, x_ctr, y_ctr = _whctrs(base)
    size = w * h
    ws = np.round(np.sqrt(size / ratios))
    hs = np.round(ws * ratios)
    ratio_anchors = _mkanchors(ws, hs, x_ctr, y_ctr)

    out = []
    for i in range(ratio_anchors.shape[0]):
        w, h, x_ctr, y_ctr = _whctrs(ratio_anchors[i])
        out.append(_mkanchors(w * scales, h * scales, x_ctr, y_ctr))
    return np.vstack(out).astype(np.float32)


def grid_anchors(
    feature_hw: Tuple[int, int], stride: int, cell_anchors: np.ndarray
) -> np.ndarray:
    """``[H*W*A, 4]`` anchors over the feature grid, (y, x, a) order."""
    h, w = feature_hw
    shifts_x = np.arange(0, w * stride, stride, np.float32)
    shifts_y = np.arange(0, h * stride, stride, np.float32)
    sx, sy = np.meshgrid(shifts_x, shifts_y)
    shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
    return (shifts + cell_anchors[None]).reshape(-1, 4)


def anchor_visibility(
    anchors: torch.Tensor, image_size: torch.Tensor, straddle_thresh: float = 0.0
) -> torch.Tensor:
    """Which anchors lie inside the image, within ``straddle_thresh``
    pixels: ``[..., N]`` bool for anchors ``[N, 4]`` and ``image_size``
    ``[..., 2]`` (h, w), batched over its leading axes.  A negative
    threshold keeps every anchor."""
    shape = image_size.shape[:-1] + anchors.shape[:-1]
    if straddle_thresh < 0:
        return torch.ones(shape, dtype=torch.bool, device=anchors.device)
    h = image_size[..., 0, None].to(anchors.dtype)
    w = image_size[..., 1, None].to(anchors.dtype)
    return (
        (anchors[..., 0] >= -straddle_thresh)
        & (anchors[..., 1] >= -straddle_thresh)
        & (anchors[..., 2] < w + straddle_thresh)
        & (anchors[..., 3] < h + straddle_thresh)
    )


def build_anchors_for_levels(
    feature_shapes: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    sizes: Sequence[float],
    aspect_ratios: Sequence[float],
    device: torch.device,
) -> List[torch.Tensor]:
    """One ``[H*W*A, 4]`` anchor tensor per feature level, on ``device``.
    One stride (C4, C5): every size on the one level.  Several strides
    (FPN): one size per level, as JAX's function assigns them; a size
    may also be a tuple of sizes for its level.  The levels and strides
    must pair up, and so must strides and sizes (JAX's checks)."""
    if len(feature_shapes) != len(strides):
        raise ValueError(
            f"{len(feature_shapes)} feature levels but {len(strides)} anchor strides: "
            "set MODEL.RPN.ANCHOR_STRIDE to one stride per FPN level"
        )
    if len(strides) == 1:
        cells = [generate_cell_anchors(strides[0], sizes, aspect_ratios)]
    else:
        if len(strides) != len(sizes):
            raise ValueError(f"FPN: {len(strides)} anchor strides but {len(sizes)} anchor sizes")
        cells = [
            generate_cell_anchors(s, sz if isinstance(sz, (tuple, list)) else (sz,), aspect_ratios)
            for s, sz in zip(strides, sizes)
        ]
    return [
        torch.from_numpy(grid_anchors(shape, stride, cell)).to(device)
        for shape, stride, cell in zip(feature_shapes, strides, cells)
    ]
