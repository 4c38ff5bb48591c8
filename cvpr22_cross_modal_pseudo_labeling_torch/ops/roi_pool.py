"""RoIPool (max pooling), in plain PyTorch.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/ops/roi_pool.py::
roi_pool`` (:22; the reference's csrc/cuda/ROIPool_cuda.cu, which no
shipped config uses): Fast R-CNN's legacy semantics, the roi rounded to
the feature grid (C rounding), sizes +1, integer bin edges, the max over
each bin, 0 for an empty bin.  The JAX package has no Pallas kernel for
it, and nothing of either package calls it.  Autograd gives the
gradient with respect to the features (split between tied maxima, as
XLA's).
"""

from typing import Optional, Tuple

import torch

from .deform_conv import _round_half_away


def roi_pool(features: torch.Tensor, rois: torch.Tensor, output_size: Tuple[int, int], spatial_scale: float,
             max_bin: Optional[int] = None) -> torch.Tensor:
    """features ``[B, H, W, C]``; rois ``[R, 5]`` (batch, x1, y1, x2, y2).
    Returns ``[R, P, Q, C]``.  ``max_bin`` caps the taps scanned a bin
    along each axis; the scan strides across the whole bin (a subsampled
    max).  None is the exact bound ``ceil(H / P) + 1`` (``W``, ``Q``
    alike), no bin being larger: the reference's full-bin max."""
    p, q = output_size
    b, h, w, c = features.shape
    dt, dev = features.dtype, features.device
    max_bin_h = max_bin if max_bin is not None else -(-h // p) + 1
    max_bin_w = max_bin if max_bin is not None else -(-w // q) + 1

    bi = rois[:, 0].to(torch.int64)

    def rnd(v):
        return _round_half_away(v).to(torch.int32)

    x1 = rnd(rois[:, 1] * spatial_scale)
    y1 = rnd(rois[:, 2] * spatial_scale)
    x2 = rnd(rois[:, 3] * spatial_scale)
    y2 = rnd(rois[:, 4] * spatial_scale)
    bin_w = torch.clamp(x2 - x1 + 1, min=1).to(dt) / q
    bin_h = torch.clamp(y2 - y1 + 1, min=1).to(dt) / p
    ph = torch.arange(p, device=dev)
    pw = torch.arange(q, device=dev)

    def edges(n, bins, start, size):
        lo = torch.floor(n.to(dt)[None] * bins[:, None]).to(torch.int32) + start[:, None]
        hi = torch.ceil((n + 1).to(dt)[None] * bins[:, None]).to(torch.int32) + start[:, None]
        return lo.clamp(0, size), hi.clamp(0, size)

    hstart, hend = edges(ph, bin_h, y1, h)  # [R, P]
    wstart, wend = edges(pw, bin_w, x1, w)  # [R, Q]
    ext_h, ext_w = hend - hstart, wend - wstart
    stride_h = torch.clamp((ext_h + max_bin_h - 1) // max_bin_h, min=1)
    stride_w = torch.clamp((ext_w + max_bin_w - 1) // max_bin_w, min=1)
    flat = features.reshape(b * h * w, c)
    base = (bi * (h * w))[:, None, None]
    neg_inf = torch.full((), float("-inf"), dtype=dt, device=dev)
    out = neg_inf.expand(rois.shape[0], p, q, c)
    for dy in range(max_bin_h):
        off_y = dy * stride_h
        yy = (hstart + off_y).clamp(0, h - 1).to(torch.int64)
        y_ok = off_y < ext_h
        for dx in range(max_bin_w):
            off_x = dx * stride_w
            xx = (wstart + off_x).clamp(0, w - 1).to(torch.int64)
            x_ok = off_x < ext_w
            vals = flat[base + yy[:, :, None] * w + xx[:, None, :]]  # [R, P, Q, C]
            ok = (y_ok[:, :, None] & x_ok[:, None, :])[..., None]
            out = torch.maximum(out, torch.where(ok, vals, neg_inf))
    # an empty bin pools 0 (the reference's maxval = 0)
    return torch.where(torch.isfinite(out), out, torch.zeros((), dtype=dt, device=dev))
