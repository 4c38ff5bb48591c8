"""RoIAlign forward over channels-last features.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/ops/
roi_align_mxu.py::roi_align_mxu`` (:91, with ``_axis_interp_matrix``
:41), the main path's pooler, and of the Pallas prototypes of the same
contraction in ``tools/proto_pallas_roialign.py`` (``run_fused``,
``run_fused_bigdot``).  The golden numerics are those of the JAX
``ops/roi_align.py::roi_align`` (:50) and ``_bilinear_weights`` (:31),
not those of the reference CUDA kernel:

* roi size is ``max(end - start, 1)``, with no half-pixel shift;
* the adaptive grid is ``ceil(roi / bins)`` clipped to
  ``[1, min(max_samples, ceil(size / bins))]`` per axis;
* samples outside ``[-1, size]`` contribute zero, coordinates clamp to
  0 below and to ``size - 1`` at the top edge;
* ``bin_stride`` keeps the bin geometry of ``output_size`` but emits only
  every ``bin_stride``-th bin on each axis.

Because each bilinear tap factorizes, the op is
``out[p, q, c] = sum_h sum_w A_y[p, h] A_x[q, w] F[h, w, c]`` with
per-roi axis matrices ``A``.  :func:`roi_align_plain` builds the A
matrices and contracts them with einsums, as the JAX function does; CUDA
tensors go to ``csrc/roi_align.cu``, which builds the same A rows as
compact tap lists in shared memory and gathers only the taps they touch.

Features may be float32 or bfloat16, and the result has their dtype;
the arithmetic is float32 either way.  bfloat16 features give what the
JAX bundle computes by pooling ``f.astype(float32)`` and casting the
result with ``.astype(bfloat16)``.
"""

from typing import Tuple

import torch

from . import kernels

_PLAIN_ROI_CHUNK = 128


def _bilinear_weights(coord: torch.Tensor, size: int):
    """(lo, hi, w_lo, w_hi, in_range) per the reference boundary rules."""
    in_range = (coord >= -1.0) & (coord <= size)
    c = coord.clamp(min=0.0)
    lo = torch.floor(c).to(torch.int64)
    at_edge = lo >= size - 1
    lo = torch.where(at_edge, size - 1, lo)
    hi = torch.where(at_edge, size - 1, lo + 1)
    c = torch.where(at_edge, lo.to(c.dtype), c)
    l = c - lo.to(c.dtype)
    return lo, hi, 1.0 - l, l, in_range


def _axis_interp_matrix(start, bin_size, grid, size, bins, s_cap, bin_stride):
    """``A [R, ceil(bins / bin_stride), size]``: bilinear tap weights per
    emitted bin over input positions, averaged over the roi's grid."""
    dtype = start.dtype
    p_idx = torch.arange(0, bins, bin_stride, dtype=dtype, device=start.device)[None, :]
    pos = torch.arange(size, device=start.device)[None, None, :]
    a = torch.zeros((start.shape[0], p_idx.shape[1], size), dtype=dtype, device=start.device)
    g = grid[:, None].to(dtype)
    for i in range(s_cap):
        coord = (
            start[:, None]
            + p_idx * bin_size[:, None]
            + (i + 0.5) * bin_size[:, None] / g
        )
        lo, hi, w_lo, w_hi, in_range = _bilinear_weights(coord, size)
        valid = (in_range & (i < grid[:, None])).to(dtype)
        w_lo = w_lo * valid
        w_hi = w_hi * valid
        a = (
            a
            + w_lo[:, :, None] * (pos == lo[:, :, None]).to(dtype)
            + w_hi[:, :, None] * (pos == hi[:, :, None]).to(dtype)
        )
    return a / g[:, :, None]


def _roi_geometry(rois, spatial_scale, P, Q, H, W, sampling_ratio, max_samples):
    rois = rois.to(torch.float32)
    start_w = rois[..., 0] * spatial_scale
    start_h = rois[..., 1] * spatial_scale
    end_w = rois[..., 2] * spatial_scale
    end_h = rois[..., 3] * spatial_scale
    roi_w = (end_w - start_w).clamp(min=1.0)
    roi_h = (end_h - start_h).clamp(min=1.0)
    # divide by tensors: CUDA turns division by a Python scalar into a
    # multiplication by its reciprocal, an ulp away from the JAX bins
    bin_h = roi_h / torch.full_like(roi_h, P)
    bin_w = roi_w / torch.full_like(roi_w, Q)
    if sampling_ratio > 0:
        s_cap_h = s_cap_w = sampling_ratio
        grid_h = torch.full(roi_h.shape, sampling_ratio, dtype=torch.int32, device=rois.device)
        grid_w = grid_h
    else:
        s_cap_h = min(max_samples, -(-H // P))
        s_cap_w = min(max_samples, -(-W // Q))
        grid_h = torch.ceil(bin_h).to(torch.int32).clamp(1, s_cap_h)
        grid_w = torch.ceil(bin_w).to(torch.int32).clamp(1, s_cap_w)
    return (start_h, bin_h, grid_h, s_cap_h), (start_w, bin_w, grid_w, s_cap_w)


def roi_align_plain(
    features: torch.Tensor,
    rois_per_image: torch.Tensor,
    output_size: Tuple[int, int],
    spatial_scale: float,
    sampling_ratio: int = 0,
    max_samples: int = 8,
    bin_stride: int = 1,
) -> torch.Tensor:
    """The plain PyTorch version of :func:`roi_align`, on any device:
    float32 arithmetic on the features cast to float32, the result cast
    back to the features' dtype."""
    out_dtype = features.dtype
    features = features.to(torch.float32)
    P, Q = output_size
    B, H, W, C = features.shape
    S = rois_per_image.shape[1]
    (sh, bh, gh, cap_h), (sw, bw, gw, cap_w) = _roi_geometry(
        rois_per_image, spatial_scale, P, Q, H, W, sampling_ratio, max_samples
    )
    out_p = -(-P // bin_stride)
    out_q = -(-Q // bin_stride)
    out = torch.empty((B, S, out_p, out_q, C), dtype=out_dtype, device=features.device)
    for b in range(B):
        feat = features[b]
        for s0 in range(0, S, _PLAIN_ROI_CHUNK):
            s1 = min(s0 + _PLAIN_ROI_CHUNK, S)
            a_y = _axis_interp_matrix(sh[b, s0:s1], bh[b, s0:s1], gh[b, s0:s1], H, P, cap_h, bin_stride)
            a_x = _axis_interp_matrix(sw[b, s0:s1], bw[b, s0:s1], gw[b, s0:s1], W, Q, cap_w, bin_stride)
            # contraction order as in the JAX function: the smaller
            # intermediate ([s, Q, H, C] or [s, P, W, C]) is materialized
            if H * out_q <= out_p * W:
                tmp = torch.einsum("sqw,hwc->sqhc", a_x, feat)
                res = torch.einsum("sph,sqhc->spqc", a_y, tmp)
            else:
                tmp = torch.einsum("sph,hwc->spwc", a_y, feat)
                res = torch.einsum("spwc,sqw->spqc", tmp, a_x)
            out[b, s0:s1] = res
    return out


def roi_align(
    features: torch.Tensor,
    rois_per_image: torch.Tensor,
    output_size: Tuple[int, int],
    spatial_scale: float,
    sampling_ratio: int = 0,
    max_samples: int = 8,
    bin_stride: int = 1,
) -> torch.Tensor:
    """RoIAlign forward (see the module docstring).

    features ``[B, H, W, C]`` float32 or bfloat16; rois_per_image
    ``[B, S, 4]`` xyxy in image pixels, roi s of image b pooling from
    ``features[b]``.  Returns ``[B, S, ceil(P / bin_stride), ceil(Q /
    bin_stride), C]`` in the features' dtype.  CPU
    tensors run the plain version; CUDA tensors launch
    ``csrc/roi_align.cu``, which reads 16 bytes of channels at a time:
    C a multiple of 4 for float32 features, of 8 for bfloat16.
    """
    if features.device.type == "cpu":
        return roi_align_plain(
            features, rois_per_image, output_size, spatial_scale,
            sampling_ratio, max_samples, bin_stride,
        )
    if features.device.type != "cuda":
        raise ValueError(f"roi_align runs on cpu or cuda tensors, not {features.device}")
    if torch.is_grad_enabled() and (features.requires_grad or rois_per_image.requires_grad):
        raise RuntimeError(
            "roi_align: csrc/roi_align.cu has no backward kernel, so its result "
            "carries no gradient; run it on inputs that need none (detach them, "
            "or call it under torch.no_grad())"
        )
    P, Q = output_size
    B, H, W, C = features.shape
    S = rois_per_image.shape[1]
    if features.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"roi_align kernel takes float32 or bfloat16 features, got {features.dtype}")
    vec = 16 // features.element_size()
    if C % vec != 0:
        raise ValueError(f"roi_align kernel needs C % {vec} == 0 for {features.dtype}, got C={C}")
    if rois_per_image.shape != (B, S, 4) or rois_per_image.device != features.device:
        raise ValueError(
            f"rois must be [B={B}, S, 4] on {features.device}, got "
            f"{tuple(rois_per_image.shape)} on {rois_per_image.device}"
        )
    # one CTA per roi; the roi's tap lists share the default 48 KB of
    # shared memory
    if not (0 < B * S < 2**31 and H * W * C < 2**31 and 0 < max_samples <= 64
            and sampling_ratio <= 64 and bin_stride >= 1):
        raise ValueError(
            f"roi_align kernel cannot take B={B}, S={S}, H={H}, W={W}, C={C}, "
            f"sampling_ratio={sampling_ratio}, max_samples={max_samples}, "
            f"bin_stride={bin_stride}"
        )
    feats = features.contiguous()
    if feats.data_ptr() % 16 != 0:
        raise ValueError("roi_align kernel reads 16 bytes at a time: features must be 16-byte aligned")
    rois = rois_per_image.to(torch.float32).contiguous()
    out_p = -(-P // bin_stride)
    out_q = -(-Q // bin_stride)
    out = torch.empty((B, S, out_p, out_q, C), dtype=feats.dtype, device=features.device)
    kernels.ROI_ALIGN.call(
        "roi_align_forward",
        feats.data_ptr(), rois.data_ptr(), out.data_ptr(),
        B, H, W, C, S, P, Q, float(spatial_scale),
        int(sampling_ratio), int(max_samples), int(bin_stride),
        int(feats.dtype == torch.bfloat16),
    )
    kernels.ROI_ALIGN.launches += 1
    hook = kernels.ROI_ALIGN.on_launch
    if hook is not None:
        hook(
            (features, rois_per_image, output_size, spatial_scale,
             sampling_ratio, max_samples, bin_stride),
            out,
        )
    return out
