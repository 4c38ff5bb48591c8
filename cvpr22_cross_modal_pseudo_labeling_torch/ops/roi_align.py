"""RoIAlign over channels-last features, and its gradient.

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

The gradient with respect to the features is the transposed contraction
``dF[h, w, c] = sum_p,q A_y[p, h] A_x[q, w] g[p, q, c]`` summed over the
rois, which XLA derives for the JAX package.  On the CPU autograd
differentiates the plain version; on CUDA a ``torch.autograd.Function``
runs the kernel's backward entry (a plan of each roi's tap lists, then
one CTA per tile of dF summing every roi's taps in shared memory and
writing the tile once in the features' dtype), counted in
``kernels.ROI_ALIGN_BACKWARD``.
"""

from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from . import kernels

_PLAIN_ROI_CHUNK = 128
# the backward kernel's tile of dF: rows, columns, channels, and the
# slabs of channels one CTA sums one after the other; sized on an H100
# (PERF.md section 6)
BACKWARD_TILE = (4, 21, 256, 2)
SHARED_MEMORY_PER_BLOCK = 232448  # bytes a CTA may use on sm_90
# constants of the backward kernel in csrc/roi_align.cu
_BWD_MAX_ROWS = 4  # kMaxTileRows
_BWD_MAX_THREADS = 256  # kBwdMaxThreads
_BWD_LIST = 512  # kListCap
_BWD_COLUMNS_PER_ITEM = 7  # kQ


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


def _sample_caps(H, W, P, Q, sampling_ratio, max_samples):
    """The most samples a bin takes along each axis: the sampling ratio,
    or the adaptive grid's cap min(max_samples, ceil(size / bins))."""
    if sampling_ratio > 0:
        return sampling_ratio, sampling_ratio
    return min(max_samples, -(-H // P)), min(max_samples, -(-W // Q))


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
    s_cap_h, s_cap_w = _sample_caps(H, W, P, Q, sampling_ratio, max_samples)
    if sampling_ratio > 0:
        grid_h = torch.full(roi_h.shape, sampling_ratio, dtype=torch.int32, device=rois.device)
        grid_w = grid_h
    else:
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


def roi_align_backward_plain(
    grad: torch.Tensor,
    rois_per_image: torch.Tensor,
    feature_shape: Tuple[int, int, int, int],
    feature_dtype: torch.dtype,
    output_size: Tuple[int, int],
    spatial_scale: float,
    sampling_ratio: int = 0,
    max_samples: int = 8,
    bin_stride: int = 1,
) -> torch.Tensor:
    """The plain version of the backward: the gradient of
    ``sum(roi_align_plain(F, rois, ...) * grad)`` with respect to ``F``
    of ``feature_shape`` and ``feature_dtype`` (it does not depend on F's
    values), by autograd of the plain version: the transposed float32
    contraction, cast to the features' dtype."""
    with torch.enable_grad():
        f = torch.zeros(feature_shape, dtype=feature_dtype, device=grad.device, requires_grad=True)
        out = roi_align_plain(
            f, rois_per_image, output_size, spatial_scale, sampling_ratio, max_samples, bin_stride
        )
        (dfeat,) = torch.autograd.grad(out, f, grad)
    return dfeat


def _check_kernel_inputs(shape, dtype, device, rois_per_image, sampling_ratio, max_samples, bin_stride):
    """What the kernels take, for features of ``shape``, ``dtype`` and
    ``device``; raises on anything else.  Returns the float32 rois."""
    B, H, W, C = shape
    S = rois_per_image.shape[1]
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"roi_align kernel takes float32 or bfloat16 features, got {dtype}")
    vec = 16 // dtype.itemsize
    if C % vec != 0:
        raise ValueError(f"roi_align kernel needs C % {vec} == 0 for {dtype}, got C={C}")
    if rois_per_image.shape != (B, S, 4) or rois_per_image.device != device:
        raise ValueError(
            f"rois must be [B={B}, S, 4] on {device}, got "
            f"{tuple(rois_per_image.shape)} on {rois_per_image.device}"
        )
    # one CTA per roi; the roi's tap lists share the default 48 KB of
    # shared memory
    if not (0 < B * S < 2**31 and 0 < H * W * C < 2**31 and 0 < max_samples <= 64
            and sampling_ratio <= 64 and bin_stride >= 1):
        raise ValueError(
            f"roi_align kernel cannot take B={B}, S={S}, H={H}, W={W}, C={C}, "
            f"sampling_ratio={sampling_ratio}, max_samples={max_samples}, "
            f"bin_stride={bin_stride}"
        )
    return rois_per_image.detach().to(torch.float32).contiguous()


def _aligned(t: torch.Tensor, what: str) -> torch.Tensor:
    t = t.contiguous()
    if t.data_ptr() % 16 != 0:
        raise ValueError(f"roi_align kernel reads 16 bytes at a time: {what} must be 16-byte aligned")
    return t


def _forward_cuda(features, rois_per_image, output_size, spatial_scale,
                  sampling_ratio, max_samples, bin_stride):
    P, Q = output_size
    B, H, W, C = features.shape
    S = rois_per_image.shape[1]
    rois = _check_kernel_inputs(
        features.shape, features.dtype, features.device, rois_per_image,
        sampling_ratio, max_samples, bin_stride,
    )
    feats = _aligned(features, "features")
    out = torch.empty(
        (B, S, -(-P // bin_stride), -(-Q // bin_stride), C), dtype=feats.dtype, device=feats.device
    )
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


def backward_tiling(H: int, W: int, C: int, column_taps: int,
                    tile: Tuple[int, int, int, int] = BACKWARD_TILE):
    """(rows, columns, channels, slabs per CTA) of the backward kernel's
    tile of dF for ``[H, W, C]`` features and at most ``column_taps`` taps
    per emitted column: ``tile`` cut to the map (at most 4 rows, the
    columns spread evenly over the tiles of a row) and to C, the channels
    a multiple of 128 (each row of the tile has a group of whole warps,
    four channels a thread, at most 256 threads in all), fewer channels
    while the CTA's shared memory would not fit, and at most as many slabs
    per CTA as C has."""
    rows, cols, slab, per_cta = tile
    rows = max(1, min(rows, H, _BWD_MAX_ROWS))
    cols = max(1, min(cols, W))
    cols = -(-W // -(-W // cols))
    widest = 4 * _BWD_MAX_THREADS // rows // 128 * 128
    slab = max(128, min(-(-slab // 128) * 128, widest, -(-C // 128) * 128))
    while slab > 128 and backward_shared_bytes(rows, cols, slab, column_taps) > SHARED_MEMORY_PER_BLOCK:
        slab -= 128
    return rows, cols, slab, max(1, min(per_cta, -(-C // slab)))


def backward_shared_bytes(rows: int, cols: int, slab: int, column_taps: int) -> int:
    """Dynamic shared memory of one CTA of the backward kernel: the
    tile's float32 sums, each row's work list, the warps' counts, and
    each warp's buffer of one item's column taps."""
    warps = rows * slab // 128
    return (rows * cols * slab * 4 + rows * _BWD_LIST * 8 + _BWD_MAX_ROWS * 32 * 4
            + warps * (_BWD_COLUMNS_PER_ITEM * column_taps + _BWD_COLUMNS_PER_ITEM) * 8)


def _plan_bytes(B, S, out_p, out_q, cap_h, cap_w):
    """Bytes of the backward's plan (``plan_layout`` of the kernel): per
    roi, the (index, weight) tap lists of its emitted rows and columns,
    their counts and index ranges, and the column range of each run of
    emitted columns; each array 256-byte aligned."""
    nr = B * S
    nqc = -(-out_q // _BWD_COLUMNS_PER_ITEM)
    sizes = (nr * out_p * 2 * cap_h * 8, nr * out_q * 2 * cap_w * 8, nr * out_p * 4,
             nr * out_q * 4, nr * out_p * 8, nr * out_q * 8, nr * nqc * 8)
    return sum(-(-n // 256) * 256 for n in sizes)


def _backward_cuda(grad, rois_per_image, feature_shape, feature_dtype, output_size,
                   spatial_scale, sampling_ratio, max_samples, bin_stride, tile=BACKWARD_TILE):
    """Launches ``roi_align_backward``: the plan of every roi's tap lists
    into a workspace, then the tiles of dF, each summed in shared memory
    and written once in the features' dtype (``tile`` as for
    :func:`backward_tiling`)."""
    P, Q = output_size
    B, H, W, C = feature_shape
    S = rois_per_image.shape[1]
    out_p, out_q = -(-P // bin_stride), -(-Q // bin_stride)
    out_shape = (B, S, out_p, out_q, C)
    if tuple(grad.shape) != out_shape:
        raise ValueError(f"roi_align backward: cotangent {tuple(grad.shape)}, expected {out_shape}")
    rois = _check_kernel_inputs(
        feature_shape, feature_dtype, grad.device, rois_per_image,
        sampling_ratio, max_samples, bin_stride,
    )
    if S > 65535 or out_p > 64 or out_q > 8 * _BWD_COLUMNS_PER_ITEM:
        raise ValueError(
            f"roi_align backward kernel takes at most 65535 rois per image and 64 x "
            f"{8 * _BWD_COLUMNS_PER_ITEM} emitted bins, got S={S}, {out_p} x {out_q}"
        )
    cap_h, cap_w = _sample_caps(H, W, P, Q, sampling_ratio, max_samples)
    rows, cols, slab, per_cta = backward_tiling(H, W, C, 2 * cap_w, tile)
    if backward_shared_bytes(rows, cols, slab, 2 * cap_w) > SHARED_MEMORY_PER_BLOCK:
        raise ValueError(f"roi_align backward: a {rows} x {cols} x {slab} tile does not fit a CTA")
    g = _aligned(grad.to(feature_dtype), "the cotangent")
    nbytes = _plan_bytes(B, S, out_p, out_q, cap_h, cap_w)
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=g.device)
    out = torch.empty(feature_shape, dtype=feature_dtype, device=g.device)
    kernels.ROI_ALIGN_BACKWARD.call(
        "roi_align_backward",
        g.data_ptr(), rois.data_ptr(), workspace.data_ptr(), nbytes, out.data_ptr(),
        B, H, W, C, S, P, Q, float(spatial_scale),
        int(sampling_ratio), int(max_samples), int(bin_stride), rows, cols, slab, per_cta,
        int(feature_dtype == torch.bfloat16),
    )
    kernels.ROI_ALIGN_BACKWARD.launches += 1
    hook = kernels.ROI_ALIGN_BACKWARD.on_launch
    if hook is not None:
        hook(
            (grad, rois_per_image, tuple(feature_shape), feature_dtype, output_size,
             spatial_scale, sampling_ratio, max_samples, bin_stride),
            out,
        )
    return out


def roi_align_backward(
    grad: torch.Tensor,
    rois_per_image: torch.Tensor,
    feature_shape: Tuple[int, int, int, int],
    feature_dtype: torch.dtype,
    output_size: Tuple[int, int],
    spatial_scale: float,
    sampling_ratio: int = 0,
    max_samples: int = 8,
    bin_stride: int = 1,
) -> torch.Tensor:
    """The gradient of :func:`roi_align` with respect to features of
    ``feature_shape`` and ``feature_dtype``, for the cotangent ``grad``
    (``[B, S, P', Q', C]``).  CPU tensors run
    :func:`roi_align_backward_plain`; CUDA tensors launch the kernel's
    ``roi_align_backward`` entry.  ``roi_align`` calls it from its
    ``autograd.Function`` on CUDA."""
    args = (grad, rois_per_image, tuple(feature_shape), feature_dtype, output_size,
            spatial_scale, sampling_ratio, max_samples, bin_stride)
    if grad.device.type == "cpu":
        return roi_align_backward_plain(*args)
    if grad.device.type != "cuda":
        raise ValueError(f"roi_align_backward runs on cpu or cuda tensors, not {grad.device}")
    return _backward_cuda(*args)


class _RoIAlignCUDA(torch.autograd.Function):
    """The CUDA route with its gradient: ``roi_align_forward`` forward,
    ``roi_align_backward`` backward (with respect to the features only)."""

    @staticmethod
    def forward(ctx, features, rois_per_image, output_size, spatial_scale,
                sampling_ratio, max_samples, bin_stride):
        ctx.save_for_backward(rois_per_image)
        ctx.args = (tuple(features.shape), features.dtype, output_size, spatial_scale,
                    sampling_ratio, max_samples, bin_stride)
        return _forward_cuda(features, rois_per_image, output_size, spatial_scale,
                             sampling_ratio, max_samples, bin_stride)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (rois_per_image,) = ctx.saved_tensors
        dfeat = _backward_cuda(grad, rois_per_image, *ctx.args)
        return (dfeat,) + (None,) * 6


def roi_align(
    features: torch.Tensor,
    rois_per_image: torch.Tensor,
    output_size: Tuple[int, int],
    spatial_scale: float,
    sampling_ratio: int = 0,
    max_samples: int = 8,
    bin_stride: int = 1,
) -> torch.Tensor:
    """RoIAlign (see the module docstring).

    features ``[B, H, W, C]`` float32 or bfloat16; rois_per_image
    ``[B, S, 4]`` xyxy in image pixels, roi s of image b pooling from
    ``features[b]``.  Returns ``[B, S, ceil(P / bin_stride), ceil(Q /
    bin_stride), C]`` in the features' dtype.  CPU tensors run the plain
    version (autograd differentiates it); CUDA tensors launch
    ``csrc/roi_align.cu``, which reads 16 bytes of channels at a time: C a
    multiple of 4 for float32 features, of 8 for bfloat16.  On CUDA the
    result carries a gradient for features that require one, computed by
    the backward kernel; rois that require grad raise, as the kernels
    differentiate with respect to the features only (the JAX model stops
    the gradient of the proposals, and gt boxes are data).
    """
    if features.device.type == "cpu":
        return roi_align_plain(
            features, rois_per_image, output_size, spatial_scale,
            sampling_ratio, max_samples, bin_stride,
        )
    if features.device.type != "cuda":
        raise ValueError(f"roi_align runs on cpu or cuda tensors, not {features.device}")
    if torch.is_grad_enabled() and rois_per_image.requires_grad:
        raise RuntimeError(
            "roi_align: csrc/roi_align.cu differentiates with respect to the "
            "features only, so rois must not require grad (detach them)"
        )
    return _RoIAlignCUDA.apply(
        features, rois_per_image, output_size, spatial_scale,
        sampling_ratio, max_samples, bin_stride,
    )
