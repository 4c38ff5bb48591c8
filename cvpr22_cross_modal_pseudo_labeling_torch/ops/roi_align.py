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
differentiates the plain version; on CUDA the gradient is the kernel's
backward entry (a plan of each roi's tap lists, then one CTA per tile of
dF summing every roi's taps in shared memory and writing the tile once in
the features' dtype), counted in ``kernels.ROI_ALIGN_BACKWARD``.

:func:`roi_align_levels` pools each roi from its own level of a feature
pyramid (the FPN pooler, ``models/roi_heads/pooler.py``).  JAX pools every
roi on every level with ``ops/roi_align.py::roi_align`` and sums the
results masked by level (``models/roi_heads/pooler.py:86-100``); each roi
has one level and ``x * 0 + y`` is exact, so pooling each roi on its own
level gives the same numbers.  Both kernels take a level filter (a ``[B,
S]`` int32 level per roi, and the level to run): the forward is launched
once a level into one output, each launch writing its own rows; the
backward once a level, each giving that level's dF from its rois only.
The plain versions take the same filter (rows of other levels are zero).

The three entries are ``torch.library`` custom ops: ``cmpl::roi_align``,
``cmpl::roi_align_levels`` and ``cmpl::roi_align_backward``.  Each one's
default implementation is its plain version and its CUDA implementation
the kernel (which counts the launch and calls the kernel's ``on_launch``);
its fake implementation gives the result's shape and dtype, so that
``torch.export`` traces a model through it without launching anything.
The two forwards take their gradient from the backward op
(``register_autograd``).  The wrappers call the ops on CUDA tensors, and
on CPU tensors when no gradient is needed; on the CPU with a gradient
they run the plain version under autograd, as the CPU tests hold it
against ``jax.grad``.
"""

from typing import List, Optional, Sequence, Tuple

import torch

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
    levels: Optional[torch.Tensor] = None,
    level: int = 0,
) -> torch.Tensor:
    """The plain PyTorch version of :func:`roi_align`, on any device:
    float32 arithmetic on the features cast to float32, the result cast
    back to the features' dtype.  With ``levels`` (``[B, S]``), only the
    rois whose level is ``level`` are pooled; the other rows are zero."""
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
    alloc = torch.empty if levels is None else torch.zeros
    out = alloc((B, S, out_p, out_q, C), dtype=out_dtype, device=features.device)
    for b in range(B):
        feat = features[b]
        rows = None if levels is None else torch.nonzero(levels[b] == level).flatten()
        n = S if rows is None else rows.numel()
        for s0 in range(0, n, _PLAIN_ROI_CHUNK):
            s1 = min(s0 + _PLAIN_ROI_CHUNK, n)
            r = slice(s0, s1) if rows is None else rows[s0:s1]
            a_y = _axis_interp_matrix(sh[b, r], bh[b, r], gh[b, r], H, P, cap_h, bin_stride)
            a_x = _axis_interp_matrix(sw[b, r], bw[b, r], gw[b, r], W, Q, cap_w, bin_stride)
            # contraction order as in the JAX function: the smaller
            # intermediate ([s, Q, H, C] or [s, P, W, C]) is materialized
            if H * out_q <= out_p * W:
                tmp = torch.einsum("sqw,hwc->sqhc", a_x, feat)
                res = torch.einsum("sph,sqhc->spqc", a_y, tmp)
            else:
                tmp = torch.einsum("sph,hwc->spwc", a_y, feat)
                res = torch.einsum("spwc,sqw->spqc", tmp, a_x)
            out[b, r] = res.to(out_dtype)
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
    levels: Optional[torch.Tensor] = None,
    level: int = 0,
) -> torch.Tensor:
    """The plain version of the backward: the gradient of
    ``sum(roi_align_plain(F, rois, ...) * grad)`` with respect to ``F``
    of ``feature_shape`` and ``feature_dtype`` (it does not depend on F's
    values): the transposed float32 contraction ``dF[h, w, c] = sum_s,p,q
    A_y[s, p, h] A_x[s, q, w] g[s, p, q, c]`` with the forward's A
    matrices, cast to the features' dtype.  With ``levels``, the rois of
    ``level`` only.  It calls no autograd, so that it runs inside the
    custom op too, where autograd is off."""
    P, Q = output_size
    B, H, W, C = feature_shape
    (sh, bh, gh, cap_h), (sw, bw, gw, cap_w) = _roi_geometry(
        rois_per_image, spatial_scale, P, Q, H, W, sampling_ratio, max_samples
    )
    g32 = grad.to(torch.float32)
    out = torch.zeros((B, H, W, C), dtype=torch.float32, device=grad.device)
    for b in range(B):
        rows = None if levels is None else torch.nonzero(levels[b] == level).flatten()
        n = rois_per_image.shape[1] if rows is None else rows.numel()
        for s0 in range(0, n, _PLAIN_ROI_CHUNK):
            s1 = min(s0 + _PLAIN_ROI_CHUNK, n)
            r = slice(s0, s1) if rows is None else rows[s0:s1]
            a_y = _axis_interp_matrix(sh[b, r], bh[b, r], gh[b, r], H, P, cap_h, bin_stride)
            a_x = _axis_interp_matrix(sw[b, r], bw[b, r], gw[b, r], W, Q, cap_w, bin_stride)
            tmp = torch.einsum("spqc,sqw->spwc", g32[b, r], a_x)
            out[b] += torch.einsum("sph,spwc->hwc", a_y, tmp)
    return out.to(feature_dtype)


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


def _check_levels(levels, B, S, device):
    """The level filter as the kernels read it: ``[B, S]`` int32,
    contiguous, on the features' device; None stays None."""
    if levels is None:
        return None
    if tuple(levels.shape) != (B, S) or levels.device != device:
        raise ValueError(f"levels must be [B={B}, S={S}] on {device}, got "
                         f"{tuple(levels.shape)} on {levels.device}")
    return levels.to(torch.int32).contiguous()


def _forward_cuda(features, rois_per_image, output_size, spatial_scale,
                  sampling_ratio, max_samples, bin_stride, levels=None, level=0, out=None):
    """Launches ``roi_align_forward``; with ``levels``, into the rows of
    ``level`` of ``out`` (allocated when None) only."""
    P, Q = output_size
    B, H, W, C = features.shape
    S = rois_per_image.shape[1]
    rois = _check_kernel_inputs(
        features.shape, features.dtype, features.device, rois_per_image,
        sampling_ratio, max_samples, bin_stride,
    )
    lv = _check_levels(levels, B, S, features.device)
    feats = _aligned(features, "features")
    shape = (B, S, -(-P // bin_stride), -(-Q // bin_stride), C)
    if out is None:
        out = torch.empty(shape, dtype=feats.dtype, device=feats.device)
    elif (tuple(out.shape) != shape or out.dtype != feats.dtype or out.device != feats.device
          or not out.is_contiguous()):
        raise ValueError(f"roi_align: out must be a contiguous {shape} {feats.dtype} tensor on "
                         f"{feats.device}, got {tuple(out.shape)} {out.dtype} on {out.device}")
    kernels.ROI_ALIGN.call(
        "roi_align_forward",
        feats.data_ptr(), rois.data_ptr(), None if lv is None else lv.data_ptr(), int(level),
        out.data_ptr(), B, H, W, C, S, P, Q, float(spatial_scale),
        int(sampling_ratio), int(max_samples), int(bin_stride),
        int(feats.dtype == torch.bfloat16),
    )
    kernels.ROI_ALIGN.launches += 1
    hook = kernels.ROI_ALIGN.on_launch
    if hook is not None:
        hook(
            (features, rois_per_image, output_size, spatial_scale,
             sampling_ratio, max_samples, bin_stride)
            + (() if levels is None else (levels, level)),
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
                   spatial_scale, sampling_ratio, max_samples, bin_stride, levels=None,
                   level=0, tile=BACKWARD_TILE):
    """Launches ``roi_align_backward``: the plan of every roi's tap lists
    into a workspace, then the tiles of dF, each summed in shared memory
    and written once in the features' dtype (``tile`` as for
    :func:`backward_tiling`).  With ``levels``, dF of the rois of
    ``level`` only."""
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
    lv = _check_levels(levels, B, S, grad.device)
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
        g.data_ptr(), rois.data_ptr(), None if lv is None else lv.data_ptr(), int(level),
        workspace.data_ptr(), nbytes, out.data_ptr(),
        B, H, W, C, S, P, Q, float(spatial_scale),
        int(sampling_ratio), int(max_samples), int(bin_stride), rows, cols, slab, per_cta,
        int(feature_dtype == torch.bfloat16),
    )
    kernels.ROI_ALIGN_BACKWARD.launches += 1
    hook = kernels.ROI_ALIGN_BACKWARD.on_launch
    if hook is not None:
        hook(
            (grad, rois_per_image, tuple(feature_shape), feature_dtype, output_size,
             spatial_scale, sampling_ratio, max_samples, bin_stride)
            + (() if levels is None else (levels, level)),
            out,
        )
    return out


@torch.library.custom_op("cmpl::roi_align_backward", mutates_args=())
def roi_align_backward_op(
    grad: torch.Tensor,
    rois_per_image: torch.Tensor,
    feature_shape: Sequence[int],
    feature_dtype: torch.dtype,
    output_size: Sequence[int],
    spatial_scale: float,
    sampling_ratio: int,
    max_samples: int,
    bin_stride: int,
    levels: Optional[torch.Tensor],
    level: int,
) -> torch.Tensor:
    """``cmpl::roi_align_backward``: dF of ``feature_shape`` and
    ``feature_dtype`` (the arguments of :func:`roi_align_backward`, every
    one given).  This default implementation is the plain version."""
    return roi_align_backward_plain(grad, rois_per_image, tuple(feature_shape), feature_dtype, tuple(output_size),
                                    spatial_scale, sampling_ratio, max_samples, bin_stride, levels, level)


@roi_align_backward_op.register_kernel("cuda")
def _roi_align_backward_op_cuda(grad, rois_per_image, feature_shape, feature_dtype, output_size, spatial_scale,
                                sampling_ratio, max_samples, bin_stride, levels, level):
    return _backward_cuda(grad, rois_per_image, tuple(feature_shape), feature_dtype, tuple(output_size),
                          spatial_scale, sampling_ratio, max_samples, bin_stride, levels, level)


@roi_align_backward_op.register_fake
def _roi_align_backward_op_fake(grad, rois_per_image, feature_shape, feature_dtype, *args):
    return grad.new_empty(tuple(feature_shape), dtype=feature_dtype)


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
    levels: Optional[torch.Tensor] = None,
    level: int = 0,
) -> torch.Tensor:
    """The gradient of :func:`roi_align` with respect to features of
    ``feature_shape`` and ``feature_dtype``, for the cotangent ``grad``
    (``[B, S, P', Q', C]``); with ``levels``, the gradient of the rois
    of ``level`` only.  CPU tensors run :func:`roi_align_backward_plain`;
    CUDA tensors launch the kernel's ``roi_align_backward`` entry; both
    through ``cmpl::roi_align_backward``, which is also the two forward
    ops' gradient."""
    if grad.device.type not in ("cpu", "cuda"):
        raise ValueError(f"roi_align_backward runs on cpu or cuda tensors, not {grad.device}")
    return roi_align_backward_op(
        grad, rois_per_image, [int(x) for x in feature_shape], feature_dtype, [int(x) for x in output_size],
        float(spatial_scale), int(sampling_ratio), int(max_samples), int(bin_stride), levels, int(level),
    )


def _out_shape(feature_shape, rois_per_image, output_size, bin_stride):
    P, Q = output_size
    return (feature_shape[0], rois_per_image.shape[1], -(-P // bin_stride), -(-Q // bin_stride),
            feature_shape[-1])


@torch.library.custom_op("cmpl::roi_align", mutates_args=())
def roi_align_op(
    features: torch.Tensor,
    rois_per_image: torch.Tensor,
    output_size: Sequence[int],
    spatial_scale: float,
    sampling_ratio: int,
    max_samples: int,
    bin_stride: int,
) -> torch.Tensor:
    """``cmpl::roi_align`` (the arguments of :func:`roi_align`, every one
    given).  This default implementation is the plain version."""
    return roi_align_plain(features, rois_per_image, tuple(output_size), spatial_scale, sampling_ratio,
                           max_samples, bin_stride)


@roi_align_op.register_kernel("cuda")
def _roi_align_op_cuda(features, rois_per_image, output_size, spatial_scale, sampling_ratio, max_samples,
                       bin_stride):
    return _forward_cuda(features, rois_per_image, tuple(output_size), spatial_scale, sampling_ratio,
                         max_samples, bin_stride)


@roi_align_op.register_fake
def _roi_align_op_fake(features, rois_per_image, output_size, spatial_scale, sampling_ratio, max_samples,
                       bin_stride):
    return features.new_empty(_out_shape(features.shape, rois_per_image, output_size, bin_stride))


def _roi_align_setup(ctx, inputs, output):
    features, rois_per_image, output_size, spatial_scale, sampling_ratio, max_samples, bin_stride = inputs
    ctx.save_for_backward(rois_per_image)
    ctx.args = ([int(x) for x in features.shape], features.dtype, output_size, spatial_scale, sampling_ratio,
                max_samples, bin_stride)


def _roi_align_grad(ctx, grad):
    (rois_per_image,) = ctx.saved_tensors
    shape, dtype, output_size, scale, sr, ms, bin_stride = ctx.args
    dfeat = roi_align_backward_op(grad, rois_per_image, shape, dtype, output_size, scale, sr, ms, bin_stride,
                                  None, 0)
    return (dfeat,) + (None,) * 6


roi_align_op.register_autograd(_roi_align_grad, setup_context=_roi_align_setup)


def _check_rois_grad(name, features, rois_per_image):
    if features.device.type == "cuda" and torch.is_grad_enabled() and rois_per_image.requires_grad:
        raise RuntimeError(
            f"{name}: csrc/roi_align.cu differentiates with respect to the "
            "features only, so rois must not require grad (detach them)"
        )


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
    version (autograd differentiates it when the features need a
    gradient); CUDA tensors launch ``csrc/roi_align.cu``, which reads 16
    bytes of channels at a time: C a multiple of 4 for float32 features,
    of 8 for bfloat16.  On CUDA the result carries a gradient for
    features that require one, computed by the backward kernel; rois that
    require grad raise, as the kernels differentiate with respect to the
    features only (the JAX model stops the gradient of the proposals, and
    gt boxes are data).
    """
    if features.device.type not in ("cpu", "cuda"):
        raise ValueError(f"roi_align runs on cpu or cuda tensors, not {features.device}")
    if features.device.type == "cpu" and torch.is_grad_enabled() and (
            features.requires_grad or rois_per_image.requires_grad):
        return roi_align_plain(
            features, rois_per_image, output_size, spatial_scale,
            sampling_ratio, max_samples, bin_stride,
        )
    _check_rois_grad("roi_align", features, rois_per_image)
    return roi_align_op(
        features, rois_per_image, [int(x) for x in output_size], float(spatial_scale),
        int(sampling_ratio), int(max_samples), int(bin_stride),
    )


def _forward_levels_cuda(features, rois_per_image, levels, output_size, scales,
                         sampling_ratio, max_samples, out=None):
    """One ``roi_align_forward`` launch a level into one output (``out``,
    allocated when None): together the launches write every row whose
    level is in ``range(len(features))``."""
    for level, (feat, scale) in enumerate(zip(features, scales)):
        out = _forward_cuda(feat, rois_per_image, output_size, scale, sampling_ratio,
                            max_samples, 1, levels, level, out)
    return out


def _roi_align_levels_plain(features, rois_per_image, levels, output_size, scales, sampling_ratio, max_samples):
    """The sum of the plain version's levels, each zero outside its rows."""
    out = None
    for level, (feat, scale) in enumerate(zip(features, scales)):
        part = roi_align_plain(feat, rois_per_image, output_size, scale, sampling_ratio,
                               max_samples, 1, levels, level)
        out = part if out is None else out + part
    return out


@torch.library.custom_op("cmpl::roi_align_levels", mutates_args=())
def roi_align_levels_op(
    features: List[torch.Tensor],
    rois_per_image: torch.Tensor,
    levels: torch.Tensor,
    output_size: Sequence[int],
    scales: Sequence[float],
    sampling_ratio: int,
    max_samples: int,
) -> torch.Tensor:
    """``cmpl::roi_align_levels`` (the arguments of
    :func:`roi_align_levels`, every one given).  This default
    implementation is the plain version."""
    return _roi_align_levels_plain(features, rois_per_image, levels, tuple(output_size), scales, sampling_ratio,
                                   max_samples)


@roi_align_levels_op.register_kernel("cuda")
def _roi_align_levels_op_cuda(features, rois_per_image, levels, output_size, scales, sampling_ratio, max_samples):
    return _forward_levels_cuda(features, rois_per_image, levels, tuple(output_size), scales, sampling_ratio,
                                max_samples)


@roi_align_levels_op.register_fake
def _roi_align_levels_op_fake(features, rois_per_image, levels, output_size, scales, sampling_ratio, max_samples):
    return features[0].new_empty(_out_shape(features[0].shape, rois_per_image, output_size, 1))


def _roi_align_levels_setup(ctx, inputs, output):
    features, rois_per_image, levels, output_size, scales, sampling_ratio, max_samples = inputs
    ctx.save_for_backward(rois_per_image, levels)
    ctx.args = ([([int(x) for x in f.shape], f.dtype) for f in features], output_size, scales, sampling_ratio,
                max_samples)


def _roi_align_levels_grad(ctx, grad):
    rois_per_image, levels = ctx.saved_tensors
    shapes, output_size, scales, sampling_ratio, max_samples = ctx.args
    needs = ctx.needs_input_grad[0]
    dfeats = [
        roi_align_backward_op(grad, rois_per_image, shape, dtype, output_size, scale, sampling_ratio,
                              max_samples, 1, levels, level) if needs[level] else None
        for level, ((shape, dtype), scale) in enumerate(zip(shapes, scales))
    ]
    return dfeats, None, None, None, None, None, None


roi_align_levels_op.register_autograd(_roi_align_levels_grad, setup_context=_roi_align_levels_setup)


def roi_align_levels(
    features: Sequence[torch.Tensor],
    rois_per_image: torch.Tensor,
    levels: torch.Tensor,
    output_size: Tuple[int, int],
    scales: Sequence[float],
    sampling_ratio: int = 0,
    max_samples: int = 8,
) -> torch.Tensor:
    """RoIAlign of each roi on its own level: roi s of image b pools from
    ``features[levels[b, s]][b]`` at ``scales[levels[b, s]]``, at every bin
    (the JAX multi-level pooler has no ``bin_stride``).

    features: one ``[B, H_l, W_l, C]`` map a level, all of one dtype;
    rois_per_image ``[B, S, 4]``; levels ``[B, S]`` integers in
    ``range(len(features))``.  Returns ``[B, S, P, Q, C]`` in the features'
    dtype.  CPU tensors sum the plain version's levels (each zero outside
    its rows; autograd differentiates it when a level needs a gradient);
    CUDA tensors launch the forward kernel once a level into one output
    and, for the gradient, the backward kernel once a level.  Rois that
    require grad raise on CUDA, as for :func:`roi_align`."""
    if len(features) != len(scales) or not features:
        raise ValueError(f"{len(features)} feature levels but {len(scales)} scales")
    if len({f.dtype for f in features}) != 1:
        raise ValueError("roi_align_levels: every level must have one dtype")
    device = features[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"roi_align_levels runs on cpu or cuda tensors, not {device}")
    if device.type == "cpu" and torch.is_grad_enabled() and (
            any(f.requires_grad for f in features) or rois_per_image.requires_grad):
        return _roi_align_levels_plain(features, rois_per_image, levels, output_size, scales, sampling_ratio,
                                       max_samples)
    _check_rois_grad("roi_align_levels", features[0], rois_per_image)
    return roi_align_levels_op(
        list(features), rois_per_image, levels, [int(x) for x in output_size], [float(x) for x in scales],
        int(sampling_ratio), int(max_samples),
    )
