"""Deformable convolution, v1 and modulated v2, in plain PyTorch.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/ops/
deform_conv.py::deform_conv2d`` (:45) and ``_bilinear_sample_nhwc``
(:24): bilinear sampling of the input at each tap's base position plus
its learned offset (zero outside the image), an optional per-tap mask,
then one matmul of the ``[.., K*K*Cin]`` patches with the kernel.
Autograd gives the gradient with respect to the input, the offsets, the
mask and the kernel.  The JAX package has no Pallas kernel for it, and
neither has the port: only ``models/backbone.py::build_backbone``'s DCN
trunk reaches it.
"""

from typing import Optional

import torch


def _bilinear_sample_rois(x: torch.Tensor, bi: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """x ``[B, H, W, C]`` sampled for each r at ys, xs ``[R, ...]`` (pixels)
    in image ``bi[r]``, without a copy of the map per r; each of the four
    taps outside the image reads 0.  Returns ``[R, ..., C]``."""
    b, h, w, c = x.shape
    y0, x0 = torch.floor(ys), torch.floor(xs)
    ly, lx = ys - y0, xs - x0
    y0, x0 = y0.to(torch.int64), x0.to(torch.int64)
    flat = x.reshape(b * h * w, c)
    base = (bi.to(torch.int64) * (h * w)).reshape(-1, *([1] * (ys.dim() - 1)))

    def tap(yi, xi, wgt):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        v = flat[base + yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)]
        return v * (wgt * inside)[..., None]

    return (
        tap(y0, x0, (1 - ly) * (1 - lx))
        + tap(y0, x0 + 1, (1 - ly) * lx)
        + tap(y0 + 1, x0, ly * (1 - lx))
        + tap(y0 + 1, x0 + 1, ly * lx)
    )


def _bilinear_sample_nhwc(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """x ``[B, H, W, C]``; ys, xs ``[B, ...]`` in pixels; each of the four
    taps outside the image reads 0.  Returns ``[B, ..., C]``."""
    return _bilinear_sample_rois(x, torch.arange(x.shape[0], device=x.device), ys, xs)


def deform_conv2d(
    x: torch.Tensor,
    offsets: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: int = 1,
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """Deformable conv (v2 when ``mask`` is given), channels last as in
    JAX: x ``[B, H, W, Cin]``; offsets ``[B, Ho, Wo, 2*K*K]`` as (dy, dx)
    per tap; weight ``[K, K, Cin // groups, Cout]`` (flax's layout); mask
    ``[B, Ho, Wo, K*K]``.  ``groups`` splits the input and output
    channels into contiguous blocks, output block g reading input block
    g; one deformable group (every channel shares the offsets).  Returns
    ``[B, Ho, Wo, Cout]`` in x's dtype."""
    b, h, w, cin = x.shape
    kh, kw, cin_g, cout = weight.shape
    if cin_g * groups != cin or cout % groups:
        raise ValueError(
            f"grouped deform conv mismatch: x has {cin} channels, weight "
            f"[{kh},{kw},{cin_g},{cout}] with groups={groups}"
        )
    ho = (h + 2 * padding - dilation * (kh - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (kw - 1) - 1) // stride + 1
    n_taps = kh * kw
    dev = x.device
    oy = torch.arange(ho, device=dev, dtype=torch.float32) * stride - padding
    ox = torch.arange(wo, device=dev, dtype=torch.float32) * stride - padding
    tap_y = torch.arange(kh, device=dev, dtype=torch.float32).repeat_interleave(kw) * dilation
    tap_x = torch.arange(kw, device=dev, dtype=torch.float32).repeat(kh) * dilation
    off = offsets.reshape(b, ho, wo, n_taps, 2)
    ys = oy[:, None, None] + tap_y + off[..., 0]  # [B, Ho, Wo, K*K]
    xs = ox[None, :, None] + tap_x + off[..., 1]
    patches = _bilinear_sample_nhwc(x, ys, xs)  # [B, Ho, Wo, K*K, Cin]
    if mask is not None:
        patches = patches * mask.reshape(b, ho, wo, n_taps)[..., None]
    if groups == 1:
        out = patches.reshape(b, ho, wo, n_taps * cin) @ weight.reshape(n_taps * cin, cout)
    else:
        pg = patches.reshape(b, ho, wo, n_taps, groups, cin_g).transpose(3, 4)
        pg = pg.reshape(b, ho, wo, groups, n_taps * cin_g)
        wg = weight.reshape(n_taps * cin_g, groups, cout // groups).transpose(0, 1)
        out = torch.einsum("bhwgk,gko->bhwgo", pg, wg).reshape(b, ho, wo, cout)
    out = out.to(x.dtype)
    if bias is not None:
        out = out + bias
    return out


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """C ``round()``: halves away from zero (``torch.round`` rounds them
    to even)."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def deform_psroi_pool(
    features: torch.Tensor,
    rois: torch.Tensor,
    offsets: Optional[torch.Tensor],
    output_size: int,
    spatial_scale: float,
    sampling_ratio: int = 4,
    trans_std: float = 0.1,
    group_size: int = 1,
) -> torch.Tensor:
    """Deformable position-sensitive RoI pooling, the counterpart of
    ``cvpr22_cross_modal_pseudo_labeling_tpu/ops/deform_conv.py::
    deform_psroi_pool`` (:132; the reference's
    DeformablePSROIPoolForwardKernel, deform_pool_kernel_cuda.cu:54-141):
    the roi's interval ``round(x1) * scale - 0.5`` to ``(round(x2) + 1) *
    scale - 0.5`` (C rounding), at least 0.1 wide; ``sampling_ratio``**2
    samples a bin at ``start + i * sub_bin``, those outside ``[-0.5, dim -
    0.5]`` skipped, the rest clamped into the map and averaged (0 when
    none lands); the position-sensitive channel ``(ctop * gs + gh) * gs +
    gw``; class-agnostic part offsets scaled by ``trans_std`` times the
    roi's size.

    features ``[B, H, W, C]``; rois ``[R, 5]`` (batch, x1, y1, x2, y2);
    offsets ``[R, P, P, 2]`` as (dy, dx), or None.  Returns ``[R, P, P,
    C // group_size**2]``.  Autograd gives the gradient with respect to
    the features and the offsets."""
    p, gs, s = output_size, group_size, sampling_ratio
    _, h, w, c = features.shape
    if c % (gs * gs):
        raise ValueError(f"{c} channels not divisible by group_size^2={gs * gs}")
    out_dim = c // (gs * gs)
    dt, dev = features.dtype, features.device
    r = rois.shape[0]
    bi = rois[:, 0].to(torch.int64)
    x1 = _round_half_away(rois[:, 1]) * spatial_scale - 0.5
    y1 = _round_half_away(rois[:, 2]) * spatial_scale - 0.5
    x2 = (_round_half_away(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    y2 = (_round_half_away(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    roi_w = torch.clamp(x2 - x1, min=0.1)
    roi_h = torch.clamp(y2 - y1, min=0.1)
    bin_w, bin_h = roi_w / p, roi_h / p
    grid = torch.arange(p, dtype=dt, device=dev)
    si = torch.arange(s, dtype=dt, device=dev) / s
    hstart = y1[:, None, None] + grid[None, :, None] * bin_h[:, None, None] + 0.0 * grid[None, None, :]
    wstart = x1[:, None, None] + 0.0 * grid[None, :, None] + grid[None, None, :] * bin_w[:, None, None]
    if offsets is not None:
        hstart = hstart + offsets[..., 0] * trans_std * roi_h[:, None, None]
        wstart = wstart + offsets[..., 1] * trans_std * roi_w[:, None, None]
    ys = hstart[..., None, None] + si[:, None] * bin_h[:, None, None, None, None]  # [R, P, P, S, S]
    xs = wstart[..., None, None] + si[None, :] * bin_w[:, None, None, None, None]
    in_range = (ys >= -0.5) & (ys <= h - 0.5) & (xs >= -0.5) & (xs <= w - 0.5)
    vals = _bilinear_sample_rois(features, bi, ys.clamp(0.0, h - 1.0), xs.clamp(0.0, w - 1.0))
    vals = vals * in_range[..., None]
    cnt = in_range.sum(dim=(3, 4)).to(dt)
    pooled = vals.sum(dim=(3, 4)) / torch.clamp(cnt, min=1.0)[..., None]
    pooled = torch.where(cnt[..., None] > 0, pooled, torch.zeros((), dtype=dt, device=dev))
    # the position-sensitive channel of each bin: [R, P, P, out_dim]
    gh = torch.clamp(torch.arange(p, device=dev) * gs // p, 0, gs - 1)
    pooled = pooled.reshape(r, p, p, out_dim, gs, gs).permute(0, 1, 2, 4, 5, 3)
    ar = torch.arange(p, device=dev)
    return pooled[:, ar[:, None], ar[None, :], gh[:, None], gh[None, :]]
