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


def _bilinear_sample_nhwc(x: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """x ``[B, H, W, C]``; ys, xs ``[B, ...]`` in pixels; each of the four
    taps outside the image reads 0.  Returns ``[B, ..., C]``."""
    b, h, w, c = x.shape
    y0, x0 = torch.floor(ys), torch.floor(xs)
    ly, lx = ys - y0, xs - x0
    y0, x0 = y0.to(torch.int64), x0.to(torch.int64)
    flat = x.reshape(b, h * w, c)
    rows = torch.arange(b, device=x.device)[:, None]

    def tap(yi, xi, wgt):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, -1)
        v = flat[rows, idx].reshape(*ys.shape, c)
        return v * (wgt * inside)[..., None]

    return (
        tap(y0, x0, (1 - ly) * (1 - lx))
        + tap(y0, x0 + 1, (1 - ly) * lx)
        + tap(y0 + 1, x0, ly * (1 - lx))
        + tap(y0 + 1, x0 + 1, ly * lx)
    )


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
