"""The FBNet mobile trunk.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/fbnet.py``
(``MODEL_ARCH`` :29, ``_divisible`` :78, ``_FrozenAffine`` :86,
``InvertedResidual`` :102, ``FBNetTrunk`` :145): a 3x3 stride-2 stem,
then the architecture's stages of inverted residual blocks (1x1 expand,
kxk depthwise, 1x1 project, a residual when the shapes allow), each conv
followed by a frozen per-channel affine; one stride-16 feature map out.
Only ``models/backbone.py::build_backbone`` (``CONV_BODY FBNet``) builds
it.  Module names are the flax scopes (``first``, ``first_bn``,
``stage{s}_g{g}_b{b}`` with ``pw``, ``dw``, ``pwl`` and their ``_bn``),
so that ``bridge.py`` maps the parameters by path; the affine's
``frozen_bn_weight``/``frozen_bn_bias`` are buffers here, as the frozen
BN's are.  Features are ``[B, H, W, C]`` at the edges and NCHW
channels-last views inside, as in ``models/resnet.py``.
"""

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d

# [t, c, n, s, k] stage tables: expansion, channels, repeats, first
# stride, depthwise kernel (the JAX module's table)
MODEL_ARCH = {
    "default": {
        "first": (32, 2),
        "stages": [
            [(1, 16, 1, 1, 3)],
            [(6, 24, 2, 2, 3)],
            [(6, 32, 3, 2, 3)],
            [(6, 64, 4, 2, 3), (6, 96, 3, 1, 3)],
        ],
    },
    "xirb16d_dsmask": {
        "first": (16, 2),
        "stages": [
            [(1, 16, 1, 1, 3)],
            [(6, 32, 2, 2, 3)],
            [(6, 48, 3, 2, 3)],
            [(6, 96, 4, 2, 3), (6, 128, 3, 1, 3)],
        ],
    },
    "mobilenet_v2": {
        "first": (32, 2),
        "stages": [
            [(1, 16, 1, 1, 3)],
            [(6, 24, 2, 2, 3)],
            [(6, 32, 3, 2, 3)],
            [(6, 64, 4, 2, 3), (6, 96, 3, 1, 3)],
        ],
    },
    "cham_v1a": {
        "first": (32, 2),
        "stages": [
            [(1, 24, 1, 1, 3)],
            [(4, 48, 2, 2, 7)],
            [(7, 64, 5, 2, 3)],
            [(12, 56, 7, 2, 5), (8, 88, 5, 1, 3)],
        ],
    },
    "cham_v2": {
        "first": (32, 2),
        "stages": [
            [(1, 24, 1, 1, 3)],
            [(8, 32, 4, 2, 5)],
            [(5, 48, 4, 2, 5)],
            [(9, 56, 4, 2, 5), (6, 56, 3, 1, 3)],
        ],
    },
}


def _divisible(c: float, divisor: int) -> int:
    """Rounds to the nearest multiple of ``divisor``, never below it."""
    if divisor <= 1:
        return int(round(c))
    return max(divisor, int(round(c / divisor)) * divisor)


class FrozenAffine(nn.Module):
    """``x * weight + bias`` per channel, both cast to the input's dtype."""

    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.weight.to(x.dtype)[:, None, None] + self.bias.to(x.dtype)[:, None, None]


class InvertedResidual(nn.Module):
    """1x1 expand (when ``t`` > 1) -> kxk depthwise at ``stride`` -> 1x1
    project, each with its affine (ReLU after the first two), plus the
    input when the stride is 1 and the widths agree."""

    def __init__(self, c_in: int, t: int, c_out: int, stride: int, kernel: int, dtype=torch.float32):
        super().__init__()
        mid = c_in * t
        self.expand = t != 1
        if self.expand:
            self.pw = Conv2d(c_in, mid, 1, bias=False, dtype=dtype)
            self.pw_bn = FrozenAffine(mid)
        self.dw = Conv2d(mid, mid, kernel, stride=stride, padding=kernel // 2, groups=mid, bias=False, dtype=dtype)
        self.dw_bn = FrozenAffine(mid)
        self.pwl = Conv2d(mid, c_out, 1, bias=False, dtype=dtype)
        self.pwl_bn = FrozenAffine(c_out)
        self.residual = stride == 1 and c_in == c_out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.pw_bn(self.pw(x))) if self.expand else x
        y = F.relu(self.dw_bn(self.dw(y)))
        y = self.pwl_bn(self.pwl(y))
        return y + x if self.residual else y


class FBNetTrunk(nn.Module):
    """The stem and the architecture's stages; ``[B, H, W, 3]`` in, a
    one-element list of the stride-16 ``[B, h, w, out_channels]`` map
    out."""

    def __init__(self, arch: str = "default", scale_factor: float = 1.0, width_divisor: int = 1,
                 dtype=torch.float32):
        super().__init__()
        spec = MODEL_ARCH[arch]
        c_first, s_first = spec["first"]
        c_first = _divisible(c_first * scale_factor, width_divisor)
        self.first = Conv2d(3, c_first, 3, stride=s_first, padding=1, bias=False, dtype=dtype)
        self.first_bn = FrozenAffine(c_first)
        self.blocks: List[str] = []
        c_in = c_first
        for si, stage in enumerate(spec["stages"]):
            for gi, (t, c, n, s, k) in enumerate(stage):
                c = _divisible(c * scale_factor, width_divisor)
                for bi in range(n):
                    name = f"stage{si}_g{gi}_b{bi}"
                    self.add_module(name, InvertedResidual(c_in, t, c, s if bi == 0 else 1, k, dtype))
                    self.blocks.append(name)
                    c_in = c
        self.out_channels = c_in

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        y = F.relu(self.first_bn(self.first(x.permute(0, 3, 1, 2))))
        for name in self.blocks:
            y = getattr(self, name)(y)
        return [y.permute(0, 2, 3, 1)]
