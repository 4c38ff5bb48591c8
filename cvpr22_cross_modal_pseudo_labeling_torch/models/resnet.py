"""ResNet body and C5 RoI head with frozen BatchNorm.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/resnet.py``
(``FrozenBatchNorm`` :31, ``Bottleneck`` :65, ``Stem`` :213,
``ResNetStage`` :266, ``ResNet`` :307, ``ResNetRoIHead`` :379), for the
``frozen_bn`` norm only (no DCN, no GroupNorm).  Module names follow the
flax scopes (``stem``, ``layer1``, ``block0``, ``downsample_conv``...)
so that ``bridge.py`` maps parameters by path.

Tensors run as NCHW in ``torch.channels_last`` memory: the NHWC input is
permuted to that view for free, and the output permutes back to a
contiguous ``[B, H, W, C]``.  ``TPU.S2D_STEM`` (an exact TPU rewrite of
the 7x7 stem) has no counterpart: the plain 7x7 conv is the same
function.
"""

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d

RESNET_STAGES = {
    "R-50": (3, 4, 6, 3),
    "R-101": (3, 4, 23, 3),
    "R-152": (3, 8, 36, 3),
}


class FrozenBatchNorm(nn.Module):
    """``x * scale + shift`` with ``scale = weight / sqrt(running_var)``:
    no epsilon (Caffe2 imports fold it in), as in the JAX module.  The
    affine pair is computed in float32 and cast to the input's dtype."""

    def __init__(self, features: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight / torch.sqrt(self.running_var)
        shift = self.bias - self.running_mean * scale
        return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def _conv(cin, cout, kernel, stride=1, dilation=1, dtype=torch.float32, groups=1):
    pad = dilation * (kernel - 1) // 2
    return Conv2d(
        cin, cout, kernel, stride=stride, padding=pad, dilation=dilation,
        groups=groups, bias=False, dtype=dtype,
    )


class Bottleneck(nn.Module):
    def __init__(self, in_channels, bottleneck_channels, out_channels,
                 stride=1, dilation=1, stride_in_1x1=True, num_groups=1,
                 dtype=torch.float32):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.has_downsample = in_channels != out_channels or stride != 1
        if self.has_downsample:
            down_stride = stride if dilation == 1 else 1
            self.downsample_conv = _conv(in_channels, out_channels, 1, down_stride, dtype=dtype)
            self.downsample_bn = FrozenBatchNorm(out_channels)
        self.conv1 = _conv(in_channels, bottleneck_channels, 1, s1, dtype=dtype)
        self.bn1 = FrozenBatchNorm(bottleneck_channels)
        self.conv2 = _conv(bottleneck_channels, bottleneck_channels, 3, s3,
                           dilation, dtype, groups=num_groups)
        self.bn2 = FrozenBatchNorm(bottleneck_channels)
        self.conv3 = _conv(bottleneck_channels, out_channels, 1, dtype=dtype)
        self.bn3 = FrozenBatchNorm(out_channels)

    def forward(self, x):
        identity = x
        if self.has_downsample:
            identity = self.downsample_bn(self.downsample_conv(x))
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


class Stem(nn.Module):
    """7x7/2 conv + frozen BN + relu + 3x3/2 max-pool (pad 1)."""

    def __init__(self, out_channels=64, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2d(3, out_channels, 7, stride=2, padding=3, bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm(out_channels)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return F.max_pool2d(x, 3, stride=2, padding=1)


class ResNetStage(nn.Sequential):
    def __init__(self, block_count, in_channels, bottleneck_channels,
                 out_channels, first_stride, dilation=1, stride_in_1x1=True,
                 num_groups=1, dtype=torch.float32):
        super().__init__()
        stride = first_stride
        for i in range(block_count):
            self.add_module(
                f"block{i}",
                Bottleneck(in_channels, bottleneck_channels, out_channels,
                           stride, dilation, stride_in_1x1, num_groups, dtype),
            )
            in_channels = out_channels
            stride = 1


class ResNet(nn.Module):
    """Stem and stages 2..N (N <= 4); ``stages`` counts blocks per
    stage.  Takes and returns NCHW channels-last tensors; returns the
    last stage."""

    def __init__(self, stages: Sequence[int], stem_out_channels=64,
                 res2_out_channels=256, num_groups=1, width_per_group=64,
                 stride_in_1x1=True, dtype=torch.float32):
        super().__init__()
        self.stem = Stem(stem_out_channels, dtype)
        in_ch = stem_out_channels
        stage2_bottleneck = num_groups * width_per_group
        self.num_stages = len(stages)
        for idx, block_count in enumerate(stages):
            stage_num = idx + 2
            factor = 2 ** idx
            out_ch = res2_out_channels * factor
            first_stride = 1 if stage_num == 2 else 2
            self.add_module(
                f"layer{stage_num - 1}",
                ResNetStage(block_count, in_ch, stage2_bottleneck * factor,
                            out_ch, first_stride, 1, stride_in_1x1,
                            num_groups, dtype),
            )
            in_ch = out_ch

    def forward(self, x):
        x = self.stem(x)
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        return x


class ResNetRoIHead(nn.Module):
    """The C5 stage on pooled RoI features, ``[R, P, Q, C]`` NHWC in,
    ``[R, P', Q', 2048]`` out.  ``prestrided``: the pooler already
    emitted only the even bins, so the first 1x1 convs run stride 1."""

    def __init__(self, block_count=3, in_channels=1024, out_channels=2048,
                 num_groups=1, width_per_group=64, stride_in_1x1=True,
                 dilation=1, prestrided=False, dtype=torch.float32):
        super().__init__()
        first_stride = 2 if dilation == 1 else 1
        if prestrided:
            first_stride = 1
        self.layer4 = ResNetStage(
            block_count, in_channels, num_groups * width_per_group * 8,
            out_channels, first_stride, dilation, stride_in_1x1, 1, dtype,
        )

    def forward(self, x):
        y = self.layer4(x.permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1)
