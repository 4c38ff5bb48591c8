"""ResNet body and C5 RoI head with frozen BatchNorm.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/resnet.py``
(``FrozenBatchNorm`` :31, ``Bottleneck`` :65, ``Stem`` :213,
``ResNetStage`` :266, ``ResNet`` :307, ``ResNetRoIHead`` :379).  Module
names follow the flax scopes (``stem``, ``layer1``, ``block0``,
``downsample_conv``...) so that ``bridge.py`` maps parameters by path.

Two trunk options, which only ``models/backbone.py::build_backbone``
passes (the detectors ignore them, as JAX's do): ``norm="gn"``
(``TRANS_FUNC BottleneckWithGN``) puts GroupNorm (32 groups, eps 1e-5,
float32 statistics and result, as flax's) in place of every frozen BN of
the stem and the blocks; a block ``with_dcn`` (``STAGE_WITH_DCN``) runs
its 3x3 conv as ``ops/deform_conv.py::deform_conv2d`` in float32, on
offsets (and, ``with_modulated_dcn``, sigmoid masks) from the
zero-initialized ``conv2_offset`` conv, dilated like the main conv; its
kernel ``conv2_kernel`` keeps flax's ``[3, 3, in / groups, out]`` layout.

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

from ..ops.deform_conv import deform_conv2d
from .layers import Conv2d, GroupNorm

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


def _norm(norm: str, features: int) -> nn.Module:
    return GroupNorm(features, eps=1e-5) if norm == "gn" else FrozenBatchNorm(features)


def _conv(cin, cout, kernel, stride=1, dilation=1, dtype=torch.float32, groups=1):
    pad = dilation * (kernel - 1) // 2
    return Conv2d(
        cin, cout, kernel, stride=stride, padding=pad, dilation=dilation,
        groups=groups, bias=False, dtype=dtype,
    )


class Bottleneck(nn.Module):
    """``in_channels`` decides whether the block has a downsample branch
    (it differs from ``out_channels``, or the block strides), as the
    flax module's attribute does; ``input_channels`` is the width of the
    input the convs read (default ``in_channels``), which flax infers
    from the input.  The two differ only for the C5 body's RoI head.
    ``norm``, ``with_dcn`` and ``with_modulated_dcn``: see the module
    docstring."""

    def __init__(self, in_channels, bottleneck_channels, out_channels,
                 stride=1, dilation=1, stride_in_1x1=True, num_groups=1,
                 dtype=torch.float32, input_channels=None, with_dcn=False,
                 with_modulated_dcn=False, norm="frozen_bn"):
        super().__init__()
        s1, s3 = (stride, 1) if stride_in_1x1 else (1, stride)
        cin = in_channels if input_channels is None else input_channels
        self.has_downsample = in_channels != out_channels or stride != 1
        if self.has_downsample:
            down_stride = stride if dilation == 1 else 1
            self.downsample_conv = _conv(cin, out_channels, 1, down_stride, dtype=dtype)
            self.downsample_bn = _norm(norm, out_channels)
        self.conv1 = _conv(cin, bottleneck_channels, 1, s1, dtype=dtype)
        self.bn1 = _norm(norm, bottleneck_channels)
        self.with_dcn, self.with_modulated_dcn = with_dcn, with_modulated_dcn
        if with_dcn:
            self.dcn_args = dict(stride=s3, padding=dilation, dilation=dilation, groups=num_groups)
            self.compute_dtype = dtype
            self.conv2_offset = Conv2d(
                bottleneck_channels, 27 if with_modulated_dcn else 18, 3, stride=s3, padding=dilation,
                dilation=dilation, dtype=dtype,
            )
            nn.init.zeros_(self.conv2_offset.weight)
            nn.init.zeros_(self.conv2_offset.bias)
            self.conv2_kernel = nn.Parameter(
                torch.zeros(3, 3, bottleneck_channels // num_groups, bottleneck_channels))
        else:
            self.conv2 = _conv(bottleneck_channels, bottleneck_channels, 3, s3,
                               dilation, dtype, groups=num_groups)
        self.bn2 = _norm(norm, bottleneck_channels)
        self.conv3 = _conv(bottleneck_channels, out_channels, 1, dtype=dtype)
        self.bn3 = _norm(norm, out_channels)

    def _deform_conv2(self, x):
        """The 3x3 conv as a deformable one: NCHW (channels-last) in and
        out, the sampling and the matmul in float32."""
        off = self.conv2_offset(x).permute(0, 2, 3, 1)
        offsets, mask = off, None
        if self.with_modulated_dcn:
            offsets, mask = off[..., :18], torch.sigmoid(off[..., 18:]).to(torch.float32)
        out = deform_conv2d(
            x.permute(0, 2, 3, 1).to(torch.float32), offsets.to(torch.float32),
            self.conv2_kernel.to(torch.float32), mask=mask, **self.dcn_args,
        )
        return out.to(self.compute_dtype).permute(0, 3, 1, 2)

    def forward(self, x):
        identity = x
        if self.has_downsample:
            identity = self.downsample_bn(self.downsample_conv(x))
        out = F.relu(self.bn1(self.conv1(x)))
        out = self._deform_conv2(out) if self.with_dcn else self.conv2(out)
        out = F.relu(self.bn2(out))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


class Stem(nn.Module):
    """7x7/2 conv + frozen BN (or GroupNorm) + relu + 3x3/2 max-pool (pad 1)."""

    def __init__(self, out_channels=64, dtype=torch.float32, norm="frozen_bn"):
        super().__init__()
        self.conv1 = Conv2d(3, out_channels, 7, stride=2, padding=3, bias=False, dtype=dtype)
        self.bn1 = _norm(norm, out_channels)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return F.max_pool2d(x, 3, stride=2, padding=1)


class ResNetStage(nn.Sequential):
    """``input_channels``: the width block 0 reads, when it is not
    ``in_channels`` (see :class:`Bottleneck`)."""

    def __init__(self, block_count, in_channels, bottleneck_channels,
                 out_channels, first_stride, dilation=1, stride_in_1x1=True,
                 num_groups=1, dtype=torch.float32, input_channels=None,
                 with_dcn=False, with_modulated_dcn=False, norm="frozen_bn"):
        super().__init__()
        stride = first_stride
        for i in range(block_count):
            self.add_module(
                f"block{i}",
                Bottleneck(in_channels, bottleneck_channels, out_channels,
                           stride, dilation, stride_in_1x1, num_groups, dtype,
                           input_channels if i == 0 else None, with_dcn,
                           with_modulated_dcn, norm),
            )
            in_channels = out_channels
            stride = 1


class ResNet(nn.Module):
    """Stem and stages 2..N (N <= 5); ``stages`` counts blocks per
    stage.  Takes NCHW channels-last tensors and returns the list of the
    stages named in ``return_stages`` (``"C2"`` .. ``"C5"``, in that
    order; default the last stage alone), as JAX's ``return_stages``.
    Stage 5 runs at ``res5_dilation`` (stride 1 when dilated).
    ``stage_with_dcn`` (one flag a stage), ``with_modulated_dcn`` and
    ``norm``: see the module docstring."""

    def __init__(self, stages: Sequence[int], stem_out_channels=64,
                 res2_out_channels=256, num_groups=1, width_per_group=64,
                 stride_in_1x1=True, res5_dilation=1, dtype=torch.float32,
                 return_stages: Sequence[str] = (), stage_with_dcn: Sequence[bool] = (),
                 with_modulated_dcn=False, norm="frozen_bn"):
        super().__init__()
        self.return_stages = tuple(return_stages) or (f"C{len(stages) + 1}",)
        self.stem = Stem(stem_out_channels, dtype, norm)
        in_ch = stem_out_channels
        stage2_bottleneck = num_groups * width_per_group
        self.num_stages = len(stages)
        for idx, block_count in enumerate(stages):
            stage_num = idx + 2
            factor = 2 ** idx
            out_ch = res2_out_channels * factor
            dilation = res5_dilation if stage_num == 5 else 1
            first_stride = 1 if stage_num == 2 or dilation > 1 else 2
            self.add_module(
                f"layer{stage_num - 1}",
                ResNetStage(block_count, in_ch, stage2_bottleneck * factor,
                            out_ch, first_stride, dilation, stride_in_1x1,
                            num_groups, dtype,
                            with_dcn=idx < len(stage_with_dcn) and bool(stage_with_dcn[idx]),
                            with_modulated_dcn=with_modulated_dcn, norm=norm),
            )
            in_ch = out_ch

    def forward(self, x):
        x = self.stem(x)
        out = {}
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
            out[f"C{i + 2}"] = x
        return [out[k] for k in self.return_stages]


class ResNetRoIHead(nn.Module):
    """The C5 stage on pooled RoI features, ``[R, P, Q, C]`` NHWC in,
    ``[R, P', Q', 2048]`` out.  ``prestrided``: the pooler already
    emitted only the even bins, so the first 1x1 convs run stride 1.
    ``feature_channels``: the width of the pooled features when it is
    not ``in_channels`` (the C5 body's trunk puts out ``8 x res2``
    channels while its statics' ``in_channels`` is
    ``BACKBONE_OUT_CHANNELS``; ``in_channels`` still decides block 0's
    downsample branch, as in the JAX module)."""

    def __init__(self, block_count=3, in_channels=1024, out_channels=2048,
                 num_groups=1, width_per_group=64, stride_in_1x1=True,
                 dilation=1, prestrided=False, dtype=torch.float32, feature_channels=None):
        super().__init__()
        first_stride = 2 if dilation == 1 else 1
        if prestrided:
            first_stride = 1
        self.out_channels = out_channels
        self.layer4 = ResNetStage(
            block_count, in_channels, num_groups * width_per_group * 8,
            out_channels, first_stride, dilation, stride_in_1x1, 1, dtype,
            input_channels=feature_channels,
        )

    def forward(self, x):
        y = self.layer4(x.permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1)
