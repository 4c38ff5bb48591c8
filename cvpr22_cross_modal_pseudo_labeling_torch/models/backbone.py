"""Image normalization on the device and the backbones.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/
backbone.py`` (``device_normalize`` :19, ``ResNetBackbone`` :59,
``ResNetFPNBackbone`` :101, ``build_backbone`` :159): the C4, C5 and FPN
bodies, which the detectors build from their statics, and
:func:`build_backbone`, which builds a body from the config with the
trunk options the detectors ignore, as JAX's do: GroupNorm
(``TRANS_FUNC`` with ``GN``), deformable convs (``STAGE_WITH_DCN``,
``WITH_MODULATED_DCN``), the FPN's ``USE_GN`` and ``USE_RELU``, and the
FBNet trunk (``CONV_BODY FBNet``, ``models/fbnet.py``).
``FREEZE_CONV_BODY_AT`` reaches its ``frozen_prefixes`` (the optimizer
freezes by name) and ``TPU.S2D_STEM`` nothing: the port's stem is the
plain 7x7 conv, the same function.
"""

from typing import List, Sequence, Tuple

import torch
from torch import nn

from .fpn import FPN
from .resnet import RESNET_STAGES, ResNet


def device_normalize(
    images: torch.Tensor,
    image_sizes: torch.Tensor,
    pixel_mean: Tuple[float, ...] = (102.9801, 115.9465, 122.7717),
    pixel_std: Tuple[float, ...] = (1.0, 1.0, 1.0),
    to_bgr255: bool = True,
) -> torch.Tensor:
    """Normalizes a uint8 ``[B, H, W, 3]`` batch as the host path would:
    BGR flip (or /255), ``(x - mean) / std`` in float32, and the padding
    outside each image's ``(h, w)`` re-zeroed.  Float input is returned
    unchanged (already normalized)."""
    if images.is_floating_point():
        return images
    x = images.to(torch.float32)
    if to_bgr255:
        x = x.flip(-1)
    else:
        # a tensor divisor: CUDA divides by a Python scalar as a
        # multiplication by its reciprocal, an ulp away from JAX
        x = x / torch.full((), 255.0, device=x.device)
    mean = torch.tensor(pixel_mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(pixel_std, dtype=torch.float32, device=x.device)
    x = (x - mean) / std
    h = torch.arange(images.shape[1], device=x.device)[None, :, None, None]
    w = torch.arange(images.shape[2], device=x.device)[None, None, :, None]
    sizes = image_sizes.to(x.device)
    valid = (h < sizes[:, 0, None, None, None]) & (w < sizes[:, 1, None, None, None])
    return torch.where(valid, x, torch.zeros((), dtype=x.dtype, device=x.device))


class ResNetBackbone(nn.Module):
    """The C4 (``num_stages`` 3: stem and stages 2-4) or C5 (4) backbone;
    returns a one-element list of ``[B, h, w, C]`` features.
    ``stage_with_dcn``, ``with_modulated_dcn`` and ``norm`` go to
    :class:`ResNet`."""

    def __init__(self, depth="R-50", num_stages=3, stem_out_channels=64,
                 res2_out_channels=256, num_groups=1, width_per_group=64,
                 stride_in_1x1=True, res5_dilation=1, dtype=torch.float32,
                 stage_with_dcn: Sequence[bool] = (), with_modulated_dcn=False, norm="frozen_bn"):
        super().__init__()
        if num_stages not in (3, 4):
            raise ValueError(f"num_stages {num_stages}: 3 (C4) or 4 (C5)")
        self.out_channels = res2_out_channels * 2 ** (num_stages - 1)
        self.body = ResNet(
            RESNET_STAGES[depth][:num_stages],
            stem_out_channels=stem_out_channels,
            res2_out_channels=res2_out_channels,
            num_groups=num_groups,
            width_per_group=width_per_group,
            stride_in_1x1=stride_in_1x1,
            res5_dilation=res5_dilation,
            dtype=dtype,
            stage_with_dcn=stage_with_dcn,
            with_modulated_dcn=with_modulated_dcn,
            norm=norm,
        )

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        # NHWC storage viewed as NCHW is channels_last, which the convs keep
        (y,) = self.body(x.permute(0, 3, 1, 2))
        return [y.permute(0, 2, 3, 1)]


class ResNetFPNBackbone(nn.Module):
    """The whole trunk (C2..C5) under an :class:`FPN` neck: returns the
    levels P2..P6 (``retinanet``: P3..P7, with C2 left out and the
    ``p6p7`` top block on C5, or on P5 without ``retinanet_use_c5``), each
    ``[B, h, w, out_channels]``.  ``use_gn`` and ``use_relu`` go to the
    :class:`FPN`, ``stage_with_dcn``, ``with_modulated_dcn`` and ``norm``
    to the :class:`ResNet`."""

    def __init__(self, depth="R-50", out_channels=256, retinanet=False,
                 retinanet_use_c5=True, stem_out_channels=64, res2_out_channels=256,
                 num_groups=1, width_per_group=64, stride_in_1x1=True, dtype=torch.float32,
                 use_gn=False, use_relu=False, stage_with_dcn: Sequence[bool] = (),
                 with_modulated_dcn=False, norm="frozen_bn"):
        super().__init__()
        self.out_channels = out_channels
        self.body = ResNet(
            RESNET_STAGES[depth],
            stem_out_channels=stem_out_channels,
            res2_out_channels=res2_out_channels,
            num_groups=num_groups,
            width_per_group=width_per_group,
            stride_in_1x1=stride_in_1x1,
            dtype=dtype,
            return_stages=("C3", "C4", "C5") if retinanet else ("C2", "C3", "C4", "C5"),
            stage_with_dcn=stage_with_dcn,
            with_modulated_dcn=with_modulated_dcn,
            norm=norm,
        )
        c = res2_out_channels
        in_list = [c * 2, c * 4, c * 8] if retinanet else [c, c * 2, c * 4, c * 8]
        self.fpn = FPN(
            in_list, out_channels, top_block="p6p7" if retinanet else "maxpool",
            p6p7_on_c5=retinanet_use_c5, dtype=dtype, use_gn=use_gn, use_relu=use_relu,
        )

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = self.body(x.permute(0, 3, 1, 2))
        return self.fpn([f.permute(0, 2, 3, 1) for f in feats])


def build_backbone(cfg, dtype: torch.dtype = torch.float32) -> Tuple[nn.Module, dict]:
    """The body ``MODEL.BACKBONE.CONV_BODY`` names (``R-*-C4``, ``-C5``,
    ``-FPN``, ``-FPN-RETINANET`` or ``FBNet``) with the config's trunk
    options, and its ``meta``: ``out_channels``, ``strides`` and the
    ``frozen_prefixes`` of ``FREEZE_CONV_BODY_AT`` (flax paths, as JAX
    gives them)."""
    body = cfg.MODEL.BACKBONE.CONV_BODY
    r = cfg.MODEL.RESNETS
    common = dict(
        stem_out_channels=r.STEM_OUT_CHANNELS,
        res2_out_channels=r.RES2_OUT_CHANNELS,
        num_groups=r.NUM_GROUPS,
        width_per_group=r.WIDTH_PER_GROUP,
        stride_in_1x1=r.STRIDE_IN_1X1,
        stage_with_dcn=tuple(r.STAGE_WITH_DCN),
        with_modulated_dcn=r.WITH_MODULATED_DCN,
        norm="gn" if "GN" in r.TRANS_FUNC else "frozen_bn",
        dtype=dtype,
    )
    fpn = dict(out_channels=r.BACKBONE_OUT_CHANNELS, use_gn=cfg.MODEL.FPN.USE_GN, use_relu=cfg.MODEL.FPN.USE_RELU)
    if body.endswith("-C4"):
        mod = ResNetBackbone(depth=body[: -len("-C4")], num_stages=3, **common)
        meta = dict(out_channels=r.RES2_OUT_CHANNELS * 4, strides=(16,))
    elif body.endswith("-C5"):
        mod = ResNetBackbone(depth=body[: -len("-C5")], num_stages=4, res5_dilation=r.RES5_DILATION, **common)
        meta = dict(out_channels=r.RES2_OUT_CHANNELS * 8, strides=(32,))
    elif body.endswith("-FPN-RETINANET"):
        mod = ResNetFPNBackbone(depth=body[: -len("-FPN-RETINANET")], retinanet=True,
                                retinanet_use_c5=cfg.MODEL.RETINANET.USE_C5, **fpn, **common)
        meta = dict(out_channels=r.BACKBONE_OUT_CHANNELS, strides=(8, 16, 32, 64, 128))
    elif body.endswith("-FPN"):
        mod = ResNetFPNBackbone(depth=body[: -len("-FPN")], **fpn, **common)
        meta = dict(out_channels=r.BACKBONE_OUT_CHANNELS, strides=(4, 8, 16, 32, 64))
    elif body == "FBNet":
        from .fbnet import FBNetTrunk

        f = cfg.MODEL.FBNET
        mod = FBNetTrunk(arch=f.ARCH, scale_factor=f.SCALE_FACTOR, width_divisor=f.WIDTH_DIVISOR, dtype=dtype)
        meta = dict(out_channels=mod.out_channels, strides=(16,))
    else:
        raise ValueError(f"Unknown CONV_BODY {body}")
    freeze_at = cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT
    meta["frozen_prefixes"] = (("body/stem",) + tuple(f"body/layer{i}" for i in range(1, freeze_at))
                               if freeze_at > 0 else ())
    return mod, meta
