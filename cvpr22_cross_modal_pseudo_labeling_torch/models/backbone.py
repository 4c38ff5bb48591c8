"""Image normalization on the device and the C4 ResNet backbone.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/
backbone.py`` (``device_normalize`` :19, ``ResNetBackbone`` :59), the C4
body only (C5 and FPN come with later slices).
"""

from typing import List, Tuple

import torch
from torch import nn

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
    """The C4 backbone (stem and stages 2-4); returns a one-element list
    of ``[B, h, w, C]`` features."""

    def __init__(self, depth="R-50", stem_out_channels=64,
                 res2_out_channels=256, num_groups=1, width_per_group=64,
                 stride_in_1x1=True, dtype=torch.float32):
        super().__init__()
        self.body = ResNet(
            RESNET_STAGES[depth][:3],
            stem_out_channels=stem_out_channels,
            res2_out_channels=res2_out_channels,
            num_groups=num_groups,
            width_per_group=width_per_group,
            stride_in_1x1=stride_in_1x1,
            dtype=dtype,
        )

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        # NHWC storage viewed as NCHW is channels_last, which the convs keep
        y = self.body(x.permute(0, 3, 1, 2))
        return [y.permute(0, 2, 3, 1)]
