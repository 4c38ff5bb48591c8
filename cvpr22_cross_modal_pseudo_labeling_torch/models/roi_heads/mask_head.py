"""Mask predictor and test-time mask probabilities.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/
roi_heads/mask_head.py`` (``MaskPredictor`` :27, ``mask_head_inference``
:177).  The uncertainty branch's parameters (``uncertain_pred``) are
held so that a student checkpoint loads; eval does not read them, and
the reparameterized sampling and the losses belong to the training
slice.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d, ConvTranspose2d


class MaskPredictor(nn.Module):
    """MaskRCNNC4Predictor: 2x2/2 transposed conv -> relu -> 1x1 logits
    (2 channels when class-agnostic); NHWC ``[N, H, W, C_in]`` in,
    ``[N, 2H, 2W, num_classes]`` logits out."""

    def __init__(self, in_channels=2048, num_classes=2, dim_reduced=256,
                 uncertainty=False, dtype=torch.float32):
        super().__init__()
        self.conv5_mask = ConvTranspose2d(in_channels, dim_reduced, 2, stride=2, dtype=dtype)
        self.mask_fcn_logits = Conv2d(dim_reduced, num_classes, 1, dtype=dtype)
        if uncertainty:
            self.uncertain_pred = Conv2d(dim_reduced, 1, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = F.relu(self.conv5_mask(x.permute(0, 3, 1, 2)))
        return self.mask_fcn_logits(up).permute(0, 2, 3, 1)


def mask_head_inference(mask_logits: torch.Tensor) -> torch.Tensor:
    """Class-agnostic ``[N, M, M, 2]`` logits -> ``[N, M, M]``
    foreground probabilities (channel 1)."""
    return torch.sigmoid(mask_logits[..., 1])
