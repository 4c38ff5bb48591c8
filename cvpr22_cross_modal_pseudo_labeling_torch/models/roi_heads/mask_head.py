"""Mask predictor with the uncertainty branch, mask loss and test-time
mask probabilities.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/
roi_heads/mask_head.py`` (``MaskPredictor`` :27, ``mask_head_loss`` :103,
``mask_head_inference`` :177) for class-agnostic masks.  In training the
uncertainty branch predicts a per-pixel sigma from the detached
upsampled features and perturbs the logits with ``num_samples``
reparameterized draws; the loss collapses the sample axis with the
configured estimator.
"""

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.losses import binary_cross_entropy_with_logits
from ...ops.masks import project_masks_on_boxes
from ..layers import Conv2d, ConvTranspose2d
from .box_head import SampledRoIs

# exp(0.5 * 2 log(sigma_max)) is the cap; below exp(-15) its log-variance
# bound falls under the clip's lower end (-30) and the clip inverts
SIGMA_MAX_FLOOR = math.exp(-15.0)


class MaskPredictor(nn.Module):
    """MaskRCNNC4Predictor: 2x2/2 transposed conv -> relu -> 1x1 logits
    (2 channels when class-agnostic); NHWC ``[N, H, W, C_in]`` in,
    ``[N, 2H, 2W, num_classes]`` logits out.  With ``uncertainty`` it
    holds ``uncertain_pred``, a 1x1 conv to the log-variance, whose
    weights start from normal(0.001) and its bias from 1, as in the JAX
    module."""

    def __init__(self, in_channels=2048, num_classes=2, dim_reduced=256,
                 uncertainty=False, sigma_max=0.0, dtype=torch.float32):
        super().__init__()
        if 0.0 < sigma_max < SIGMA_MAX_FLOOR:
            raise ValueError(
                f"UNCERTAINTY_SIGMA_MAX {sigma_max} is under exp(-15): its "
                "log-variance cap 2*log(sigma_max) would fall below the clip's "
                "lower end of -30; use 0 (no cap) or a larger value"
            )
        # the log-variance clip keeps exp finite under divergence; the cap
        # is the float32 log, as in the JAX module
        self.log_var_max = (
            2.0 * float(torch.log(torch.tensor(sigma_max, dtype=torch.float32)))
            if sigma_max > 0 else 30.0
        )
        self.conv5_mask = ConvTranspose2d(in_channels, dim_reduced, 2, stride=2, dtype=dtype)
        self.mask_fcn_logits = Conv2d(dim_reduced, num_classes, 1, dtype=dtype)
        if uncertainty:
            self.uncertain_pred = Conv2d(dim_reduced, 1, 1, dtype=dtype)
            nn.init.normal_(self.uncertain_pred.weight, std=0.001)
            nn.init.ones_(self.uncertain_pred.bias)

    def forward(
        self,
        x: torch.Tensor,
        compute_uncertain: bool = False,
        train: bool = False,
        num_samples: int = 1,
        eps: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Returns ``(logits, scale)``: logits ``[N, M, M, C]``, or ``[n_s,
        N, M, M, C]`` when sampling in training; ``scale [N, M, M, 1]``
        (sigma) or None.  ``eps`` ``[n_s, N, M, M, C]`` in the logits'
        dtype replaces the normal draws from ``generator``."""
        up = F.relu(self.conv5_mask(x.permute(0, 3, 1, 2)))
        logits = self.mask_fcn_logits(up).permute(0, 2, 3, 1)
        if not (hasattr(self, "uncertain_pred") and compute_uncertain):
            return logits, None
        scale_logit = self.uncertain_pred(up.detach()).permute(0, 2, 3, 1)
        scale = torch.exp(0.5 * scale_logit.clamp(min=-30.0, max=self.log_var_max))
        if train:
            if eps is None:
                eps = torch.randn(
                    (num_samples,) + tuple(logits.shape), generator=generator,
                    device=logits.device, dtype=logits.dtype,
                )
            logits = logits[None] + eps * scale[None]
        return logits, scale


def mask_head_loss(
    mask_logits: torch.Tensor,
    sampled: SampledRoIs,
    gt_masks: torch.Tensor,
    gt_boxes: torch.Tensor,
    estimator: str = "sampled_bce",
) -> torch.Tensor:
    """Mean BCE over the mask pixels of positive rois (class-agnostic:
    channel 1).

    mask_logits ``[B*S, M, M, C]`` or ``[n_s, B*S, M, M, C]``; gt_masks
    ``[B, G, Mr, Mr]`` rasterized over gt_boxes ``[B, G, 4]``.  The sample
    axis collapses per ``estimator``: ``"sampled_bce"`` averages the
    per-sample BCE; ``"logmeanexp"`` takes ``-log(mean_t exp(-bce_t))``
    per pixel (the same for one sample)."""
    if estimator not in ("sampled_bce", "logmeanexp"):
        raise ValueError(f"unknown mask uncertainty estimator {estimator!r}")
    if mask_logits.dim() == 4:
        mask_logits = mask_logits[None]
    n_s, n, m = mask_logits.shape[:3]
    targets = project_masks_on_boxes(
        gt_masks, gt_boxes, sampled.boxes, sampled.matched_gt, m
    ).reshape(n, m, m)
    targets = (targets >= 0.5).to(mask_logits.dtype)

    pos = (sampled.is_pos & sampled.valid).reshape(-1)
    per_pix = binary_cross_entropy_with_logits(mask_logits[..., 1], targets[None])
    if estimator == "logmeanexp" and n_s > 1:
        per_pix = -(torch.logsumexp(-per_pix, dim=0, keepdim=True) - math.log(n_s))
        n_s = 1
    w = pos.to(per_pix.dtype)[None, :, None, None]
    denom = (pos.to(per_pix.dtype).sum() * (n_s * m * m)).clamp(min=1.0)
    return torch.sum(per_pix * w) / denom


def mask_head_inference(mask_logits: torch.Tensor) -> torch.Tensor:
    """Class-agnostic ``[N, M, M, 2]`` logits -> ``[N, M, M]``
    foreground probabilities (channel 1)."""
    return torch.sigmoid(mask_logits[..., 1])
