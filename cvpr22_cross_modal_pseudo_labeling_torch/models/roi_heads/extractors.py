"""The FPN family's RoI feature extractors and predictors, and the mask
predictor variants.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/
roi_heads/extractors.py`` (reference roi_box_feature_extractors.py:49-144,
roi_box_predictors.py FPNPredictor, roi_mask_predictors.py).  Only tests
reach them in either package.  NHWC in and out, as the JAX modules; each
submodule carries its flax scope's name (``fc6``, ``fc7``,
``xconvs{i}``, ``xconvs{i}_gn``, ``cls_score``, ``bbox_pred``,
``conv5_mask``, ``mask_fcn_logits``), so ``bridge.py`` carries a flax
tree across as it does for every other module, and the layers compute
in ``dtype`` as flax's ``dtype`` does.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d, ConvTranspose2d, GroupNorm, Linear


class FPN2MLPFeatureExtractor(nn.Module):
    """Pooled ``[N, P, P, C]`` -> flatten -> two FC with ReLU -> ``[N, D]``
    (roi_box_feature_extractors.py:49-81)."""

    def __init__(self, in_features: int, mlp_head_dim: int = 1024, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc6 = Linear(in_features, mlp_head_dim, dtype=dtype)
        self.fc7 = Linear(mlp_head_dim, mlp_head_dim, dtype=dtype)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        x = pooled.reshape(pooled.shape[0], -1)
        return F.relu(self.fc7(F.relu(self.fc6(x))))


class FPNXconv1fcFeatureExtractor(nn.Module):
    """``num_stacked_convs`` 3x3 convs (GroupNorm with ``use_gn``, no bias
    then), ReLU each, then one FC with ReLU
    (roi_box_feature_extractors.py:84-144).  ``resolution`` is the pooled
    side P."""

    def __init__(self, in_channels: int, resolution: int, conv_head_dim: int = 256, num_stacked_convs: int = 4,
                 mlp_head_dim: int = 1024, dilation: int = 1, use_gn: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_stacked_convs = num_stacked_convs
        self.use_gn = use_gn
        for i in range(num_stacked_convs):
            setattr(self, f"xconvs{i}", Conv2d(
                in_channels if i == 0 else conv_head_dim, conv_head_dim, 3, padding=dilation,
                dilation=dilation, bias=not use_gn, dtype=dtype,
            ))
            if use_gn:
                setattr(self, f"xconvs{i}_gn", GroupNorm(conv_head_dim))
        self.fc6 = Linear(resolution * resolution * conv_head_dim, mlp_head_dim, dtype=dtype)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        x = pooled.permute(0, 3, 1, 2)
        for i in range(self.num_stacked_convs):
            x = getattr(self, f"xconvs{i}")(x)
            if self.use_gn:
                x = getattr(self, f"xconvs{i}_gn")(x)
            x = F.relu(x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return F.relu(self.fc6(x))


class FPNPredictor(nn.Module):
    """Linear class logits and box deltas over the MLP features (two
    classes' deltas when class-agnostic); kernels from normal(0.01) and
    normal(0.001), biases 0."""

    def __init__(self, in_features: int, num_classes: int, cls_agnostic_bbox_reg: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cls_score = Linear(in_features, num_classes, dtype=dtype)
        self.bbox_pred = Linear(in_features, (2 if cls_agnostic_bbox_reg else num_classes) * 4, dtype=dtype)
        for layer, std in ((self.cls_score, 0.01), (self.bbox_pred, 0.001)):
            nn.init.normal_(layer.weight, std=std)
            nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.cls_score(x), self.bbox_pred(x)


class MaskRCNNConv1x1Predictor(nn.Module):
    """1x1 conv mask logits, no upsampling: ``[N, M, M, C]`` ->
    ``[N, M, M, num_classes]``."""

    def __init__(self, in_channels: int, num_classes: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mask_fcn_logits = Conv2d(in_channels, num_classes, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mask_fcn_logits(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class DropoutMaskPredictor(nn.Module):
    """MC-dropout uncertainty (roi_mask_predictors.py
    DropOut_MaskRCNNC4Predictor:100-139): dropout stays on at inference,
    and the predictive entropy over ``num_samples`` passes is the
    uncertainty map.  Returns ``(mean logits, entropy)``, each ``[N, 2M,
    2M, num_classes]``."""

    def __init__(self, in_channels: int, num_classes: int, dim_reduced: int = 256, drop_rate: float = 0.5,
                 num_samples: int = 5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.drop_rate = drop_rate
        self.num_samples = num_samples
        self.conv5_mask = ConvTranspose2d(in_channels, dim_reduced, 2, stride=2, dtype=dtype)
        self.mask_fcn_logits = Conv2d(dim_reduced, num_classes, 1, dtype=dtype)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``keep`` (bool ``[num_samples, N, 2M, 2M, dim_reduced]``) gives
        the dropout masks; otherwise each sample keeps a unit with
        probability ``1 - drop_rate``, drawn from ``generator``."""
        up = F.relu(self.conv5_mask(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        if keep is None:
            probs = torch.full((self.num_samples,) + tuple(up.shape), 1.0 - self.drop_rate, device=up.device)
            keep = torch.bernoulli(probs, generator=generator).to(torch.bool)
        samples = torch.stack([
            self.mask_fcn_logits((up * k / (1.0 - self.drop_rate)).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            for k in keep
        ])
        mean = torch.sigmoid(samples).mean(dim=0)
        eps = 1e-6
        entropy = -(mean * torch.log(mean + eps) + (1 - mean) * torch.log(1 - mean + eps))
        return samples.mean(dim=0), entropy


def pixel_score_uncertainty(mask_logits: torch.Tensor) -> torch.Tensor:
    """The PixelScore variant (roi_mask_predictors.py:141-175): how close
    the sigmoid probability is to 0.5."""
    p = torch.sigmoid(mask_logits)
    return 1.0 - 2.0 * torch.abs(p - 0.5)
