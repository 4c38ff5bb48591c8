"""Keypoint head (``MODEL.KEYPOINT_ON``).

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/models/
roi_heads/keypoint_head.py`` (``KeypointPredictor`` :20,
``keypoints_to_heatmap_targets`` :49, ``keypoint_loss`` :82,
``keypoint_inference`` :97): eight 3x3 conv + ReLU layers on the box
head's RoI features, a 4x4 stride-2 transposed conv to one heatmap a
keypoint and a 2x bilinear upscale; the loss is a softmax cross-entropy
over each visible keypoint's heatmap at its discretized location, and
inference takes each heatmap's argmax back to image coordinates.

Flax's ``nn.ConvTranspose`` (``transpose_kernel=False``) correlates the
stride-dilated input with its kernel unflipped, padded ``SAME``: for a
4x4 kernel at stride 2 that is 2 rows and columns on each side of the
dilated input.  Torch's transposed conv is the gradient of a conv: it
correlates with the kernel flipped, padded ``kernel - 1 - padding``, so
``padding=1`` pads the same 2 and ``bridge.py``'s ``conv_transpose``
layout flips the kernel.  The upscale is ``jax.image.resize``'s
half-pixel bilinear, which at 2x equals ``F.interpolate`` with
``align_corners=False``, borders included: an output sample a quarter
pixel outside the map takes the edge pixel in both (JAX renormalizes the
tent's in-range weights, torch clamps the coordinate).
"""

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import Conv2d, ConvTranspose2d


class KeypointPredictor(nn.Module):
    def __init__(self, in_channels: int, num_keypoints: int = 17, conv_layers: Sequence[int] = (512,) * 8,
                 dtype=torch.float32):
        super().__init__()
        self.num_convs = len(conv_layers)
        cin = in_channels
        for i, ch in enumerate(conv_layers):
            self.add_module(f"conv_fcn{i + 1}", Conv2d(cin, ch, 3, padding=1, dtype=dtype))
            cin = ch
        self.kps_score_lowres = ConvTranspose2d(cin, num_keypoints, 4, stride=2, padding=1, dtype=dtype)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        """``[N, H, W, C]`` RoI features -> ``[N, 4H, 4W, K]`` logits."""
        x = pooled.permute(0, 3, 1, 2)
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"conv_fcn{i + 1}")(x))
        x = self.kps_score_lowres(x)
        x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
        return x.permute(0, 2, 3, 1)


def keypoints_to_heatmap_targets(keypoints: torch.Tensor, rois: torch.Tensor,
                                 heatmap_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """keypoints ``[S, K, 3]`` (x, y, visibility); rois ``[S, 4]``.
    Returns ``(targets [S, K]`` flattened heatmap index, ``valid [S,
    K])``.  A point on the roi's right or bottom edge snaps to the last
    bin; a point outside the roi, or invisible, is not valid."""
    rois = rois.to(torch.float32)
    offset_x = rois[:, 0, None]
    offset_y = rois[:, 1, None]
    size = torch.full((), float(heatmap_size), device=rois.device)
    scale_x = size / (rois[:, 2] - rois[:, 0]).clamp(min=1e-6)
    scale_y = size / (rois[:, 3] - rois[:, 1]).clamp(min=1e-6)
    x_edge = keypoints[..., 0] == rois[:, 2, None]
    y_edge = keypoints[..., 1] == rois[:, 3, None]
    # int64: a point far outside a degenerate roi overflows int32, and
    # is out of range (not valid) either way
    x = torch.floor((keypoints[..., 0] - offset_x) * scale_x[:, None]).to(torch.int64)
    y = torch.floor((keypoints[..., 1] - offset_y) * scale_y[:, None]).to(torch.int64)
    last = torch.full((), heatmap_size - 1, dtype=torch.int64, device=x.device)
    x = torch.where(x_edge, last, x)
    y = torch.where(y_edge, last, y)
    in_range = (x >= 0) & (x < heatmap_size) & (y >= 0) & (y < heatmap_size)
    valid = in_range & (keypoints[..., 2] > 0)
    targets = (y * heatmap_size + x).clamp(0, heatmap_size * heatmap_size - 1)
    return targets, valid


def keypoint_loss(kp_logits: torch.Tensor, keypoints: torch.Tensor, rois: torch.Tensor,
                  roi_valid: torch.Tensor) -> torch.Tensor:
    """kp_logits ``[S, H, W, K]``: the cross-entropy over each heatmap's
    positions at its visible keypoints, averaged over them."""
    s, h, w, k = kp_logits.shape
    flat = kp_logits.permute(0, 3, 1, 2).reshape(s, k, h * w)
    targets, valid = keypoints_to_heatmap_targets(keypoints, rois, h)
    valid = valid & roi_valid[:, None]
    logp = torch.log_softmax(flat, dim=-1)
    nll = -torch.gather(logp, 2, targets[..., None])[..., 0]
    denom = valid.sum().clamp(min=1).to(nll.dtype)
    return torch.sum(nll * valid) / denom


def keypoint_inference(kp_logits: torch.Tensor, rois: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each heatmap's argmax (the first, on ties) in image coordinates,
    and its softmax probability: ``(xy [S, K, 2], scores [S, K])``."""
    s, h, w, k = kp_logits.shape
    flat = kp_logits.permute(0, 3, 1, 2).reshape(s, k, h * w)
    probs = torch.softmax(flat, dim=-1)
    idx = torch.argmax(flat, dim=-1)
    scores = torch.gather(probs, 2, idx[..., None])[..., 0]
    yy = torch.div(idx, w, rounding_mode="floor").to(torch.float32) + 0.5
    xx = (idx % w).to(torch.float32) + 0.5
    rois = rois.to(torch.float32)
    roi_w = (rois[:, 2] - rois[:, 0]).clamp(min=1e-6)[:, None]
    roi_h = (rois[:, 3] - rois[:, 1]).clamp(min=1e-6)[:, None]
    # tensor divisors: CUDA divides by a Python scalar as a multiplication
    # by its reciprocal, an ulp away from JAX
    x = rois[:, 0, None] + xx / torch.full((), float(w), device=xx.device) * roi_w
    y = rois[:, 1, None] + yy / torch.full((), float(h), device=yy.device) * roi_h
    return torch.stack([x, y], dim=-1), scores
