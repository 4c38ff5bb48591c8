"""Loss primitives.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/ops/losses.py``
(:13-37): the beta-scaled smooth-L1, per-example softmax cross-entropy
and binary cross-entropy with logits, all elementwise.
"""

import torch
import torch.nn.functional as F


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0 / 9) -> torch.Tensor:
    n = torch.abs(pred - target)
    # a tensor divisor: CUDA divides by a Python scalar as a
    # multiplication by its reciprocal (torch.full fills on the device;
    # a tensor made from Python data would copy and sync)
    divisor = torch.full((), beta, dtype=n.dtype, device=n.device)
    return torch.where(n < beta, 0.5 * n**2 / divisor, n - 0.5 * beta)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example CE of int ``labels`` clipped into range (callers mask
    invalid rows)."""
    labels = labels.clamp(0, logits.shape[-1] - 1).to(torch.int64)
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None])[..., 0]


def binary_cross_entropy_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return -(targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits))
