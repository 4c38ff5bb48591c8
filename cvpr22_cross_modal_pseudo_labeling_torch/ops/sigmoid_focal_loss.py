"""Sigmoid focal loss, the RetinaNet classification loss.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/ops/
sigmoid_focal_loss.py::sigmoid_focal_loss`` (:19), which has no Pallas
kernel: per anchor n and class c in 1..C (0 is the background),

  loss[n, c] = -alpha       * 1[t_n == c]             * (1-p)^g log(p)
               -(1 - alpha) * 1[t_n != c and t_n >= 0] * p^g     log(1-p)

with the log-sigmoid forms of log(p) and log(1-p).  Plain PyTorch;
autograd gives the gradient.  Callers pass float32 logits, as the JAX
RetinaNet does.
"""

import torch
import torch.nn.functional as F


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, gamma: float, alpha: float) -> torch.Tensor:
    """logits ``[..., N, C]``; targets ``[..., N]`` int: class ids in
    1..C, 0 the background, negative ignored.  Returns the ``[..., N,
    C]`` per-element losses."""
    num_classes = logits.shape[-1]
    class_range = torch.arange(1, num_classes + 1, device=logits.device)
    t = targets[..., None]
    p = torch.sigmoid(logits)
    term1 = (1.0 - p) ** gamma * F.logsigmoid(logits)
    term2 = p**gamma * F.logsigmoid(-logits)
    pos = (t == class_range).to(logits.dtype)
    neg = ((t != class_range) & (t >= 0)).to(logits.dtype)
    return -pos * term1 * alpha - neg * term2 * (1.0 - alpha)
