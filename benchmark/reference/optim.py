"""Plain momentum SGD with the detectors' parameter groups, for the
reference's training steps.

maskrcnn_benchmark's solver as the configuration states it: weight decay
added to the gradient before the momentum trace (no dampening), biases
at ``bias_lr_factor`` times the rate without decay, the mask
uncertainty head at ``uncertainty_lr_factor``, a linear warmup from
``warmup_factor``; frozen parameters (named by the configuration's
prefixes, matched on ``/``-joined names) take no step.  A trainable
parameter without a gradient steps on a zero gradient.
"""

from typing import Dict, List

import torch


def trainable(names: List[str], frozen: List[str]) -> List[str]:
    return [n for n in names if not any(p in n.replace(".", "/") for p in frozen)]


def lr_at(solver, count: int) -> float:
    if count >= solver["warmup_iters"]:
        return solver["base_lr"]
    alpha = count / solver["warmup_iters"]
    return solver["base_lr"] * (solver["warmup_factor"] * (1.0 - alpha) + alpha)


class SGD:
    def __init__(self, params: Dict[str, torch.nn.Parameter], solver):
        self.params = params
        self.solver = solver
        self.momentum: Dict[str, torch.Tensor] = {}
        self.count = 0

    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        s = self.solver
        lr = lr_at(s, self.count)
        with torch.no_grad():
            for n, p in self.params.items():
                g = grads.get(n)
                g = torch.zeros_like(p) if g is None else g
                bias = n.endswith("bias")
                factor = (s["bias_lr_factor"] if bias else 1.0) * (
                    s["uncertainty_lr_factor"] if "uncertain_pred" in n else 1.0)
                d = g + (s["weight_decay_bias"] if bias else s["weight_decay"]) * p
                buf = self.momentum.get(n)
                buf = d.clone() if buf is None else buf * s["momentum"] + d
                self.momentum[n] = buf
                p -= lr * factor * buf
        self.count += 1
