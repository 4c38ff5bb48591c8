"""SGD with the reference's parameter groups.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/engine/
optimizer.py`` (``label_params`` :35, ``_freeze_after`` :59,
``make_optimizer`` :81, ``frozen_prefixes_from_cfg`` :148) on
``torch.optim.SGD``:

* momentum SGD with weight decay added to the gradient before the
  momentum trace (optax's ``add_decayed_weights`` then ``trace``, and
  torch's SGD with dampening 0, compute the same update);
* biases get lr x ``BIAS_LR_FACTOR`` and ``WEIGHT_DECAY_BIAS``;
  ``uncertain_pred`` gets lr x ``UNCERTAINTY_LR_FACTOR`` (its bias both
  factors) and stops updating after ``UNCERTAINTY_TRAIN_ITER`` updates;
* frozen parameters (the backbone stages, the RPN under ``DONT_TRAIN``,
  the teacher and the word table for the student-teacher model) get
  ``requires_grad=False`` and no group;
* optional global-norm clipping over the trainable gradients
  (``SOLVER.CLIP_GRAD_NORM_AT``) and gradient accumulation that averages
  ``SOLVER.GRADIENT_ACCUMULATION_STEPS`` micro-steps before one update;
* ``state_dict`` / ``load_state_dict`` carry what a resume needs besides
  the weights: without ``updates`` a resumed run would restart warmup.

Parameters are labelled by their ``/``-joined names, which are the flax
paths (``bridge.py``), with the JAX function's substring rules.
"""

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..models.detector import ST_FAMILY
from .lr_schedule import warmup_multistep_schedule


def label_params(names: Sequence[str], frozen_prefixes: Sequence[str]) -> Dict[str, str]:
    """Labels each parameter name ``frozen``, ``uncertain_bias``,
    ``uncertain``, ``bias`` or ``default``."""

    def label(name: str) -> str:
        p = name.replace(".", "/")
        if "frozen_bn" in p or any(pre in p for pre in frozen_prefixes):
            return "frozen"
        is_bias = p.endswith("/bias") or p == "bias"
        if "uncertain_pred" in p:
            return "uncertain_bias" if is_bias else "uncertain"
        return "bias" if is_bias else "default"

    return {n: label(n) for n in names}


def frozen_prefixes_from_cfg(cfg, meta_arch: str = "GeneralizedRCNN"):
    """Name substrings of the parameters the reference trains with
    ``requires_grad=False``."""
    prefixes = []
    freeze_at = cfg.MODEL.BACKBONE.FREEZE_CONV_BODY_AT
    if freeze_at > 0:
        prefixes.append("backbone/body/stem")
        for i in range(1, freeze_at):
            prefixes.append(f"backbone/body/layer{i}")
    if cfg.MODEL.RPN.DONT_TRAIN:
        prefixes.append("rpn_head")
    if cfg.MODEL.ROI_BOX_HEAD.FREEZE_EMB_PRED:
        prefixes.append("emb_pred")
    if cfg.MODEL.ROI_BOX_HEAD.FREEZE_FEATURE_EXTRACTOR:
        prefixes.append("roi_extractor")
    if meta_arch in ST_FAMILY:
        prefixes.append("backbone/")
        prefixes.append("teacher/")
        if not cfg.MODEL.LANGUAGE_BACKBONE.FT_EMB:
            prefixes.append("bert/")
    if meta_arch == "MMSS-GCNN" and cfg.MODEL.LANGUAGE_BACKBONE.FREEZE:
        prefixes.append("language_backbone/")
    return tuple(prefixes)


class Optimizer:
    """The optimizer of one model (``make_optimizer``'s transform): call
    :meth:`step` after each ``backward``.  It owns a ``torch.optim.SGD`` whose groups carry the
    labels above; each update sets every group's lr from the schedule."""

    def __init__(self, cfg, model: nn.Module, frozen_prefixes: Sequence[str] = ()):
        s = cfg.SOLVER
        named = list(model.named_parameters())
        self.labels = label_params([n for n, _ in named], frozen_prefixes)
        # (lr factor, weight decay) per label; the products are float32,
        # as optax scales the float32 schedule by them
        factors = {
            "default": (1.0, s.WEIGHT_DECAY),
            "bias": (float(s.BIAS_LR_FACTOR), float(s.WEIGHT_DECAY_BIAS)),
            "uncertain": (s.UNCERTAINTY_LR_FACTOR, s.WEIGHT_DECAY),
            "uncertain_bias": (
                s.UNCERTAINTY_LR_FACTOR * float(s.BIAS_LR_FACTOR), float(s.WEIGHT_DECAY_BIAS)
            ),
        }
        groups, self.names = [], []
        for label, (lr_factor, wd) in factors.items():
            members = [(n, p) for n, p in named if self.labels[n] == label]
            if members:
                groups.append(dict(params=[p for _, p in members], label=label,
                                   lr_factor=lr_factor, weight_decay=wd, lr=0.0))
                self.names += [n for n, _ in members]
        for n, p in named:
            p.requires_grad_(self.labels[n] != "frozen")
        # the trainable parameters, in group order, and their names
        self.params: List[nn.Parameter] = [p for g in groups for p in g["params"]]
        self.sgd = torch.optim.SGD(groups, lr=0.0, momentum=s.MOMENTUM)
        self.schedule = warmup_multistep_schedule(
            s.BASE_LR, s.STEPS, s.GAMMA, s.WARMUP_FACTOR, s.WARMUP_ITERS, s.WARMUP_METHOD
        )
        self.clip_at = s.CLIP_GRAD_NORM_AT
        self.accumulate = max(int(s.GRADIENT_ACCUMULATION_STEPS), 1)
        self.freeze_uncertain_at: Optional[int] = (
            cfg.MODEL.UNCERTAINTY_TRAIN_ITER
            if cfg.MODEL.UNCERTAINTY and cfg.MODEL.UNCERTAINTY_TRAIN_ITER > 0 else None
        )
        self.updates = 0  # applied updates: the schedule's count
        self._micro = 0
        self._acc: Optional[List[torch.Tensor]] = None

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Applies this micro-step's gradients (an update every
        ``accumulate`` micro-steps) and returns their global norm.  A
        trainable parameter without a gradient counts as a zero gradient,
        as in the JAX transform, so weight decay still reaches it."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        grad_norm = global_norm(grads)
        if self.accumulate > 1:
            # optax.MultiSteps' running mean over the micro-steps
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            # a tensor divisor, filled on the device, as optax divides
            n = torch.full((), float(self._micro + 1), device=grads[0].device)
            self._acc = [a + (g - a) / n for a, g in zip(self._acc, grads)]
            self._micro += 1
            if self._micro < self.accumulate:
                self.zero_grad()
                return grad_norm
            grads, self._acc, self._micro = self._acc, None, 0
        if self.clip_at > 0:
            norm = global_norm(grads)
            grads = [torch.where(norm < self.clip_at, g, g / norm * self.clip_at) for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g
        lr = np.float32(self.schedule(self.updates))
        frozen_unc = (
            self.freeze_uncertain_at is not None and self.updates >= self.freeze_uncertain_at
        )
        for group in self.sgd.param_groups:
            group["lr"] = float(lr * np.float32(group["lr_factor"]))
            if frozen_unc and group["label"].startswith("uncertain"):
                for p in group["params"]:
                    p.grad = None  # SGD skips it: no update, as optax's zeroed one
        self.sgd.step()
        self.updates += 1
        return grad_norm

    def state_dict(self) -> Dict:
        """What a resume needs besides the weights, by parameter name:
        the momentum buffers, ``updates`` (the schedule's count and the
        uncertainty freeze's) and the accumulation's micro-step and
        running mean.  Tensors, ints and dicts only."""
        momentum = {}
        for n, p in zip(self.names, self.params):
            buf = self.sgd.state.get(p, {}).get("momentum_buffer")
            if buf is not None:
                momentum[n] = buf
        acc = {} if self._acc is None else dict(zip(self.names, self._acc))
        return {"momentum": momentum, "updates": self.updates, "micro": self._micro, "acc": acc}

    def load_state_dict(self, state: Dict) -> None:
        """Restores :meth:`state_dict`'s output onto the same
        parameters; raises if the names differ."""
        names = set(self.names)
        for key in ("momentum", "acc"):
            extra = sorted(set(state[key]) - names)
            if extra:
                raise KeyError(f"optimizer state {key} names parameters this model does not train: {extra[:5]}")
        self.sgd.state.clear()
        for n, p in zip(self.names, self.params):
            if n in state["momentum"]:
                self.sgd.state[p] = {"momentum_buffer": state["momentum"][n].to(p.device, p.dtype).clone()}
        self.updates = int(state["updates"])
        self._micro = int(state["micro"])
        acc = state["acc"]
        if acc and set(acc) != names:
            raise KeyError("optimizer state: the accumulated gradients do not cover the trainable parameters")
        self._acc = [acc[n].to(p.device, p.dtype).clone() for n, p in zip(self.names, self.params)] if acc else None


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every element, as optax.global_norm."""
    return torch.sqrt(sum(torch.sum(t.to(torch.float32) ** 2) for t in tensors))
