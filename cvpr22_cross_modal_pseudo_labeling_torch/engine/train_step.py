"""Training entry point: a config file in, one SGD step per batch.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/engine/
train_step.py``: the student-teacher branch of ``build_loss_fn`` (:61)
and ``build_train_step`` (:180).  One step is the training forward, the
sum of its losses, the backward and one optimizer step; its metrics are
each loss, ``avg_uncertain``, ``adaptive_lamb``, ``total_loss`` and
``grad_norm``.  ``grad_norm`` is the global norm of the trainable
parameters' gradients (the JAX step's norm also counts gradients of
parameters that never update, such as the student's frozen-BN leaves).

:func:`device_batch` takes the numpy batch of ``data/collate.py`` (plus
the two class tables) to device tensors; the port's data loader comes
with a later slice.
"""

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from ..bridge import load_flax_params
from ..models.detector.st_generalized_rcnn import (
    STGeneralizedRCNN,
    TrainDraws,
    st_statics_from_cfg,
)
from .inference import load_cfg
from .optimizer import Optimizer, frozen_prefixes_from_cfg

# batch key -> device dtype (None: keep the array's own); the collated
# keys the student-teacher step reads, and the two class tables
BATCH_DTYPES = {
    "images": None,
    "image_sizes": torch.int32,
    "gt_boxes": torch.float32,
    "gt_labels": torch.int64,
    "gt_valid": torch.bool,
    "gt_masks": torch.float32,
    "cap_mask": torch.bool,
    "det_mask": torch.bool,
    "cap_labels": torch.int64,
    "cap_word_valid": torch.bool,
    "cap_tok_ids": torch.int64,
    "cap_tok_mask": torch.float32,
    "class_embeddings": torch.float32,
    "lvis_class_embeddings": torch.float32,
}


def device_batch(batch: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The keys of :data:`BATCH_DTYPES` as tensors on ``device``; other
    collated keys (the caption token batch, image ids) are left out."""
    missing = sorted(set(BATCH_DTYPES) - set(batch))
    if missing:
        raise KeyError(f"the training batch lacks {missing}")
    out = {}
    for key, dtype in BATCH_DTYPES.items():
        t = torch.as_tensor(np.asarray(batch[key]))
        out[key] = t.to(device=device, dtype=dtype or t.dtype, non_blocking=True)
    return out


class Trainer:
    """Builds the model and optimizer a config names and takes SGD steps.

    ``device`` defaults to ``"cuda"`` and raises when no card is
    present; pass ``device="cpu"`` to run the plain versions of the
    kernels on the CPU.  ``seed`` seeds the generator of the step's
    random draws.  Load weights with :meth:`load_flax_params` before the
    first step.
    """

    def __init__(self, config_file: str, opts: Sequence = (), device: str = "cuda", seed: int = 0):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Trainer: no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        self.cfg = load_cfg(config_file, opts)
        arch = self.cfg.MODEL.META_ARCHITECTURE
        if arch != "STGeneralizedRCNN":
            raise NotImplementedError(
                f"META_ARCHITECTURE {arch}: only the STGeneralizedRCNN train step is ported yet"
            )
        if self.cfg.MODEL.LANGUAGE_BACKBONE.FT_EMB:
            raise NotImplementedError(
                "MODEL.LANGUAGE_BACKBONE.FT_EMB: the in-step LVIS table is not ported"
            )
        self.device = device
        self.model = STGeneralizedRCNN(st_statics_from_cfg(self.cfg)).to(device)
        self.optimizer = Optimizer(self.cfg, self.model, frozen_prefixes_from_cfg(self.cfg, arch))
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)

    def load_flax_params(self, params) -> None:
        load_flax_params(self.model, params)

    def step(self, batch: Mapping[str, np.ndarray], draws: TrainDraws = TrainDraws()) -> Dict[str, torch.Tensor]:
        """One training step on a numpy batch (see :func:`device_batch`).
        ``draws`` replaces the generator's draws of this step.  Returns
        the metrics as 0-d tensors on the device."""
        b = device_batch(batch, self.device)
        out = self.model(
            b["images"], b["image_sizes"], b["class_embeddings"], train=True, batch=b,
            lvis_class_embeddings=b["lvis_class_embeddings"], draws=draws,
            generator=self.generator,
        )
        total = sum(out.losses.values())
        self.optimizer.zero_grad()
        total.backward()
        grad_norm = self.optimizer.step()
        metrics = {k: v.detach() for k, v in {**out.losses, **out.info}.items()}
        metrics["total_loss"] = total.detach()
        metrics["grad_norm"] = grad_norm
        return metrics
