"""Training entry point: a config file in, one SGD step per batch.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/engine/
train_step.py``: the ``GeneralizedRCNN`` and student-teacher branches of
``build_loss_fn`` (:61) and ``build_train_step`` (:180).  One step is the
training forward, the sum of its losses, the backward and one optimizer
step; its metrics are each loss, the model's info (``avg_uncertain``,
``adaptive_lamb`` for the student-teacher model), ``total_loss`` and
``grad_norm``.  ``grad_norm`` is the global norm of the trainable
parameters' gradients (the JAX step's norm also counts gradients of
parameters that never update: frozen-BN leaves, frozen stages,
``emb_pred`` under ``FREEZE_EMB_PRED``).

:func:`device_batch` takes the numpy batch of ``data/collate.py`` (plus
the class tables) to device tensors; the port's data loader comes with a
later slice.
"""

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from ..bridge import load_flax_params
from ..models.detector import RCNN_FAMILY, build_detection_model
from ..models.detector.generalized_rcnn import RCNNTrainOutput, TrainDraws
from .inference import load_cfg
from .optimizer import Optimizer, frozen_prefixes_from_cfg

# batch key -> device dtype (None: keep the array's own), per family: the
# collated keys each training forward reads, and the class tables
RCNN_BATCH_DTYPES = {
    "images": None,
    "image_sizes": torch.int32,
    "gt_boxes": torch.float32,
    "gt_labels": torch.int64,
    "gt_valid": torch.bool,
    "gt_masks": torch.float32,
    "class_embeddings": torch.float32,
}
ST_BATCH_DTYPES = {
    **RCNN_BATCH_DTYPES,
    "cap_mask": torch.bool,
    "det_mask": torch.bool,
    "cap_labels": torch.int64,
    "cap_word_valid": torch.bool,
    "cap_tok_ids": torch.int64,
    "cap_tok_mask": torch.float32,
    "lvis_class_embeddings": torch.float32,
}


def device_batch(
    batch: Mapping[str, np.ndarray], device, meta_arch: str = "STGeneralizedRCNN"
) -> Dict[str, torch.Tensor]:
    """The keys ``meta_arch``'s training forward reads, as tensors on
    ``device``; other collated keys (the caption token batch, image ids,
    the other family's keys) are left out."""
    dtypes = RCNN_BATCH_DTYPES if meta_arch in RCNN_FAMILY else ST_BATCH_DTYPES
    missing = sorted(set(dtypes) - set(batch))
    if missing:
        raise KeyError(f"the training batch lacks {missing}")
    out = {}
    for key, dtype in dtypes.items():
        t = torch.as_tensor(np.asarray(batch[key]))
        out[key] = t.to(device=device, dtype=dtype or t.dtype, non_blocking=True)
    return out


def training_forward(
    model, meta_arch: str, b: Dict[str, torch.Tensor], draws: TrainDraws,
    generator: torch.Generator = None,
) -> RCNNTrainOutput:
    """The model's training forward on a :func:`device_batch`."""
    if meta_arch in RCNN_FAMILY:
        return model(
            b["images"], b["image_sizes"], b["class_embeddings"], train=True, batch=b,
            draws=draws, generator=generator,
        )
    return model(
        b["images"], b["image_sizes"], b["class_embeddings"], train=True, batch=b,
        lvis_class_embeddings=b["lvis_class_embeddings"], draws=draws, generator=generator,
    )


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
        self.meta_arch = self.cfg.MODEL.META_ARCHITECTURE
        if self.cfg.MODEL.LANGUAGE_BACKBONE.FT_EMB and self.meta_arch not in RCNN_FAMILY:
            raise NotImplementedError(
                "MODEL.LANGUAGE_BACKBONE.FT_EMB: the in-step LVIS table is not ported"
            )
        self.device = device
        self.model = build_detection_model(self.cfg).to(device)
        self.optimizer = Optimizer(
            self.cfg, self.model, frozen_prefixes_from_cfg(self.cfg, self.meta_arch)
        )
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)

    def load_flax_params(self, params) -> None:
        load_flax_params(self.model, params)

    def step(self, batch: Mapping[str, np.ndarray], draws: TrainDraws = TrainDraws()) -> Dict[str, torch.Tensor]:
        """One training step on a numpy batch (see :func:`device_batch`).
        ``draws`` replaces the generator's draws of this step.  Returns
        the metrics as 0-d tensors on the device."""
        b = device_batch(batch, self.device, self.meta_arch)
        out = training_forward(self.model, self.meta_arch, b, draws, self.generator)
        total = sum(out.losses.values())
        self.optimizer.zero_grad()
        total.backward()
        grad_norm = self.optimizer.step()
        metrics = {k: v.detach() for k, v in {**out.losses, **out.info}.items()}
        metrics["total_loss"] = total.detach()
        metrics["grad_norm"] = grad_norm
        return metrics
