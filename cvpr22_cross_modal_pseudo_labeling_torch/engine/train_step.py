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

:func:`host_batch` turns the numpy batch of ``data/collate.py`` (plus
the class tables) into CPU tensors of the step's dtypes and
:func:`device_batch` puts them on the device; a ``Trainer`` may hold the
class tables on the device already (:meth:`Trainer.set_class_tables`),
and its :meth:`Trainer.train_step` takes a batch already on the device,
so that ``engine/trainer.py``'s prefetcher can upload the next batch
while a step runs.  :meth:`Trainer.state_dict` holds what a resume
restores: the model, the optimizer and the generator.
"""

from typing import Dict, Mapping, Sequence, Union

import numpy as np
import torch

from ..bridge import load_flax_params
from ..config.cfg_node import CfgNode
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


def host_batch(
    batch: Mapping[str, np.ndarray], meta_arch: str = "STGeneralizedRCNN", provided: Sequence[str] = ()
) -> Dict[str, torch.Tensor]:
    """The keys ``meta_arch``'s training forward reads, as CPU tensors of
    the step's dtypes; other collated keys (the caption token batch,
    image ids, the other family's keys) and the keys in ``provided``
    (tables already on the device) are left out."""
    dtypes = RCNN_BATCH_DTYPES if meta_arch in RCNN_FAMILY else ST_BATCH_DTYPES
    missing = sorted(set(dtypes) - set(batch) - set(provided))
    if missing:
        raise KeyError(f"the training batch lacks {missing}")
    out = {}
    for key, dtype in dtypes.items():
        if key in provided:
            continue
        t = torch.as_tensor(np.asarray(batch[key]))
        out[key] = t.to(dtype=dtype or t.dtype)
    return out


def device_batch(
    batch: Mapping[str, np.ndarray], device, meta_arch: str = "STGeneralizedRCNN"
) -> Dict[str, torch.Tensor]:
    """:func:`host_batch` on ``device``."""
    return {k: t.to(device, non_blocking=True) for k, t in host_batch(batch, meta_arch).items()}


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

    ``config`` is a config file (``opts`` are merged into it) or a loaded
    config.  ``device`` defaults to ``"cuda"`` and raises when no card is
    present; pass ``device="cpu"`` to run the plain versions of the
    kernels on the CPU.  ``seed`` seeds the generator of the step's
    random draws.  Load weights with :meth:`load_flax_params` (or
    :meth:`load_state_dict`) before the first step.
    """

    def __init__(self, config: Union[str, CfgNode], opts: Sequence = (), device: str = "cuda", seed: int = 0):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Trainer: no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if isinstance(config, str):
            self.cfg = load_cfg(config, opts)
        elif opts:
            raise ValueError("Trainer: opts go with a config file; merge them into a loaded config")
        else:
            self.cfg = config
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
        self.class_tables: Dict[str, torch.Tensor] = {}

    def load_flax_params(self, params) -> None:
        load_flax_params(self.model, params)

    def set_class_tables(self, **tables: np.ndarray) -> None:
        """Keeps batch-invariant tables (``class_embeddings``,
        ``lvis_class_embeddings``) on the device; :meth:`device_batch`
        adds them to every batch."""
        self.class_tables = {
            k: torch.as_tensor(np.asarray(v, np.float32)).to(self.device) for k, v in tables.items()
        }

    def host_batch(self, batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """:func:`host_batch` without the tables this trainer holds."""
        return host_batch(batch, self.meta_arch, tuple(self.class_tables))

    def device_batch(self, batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A numpy batch on the device, with this trainer's tables."""
        b = {k: t.to(self.device, non_blocking=True) for k, t in self.host_batch(batch).items()}
        return {**b, **self.class_tables}

    def step(self, batch: Mapping[str, np.ndarray], draws: TrainDraws = TrainDraws()) -> Dict[str, torch.Tensor]:
        """One training step on a numpy batch (see :func:`host_batch`).
        ``draws`` replaces the generator's draws of this step.  Returns
        the metrics as 0-d tensors on the device."""
        return self.train_step(self.device_batch(batch), draws)

    def train_step(self, b: Dict[str, torch.Tensor], draws: TrainDraws = TrainDraws()) -> Dict[str, torch.Tensor]:
        """One training step on a batch already on the device."""
        out = training_forward(self.model, self.meta_arch, b, draws, self.generator)
        total = sum(out.losses.values())
        self.optimizer.zero_grad()
        total.backward()
        grad_norm = self.optimizer.step()
        metrics = {k: v.detach() for k, v in {**out.losses, **out.info}.items()}
        metrics["total_loss"] = total.detach()
        metrics["grad_norm"] = grad_norm
        return metrics

    def state_dict(self) -> Dict:
        """The model's weights and buffers, the optimizer's state and the
        generator's state (tensors, ints and dicts)."""
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "generator": self.generator.get_state(),
        }

    def load_state_dict(self, state: Mapping) -> None:
        """Restores :meth:`state_dict`'s output (strict: every key of the
        model must be there, and no other)."""
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.generator.set_state(state["generator"])
