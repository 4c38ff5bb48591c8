"""Training entry point: a config file in, one SGD step per batch.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/engine/
train_step.py``: the ``GeneralizedRCNN`` (RetinaNet and the RPN-only
detector included: their losses are RetinaNet's two or the RPN's),
student-teacher and MMSS branches of ``build_loss_fn`` (:61), ``build_train_step`` (:180) and
``build_val_loss_step`` (:211), with the student-teacher model's exemplar
table (``TrainState.extra`` :32) as :attr:`Trainer.exemplars`.  One step is the training forward, the
sum of its losses, the backward and one optimizer step; its metrics are
each loss, the model's info (``avg_uncertain``, ``adaptive_lamb`` for the
student-teacher model, the batch accuracies for MMSS), ``total_loss``
and ``grad_norm``.  ``grad_norm`` is the global norm of the trainable
parameters' gradients and, for MMSS, of the frozen language backbone's
too, as JAX logs it (``Optimizer``'s ``counted_prefixes``).  The JAX
norm also counts gradients that the port never computes: the frozen-BN
leaves (buffers here), and for the detectors the frozen stages and
``emb_pred`` under ``FREEZE_EMB_PRED``.  :meth:`Trainer.val_loss` is
the validation-loss pass: the training branches on fixed draws, with no
update.

Under ``MODEL.EXEMPLARS_ENABLED`` a student-teacher ``Trainer`` holds the
exemplar table on the device: each step passes it in and keeps the
updated table the model hands back (``info["exemplars"]``, not logged);
the validation-loss pass passes none, as JAX's does.  Under
``MODEL.LANGUAGE_BACKBONE.FT_EMB`` the batch carries the tokenized LVIS
names (``lvis_name_ids``, ``lvis_name_mask``) in place of the LVIS table,
and the model rebuilds the table from its live word table.

:func:`host_batch` turns the numpy batch of ``data/collate.py`` (plus
the class tables) into CPU tensors of the step's dtypes and
:func:`device_batch` puts them on the device; a ``Trainer`` may hold the
class tables on the device already (:meth:`Trainer.set_class_tables`),
and its :meth:`Trainer.train_step` takes a batch already on the device,
so that ``engine/trainer.py``'s prefetcher can upload the next batch
while a step runs.  :meth:`Trainer.state_dict` holds what a resume
restores: the model, the optimizer, the generator and, when it exists,
the exemplar table.
"""

from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..bridge import load_flax_params
from ..config.cfg_node import CfgNode
from ..models.detector import RCNN_FAMILY, ST_FAMILY, build_detection_model
from ..models.detector.generalized_rcnn import RCNNTrainOutput, TrainDraws
from ..models.detector.st_generalized_rcnn import init_exemplar_table
from .inference import load_cfg
from .optimizer import Optimizer, frozen_prefixes_from_cfg

MMSS = "MMSS-GCNN"

# batch key -> device dtype (None: keep the array's own), per family: the
# collated keys each training forward reads, and the class tables
DETECTION_BATCH_DTYPES = {
    "images": None,
    "image_sizes": torch.int32,
    "gt_boxes": torch.float32,
    "gt_labels": torch.int64,
    "gt_valid": torch.bool,
    "gt_masks": torch.float32,
    "class_embeddings": torch.float32,
}
RCNN_BATCH_DTYPES = {**DETECTION_BATCH_DTYPES, "gt_keypoints": torch.float32}
ST_BATCH_DTYPES = {
    **DETECTION_BATCH_DTYPES,
    "cap_mask": torch.bool,
    "det_mask": torch.bool,
    "cap_labels": torch.int64,
    "cap_word_valid": torch.bool,
    "cap_tok_ids": torch.int64,
    "cap_tok_mask": torch.float32,
    "lvis_class_embeddings": torch.float32,
    "lvis_name_ids": torch.int64,
    "lvis_name_mask": torch.float32,
    "class_lvis_ids": torch.int64,
}
# keys the student-teacher family reads when the batch has them: the LVIS
# table or, under FT_EMB, the tokenized LVIS names it is rebuilt from, and
# the dataset classes' LVIS slots of the exemplar table
ST_OPTIONAL_KEYS = ("lvis_class_embeddings", "lvis_name_ids", "lvis_name_mask", "class_lvis_ids")
# keys the GeneralizedRCNN family reads when the batch has them: the class
# table of the embedding-based detector (the class-specific one reads
# none, and a dataset without embeddings, such as VOC, gives none), and
# the gt keypoints that the collate adds under MODEL.KEYPOINT_ON (JAX's
# loss function passes them on when the batch has them)
RCNN_OPTIONAL_KEYS = ("class_embeddings", "gt_keypoints")
MMSS_BATCH_DTYPES = {
    "images": None,
    "image_sizes": torch.int32,
    "input_ids": torch.int64,
    "attention_mask": torch.int32,
    "special_tokens_mask": torch.int32,
}


def batch_dtypes(meta_arch: str) -> Dict[str, torch.dtype]:
    if meta_arch in RCNN_FAMILY:
        return RCNN_BATCH_DTYPES
    if meta_arch in ST_FAMILY:
        return ST_BATCH_DTYPES
    if meta_arch == MMSS:
        return MMSS_BATCH_DTYPES
    raise ValueError(f"Unknown META_ARCHITECTURE {meta_arch}")


def host_batch(
    batch: Mapping[str, np.ndarray], meta_arch: str = "STGeneralizedRCNN", provided: Sequence[str] = ()
) -> Dict[str, torch.Tensor]:
    """The keys ``meta_arch``'s training forward reads, as CPU tensors of
    the step's dtypes; other collated keys (the caption token batch,
    image ids, the other family's keys), the keys in ``provided``
    (tables already on the device) and absent optional keys (the class
    table of a ``GeneralizedRCNN``) are left out."""
    dtypes = batch_dtypes(meta_arch)
    optional = RCNN_OPTIONAL_KEYS if meta_arch in RCNN_FAMILY else ST_OPTIONAL_KEYS if meta_arch in ST_FAMILY else ()
    missing = sorted(set(dtypes) - set(batch) - set(provided) - set(optional))
    if missing:
        raise KeyError(f"the training batch lacks {missing}")
    out = {}
    for key, dtype in dtypes.items():
        if key in provided or key not in batch:
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
    model, meta_arch: str, b: Dict[str, torch.Tensor], draws, generator: torch.Generator = None,
    exemplars: Optional[Dict[str, torch.Tensor]] = None,
) -> RCNNTrainOutput:
    """The model's training forward on a :func:`device_batch`.  ``draws``
    is a ``TrainDraws`` for the detectors, an ``MMSSDraws`` for MMSS;
    ``exemplars`` the student-teacher model's exemplar table."""
    if meta_arch == MMSS:
        captions = {k: b[k] for k in ("input_ids", "attention_mask", "special_tokens_mask")}
        info, losses = model(b["images"], b["image_sizes"], captions, train=True, draws=draws,
                             generator=generator)
        return RCNNTrainOutput(losses, info)
    if meta_arch in RCNN_FAMILY:
        return model(
            b["images"], b["image_sizes"], b.get("class_embeddings"), train=True, batch=b,
            draws=draws, generator=generator,
        )
    return model(
        b["images"], b["image_sizes"], b["class_embeddings"], train=True, batch=b,
        lvis_class_embeddings=b.get("lvis_class_embeddings"), draws=draws, generator=generator,
        exemplars=exemplars,
    )


class Trainer:
    """Builds the model and optimizer a config names and takes SGD steps.

    ``config`` is a config file (``opts`` are merged into it) or a loaded
    config.  ``device`` defaults to ``"cuda"`` and raises when no card is
    present; pass ``device="cpu"`` to run the plain versions of the
    kernels on the CPU.  ``seed`` seeds the generator of the step's
    random draws.  ``model`` replaces the model the config names (built
    from statics, e.g. at narrow widths); the optimizer still follows
    the config.  Load weights with :meth:`load_flax_params` (or
    :meth:`load_state_dict`) before the first step.
    """

    # the validation-loss pass draws from a generator seeded so, anew
    # for every batch (JAX's ``build_val_loss_step`` uses PRNGKey(0))
    VAL_SEED = 0

    def __init__(self, config: Union[str, CfgNode], opts: Sequence = (), device: str = "cuda", seed: int = 0,
                 model: torch.nn.Module = None):
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
        self.device = device
        self.model = (model if model is not None else build_detection_model(self.cfg)).to(device)
        frozen = frozen_prefixes_from_cfg(self.cfg, self.meta_arch)
        # JAX's logged norm counts the frozen BERT's gradient, which no
        # stop_gradient cuts (tpu/models/detector/mmss_gcnn.py:248)
        counted = ("language_backbone/",) if self.meta_arch == MMSS else ()
        self.optimizer = Optimizer(self.cfg, self.model, frozen, counted_prefixes=counted)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)
        self.class_tables: Dict[str, torch.Tensor] = {}
        # the exemplar table over the LVIS vocabulary (TrainState.extra)
        self.exemplars: Optional[Dict[str, torch.Tensor]] = None
        if self.cfg.MODEL.EXEMPLARS_ENABLED and self.meta_arch in ST_FAMILY:
            s = self.model.statics
            self.exemplars = init_exemplar_table(s.lvis_vocab, s.base.emb_dim, device)

    def load_flax_params(self, params) -> None:
        load_flax_params(self.model, params)

    def set_class_tables(self, **tables: np.ndarray) -> None:
        """Keeps batch-invariant tables (``class_embeddings``,
        ``lvis_class_embeddings``, or under FT_EMB ``lvis_name_ids`` and
        ``lvis_name_mask``; ``class_lvis_ids``) on the device, each in its
        batch dtype (an integer table stays integer); :meth:`device_batch`
        adds them to every batch.  A None table (a dataset without class
        embeddings) is left out."""
        dtypes = batch_dtypes(self.meta_arch)
        self.class_tables = {
            k: torch.as_tensor(np.asarray(v)).to(self.device, dtypes[k]) for k, v in tables.items() if v is not None
        }

    def host_batch(self, batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """:func:`host_batch` without the tables this trainer holds."""
        return host_batch(batch, self.meta_arch, tuple(self.class_tables))

    def device_batch(self, batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A numpy batch on the device, with this trainer's tables."""
        b = {k: t.to(self.device, non_blocking=True) for k, t in self.host_batch(batch).items()}
        return {**b, **self.class_tables}

    def _draws(self, draws):
        if draws is not None:
            return draws
        if self.meta_arch == MMSS:
            from ..models.detector.mmss_gcnn import MMSSDraws

            return MMSSDraws()
        return TrainDraws()

    def step(self, batch: Mapping[str, np.ndarray], draws=None) -> Dict[str, torch.Tensor]:
        """One training step on a numpy batch (see :func:`host_batch`).
        ``draws`` (a ``TrainDraws``, or an ``MMSSDraws`` for MMSS)
        replaces the generator's draws of this step.  Returns the metrics
        as 0-d tensors on the device."""
        return self.train_step(self.device_batch(batch), draws)

    def train_step(self, b: Dict[str, torch.Tensor], draws=None) -> Dict[str, torch.Tensor]:
        """One training step on a batch already on the device."""
        out = training_forward(self.model, self.meta_arch, b, self._draws(draws), self.generator, self.exemplars)
        table = out.info.pop("exemplars", None)
        if table is not None:
            self.exemplars = table
        total = sum(out.losses.values())
        self.optimizer.zero_grad()
        total.backward()
        grad_norm = self.optimizer.step()
        metrics = {k: v.detach() for k, v in {**out.losses, **out.info}.items()}
        metrics["total_loss"] = total.detach()
        metrics["grad_norm"] = grad_norm
        return metrics

    @torch.no_grad()
    def val_loss(self, b: Dict[str, torch.Tensor], draws=None) -> Dict[str, torch.Tensor]:
        """The validation loss of a batch on the device: each loss and
        ``val_total_loss``, from the training branches on draws of a
        generator seeded ``VAL_SEED`` anew (or ``draws``); no update, and
        no exemplar table (neither mixed nor updated)."""
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.VAL_SEED)
        out = training_forward(self.model, self.meta_arch, b, self._draws(draws), generator)
        metrics = dict(out.losses)
        metrics["val_total_loss"] = sum(out.losses.values())
        return metrics

    def state_dict(self) -> Dict:
        """The model's weights and buffers, the optimizer's state, the
        generator's state (tensors, ints and dicts) and, only when it
        exists, the exemplar table."""
        state = {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "generator": self.generator.get_state(),
        }
        if self.exemplars is not None:
            state["exemplars"] = dict(self.exemplars)
        return state

    def load_state_dict(self, state: Mapping) -> None:
        """Restores :meth:`state_dict`'s output (strict: every key of the
        model must be there, and no other; the exemplar table must be
        there exactly when this trainer has one)."""
        if ("exemplars" in state) != (self.exemplars is not None):
            raise KeyError(
                "exemplar table: the state has " + ("one" if "exemplars" in state else "none")
                + ", this trainer " + ("one" if self.exemplars is not None else "none")
                + " (MODEL.EXEMPLARS_ENABLED)"
            )
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.generator.set_state(state["generator"])
        if self.exemplars is not None:
            table = state["exemplars"]
            if set(table) != set(self.exemplars) or any(
                    table[k].shape != self.exemplars[k].shape for k in self.exemplars):
                raise KeyError(f"exemplar table: {sorted(table)} does not match this trainer's")
            self.exemplars = {k: table[k].to(self.device, self.exemplars[k].dtype) for k in self.exemplars}
