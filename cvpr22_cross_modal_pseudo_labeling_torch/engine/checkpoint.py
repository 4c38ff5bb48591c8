"""Checkpoints of the port, and the import of other weights.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/engine/
checkpoint.py`` (reference maskrcnn_benchmark/utils/checkpoint.py:13-154
and utils/model_serialization.py:10-67).

* **Native checkpoints** (:func:`save_checkpoint`, :func:`load_checkpoint`,
  :func:`latest_checkpoint`): ``torch.save`` in place of orbax, one file
  per save, ``OUTPUT_DIR/model_%07d.pth``, holding :func:`checkpoint_state`:
  the ``Trainer`` state (model, optimizer, generator), each model key's
  layout (``bridge.port_layouts``), the iteration and the
  meta-architecture.  Only tensors, ints, strings and dicts, so that
  ``torch.load(..., weights_only=True)`` reads them.  The state is taken
  to the host with one copy per device and dtype, written to a temporary
  name and renamed.  A ``last_checkpoint`` tag names the newest published
  save.  With ``block=False`` the write runs on a background thread and
  the save is published (the tag, the pruning to ``keep`` saves and the
  staged sidecar files) by the next save or :func:`flush_pending_checkpoint`,
  never earlier; :func:`discard_pending_checkpoint` deletes an unpublished
  save (the divergence abort of ``engine/trainer.py::do_train``).
* **Importers**, copied from the JAX package (numpy, on
  flax-layout trees: ``bridge.flax_from_state_dict`` of a model, or
  ``bridge.flax_tree_from_checkpoint`` of a checkpoint; the result goes
  back through ``bridge.load_flax_params``): the reference key surgery,
  the longest-suffix torch ``state_dict`` import, the cross-stage import
  between the port's own checkpoints, the language-table import and the
  student's start from the teacher.  One change: the cross-stage import
  routes a source trunk's ``layer4`` to the RoI extractor only when the
  target's trunk has none (:func:`import_flax_params`).
* :func:`import_external_weights` is the ``MODEL.WEIGHT`` chain of both
  entry points: a port checkpoint (a file, or an ``OUTPUT_DIR`` whose tag
  names one), a Caffe2 ``.pkl`` or a reference ``.pth``.  An orbax
  directory written by the JAX package cannot be read without jax and
  orbax: it raises (ROADMAP.md queue A item 9), and so does a path that
  does not exist.
"""

import os
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import bridge

ORBAX_NOT_READ = (
    "an orbax checkpoint of the JAX package: the port reads it only through jax and "
    "orbax, which it does not use (ROADMAP.md queue A item 9)"
)


# ---------------------------------------------------------------------------
# native checkpoints
# ---------------------------------------------------------------------------


class _PendingSave:
    """An unpublished save: its write thread and what publishing needs."""

    def __init__(self, directory: str, path: str, keep: int, extras, thread: threading.Thread):
        self.directory, self.path, self.keep, self.extras = directory, path, keep, extras
        self.thread = thread
        self.error: Optional[BaseException] = None


_pending: Optional[_PendingSave] = None


def checkpoint_step(path: str) -> int:
    """The iteration a ``model_%07d.pth`` file name encodes."""
    return int(os.path.splitext(os.path.basename(path))[0].rsplit("_", 1)[-1])


def checkpoint_state(trainer, iteration: int) -> Dict[str, Any]:
    """What one save holds: the trainer's state, its model's layouts,
    the iteration and the meta-architecture."""
    return {
        "trainer": trainer.state_dict(),
        "layouts": bridge.port_layouts(trainer.model),
        "iteration": int(iteration),
        "meta_arch": trainer.meta_arch,
    }


def _to_host(state):
    """A copy of ``state`` on the host.  The tensors of each (device,
    dtype) are gathered into one buffer and copied in one transfer (for
    CPU tensors the gather is the copy), so that training may go on
    changing the originals while the copy is written."""
    groups: Dict[Tuple[torch.device, torch.dtype], list] = {}

    def collect(node):
        if isinstance(node, dict):
            for v in node.values():
                collect(v)
        elif torch.is_tensor(node):
            groups.setdefault((node.device, node.dtype), []).append(node)
        elif not isinstance(node, (int, str)):
            raise TypeError(f"a checkpoint holds tensors, ints, strings and dicts, not {type(node)}")

    collect(state)
    copies = {}
    for tensors in groups.values():
        flat = torch.cat([t.detach().reshape(-1) for t in tensors]).cpu()
        for t, part in zip(tensors, torch.split(flat, [t.numel() for t in tensors])):
            copies[id(t)] = part.view(t.shape)

    def rebuild(node):
        if isinstance(node, dict):
            return {k: rebuild(v) for k, v in node.items()}
        return copies[id(node)] if torch.is_tensor(node) else node

    return rebuild(state)


def _write(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _finalize(directory: str, path: str, keep: int, extras=None) -> None:
    """Publishes a written save: the staged sidecar files (``extras``:
    path -> content, e.g. a loader-state snapshot taken at the save's
    iteration), the ``last_checkpoint`` tag and the pruning to ``keep``
    saves."""
    for p, content in (extras or {}).items():
        with open(p, "w") as f:
            f.write(content)
    tag = os.path.join(directory, "last_checkpoint")
    with open(tag + ".tmp", "w") as f:
        f.write(os.path.basename(path))
    os.replace(tag + ".tmp", tag)
    saves = sorted(d for d in os.listdir(directory) if d.startswith("model_") and d.endswith(".pth"))
    for old in saves[:-keep]:
        os.remove(os.path.join(directory, old))


def _join(pending: _PendingSave) -> None:
    pending.thread.join()
    if pending.error is not None:
        raise RuntimeError(f"writing checkpoint {pending.path} failed") from pending.error


def flush_pending_checkpoint() -> None:
    """Waits for an unpublished save's write and publishes it."""
    global _pending
    if _pending is None:
        return
    pending, _pending = _pending, None
    _join(pending)
    _finalize(pending.directory, pending.path, pending.keep, pending.extras)


def pending_checkpoint_step() -> Optional[int]:
    """Iteration of the unpublished save, or None."""
    return None if _pending is None else checkpoint_step(_pending.path)


def discard_pending_checkpoint() -> None:
    """Waits for an unpublished save's write and deletes it without
    publishing: ``last_checkpoint`` keeps naming the previous save.  The
    divergence abort uses it: a save taken after the last finite loss
    may hold non-finite weights, and publishing it would make the next
    launch resume from them."""
    global _pending
    if _pending is None:
        return
    pending, _pending = _pending, None
    pending.thread.join()
    for p in (pending.path, pending.path + ".tmp"):
        if os.path.exists(p):
            os.remove(p)


def save_checkpoint(
    directory: str, state: Dict[str, Any], step: int, keep: int = 5, block: bool = True, extras=None,
) -> str:
    """Saves ``state`` as ``directory/model_{step:07d}.pth``; returns the
    path.  ``block=False`` writes on a background thread and leaves the
    publishing to the next save or :func:`flush_pending_checkpoint`, so
    the tag never names an unfinished file and the sidecars never run
    ahead of it.  The reference blocks on ``torch.save`` at every
    CHECKPOINT_PERIOD (checkpoint.py:34-52)."""
    global _pending
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"model_{step:07d}.pth")
    flush_pending_checkpoint()
    host = _to_host(state)
    if block:
        _write(host, path)
        _finalize(directory, path, keep, extras)
        return path

    def run():
        try:
            _write(host, path)
        except BaseException as e:  # surfaced by the flush that publishes it
            pending.error = e

    pending = _PendingSave(directory, path, keep, extras, threading.Thread(target=run, name="checkpoint-write"))
    _pending = pending
    pending.thread.start()
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    """The save ``directory/last_checkpoint`` names, if it exists."""
    tag = os.path.join(directory, "last_checkpoint")
    if os.path.exists(tag):
        with open(tag) as f:
            path = os.path.join(directory, f.read().strip())
        if os.path.exists(path):
            return path
    return None


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Reads a port checkpoint onto the host (``weights_only=True``).
    A directory is an orbax checkpoint of the JAX package and raises."""
    if os.path.isdir(path):
        raise NotImplementedError(f"{path} is {ORBAX_NOT_READ}")
    return torch.load(path, map_location="cpu", weights_only=True)


def is_port_checkpoint(blob) -> bool:
    return isinstance(blob, dict) and {"trainer", "layouts", "iteration", "meta_arch"} <= set(blob)


def restore_trainer(trainer, ckpt: Dict[str, Any], path: str = "checkpoint") -> int:
    """Loads a checkpoint into ``trainer``; returns its iteration.  A
    checkpoint of another model or optimizer layout raises one line that
    says what to do."""
    if ckpt.get("meta_arch") != trainer.meta_arch:
        raise RuntimeError(
            f"{path} holds a {ckpt.get('meta_arch')} model, not {trainer.meta_arch}: start from a "
            "fresh OUTPUT_DIR, or import its weights through MODEL.WEIGHT"
        )
    try:
        trainer.load_state_dict(ckpt["trainer"])
    except (KeyError, RuntimeError) as e:
        raise RuntimeError(
            f"checkpoint {path} does not match the current model/optimizer structure (it was "
            "saved by a different config or code version). Start from a fresh OUTPUT_DIR, or "
            "load weights only via MODEL.WEIGHT / MODEL.LOAD_TRAINER_STATE=False. First "
            "mismatch: " + " ".join(str(e).split())[:300]
        ) from None
    return int(ckpt["iteration"])


# ---------------------------------------------------------------------------
# torch -> flax-layout import (copied from the JAX package)
# ---------------------------------------------------------------------------


def _flatten_params(params) -> Dict[Tuple[str, ...], np.ndarray]:
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            flat[path] = node

    walk(params, ())
    return flat


def _unflatten(flat: Dict[Tuple[str, ...], Any]):
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


_TORCH_LEAF_MAP = {
    "weight": ("kernel", "frozen_bn_weight", "scale"),
    "bias": ("bias", "frozen_bn_bias"),
    "running_mean": ("frozen_bn_mean",),
    "running_var": ("frozen_bn_var",),
    # STGeneralizedRCNN registers the BERT word-embedding table as a bare
    # Parameter named `bert.embeddings` (reference transformers.py:24);
    # our table-only backbone calls it word_embeddings.
    "embeddings": ("word_embeddings",),
}


def _normalize_torch_key(key: str) -> str:
    """Converts a torch dotted name into a slash path in our module
    vocabulary: layerN.M -> layerN/blockM, downsample.0/1 ->
    downsample_conv/bn, predictor/extractor names flattened, and the
    student-teacher module names mapped onto our subtrees
    (roi_heads -> teacher, roi_heads_student -> student) so a full ST
    checkpoint routes each bundle deterministically instead of tying on
    the shared suffix."""
    parts = key.split(".")
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p.startswith("layer") and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append(p)
            out.append(f"block{parts[i + 1]}")
            i += 2
            continue
        if p == "downsample" and i + 1 < len(parts) and parts[i + 1].isdigit():
            out.append("downsample_conv" if parts[i + 1] == "0" else "downsample_bn")
            i += 2
            continue
        if p == "roi_heads_student":
            out.append("student")
            i += 1
            continue
        if p == "roi_heads":
            out.append("teacher")
            i += 1
            continue
        # roi_heads.{box,mask}.predictor -> {box,mask}_predictor;
        # roi_heads.{box,mask}.feature_extractor.head -> roi_extractor
        # (reference box_head/roi_box_feature_extractors.py:13-46 pooler
        # + ResNetHead; ours is the shared RoIHeadsBundle.roi_extractor)
        if p in ("box", "mask") and i + 1 < len(parts):
            if parts[i + 1] == "predictor":
                out.append(f"{p}_predictor")
                i += 2
                continue
            if parts[i + 1] == "feature_extractor" and i + 2 < len(parts) and parts[i + 2] == "head":
                out.append("roi_extractor")
                i += 3
                continue
        out.append(p)
        i += 1
    return "/".join(out)


def _candidate_values(value: np.ndarray, target_shape) -> Optional[np.ndarray]:
    """Reshapes/transposes a torch tensor to the flax layout implied by
    the target shape, or None if incompatible."""
    v = np.asarray(value)
    if tuple(v.shape) == tuple(target_shape):
        return v
    if v.ndim == 4:
        # Conv2d: torch (out, in, kh, kw) -> flax (kh, kw, in, out).
        t = v.transpose(2, 3, 1, 0)
        if tuple(t.shape) == tuple(target_shape):
            return t
        # ConvTranspose2d: torch (in, out, kh, kw) -> flax ConvTranspose
        # (kh, kw, in, out) *with a spatial flip* -- torch's deconv is the
        # gradient of conv (taps reversed), flax/lax.conv_transpose reads
        # the kernel unflipped.  Only reached when in != out, so it cannot
        # shadow a Conv2d kernel; a *square* ConvTranspose would be
        # ambiguous, and none exists in this model family.
        t = v[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
        if tuple(t.shape) == tuple(target_shape):
            return t
    if v.ndim == 2 and tuple(v.T.shape) == tuple(target_shape):
        return v.T
    if v.ndim == 1 and tuple(v.shape) == tuple(target_shape):
        return v
    return None


def apply_reference_key_surgery(
    state_dict: Dict[str, np.ndarray],
    backbone_prefix: str = "",
    load_emb_pred_from_mmss_head: bool = False,
    default_mmss_head: str = "GroundingHead",
    load_classifier: bool = True,
) -> Dict[str, np.ndarray]:
    """The DetectronCheckpointer renames (checkpoint.py:113-126)."""
    out = {}
    for k, v in state_dict.items():
        nk = k
        if nk.startswith("module."):
            nk = nk[len("module."):]
        if backbone_prefix and nk.startswith(backbone_prefix):
            nk = "backbone.body." + nk[len(backbone_prefix):]
        if load_emb_pred_from_mmss_head:
            marker = f"mmss_heads.{default_mmss_head}.v2l_projection"
            if marker in nk:
                nk = "roi_heads.box.predictor.emb_pred" + nk[nk.index(marker) + len(marker):]
        if not load_classifier and "cls_score" in nk:
            continue
        out[nk] = v
    return out


def import_torch_state_dict(
    params: Dict[str, Any],
    state_dict: Dict[str, np.ndarray],
    verbose: bool = False,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Longest-suffix matching of translated torch keys onto the flax
    param tree (model_serialization.py:10-67 semantics).

    Returns (new_params, report) where report lists matched/missed keys.
    """
    flat = _flatten_params(params)
    # target path strings (leaf translated back to torch-ish vocab)
    target_keys = {path: "/".join(path) for path in flat}
    top_level = {path[0] for path in flat if len(path) > 1}

    matched, missed = {}, []
    used_targets = set()
    for tk, tv in state_dict.items():
        tv = np.asarray(tv)
        norm = _normalize_torch_key(tk)
        segs = norm.split("/")
        leaf = segs[-1]
        body = segs[:-1]
        leaf_options = _TORCH_LEAF_MAP.get(leaf, (leaf,))
        # when the source names a known top-level subtree (teacher /
        # student / backbone ...), never let suffix matching cross into a
        # different subtree: an ST checkpoint's duplicated shared-
        # extractor keys (roi_heads.mask.feature_extractor == box's)
        # would otherwise fall through onto the *student's* extractor
        # before the student's own keys are reached
        root = body[0] if body and body[0] in top_level else None
        best = None
        best_len = -1
        for path, pstr in target_keys.items():
            if path in used_targets:
                continue
            if root is not None and path[0] != root:
                continue
            if path[-1] not in leaf_options:
                continue
            # suffix match on the body segments
            tpath = list(path[:-1])
            n = 0
            while (
                n < len(body)
                and n < len(tpath)
                and body[len(body) - 1 - n] == tpath[len(tpath) - 1 - n]
            ):
                n += 1
            if n == 0 and body:
                continue
            cand = _candidate_values(tv, flat[path].shape)
            if cand is None:
                continue
            if n > best_len:
                best_len = n
                best = (path, cand)
        if best is None:
            missed.append(tk)
            continue
        matched[best[0]] = best[1]
        used_targets.add(best[0])
        if verbose:
            print(f"{tk} -> {'/'.join(best[0])}")

    new_flat = dict(flat)
    for path, v in matched.items():
        new_flat[path] = np.asarray(v, dtype=np.asarray(flat[path]).dtype)
    report = {
        "matched": len(matched),
        "missed_source_keys": missed,
        "unfilled_targets": ["/".join(p) for p in flat if p not in matched],
    }
    return _unflatten(new_flat), report


def extract_params_tree(raw) -> Dict[str, Any]:
    """Pulls the bare model param tree out of a raw restore of the JAX
    package's layout: ``{"state": TrainState, "iteration"}`` with
    ``TrainState.params = {"params": <tree>}``, or ``{"params": <tree>}``.
    Model trees never contain a top-level ``params`` key themselves, so
    unwrapping is unambiguous."""
    node = raw
    if isinstance(node, dict) and "state" in node:
        node = node["state"]
    for _ in range(2):
        if isinstance(node, dict) and "params" in node and isinstance(node["params"], dict):
            node = node["params"]
    return node


def import_flax_params(
    params: Dict[str, Any],
    source_params: Dict[str, Any],
    load_emb_pred_from_mmss_head: bool = False,
    default_mmss_head: str = "GroundingHead",
    load_classifier: bool = True,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Cross-stage import between this framework's OWN checkpoints: the
    documented pipeline trains MMSS -> teacher -> student entirely here,
    so stage N+1's MODEL.WEIGHT is a checkpoint of stage N, not a torch
    .pth.  Transplants the reference DetectronCheckpointer surgeries
    (checkpoint.py:113-126) into the flax naming vocabulary:

    * identical paths with identical shapes copy directly (both sides
      share this framework's module names -- no layout transposes);
    * MMSS ``v2l_projection`` (shared or ``v2l_projection_<HEAD>``) ->
      the box predictor's ``emb_pred`` when
      LOAD_EMB_PRED_FROM_MMSS_HEAD (reference checkpoint.py:120-122);
    * an MMSS C5 backbone's ``backbone/body/layer4`` -> the C4 RoI
      extractor's ``layer4`` (the reference reaches the same routing
      via suffix matching, model_serialization.py:10-67), unless the
      target's trunk has a ``layer4`` of its own (the FPN body), which
      takes it (a divergence from JAX, see the comment below);
    * a GeneralizedRCNN source routes ``roi_extractor`` /
      ``*_predictor`` onto the ST ``teacher`` bundle (the student is
      then populated by prepare_model, st_generalized_rcnn.py:197-199);
    * an MMSS ``language_backbone`` fills the ST ``bert`` table;
    * classifier leaves skipped unless ``load_classifier``
      (checkpoint.py:125-126).

    Returns (new_params, report) with the torch importer's report shape.
    """
    tflat = _flatten_params(params)
    sflat = _flatten_params(source_params)
    t_tops = {p[0] for p in tflat if len(p) > 1}

    def emb_pred_base(bundle: str = "teacher") -> Optional[Tuple[str, ...]]:
        for cand in (
            ("box_predictor", "emb_pred"),
            (bundle, "box_predictor", "emb_pred"),
        ):
            if any(p[: len(cand)] == cand for p in tflat):
                return cand
        return None

    matched, missed = {}, []
    for spath, sval in sflat.items():
        # source-path surgeries, most specific first
        candidates = []
        if load_emb_pred_from_mmss_head and spath[0] in (
            "v2l_projection",
            f"v2l_projection_{default_mmss_head}",
        ):
            base = emb_pred_base()
            if base is not None:
                candidates.append(base + spath[1:])
        if spath[:3] == ("backbone", "body", "layer4") and spath not in tflat:
            # C5 pretraining backbone -> C4 detector's RoI extractor.  A
            # target whose trunk has its own C5 stage (the FPN body) takes
            # it there: JAX tries the extractor first, so it puts the
            # same-shaped leaves of an FPN teacher's trunk on the student's
            # teacher head and leaves the student's trunk stage unfilled
            for root in (("roi_extractor",), ("teacher", "roi_extractor")):
                candidates.append(root + spath[2:])
        if spath[0] == "language_backbone" and "bert" in t_tops:
            candidates.append(("bert",) + spath[1:])
        if spath[0] == "bert" and "language_backbone" in t_tops:
            candidates.append(("language_backbone",) + spath[1:])
        if spath[0] in (
            "roi_extractor",
            "box_predictor",
            "mask_predictor",
            "keypoint_predictor",
        ) and "teacher" in t_tops and spath[0] not in t_tops:
            candidates.append(("teacher",) + spath)
        candidates.append(spath)  # identity last

        if not load_classifier and "cls_score" in spath:
            continue
        placed = False
        for tpath in candidates:
            tgt = tflat.get(tpath)
            if tgt is not None and tuple(np.shape(tgt)) == tuple(np.shape(sval)):
                matched[tpath] = np.asarray(sval, dtype=np.asarray(tgt).dtype)
                placed = True
                break
        if not placed:
            missed.append("/".join(spath))

    new_flat = dict(tflat)
    new_flat.update(matched)
    report = {
        "matched": len(matched),
        "missed_source_keys": missed,
        "unfilled_targets": ["/".join(p) for p in tflat if p not in matched],
    }
    return _unflatten(new_flat), report


def populate_student_from_teacher(
    params: Dict[str, Any],
    teacher_key: str = "teacher",
    student_key: str = "student",
) -> Tuple[Dict[str, Any], int]:
    """prepare_model step 3 (reference st_generalized_rcnn.py:197-199):
    at iteration 0, unless ``MODEL.RESUME``, the student roi_heads are
    initialized as a copy of the (frozen) teacher roi_heads
    (``load_state_dict(teacher.state_dict(), strict=False)``).

    Copies every ``teacher/...`` leaf onto the same relative path under
    ``student/...`` when it exists with the same shape; student-only
    leaves (e.g. the uncertainty head's ``uncertain_pred``) are left at
    their fresh initialization, matching ``strict=False``.

    Returns (new_params, number_of_leaves_copied)."""
    flat = _flatten_params(params)
    out = dict(flat)
    copied = 0
    for path, v in flat.items():
        if not path or path[0] != teacher_key:
            continue
        spath = (student_key,) + path[1:]
        tgt = flat.get(spath)
        if tgt is not None and tuple(np.shape(tgt)) == tuple(np.shape(v)):
            # a distinct buffer: the student trains, the teacher does not
            out[spath] = np.array(v)
            copied += 1
    return _unflatten(out), copied


def _numpy_state_dict(blob) -> Dict[str, np.ndarray]:
    if isinstance(blob, dict) and "model" in blob:
        blob = blob["model"]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in blob.items()}


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Loads a reference torch .pth (or Caffe2-converted dict) to numpy."""
    return _numpy_state_dict(torch.load(path, map_location="cpu", weights_only=False))


def _read_weights(weight_path: str):
    """(path, raw blob) of the weights ``weight_path`` names: a port
    checkpoint (a file, or a directory whose ``last_checkpoint`` names
    one) or a torch ``.pth``."""
    path = weight_path
    if os.path.isdir(weight_path):
        path = latest_checkpoint(weight_path) or weight_path
        return path, load_checkpoint(path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"weights {weight_path}: no such file or directory")
    return path, torch.load(path, map_location="cpu", weights_only=False)


def import_language_table(params: Dict[str, Any], weight_path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Fills the (frozen) language backbone -- the BERT word-embedding
    table and, for full-encoder models, the encoder -- from another
    checkpoint (``MODEL.LANGUAGE_WEIGHT``): a teacher checkpoint carries
    no BERT (GeneralizedRCNN has none), so a student run started from it
    takes the table from an MMSS checkpoint or a reference ``.pth`` that
    registers ``bert.embeddings``."""
    _, blob = _read_weights(weight_path)
    if is_port_checkpoint(blob):
        sflat = _flatten_params(bridge.flax_tree_from_checkpoint(blob))
        keep = {p: v for p, v in sflat.items() if p and p[0] in ("bert", "language_backbone")}
        return import_flax_params(params, _unflatten(keep))
    sd = {k: v for k, v in _numpy_state_dict(blob).items() if "bert" in k or "language_backbone" in k}
    return import_torch_state_dict(params, sd)


def import_external_weights(params_tree, weight_path: str, cfg):
    """The MODEL.WEIGHT import chain of both entry points (reference
    utils/checkpoint.py:51-75 ``_load_file`` dispatch) on a flax-layout
    tree:

    * a port checkpoint (a file, or an ``OUTPUT_DIR`` whose
      ``last_checkpoint`` names one) -- cross-stage import in this
      framework's own vocabulary via :func:`import_flax_params`;
    * a Caffe2 ``.pkl`` -- ImageNet init blobs;
    * a torch ``.pth`` or state-dict file -- reference weights through
      :func:`apply_reference_key_surgery` and
      :func:`import_torch_state_dict`.

    Returns ``(new_params_tree, message)``; ``(params_tree, None)`` for
    an empty ``weight_path``.  A path that does not exist, and an orbax
    directory of the JAX package, raise.
    """
    if not weight_path:
        return params_tree, None
    surgery = dict(
        load_emb_pred_from_mmss_head=cfg.MODEL.LOAD_EMB_PRED_FROM_MMSS_HEAD,
        default_mmss_head=cfg.MODEL.MMSS_HEAD.DEFAULT_HEAD,
        load_classifier=cfg.MODEL.LOAD_CLASSIFIER,
    )
    if weight_path.endswith(".pkl"):
        from .c2_loading import import_c2_imagenet_weights

        if not os.path.exists(weight_path):
            raise FileNotFoundError(f"weights {weight_path}: no such file")
        new_params, report = import_c2_imagenet_weights(params_tree, weight_path)
        return new_params, f"imported {report['matched']} caffe2 blobs"
    path, blob = _read_weights(weight_path)
    if is_port_checkpoint(blob):
        src = bridge.flax_tree_from_checkpoint(blob)
        new_params, report = import_flax_params(params_tree, src, **surgery)
        return new_params, (
            f"imported {report['matched']} leaves from checkpoint {path} "
            f"({len(report['missed_source_keys'])} source leaves unmatched)"
        )
    sd = apply_reference_key_surgery(
        _numpy_state_dict(blob), backbone_prefix=cfg.MODEL.BACKBONE_PREFIX, **surgery
    )
    new_params, report = import_torch_state_dict(params_tree, sd)
    return new_params, (
        f"imported {report['matched']} torch tensors "
        f"({len(report['missed_source_keys'])} source keys unmatched)"
    )
