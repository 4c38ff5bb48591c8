"""End-to-end noisy-pseudo-label ablation at the AP level (the
counterpart of ``tools/ablate_st_e2e.py``):

    python -m cvpr22_cross_modal_pseudo_labeling_torch.tools.ablate_st_e2e \\
        [--steps 400] [--corrupt 0.5] [--seed 0] [--device cuda|cpu] \\
        [--dtype float32|bfloat16] [--params NPZ] [--conditions A,B] \\
        [--nudge ULPS] [--deterministic]

It trains the port's ``STGeneralizedRCNN`` (caption branch, proposal
matching, RoI sampling, the per-pixel attenuated mask loss, the adaptive
``0.01 / avg_uncertain`` branch weight where ``MODEL.REWEIGHT`` asks for
it) under pseudo-labels whose masks are complemented at a controlled
rate, and compares the held-out GT-box mask AP50 of the conditions in
:data:`CONDITIONS`: plain BCE (``fixed``), the ``sampled_bce`` and
``logmeanexp`` estimators at a fixed branch weight (``logmeanexp`` with
sigma capped at 4, and unbounded), and both estimators with the
adaptive weight.

The experiment is JAX's: a "perfect boxes, noisy masks" teacher.  The
``_override_pseudo`` hook of :class:`ControlledPseudoST` puts in the gt
boxes and labels with each example's mask complemented with probability
``corrupt`` (fixed per example); the detection branch is off
(``det_mask`` False), so only the pseudo branch trains the student; the
backbone, RPN and teacher are frozen by the student-teacher model.  The
data (:func:`make_detection_data`, one 48-72 px circle or diamond per 96
x 96 image, 28 x 28 gt rasters) is a numpy copy of JAX's, bit-equal for
a seed, and so are the corruption pattern and the batch order.  The
optimizer is JAX's ``optax.chain(clip_by_global_norm(10), sgd(0.002,
momentum=0.9))`` over every parameter that gets a gradient, the
student's frozen-BN statistics included (optax's chain trains every
leaf): the port's ``engine/optimizer.py::Optimizer`` with
:func:`ablation_cfg`'s solver.  Held-out scoring follows ``GT_BOX_EVAL``: the
student heads run on the gt boxes, and a true positive needs the right
class argmax and a mask IoU of at least 0.5 with the clean raster.

The weights are drawn with numpy from ``--seed`` out of the
distributions of JAX's ``model.init`` (:func:`jax_init_params`), or read
from ``--params`` (an npz of flax paths, e.g. JAX's own ``model.init``
dumped where jax runs: ``tests/test_torch_ablate_st_e2e.py::
dump_jax_init``).  The CPU tests hold two steps of the tool against JAX's
on the same weights and draws.  Prints one JSON line, as JAX's tool
does.
"""

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

LVIS_SLOTS = 5  # toy LVIS vocabulary; labels 1 (circle) / 2 (diamond)
EMB = 16
HW = 96
M2 = 28  # gt raster resolution in the box frame

CONDITIONS = (
    # name, uncertainty, estimator, n_samples, reweight, sigma_max
    ("fixed", False, "sampled_bce", 1, False, 0.0),
    ("sampled_bce", True, "sampled_bce", 1, False, 0.0),
    ("logmeanexp", True, "logmeanexp", 8, False, 4.0),
    ("logmeanexp_unbounded", True, "logmeanexp", 8, False, 0.0),
    ("sampled_bce_adaptive", True, "sampled_bce", 1, True, 0.0),
    ("logmeanexp_adaptive", True, "logmeanexp", 8, True, 4.0),
)


def make_detection_data(rng, n, hw=HW, m2=M2):
    """One bright square-box shape per image on a dark noisy background:
    a circle (label 1) or a diamond (label 2), so that a class-agnostic
    mask head must read the image.  Square 48-72 px shapes against the
    frozen RPN's square anchors (48-72 at stride 16) guarantee a
    proposal of IoU >= 0.45 for every target.  Returns ``(images [n,
    hw, hw, 3] float32 in 0..255, boxes [n, 1, 4], labels [n, 1] int32,
    masks [n, 1, m2, m2])``, bit-equal to JAX's tool for the same
    ``np.random.RandomState``."""
    images = (rng.rand(n, hw, hw, 3) * 0.15).astype(np.float32)
    boxes = np.zeros((n, 1, 4), np.float32)
    labels = np.zeros((n, 1), np.int32)
    masks = np.zeros((n, 1, m2, m2), np.float32)
    yy, xx = np.mgrid[0:hw, 0:hw]
    gy, gx = np.mgrid[0:m2, 0:m2]
    for i in range(n):
        w = h = rng.randint(48, 73)
        x0 = rng.randint(2, hw - w - 2)
        y0 = rng.randint(2, hw - h - 2)
        cx, cy, rx, ry = x0 + w / 2, y0 + h / 2, w / 2, h / 2
        lab = 1 + (i % 2)
        if lab == 1:  # ellipse
            inside = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1.0
            gin = ((gx + 0.5) / m2 - 0.5) ** 2 / 0.25 + ((gy + 0.5) / m2 - 0.5) ** 2 / 0.25 <= 1.0
        else:  # diamond
            inside = np.abs(xx - cx) / rx + np.abs(yy - cy) / ry <= 1.0
            gin = np.abs((gx + 0.5) / m2 - 0.5) / 0.5 + np.abs((gy + 0.5) / m2 - 0.5) / 0.5 <= 1.0
        color = np.array([0.9, 0.3, 0.2] if lab == 1 else [0.2, 0.4, 0.9], np.float32)
        images[i][inside] = color + 0.05 * rng.randn(int(inside.sum()), 3).astype(np.float32)
        boxes[i, 0] = (x0, y0, x0 + w, y0 + h)
        labels[i, 0] = lab
        masks[i, 0] = gin.astype(np.float32)
    images = np.clip(images, 0.0, 1.0) * 255.0
    return images, boxes, labels, masks


def ablation_cfg():
    """JAX's ``ablation_cfg``: the defaults (R-50-C4 at full width,
    float32) with the frozen RPN's square anchors, every anchor kept as a
    caption-branch candidate (NMS at 0.95), 16 rois an image, all
    positive, and EMB_DIM 16; and the solver that gives the port's
    ``Optimizer`` the update of JAX's optax chain."""
    from ..config import get_default_cfg

    cfg = get_default_cfg()
    cfg.MODEL.META_ARCHITECTURE = "STGeneralizedRCNN"
    cfg.MODEL.MASK_ON = True
    cfg.MODEL.CLS_AGNOSTIC_BBOX_REG = True
    cfg.MODEL.CLS_AGNOSTIC_MASK = True
    cfg.MODEL.RPN.DONT_TRAIN = True
    cfg.MODEL.ROI_BOX_HEAD.EMBEDDING_BASED = True
    cfg.MODEL.ROI_BOX_HEAD.EMB_DIM = EMB
    cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 1.0
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 16
    cfg.MODEL.ROI_HEADS.DETECTIONS_PER_IMG = 8
    cfg.MODEL.RPN.ANCHOR_SIZES = (48, 56, 64, 72)
    cfg.MODEL.RPN.ASPECT_RATIOS = (1.0,)
    cfg.MODEL.RPN.NMS_THRESH = 0.95
    cfg.MODEL.ROI_HEADS.FG_IOU_THRESHOLD = 0.45
    cfg.MODEL.ROI_HEADS.BG_IOU_THRESHOLD = 0.45
    cfg.MODEL.RPN.PRE_NMS_TOP_N_TEST = 256
    cfg.MODEL.RPN.POST_NMS_TOP_N_TEST = 160
    cfg.MODEL.RPN.PRE_NMS_TOP_N_TRAIN = 256
    cfg.MODEL.RPN.POST_NMS_TOP_N_TRAIN = 160
    cfg.TPU.MAX_GT = 2
    cfg.TPU.MAX_CAP_NOUNS = 1
    cfg.TPU.NMS_TILE = 256
    # the pseudo losses are unweighted here (lambda 1.0, production's is
    # 0.1): a small LR, clipped, alike in every condition
    cfg.SOLVER.BASE_LR = 0.002
    # JAX's optax.chain(clip_by_global_norm(10), sgd(0.002, momentum=0.9)):
    # one constant LR for every parameter, no weight decay, no warmup
    cfg.SOLVER.CLIP_GRAD_NORM_AT = 10.0
    cfg.SOLVER.MOMENTUM = 0.9
    cfg.SOLVER.WEIGHT_DECAY = 0.0
    cfg.SOLVER.WEIGHT_DECAY_BIAS = 0.0
    cfg.SOLVER.BIAS_LR_FACTOR = 1
    cfg.SOLVER.UNCERTAINTY_LR_FACTOR = 1.0
    cfg.SOLVER.WARMUP_ITERS = 0
    cfg.SOLVER.STEPS = ()
    cfg.MODEL.UNCERTAINTY_TRAIN_ITER = 0
    return cfg


def train_frozen_bn(module: torch.nn.Module) -> None:
    """Makes the four statistics of every ``FrozenBatchNorm`` under
    ``module`` parameters: JAX's frozen BN keeps them as params, and the
    ablation's optax chain trains every leaf that has a gradient."""
    from ..models.resnet import FrozenBatchNorm

    for m in module.modules():
        if isinstance(m, FrozenBatchNorm):
            for name in ("weight", "bias", "running_mean", "running_var"):
                m.register_parameter(name, torch.nn.Parameter(m._buffers.pop(name)))


def _truncated_normal(rng, shape, std):
    """flax's ``truncated_normal``: N(0, 1) cut at +-2, scaled so that the
    cut distribution has standard deviation ``std``."""
    x = rng.standard_normal(shape)
    out = np.abs(x) > 2.0
    while out.any():
        x[out] = rng.standard_normal(int(out.sum()))
        out = np.abs(x) > 2.0
    return (x * (std / 0.87962566103423978)).astype(np.float32)


def jax_init_params(model: torch.nn.Module, seed: int):
    """A flax-layout tree for the ablation model drawn with numpy from
    ``seed`` out of the distributions of JAX's ``model.init`` (the JAX
    tool's init; jax.random's bits are not reproduced): flax's
    ``lecun_normal`` for the convs (fan-in variance, truncated at 2 sigma),
    the frozen BN the identity, the RPN convs, ``emb_pred`` and
    ``cls_score`` N(0, 0.01), the box regression and ``uncertain_pred``
    N(0, 0.001) (its bias 1), the mask head's convs
    ``variance_scaling(2, fan_out)``, the word table N(0, 0.02), other
    biases and ``lambda_exemplar`` 0."""
    from .. import bridge

    rng = np.random.default_rng(seed)

    def draw(path, value):
        leaf, owner, shape = path[-1], path[-2] if len(path) > 1 else "", value.shape
        if leaf in ("frozen_bn_weight", "frozen_bn_var") or (leaf == "bias" and owner == "uncertain_pred"):
            return np.ones(shape, np.float32)
        if leaf in ("frozen_bn_bias", "frozen_bn_mean", "bias", "lambda_exemplar"):
            return np.zeros(shape, np.float32)
        if leaf == "word_embeddings":
            return rng.standard_normal(shape, np.float32) * np.float32(0.02)
        if leaf != "kernel":
            raise KeyError(f"no JAX initializer known for {'/'.join(path)}")
        if "rpn_head" in path or owner in ("emb_pred", "cls_score"):
            return rng.standard_normal(shape, np.float32) * np.float32(0.01)
        if owner in ("bbox_pred", "uncertain_pred"):
            return rng.standard_normal(shape, np.float32) * np.float32(0.001)
        receptive = int(np.prod(shape[:-2]))
        if owner in ("conv5_mask", "mask_fcn_logits"):
            return _truncated_normal(rng, shape, np.sqrt(2.0 / (shape[-1] * receptive)))
        return _truncated_normal(rng, shape, np.sqrt(1.0 / (shape[-2] * receptive)))

    def walk(node, path):
        return {k: walk(v, path + (k,)) if isinstance(v, dict) else draw(path + (k,), v) for k, v in node.items()}

    return walk(bridge.flax_from_state_dict(model), ())


def load_params(path: str, model: torch.nn.Module):
    """The flax-layout tree of an npz of ``/``-joined flax paths (a dump of
    ``tools/orbax_to_npz.py``, or of a JAX ``model.init``), cut to the
    leaves ``model`` has (a condition without the uncertainty head takes
    none of its leaves); a leaf the model has and the npz lacks raises."""
    from .. import bridge
    from ..engine.jax_checkpoint import params_tree, read_dump

    tree = params_tree(read_dump(path))

    def cut(node, like):
        return {k: cut(node[k], v) if isinstance(v, dict) else node[k] for k, v in like.items()}

    return cut(tree, bridge.flax_from_state_dict(model))


def nudge_params(tree, ulps: int):
    """``tree`` with every float32 weight that is not a constant moved
    ``ulps`` float32 ulps up: the smallest change of the initial weights,
    to show how far rounding alone moves the study's outcome."""
    def nudge(v):
        if v.dtype != np.float32 or not v.std():
            return v
        for _ in range(ulps):
            v = np.nextafter(v, np.float32(np.inf))
        return v

    return {k: nudge_params(v, ulps) if isinstance(v, dict) else nudge(v) for k, v in tree.items()}


def build_model(uncertainty: bool, estimator: str, n_samples: int, reweight: bool = False,
                sigma_max: float = 0.0, dtype: str = "float32"):
    """``(ControlledPseudoST, cfg)`` of one condition: every branch weight
    1.0 unless ``reweight``, so that without it only the mask loss's
    estimator differs."""
    from ..models.detector.st_generalized_rcnn import PseudoLabels, STGeneralizedRCNN, st_statics_from_cfg

    class ControlledPseudoST(STGeneralizedRCNN):
        """The ``_override_pseudo`` experiment: perfect boxes and labels,
        masks corrupted outside the model, all detached; the student's
        frozen-BN statistics train.  The hook replaces every field of
        the teacher's pseudo-labels that a loss reads, so the teacher's
        pass is dead code, which XLA removes from JAX's jitted step: it
        is not run here either (``generate_pseudo_labels`` gives None)."""

        def __init__(self, statics):
            super().__init__(statics)
            train_frozen_bn(self.student)

        def generate_pseudo_labels(self, *args):
            return None

        def _override_pseudo(self, pseudo, batch):
            valid = batch["pseudo_valid"]
            return PseudoLabels(
                boxes=batch["pseudo_boxes"].detach(),
                scores=valid.to(torch.float32),
                valid=valid,
                labels=batch["pseudo_labels"].to(torch.int64),
                masks=batch["pseudo_masks"].detach() if self.statics.base.mask_on else None,
            )

    cfg = ablation_cfg()
    cfg.MODEL.UNCERTAINTY = uncertainty
    cfg.MODEL.REWEIGHT = reweight
    cfg.MODEL.LAMBDA_PSEUDO_LABEL = 1.0
    cfg.MODEL.ROI_MASK_HEAD.UNCERTAINTY_ESTIMATOR = estimator
    cfg.MODEL.ROI_MASK_HEAD.UNCERTAINTY_SAMPLES = n_samples
    # unbounded, logmeanexp's sigma can run away at 50% mask noise (JAX's
    # record); the cap is the shipped recipe for that estimator
    cfg.MODEL.ROI_MASK_HEAD.UNCERTAINTY_SIGMA_MAX = sigma_max
    cfg.TPU.COMPUTE_DTYPE = dtype
    statics = st_statics_from_cfg(cfg)._replace(vocab_size=64, lvis_vocab=LVIS_SLOTS)
    return ControlledPseudoST(statics), cfg


def make_batch(images, boxes, labels, masks, corrupt, lvis_table, device) -> Dict[str, torch.Tensor]:
    """A training batch on ``device``: the caption branch only
    (``det_mask`` False), the pseudo overrides carrying the gt boxes and
    labels and the per-example corrupted masks."""
    b = images.shape[0]
    pseudo_masks = np.where(corrupt[:, None, None, None], 1.0 - masks, masks).astype(np.float32)
    host = {
        "images": torch.from_numpy(np.ascontiguousarray(images, np.float32)),
        "image_sizes": torch.tensor([[HW, HW]] * b, dtype=torch.int32),
        "cap_mask": torch.ones((b,), dtype=torch.bool),
        "det_mask": torch.zeros((b,), dtype=torch.bool),
        "cap_tok_ids": torch.full((b, 1, 2), 7, dtype=torch.int64),
        "cap_tok_mask": torch.ones((b, 1, 2), dtype=torch.float32),
        "cap_word_valid": torch.ones((b, 1), dtype=torch.bool),
        "cap_labels": torch.from_numpy(labels.astype(np.int64)),
        "pseudo_boxes": torch.from_numpy(np.ascontiguousarray(boxes, np.float32)),
        "pseudo_labels": torch.from_numpy(labels.astype(np.int64)),
        "pseudo_valid": torch.ones((b, 1), dtype=torch.bool),
        "pseudo_masks": torch.from_numpy(pseudo_masks),
        # the detection branch's placeholders (masked out by det_mask)
        "gt_boxes": torch.zeros((b, 2, 4), dtype=torch.float32),
        "gt_labels": torch.zeros((b, 2), dtype=torch.int64),
        "gt_valid": torch.zeros((b, 2), dtype=torch.bool),
        "gt_masks": torch.zeros((b, 2, M2, M2), dtype=torch.float32),
        "class_embeddings": torch.from_numpy(lvis_table),
        "lvis_class_embeddings": torch.from_numpy(lvis_table),
    }
    return {k: v.to(device, non_blocking=True) for k, v in host.items()}


@torch.no_grad()
def gtbox_metrics(model, images, boxes, labels, masks, lvis_table, device) -> Dict[str, float]:
    """``GT_BOX_EVAL`` on held-out data: the student heads on the gt
    boxes; a true positive has the right class argmax (background column
    0 skipped) and a mask IoU >= 0.5 with the clean gt raster, compared at
    the raster's resolution (nearest upsampling of the head's output)."""
    from ..models.backbone import device_normalize
    from ..models.detector.st_generalized_rcnn import normalize_rows
    from ..models.roi_heads.mask_head import mask_head_inference

    sb = model.statics.base
    b = images.shape[0]
    im = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(device)
    sizes = torch.tensor([[HW, HW]] * b, dtype=torch.int32, device=device)
    feats = model.backbone(device_normalize(im, sizes, sb.pixel_mean, sb.pixel_std, sb.to_bgr255))
    x = model.student.extract(feats, torch.from_numpy(np.ascontiguousarray(boxes, np.float32)).to(device))
    table = torch.from_numpy(lvis_table).to(device)
    logits, _, _ = model.student.box_outputs(x, normalize_rows(table))
    mask_logits, _ = model.student.mask_outputs(x)
    probs = mask_head_inference(mask_logits.to(torch.float32),
                                torch.ones(mask_logits.shape[0], dtype=torch.int64, device=device), True)
    pred_masks = probs.cpu().numpy() >= 0.5
    if pred_masks.shape[-1] != M2:
        f = M2 // pred_masks.shape[-1]
        pred_masks = pred_masks.repeat(f, axis=-2).repeat(f, axis=-1)
    gt = masks.reshape(-1, M2, M2) >= 0.5
    inter = (pred_masks & gt).sum((1, 2))
    union = (pred_masks | gt).sum((1, 2))
    iou = inter / np.maximum(union, 1)
    pred_label = 1 + torch.argmax(logits.to(torch.float32)[:, 1:], dim=-1).cpu().numpy()
    correct = pred_label == labels.reshape(-1)
    return {
        "gtbox_mask_ap50": float((correct & (iou >= 0.5)).mean()),
        "mean_mask_iou": float(iou.mean()),
        "cls_acc": float(correct.mean()),
    }


def run_condition(
    name: str,
    uncertainty: bool,
    estimator: str,
    n_samples: int,
    steps: int,
    corrupt_rate: float,
    seed: int = 0,
    batch_size: int = 8,
    n_train: int = 64,
    n_held: int = 32,
    reweight: bool = False,
    sigma_max: float = 0.0,
    device: str = "cuda",
    dtype: str = "float32",
    params=None,
    draws: Optional[Callable[[int], object]] = None,
    record: Optional[Dict] = None,
    on_step: Optional[Callable[[int], None]] = None,
) -> Dict[str, float]:
    """Trains one condition for ``steps`` steps and scores it on held-out
    data; returns the ``gtbox_metrics`` and the last step's
    ``loss_mask_pseudo``.  ``params``: a flax-layout tree of initial
    weights (default: :func:`jax_init_params` of ``seed``, JAX's init
    distributions); ``draws(step)``: the step's ``TrainDraws`` (default:
    a generator seeded ``seed``); ``record``, a dict that receives the
    model, its ``Optimizer`` and each step's metrics (``record["steps"]``);
    ``on_step(step)`` is called before each step and once more, with
    ``steps``, after the last.  Raises on a non-finite loss, or when
    ``loss_mask_pseudo`` stays 0 (no positive roi all run)."""
    from .. import bridge
    from ..engine.optimizer import Optimizer, frozen_prefixes_from_cfg
    from ..engine.train_step import training_forward
    from ..models.detector.generalized_rcnn import TrainDraws

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ablate_st_e2e: no CUDA device is available; pass device='cpu' to run on the CPU")
    rng = np.random.RandomState(seed)
    tr_im, tr_bx, tr_lb, tr_mk = make_detection_data(rng, n_train)
    he_im, he_bx, he_lb, he_mk = make_detection_data(np.random.RandomState(seed + 100), n_held)
    corrupt = rng.rand(n_train) < corrupt_rate
    lvis_table = np.random.RandomState(5).randn(LVIS_SLOTS, EMB).astype(np.float32)

    model, cfg = build_model(uncertainty, estimator, n_samples, reweight, sigma_max, dtype)
    bridge.load_flax_params(model, params if params is not None else jax_init_params(model, seed))
    model = model.to(device).train()
    # the student-teacher model's frozen parts stay frozen (their
    # gradients are zero in JAX); every other parameter that gets a
    # gradient trains, the student's frozen-BN statistics included
    opt = Optimizer(cfg, model, frozen_prefixes_from_cfg(cfg, "STGeneralizedRCNN"))
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    if record is not None:
        record.update(model=model, optimizer=opt, steps=[])

    order = np.arange(n_train)
    totals: List[torch.Tensor] = []
    mask_losses: List[torch.Tensor] = []
    for it in range(steps):
        if it % (n_train // batch_size) == 0:
            rng.shuffle(order)
        start = (it * batch_size) % n_train
        sel = order[start:start + batch_size]
        b = make_batch(tr_im[sel], tr_bx[sel], tr_lb[sel], tr_mk[sel], corrupt[sel], lvis_table, device)
        if on_step is not None:
            on_step(it)
        out = training_forward(model, "STGeneralizedRCNN", b, draws(it) if draws else TrainDraws(), generator)
        total = sum(out.losses.values())
        opt.zero_grad()
        total.backward()
        grad_norm = opt.step()
        totals.append(total.detach())
        mask_losses.append(out.losses["loss_mask_pseudo"].detach())
        if record is not None:
            record["steps"].append({**{k: v.detach() for k, v in out.losses.items()},
                                    **{k: v.detach() for k, v in out.info.items()},
                                    "total_loss": total.detach(), "grad_norm": grad_norm})
    if on_step is not None:
        on_step(steps)
    # one copy to the host for the run, not one a step
    finite = torch.isfinite(torch.stack(totals)).cpu().numpy() if totals else np.ones(0, bool)
    if not finite.all():
        raise RuntimeError(f"{name}: non-finite loss at step {int(np.argmin(finite))}")
    mask_host = torch.stack(mask_losses).float().cpu().numpy() if mask_losses else np.zeros(1)
    if mask_host.max() == 0.0:
        # no positive roi all run: the anchor-coverage premise failed and
        # the conditions would compare nothing
        raise RuntimeError(
            f"{name}: loss_mask_pseudo stayed 0.0 for {steps} steps "
            "(no positive RoIs: check anchor coverage against the shape sizes)"
        )
    model.eval()
    out = gtbox_metrics(model, he_im, he_bx, he_lb, he_mk, lvis_table, device)
    out["final_loss_mask_pseudo"] = float(mask_host[-1])
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description="end-to-end noisy pseudo-label ablation (PyTorch port)")
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--corrupt", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    p.add_argument("--params", default="", metavar="NPZ",
                   help="initial weights: an npz of flax paths (default: drawn from --seed)")
    p.add_argument("--conditions", default=",".join(c[0] for c in CONDITIONS),
                   help="comma-separated names of the conditions to run (default: all)")
    p.add_argument("--nudge", type=int, default=0, metavar="ULPS",
                   help="move every initial weight that is not a constant this many float32 ulps up")
    p.add_argument("--deterministic", action="store_true",
                   help="torch.use_deterministic_algorithms(True) (the port's kernels are deterministic)")
    args = p.parse_args(argv)
    names = args.conditions.split(",")
    unknown = set(names) - {c[0] for c in CONDITIONS}
    if unknown:
        raise SystemExit(f"unknown conditions {sorted(unknown)}; choose from {[c[0] for c in CONDITIONS]}")
    # float32 means float32: no TF32 in cuDNN's convolutions
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.deterministic:
        # cuBLAS reads this at its first handle
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.benchmark = False
    results = {}
    for name, unc, est, ns, rw, sm in CONDITIONS:
        if name not in names:
            continue
        t = time.perf_counter()
        model = build_model(unc, est, ns)[0]
        params = load_params(args.params, model) if args.params else jax_init_params(model, args.seed)
        results[name] = run_condition(name, unc, est, ns, args.steps, args.corrupt, seed=args.seed,
                                      reweight=rw, sigma_max=sm, device=args.device, dtype=args.dtype,
                                      params=nudge_params(params, args.nudge))
        print(f"# {name}: {results[name]} ({time.perf_counter() - t:.1f} s)", file=sys.stderr)
    report = {"metric": "st_e2e_noisy_pseudo_ablation", "corrupt_rate": args.corrupt, "steps": args.steps,
              "seed": args.seed, "dtype": args.dtype, "params": args.params or "jax_init_params",
              "nudge": args.nudge, "deterministic": args.deterministic, "conditions": results}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
