"""The port's class-specific heads against the JAX package, on the CPU.

maskrcnn_benchmark's supervised R-50-C4 detector, the JAX package's
defaults: ``cls_score`` over ``NUM_CLASSES``, one box per class
(``bbox_pred`` of ``4 * NUM_CLASSES``), masks of a channel per class, and
no class-embedding table.  The pieces (``BoxPredictor``,
``box_head_loss`` with the baselines' ``sample_weights`` and
``focal_gamma``, ``postprocess_boxes`` with ties and
``gt_override_labels``, ``mask_head_loss`` and ``mask_head_inference``)
on numpy inputs drawn from a seed, then the whole ``GeneralizedRCNN``
at the narrow width of ``tests/test_torch_teacher.py`` (stem 8, res2 16,
width 4, 6 classes, RPN 128 -> 32, 16 rois and 8 mask rois per image,
64 x 64 images): two train steps on JAX's replayed draws, the eval
forward with and without masks, and ``MODEL.GT_BOX_EVAL``.  The weight
importers take a maskrcnn_benchmark state dict of such a model bit for
bit.

Tolerances (float32): the pieces' outputs and gradients 1e-6 relative
(1e-5 for the focal factor's power); boxes 1e-3 px (1e-4 for the
pieces), scores 1e-5, mask probabilities 1e-4, labels and valid flags
equal; losses 1e-5 relative, 1e-4 after a step; each parameter's update
within 1e-3 of the JAX update's norm (as in ``tests/test_torch_
teacher.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.config import get_default_cfg as jax_cfg
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import checkpoint as jax_ckpt
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import optimizer as jax_opt
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import train_step as jax_train
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import generalized_rcnn as jax_grcnn
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import statics as jax_statics
from cvpr22_cross_modal_pseudo_labeling_tpu.models.roi_heads import box_head as jax_box
from cvpr22_cross_modal_pseudo_labeling_tpu.models.roi_heads import mask_head as jax_mask
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.engine import checkpoint as torch_ckpt
from cvpr22_cross_modal_pseudo_labeling_torch.engine.inference import Predictor
from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.generalized_rcnn import GeneralizedRCNN
from cvpr22_cross_modal_pseudo_labeling_torch.models.roi_heads import box_head as torch_box
from cvpr22_cross_modal_pseudo_labeling_torch.models.roi_heads import mask_head as torch_mask
from tests.test_torch_checkpoint import assert_trees_equal, reference_names
from tests.test_torch_teacher import JaxDraws, _rel_norm
from tests.test_torch_teacher import tiny_batch as teacher_batch

NUM_CLASSES = 6
# the JAX defaults (class-specific boxes and masks, no class table) at
# the teacher tests' narrow width
OPTS = [
    "MODEL.MASK_ON", True,
    "MODEL.ROI_BOX_HEAD.NUM_CLASSES", NUM_CLASSES,
    "MODEL.RESNETS.STEM_OUT_CHANNELS", 8,
    "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
    "MODEL.RESNETS.WIDTH_PER_GROUP", 4,
    "MODEL.RPN.PRE_NMS_TOP_N_TEST", 128,
    "MODEL.RPN.POST_NMS_TOP_N_TEST", 32,
    "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 128,
    "MODEL.RPN.POST_NMS_TOP_N_TRAIN", 32,
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 16,
    "MODEL.ROI_MASK_HEAD.CONV_LAYERS", (8,),
    "TPU.MASK_POS_CAP", 8,
    "TPU.MAX_GT", 4,
    "TPU.COMPUTE_DTYPE", "float32",
    "TPU.NMS_TILE", 64,
]
LOSSES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg", "loss_mask")
RCNN_KEYS = ("images", "image_sizes", "gt_boxes", "gt_labels", "gt_valid", "gt_masks")


def tiny_batch(variant="three_gt", seed=1):
    """The teacher tests' batch without its class table (labels 1-5)."""
    batch = teacher_batch(variant, seed)
    del batch["class_embeddings"]
    return batch


def jax_cfg_of(opts=()):
    cfg = jax_cfg()
    cfg.merge_from_list(OPTS + list(opts))
    return cfg


def make_setup(opts=()):
    trainer = Trainer("", OPTS + list(opts), device="cpu", seed=3)
    tree = bridge.seeded_flax_params(trainer.model, seed=0)
    trainer.load_flax_params(tree)
    cfg = jax_cfg_of(opts)
    model = jax_grcnn.GeneralizedRCNN(jax_statics.statics_from_cfg(cfg))
    params = {"params": jax.tree_util.tree_map(jnp.asarray, tree)}
    return dict(trainer=trainer, tree=tree, cfg=cfg, model=model, params=params)


@pytest.fixture(scope="module")
def masks_on():
    return make_setup()


@pytest.fixture(scope="module")
def masks_off():
    return make_setup(["MODEL.MASK_ON", False])


def jax_batch(batch):
    return {k: jnp.asarray(batch[k]) for k in RCNN_KEYS}


# ---------------------------------------------------------------------------
# the pieces


@pytest.mark.parametrize("agnostic", [False, True])
def test_class_specific_box_predictor_matches_jax(agnostic):
    """``cls_score`` and ``bbox_pred`` (8 columns when class-agnostic,
    else 4 a class) on the same weights; no embeddings, no table."""
    rng = np.random.default_rng(0)
    vec = rng.standard_normal((10, 32)).astype(np.float32)
    jm = jax_box.BoxPredictor(embedding_based=False, num_classes=NUM_CLASSES, cls_agnostic_bbox_reg=agnostic)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(vec))
    logits, deltas, emb = jm.apply(params, jnp.asarray(vec))
    tm = torch_box.BoxPredictor(in_channels=32, embedding_based=False, num_classes=NUM_CLASSES,
                                cls_agnostic_bbox_reg=agnostic)
    assert not hasattr(tm, "emb_pred") and emb is None
    bridge.load_flax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        got = tm(torch.from_numpy(vec))
    assert got[2] is None and got[1].shape == (10, 8 if agnostic else 4 * NUM_CLASSES)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(logits), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(deltas), rtol=1e-6, atol=1e-6)


def sampled_rois(rng, b=2, s=12, classes=NUM_CLASSES):
    """A ``SampledRoIs`` of both packages: labels 0 (background) to
    ``classes - 1``, a few invalid slots, positives the valid
    foreground ones."""
    labels = rng.integers(0, classes, (b, s)).astype(np.int32)
    labels[:, -4:] = 0
    valid = rng.random((b, s)) > 0.15
    is_pos = (labels > 0) & valid
    boxes = rng.uniform(0, 40, (b, s, 4)).astype(np.float32)
    boxes[..., 2:] += boxes[..., :2] + 4
    fields = dict(boxes=boxes, labels=labels, reg_targets=rng.standard_normal((b, s, 4)).astype(np.float32),
                  valid=valid, is_pos=is_pos, matched_gt=rng.integers(0, 3, (b, s)).astype(np.int32))
    jax_s = jax_box.SampledRoIs(**{k: jnp.asarray(v) for k, v in fields.items()})
    torch_s = torch_box.SampledRoIs(**{k: torch.from_numpy(v).to(torch.int64) if v.dtype == np.int32
                                       else torch.from_numpy(v) for k, v in fields.items()})
    return jax_s, torch_s


@pytest.mark.parametrize("agnostic,weights,gamma", [
    (True, False, None), (False, False, None), (False, True, None), (False, False, 1.5), (False, True, 1.5),
])
def test_box_head_loss_matches_jax(agnostic, weights, gamma):
    """Both losses and their gradients in the logits and deltas.  The
    class-specific regression reads each positive's label columns; the
    background rois read class 0's and get no gradient there."""
    rng = np.random.default_rng(1)
    jax_s, torch_s = sampled_rois(rng)
    n = 24
    logits = rng.standard_normal((n, NUM_CLASSES)).astype(np.float32)
    deltas = rng.standard_normal((n, 8 if agnostic else 4 * NUM_CLASSES)).astype(np.float32)
    sw = rng.uniform(0.2, 1.0, (2, 12)).astype(np.float32) if weights else None
    kw = dict(bg_weight=0.7, cls_agnostic_bbox_reg=agnostic, focal_gamma=gamma)

    def jax_loss(lg, dl):
        c, bx = jax_box.box_head_loss(lg, dl, jax_s, sample_weights=None if sw is None else jnp.asarray(sw), **kw)
        return c + 3.0 * bx, (c, bx)

    (jg_l, jg_d), (jc, jb) = jax.grad(jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(logits), jnp.asarray(deltas))
    tl = torch.from_numpy(logits).requires_grad_()
    td = torch.from_numpy(deltas).requires_grad_()
    c, bx = torch_box.box_head_loss(tl, td, torch_s, sample_weights=None if sw is None else torch.from_numpy(sw), **kw)
    (c + 3.0 * bx).backward()
    tol = 1e-5 if gamma else 1e-6
    np.testing.assert_allclose(c.item(), float(jc), rtol=tol)
    np.testing.assert_allclose(bx.item(), float(jb), rtol=1e-6)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jg_l), rtol=tol, atol=1e-7)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(jg_d), rtol=1e-6, atol=1e-7)
    assert bx.item() > 0 and c.item() > 0
    pos = torch_s.is_pos.reshape(-1).numpy()
    assert not td.grad.numpy()[~pos].any()  # background rows: no box gradient
    if not agnostic:
        # a positive's gradient lies in its own label's four columns
        lab = torch_s.labels.reshape(-1).numpy()
        for i in np.nonzero(pos)[0]:
            row = td.grad.numpy()[i].reshape(NUM_CLASSES, 4)
            assert row[lab[i]].any() and not np.delete(row, lab[i], axis=0).any()


def postprocess_inputs(rng, b=2, s=20, classes=NUM_CLASSES, ties=True):
    logits = rng.standard_normal((b, s, classes)).astype(np.float32)
    if ties:
        # rows repeated: equal scores for many (roi, class) candidates
        logits[:, 10:] = logits[:, :10]
        logits = np.round(logits * 2) / 2
    props = rng.uniform(0, 50, (b, s, 4)).astype(np.float32)
    props[..., 2:] += props[..., :2] + 6
    deltas = (rng.standard_normal((b, s, 4 * classes)) * 0.5).astype(np.float32)
    valid = rng.random((b, s)) > 0.1
    sizes = np.array([[64, 64], [48, 60]], np.int32)
    return logits, deltas, props, valid, sizes


@pytest.mark.parametrize("case", ["ties", "gt_override"])
def test_class_specific_postprocess_matches_jax(case):
    """Per-class decoding and clipping, the top 100 (roi, class) pairs
    and the per-class NMS; one roi's candidates under two labels carry
    two boxes.  ``gt_override``: image 0's rois keep only their own
    label (-1 on some), at thresholds 1.0 as ``GT_BOX_EVAL`` sets."""
    rng = np.random.default_rng(2)
    logits, deltas, props, valid, sizes = postprocess_inputs(rng, ties=case == "ties")
    kw = dict(score_thresh=0.05, nms_thresh=0.5, detections_per_img=10, pre_nms_candidates=100,
              cls_agnostic_bbox_reg=False)
    override = None
    if case == "gt_override":
        override = rng.integers(-1, NUM_CLASSES, (2, 20)).astype(np.int32)
        override[1] = -1  # image 1 has none: its scores stay
        kw.update(score_thresh=1.0, nms_thresh=1.0)
    ref = jax_box.postprocess_boxes(
        *(jnp.asarray(a) for a in (logits, deltas, props, valid, sizes)), nms_tile=64,
        gt_override_labels=None if override is None else jnp.asarray(override), **kw)
    got = torch_box.postprocess_boxes(
        *(torch.from_numpy(a) for a in (logits, deltas, props, valid, sizes)),
        gt_override_labels=None if override is None else torch.from_numpy(override).to(torch.int64), **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(ref.boxes), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores), rtol=0, atol=1e-6)
    assert got.valid.sum() > 0
    if case == "gt_override":
        # image 0: one detection per overridden roi, at its own label
        assert int(got.valid[0].sum()) == min(int((override[0] >= 0).sum()), 10)
        assert (got.scores[0][got.valid[0]] > 1.0).all()


@pytest.mark.parametrize("samples", [False, True])
def test_class_specific_mask_loss_matches_jax(samples):
    """The BCE on each positive roi's label channel, with and without a
    sample axis; the logits' gradient lies in those channels only."""
    rng = np.random.default_rng(3)
    jax_s, torch_s = sampled_rois(rng, s=6)
    m = 14
    shape = ((2,) if samples else ()) + (12, m, m, NUM_CLASSES)
    logits = rng.standard_normal(shape).astype(np.float32)
    gt_masks = rng.choice(np.float32([0.2, 0.9]), (2, 3, 28, 28))
    gt_boxes = np.array([[[2, 2, 30, 30], [10, 5, 40, 50], [0, 20, 20, 60]]] * 2, np.float32)

    def jax_loss(lg):
        return jax_mask.mask_head_loss(lg, jax_s, jnp.asarray(gt_masks), jnp.asarray(gt_boxes),
                                       cls_agnostic_mask=False)

    ref, ref_g = jax.value_and_grad(jax_loss)(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    got = torch_mask.mask_head_loss(tl, torch_s, torch.from_numpy(gt_masks), torch.from_numpy(gt_boxes),
                                    cls_agnostic_mask=False)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(ref_g), rtol=1e-6, atol=1e-9)
    g = tl.grad.numpy().reshape(-1, 12, m, m, NUM_CLASSES)
    lab = torch_s.labels.reshape(-1).numpy()
    pos = (torch_s.is_pos & torch_s.valid).reshape(-1).numpy()
    for i in range(12):
        others = np.delete(g[:, i], lab[i], axis=-1)
        assert not others.any() and (g[:, i, ..., lab[i]].any() == pos[i])


def test_class_specific_mask_inference_matches_jax():
    """The probability of each detection's label channel, the labels
    clipped into range as padded detections' may lie outside it."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((9, 14, 14, NUM_CLASSES)).astype(np.float32)
    labels = np.array([1, 5, 0, 3, -1, 7, 2, 2, 4], np.int32)
    ref = jax_mask.mask_head_inference(jnp.asarray(logits), jnp.asarray(labels), cls_agnostic_mask=False)
    got = torch_mask.mask_head_inference(torch.from_numpy(logits), torch.from_numpy(labels), cls_agnostic_mask=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        torch_mask.mask_head_inference(torch.from_numpy(logits)).numpy(),
        torch.sigmoid(torch.from_numpy(logits[..., 1])).numpy())


# ---------------------------------------------------------------------------
# the detector


def test_class_specific_model_has_the_reference_heads(masks_on):
    """``cls_score`` over the classes, 4 deltas a class, a mask channel
    a class; no ``emb_pred`` and no class table; the bridge round-trips
    a JAX init of the same model leaf for leaf."""
    model = masks_on["trainer"].model
    sd = model.state_dict()
    assert sd["box_predictor.cls_score.weight"].shape == (NUM_CLASSES, 2048)
    assert sd["box_predictor.bbox_pred.weight"].shape == (4 * NUM_CLASSES, 2048)
    assert sd["mask_predictor.mask_fcn_logits.weight"].shape == (NUM_CLASSES, 8, 1, 1)
    assert not any("emb_pred" in k for k in sd)
    b = jax_batch(tiny_batch())
    targets = {k: b[k] for k in ("gt_boxes", "gt_labels", "gt_valid", "gt_masks")}
    m = masks_on["model"]
    rngs = {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)}
    tree = jax.jit(lambda r: m.init(r, b["images"], b["image_sizes"], None, targets, train=True))(rngs)["params"]
    tree = jax.tree_util.tree_map(np.asarray, tree)
    model.load_state_dict(bridge.state_dict_from_flax(model, tree), strict=True)
    assert_trees_equal(bridge.flax_from_state_dict(model), tree)
    bridge.load_flax_params(model, masks_on["tree"])


@pytest.mark.parametrize("setup_name", ["masks_on", "masks_off"])
def test_class_specific_eval_matches_jax(setup_name, request):
    """Boxes (1e-3 px), scores (1e-5), labels and valid flags (equal),
    and the label channel's mask probabilities (1e-4)."""
    setup = request.getfixturevalue(setup_name)
    batch = tiny_batch()
    images, sizes = batch["images"], batch["image_sizes"]
    m = setup["model"]
    ref = jax.jit(lambda p, i, s: m.apply(p, i, s, train=False))(setup["params"], images, sizes)
    model = setup["trainer"].model.eval()
    with torch.no_grad():
        out = model(torch.from_numpy(images), torch.from_numpy(sizes))
    model.train()
    rd, od = ref.detections, out.detections
    valid = np.asarray(rd.valid)
    assert valid.sum(axis=1).min() > 0 and len(np.unique(np.asarray(rd.labels)[valid])) > 1
    np.testing.assert_array_equal(od.valid.numpy(), valid)
    np.testing.assert_array_equal(od.labels.numpy(), np.asarray(rd.labels))
    np.testing.assert_allclose(od.boxes.numpy(), np.asarray(rd.boxes), rtol=0, atol=1e-3)
    np.testing.assert_allclose(od.scores.numpy(), np.asarray(rd.scores), rtol=0, atol=1e-5)
    if setup_name == "masks_off":
        assert out.mask_probs is None and ref.mask_probs is None
    else:
        assert out.mask_probs.shape == (2, 100, 14, 14)
        np.testing.assert_allclose(out.mask_probs.numpy(), np.asarray(ref.mask_probs), rtol=0, atol=1e-4)


@pytest.mark.parametrize("setup_name", ["masks_on", "masks_off"])
def test_class_specific_loss_dict_matches_jax(setup_name, request):
    setup = request.getfixturevalue(setup_name)
    loss_fn = jax_train.build_loss_fn(setup["model"], "GeneralizedRCNN")
    batch = tiny_batch()
    with JaxDraws() as rec:
        _, (losses, _) = jax.jit(loss_fn)(setup["params"], jax_batch(batch), jax.random.PRNGKey(0))
        jax.block_until_ready(losses)
    trainer = setup["trainer"]
    with torch.no_grad():
        out = trainer.model(*(torch.from_numpy(batch[k]) for k in ("images", "image_sizes")), train=True,
                            batch=trainer.device_batch(batch), draws=rec.draws())
    keys = LOSSES if setup_name == "masks_on" else LOSSES[:-1]
    assert tuple(sorted(out.losses)) == tuple(sorted(keys)) == tuple(sorted(losses))
    for k in keys:
        np.testing.assert_allclose(out.losses[k].numpy(), np.asarray(losses[k]), rtol=1e-5, atol=1e-7, err_msg=k)
        assert float(out.losses[k]) > 0, k


def test_class_specific_trainer_steps_match_jax_train_step():
    """Two ``Trainer.step`` calls against two steps of the jitted JAX
    ``build_train_step`` with ``make_optimizer``, on JAX's draws: the
    losses and each trainable parameter's update (``cls_score``, the 4C
    box deltas and the C mask channels among them)."""
    setup = make_setup()
    trainer, cfg = setup["trainer"], setup["cfg"]
    assert "class_embeddings" not in trainer.host_batch(tiny_batch())
    prefixes = jax_opt.frozen_prefixes_from_cfg(cfg, "GeneralizedRCNN")
    tx, _ = jax_opt.make_optimizer(cfg, setup["params"]["params"], prefixes)
    state = jax_train.create_train_state(setup["params"], tx, jax.random.PRNGKey(0))
    step = jax.jit(jax_train.build_train_step(setup["model"], tx, "GeneralizedRCNN"))
    start = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    for it, variant in enumerate(["three_gt", "image_without_gt"]):
        batch = tiny_batch(variant, seed=1 + it)
        with JaxDraws() as rec:
            state, metrics = step(state, jax_batch(batch))
            jax.block_until_ready(state.params)
        prev = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        got = trainer.step(batch, rec.draws())
        for k in LOSSES + ("total_loss",):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(metrics[k]), rtol=1e-4, err_msg=k)
        ref = bridge.state_dict_from_flax(trainer.model, jax.tree_util.tree_map(np.asarray, state.params["params"]))
        for name, p in trainer.model.named_parameters():
            if not p.requires_grad:
                continue
            up = (p.detach() - prev[name]).numpy()
            want = ref[name].numpy() - prev[name].numpy()
            assert _rel_norm(up, want) <= 1e-3, (it, name, _rel_norm(up, want))
    for name in ("box_predictor.cls_score.weight", "box_predictor.bbox_pred.weight",
                 "mask_predictor.mask_fcn_logits.weight"):
        assert not torch.equal(trainer.model.get_parameter(name), start[name]), name


def test_gt_box_eval_matches_jax(masks_on):
    """``MODEL.GT_BOX_EVAL``: the gt boxes replace the proposals, each
    keeps its own label with score p + 1.1, thresholds 1.0; through the
    module and through ``Predictor``."""
    setup = make_setup(["MODEL.GT_BOX_EVAL", True])
    s = setup["trainer"].model.statics
    assert s.gt_box_eval and s.score_thresh == 1.0 and s.nms_thresh == 1.0
    batch = tiny_batch("image_without_gt")
    gt_eval = {"boxes": batch["gt_boxes"], "labels": batch["gt_labels"], "valid": batch["gt_valid"]}
    m = setup["model"]
    ref = jax.jit(lambda p, i, s_, g: m.apply(p, i, s_, train=False, gt_eval=g))(
        setup["params"], batch["images"], batch["image_sizes"], jax.tree_util.tree_map(jnp.asarray, gt_eval))
    pred = Predictor("", OPTS + ["MODEL.GT_BOX_EVAL", True], device="cpu")
    pred.load_flax_params(setup["tree"])
    dets, masks = pred(batch["images"], batch["image_sizes"], None, gt_eval)
    rd = ref.detections
    np.testing.assert_array_equal(dets.valid, np.asarray(rd.valid))
    np.testing.assert_array_equal(dets.labels, np.asarray(rd.labels))
    np.testing.assert_allclose(dets.boxes, np.asarray(rd.boxes), rtol=0, atol=1e-4)
    np.testing.assert_allclose(dets.scores, np.asarray(rd.scores), rtol=0, atol=1e-5)
    np.testing.assert_allclose(masks, np.asarray(ref.mask_probs), rtol=0, atol=1e-4)
    # image 0: its three gt boxes (regressed) at their labels; image 1 has none
    assert dets.valid.sum(axis=1).tolist() == [3, 0]
    np.testing.assert_array_equal(np.sort(dets.labels[0][dets.valid[0]]), np.sort(batch["gt_labels"][0][:3]))
    assert (dets.scores[0][dets.valid[0]] > 1.0).all()


def test_reference_state_dict_of_a_class_specific_model_imports_bit_for_bit(masks_on, tmp_path):
    """A maskrcnn_benchmark ``.pth`` of the class-specific model
    (``cls_score`` [C, 2048], ``bbox_pred`` [4C, 2048],
    ``mask_fcn_logits`` [C, 256, 1, 1]) through ``import_external_weights``:
    every tensor lands bit for bit, as the JAX importer places it; with
    ``MODEL.LOAD_CLASSIFIER False`` the ``cls_score`` leaves keep their
    values, in both packages."""
    trainer = masks_on["trainer"]
    names = reference_names(trainer.model)
    rng = np.random.default_rng(7)
    sd = {names[k]: rng.standard_normal(v.shape).astype(np.float32) for k, v in trainer.model.state_dict().items()}
    path = tmp_path / "mask_rcnn_R_50_C4.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    for load_classifier in (True, False):
        cfg = trainer.cfg.clone()
        cfg.defrost()
        cfg.MODEL.LOAD_CLASSIFIER = load_classifier
        target = bridge.seeded_flax_params(trainer.model, seed=4)
        tree, msg = torch_ckpt.import_external_weights(target, str(path), cfg)
        kept = 0 if load_classifier else 2
        assert msg == f"imported {len(sd) - kept} torch tensors (0 source keys unmatched)"
        ref_sd = jax_ckpt.apply_reference_key_surgery(
            {k: v for k, v in sd.items()}, load_classifier=load_classifier)
        ref, _ = jax_ckpt.import_torch_state_dict(target, ref_sd)
        assert_trees_equal(tree, ref)
        got = bridge.state_dict_from_flax(trainer.model, tree)
        seeded = bridge.state_dict_from_flax(trainer.model, target)
        for port_key, ref_key in names.items():
            want = seeded[port_key] if ("cls_score" in port_key and not load_classifier) else torch.from_numpy(
                sd[ref_key])
            assert torch.equal(got[port_key], want), port_key


def test_class_specific_configs_that_jax_cannot_run_raise():
    """An embedding-based predictor regresses one box, and the
    student-teacher model scores regions against caption nouns: the
    class-specific regression and predictor have no meaning there."""
    with pytest.raises(ValueError, match="CLS_AGNOSTIC_BBOX_REG"):
        Trainer("", OPTS + ["MODEL.ROI_BOX_HEAD.EMBEDDING_BASED", True], device="cpu")
    with pytest.raises(ValueError, match="EMBEDDING_BASED"):
        Trainer("", OPTS + ["MODEL.META_ARCHITECTURE", "STGeneralizedRCNN",
                            "MODEL.CLS_AGNOSTIC_BBOX_REG", True], device="cpu")
    statics = Trainer("", OPTS, device="cpu").model.statics
    model = GeneralizedRCNN(statics._replace(embedding_based=True, cls_agnostic_bbox_reg=True))
    with pytest.raises(ValueError, match="class-embedding table"):
        model(torch.zeros((1, 64, 64, 3), dtype=torch.uint8), torch.tensor([[64, 64]], dtype=torch.int32))


def test_port_checkpoint_of_a_class_specific_model_imports_as_in_jax(masks_on, tmp_path):
    """A port checkpoint of the class-specific model through
    ``import_external_weights`` (its ``OUTPUT_DIR``): the same tree as the
    JAX ``import_flax_params`` gives on its flax-layout tree, every leaf
    the checkpoint's, and ``cls_score`` kept back under
    ``MODEL.LOAD_CLASSIFIER False``."""
    trainer = masks_on["trainer"]
    torch_ckpt.save_checkpoint(str(tmp_path), torch_ckpt.checkpoint_state(trainer, 1), 1)
    src = bridge.flax_from_state_dict(trainer.model)
    for load_classifier in (True, False):
        cfg = trainer.cfg.clone()
        cfg.defrost()
        cfg.MODEL.LOAD_CLASSIFIER = load_classifier
        target = bridge.seeded_flax_params(trainer.model, seed=9)
        tree, msg = torch_ckpt.import_external_weights(target, str(tmp_path), cfg)
        ref, report = jax_ckpt.import_flax_params(target, src, load_classifier=load_classifier)
        assert_trees_equal(tree, ref)
        assert f"imported {report['matched']} leaves" in msg
        got = bridge.state_dict_from_flax(trainer.model, tree)
        seeded = bridge.state_dict_from_flax(trainer.model, target)
        for k, v in trainer.model.state_dict().items():
            want = seeded[k] if ("cls_score" in k and not load_classifier) else v
            assert torch.equal(got[k], want), k
