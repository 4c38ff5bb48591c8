"""The port's teacher ``GeneralizedRCNN`` (``zeroshot_mask.yaml``) against
the JAX package: eval forward, training losses, gradients and train
steps, on the CPU.

The same flax-layout weights (numpy draws, loaded through ``bridge.py``)
and the same collated numpy batch go through the JAX model (its
``apply``, and ``engine/train_step.py``'s ``build_loss_fn`` and
``build_train_step`` with ``make_optimizer``, jitted on the CPU) and the
port, at the narrow width of ``tests/test_torch_st_train.py`` (stem 8,
res2 16, width 4, EMB_DIM 16, RPN 128 -> 32, 16 rois and 8 mask rois
per image, 64 x 64 images, 2 images).

The random draws are the JAX program's own: :class:`JaxDraws` wraps the
JAX ``rpn_loss`` and ``subsample_rois`` of ``generalized_rcnn.py`` to
compute, from the key each is given, the priorities that its balanced
sampler draws per image, and passes them out with
``jax.debug.callback``; the port takes them as a ``TrainDraws``.  The
gt masks take the values 0.2 and 0.9, whose resampled targets do not
fall on the 0.5 binarization threshold.

Tolerances (float32): losses 1e-5 relative; gradients per tensor 1e-5
of the JAX gradient's norm for the box and mask predictors.  The trunk
(``layer2``, ``layer3``), the RPN head and the C5 head pass their
gradients through the whole C4 map and many ReLU boundaries, where
rounding decides, so they are held against a float64 run of the port on
the same draws, as ``tests/test_torch_st_train.py`` holds the C5 head:
the port within 5e-3 of it, and no farther from JAX than twice the
larger of the two float32 programs' distances from it (both sum the
convolutions in their own orders; at this seed each is 0.4-3.2e-5 away,
and port and JAX at most 1.54 times the larger apart).  Updates after
one and two steps: 1e-3 of the JAX update's norm for every parameter (at
most 1.1e-4 at this seed; the momentum carries the first step's
rounding into the second).  bfloat16 losses: 2%.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.config import get_default_cfg as jax_cfg
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import optimizer as jax_opt
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import train_step as jax_train
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import generalized_rcnn as jax_grcnn
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import statics as jax_statics
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.config import get_default_cfg as torch_cfg
from cvpr22_cross_modal_pseudo_labeling_torch.engine import optimizer as torch_opt
from cvpr22_cross_modal_pseudo_labeling_torch.engine.inference import Predictor
from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import (
    Trainer,
    device_batch,
    training_forward,
)
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector import build_detection_model
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.generalized_rcnn import (
    GeneralizedRCNN,
    TrainDraws,
)
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.st_generalized_rcnn import (
    STGeneralizedRCNN,
)
from tests.test_torch_st_eval import CONFIG as ST_CONFIG
from tests.test_torch_st_eval import TINY_OPTS

TEACHER = "configs/coco_cap_det/zeroshot_mask.yaml"
TRAIN_OPTS = TINY_OPTS + [
    "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 128,
    "MODEL.RPN.POST_NMS_TOP_N_TRAIN", 32,
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 16,
    "TPU.MASK_POS_CAP", 8,
    "TPU.MAX_GT", 4,
]
LOSSES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg", "loss_mask")
RCNN_KEYS = ("images", "image_sizes", "class_embeddings", "gt_boxes", "gt_labels", "gt_valid",
             "gt_masks")
FROZEN = ("backbone.body.stem.", "backbone.body.layer1.", "box_predictor.emb_pred.")
PREDICTORS = ("box_predictor.", "mask_predictor.")


def tiny_batch(variant="three_gt", seed=1):
    """A collated teacher batch of 2 images and the class table (row 0
    the background, rows not normalized).  ``image_without_gt``: image 1
    has no valid gt box, so its rois and anchors are all negatives."""
    rng = np.random.default_rng(seed)
    b = 2
    gt = np.array([[4, 4, 30, 30], [10, 20, 50, 40], [30, 8, 60, 44], [0, 0, 0, 0]], np.float32)
    valid = np.array([[1, 1, 1, 0]] * b, bool)
    if variant == "image_without_gt":
        valid[1] = False
    else:
        assert variant == "three_gt", variant
    table = rng.standard_normal((6, 16)).astype(np.float32)
    table[0] = 0.0
    return dict(
        images=rng.integers(0, 256, (b, 64, 64, 3), dtype=np.uint8),
        image_sizes=np.array([[64, 64], [48, 64]], np.int32),
        gt_boxes=np.tile(gt, (b, 1, 1)) * valid[..., None],
        gt_labels=(rng.integers(1, 6, (b, 4)) * valid).astype(np.int32),
        gt_valid=valid,
        gt_masks=rng.choice(np.float32([0.2, 0.9]), (b, 4, 28, 28)),
        class_embeddings=table,
    )


# the callbacks of a jitted program are fixed when it is traced, so they
# write here and each recorder reads what its own execution wrote
_SINK = {}


def _priorities(key, b, n):
    """The JAX balanced sampler's per-image uniforms from ``key``."""
    out = []
    for k in jax.random.split(key, b):
        kp, kn = jax.random.split(k)
        out.append(jnp.stack([jax.random.uniform(kp, (n,)), jax.random.uniform(kn, (n,))]))
    return jnp.stack(out)


class JaxDraws(contextlib.ContextDecorator):
    """Records the JAX teacher's sampler draws: the RPN loss's over the
    anchors, the RoI sampler's over the proposals plus the gt."""

    def __enter__(self):
        _SINK.clear()
        self._saved = jax_grcnn.rpn_loss, jax_grcnn.subsample_rois
        rpn, sub = self._saved

        def record(name):
            return lambda x: _SINK.__setitem__(name, np.array(x, np.float32))

        def rpn_loss(anchors, vis, obj, reg, gt_boxes, gt_valid, key, *a, **k):
            jax.debug.callback(record("rpn_sampler"), _priorities(key, *obj.shape))
            return rpn(anchors, vis, obj, reg, gt_boxes, gt_valid, key, *a, **k)

        def subsample(proposals, proposal_valid, gt_boxes, gt_labels, gt_valid, key, *a, **k):
            jax.debug.callback(record("gt_sampler"), _priorities(key, *proposals.shape[:2]))
            return sub(proposals, proposal_valid, gt_boxes, gt_labels, gt_valid, key, *a, **k)

        jax_grcnn.rpn_loss, jax_grcnn.subsample_rois = rpn_loss, subsample
        return self

    def __exit__(self, *exc):
        jax_grcnn.rpn_loss, jax_grcnn.subsample_rois = self._saved
        return False

    @staticmethod
    def draws():
        return TrainDraws(gt_sampler=torch.from_numpy(_SINK["gt_sampler"]),
                          rpn_sampler=torch.from_numpy(_SINK["rpn_sampler"]))


def jax_cfg_of(opts):
    cfg = jax_cfg()
    cfg.merge_from_file(TEACHER)
    cfg.merge_from_list(TRAIN_OPTS + list(opts))
    return cfg


def jax_batch(batch):
    return {k: jnp.asarray(batch[k]) for k in RCNN_KEYS}


def make_setup(dtype="float32", opts=()):
    opts = ["TPU.COMPUTE_DTYPE", dtype] + list(opts)
    trainer = Trainer(TEACHER, TRAIN_OPTS + opts, device="cpu", seed=3)
    tree = bridge.seeded_flax_params(trainer.model, seed=0)
    trainer.load_flax_params(tree)
    cfg = jax_cfg_of(opts)
    model = jax_grcnn.GeneralizedRCNN(jax_statics.statics_from_cfg(cfg))
    loss_fn = jax_train.build_loss_fn(model, "GeneralizedRCNN")
    params = {"params": jax.tree_util.tree_map(jnp.asarray, tree)}
    return dict(trainer=trainer, tree=tree, cfg=cfg, model=model, loss_fn=loss_fn,
                grad_fn=jax.jit(jax.grad(loss_fn, has_aux=True)), params=params)


@pytest.fixture(scope="module")
def f32():
    return make_setup("float32")


def jax_grads(setup, batch, params=None, rng=None):
    """(grads, losses, info, TrainDraws) of the JAX loss function."""
    with JaxDraws() as rec:
        grads, (losses, info) = setup["grad_fn"](
            setup["params"] if params is None else params, jax_batch(batch),
            jax.random.PRNGKey(0) if rng is None else rng,
        )
        jax.block_until_ready(grads)
    return grads, losses, info, rec.draws()


def port_forward(model, batch, draws):
    return training_forward(model, "GeneralizedRCNN", device_batch(batch, "cpu", "GeneralizedRCNN"), draws)


def _rel_norm(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def float64_grads(setup, batch, draws):
    """The port's gradients in float64 (weights, activations and
    compute), with the trainer's frozen parameters frozen."""
    trainer = setup["trainer"]
    m64 = GeneralizedRCNN(trainer.model.statics)
    bridge.load_flax_params(m64, setup["tree"])
    m64 = m64.double()
    for m in m64.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    for name, p in m64.named_parameters():
        p.requires_grad_(trainer.model.get_parameter(name).requires_grad)
    out = port_forward(m64, batch, draws)
    sum(out.losses.values()).backward()
    return {n: p.grad for n, p in m64.named_parameters() if p.grad is not None}


# ---------------------------------------------------------------------------


def test_bridge_round_trips_a_jax_teacher_tree():
    """A train-mode JAX init of the teacher maps leaf for leaf onto the
    port (the five flax scopes at the top level) and back, bit for bit."""
    cfg = jax_cfg_of(())
    m = jax_grcnn.GeneralizedRCNN(jax_statics.statics_from_cfg(cfg))
    b = jax_batch(tiny_batch())
    targets = {k: b[k] for k in ("gt_boxes", "gt_labels", "gt_valid", "gt_masks")}
    rngs = {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)}
    tree = jax.jit(lambda r: m.init(r, b["images"], b["image_sizes"], b["class_embeddings"], targets,
                                    train=True))(rngs)["params"]
    tree = jax.tree_util.tree_map(np.asarray, tree)
    assert set(tree) == {"backbone", "rpn_head", "roi_extractor", "box_predictor", "mask_predictor"}
    model = build_detection_model(_port_cfg(TEACHER, TRAIN_OPTS))
    assert isinstance(model, GeneralizedRCNN)
    sd = bridge.state_dict_from_flax(model, {"params": tree})
    assert len(sd) == len(model.state_dict())
    model.load_state_dict(sd, strict=True)
    back = bridge.flax_from_state_dict(model)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, value in flat:
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, value, err_msg=str(path))
    assert set(bridge.seeded_flax_params(model, seed=0)) == set(tree)


def _port_cfg(config, opts):
    cfg = torch_cfg()
    cfg.merge_from_file(config)
    cfg.merge_from_list(list(opts))
    return cfg


def test_teacher_eval_matches_jax(f32):
    """Boxes (1e-3 px), scores (1e-5), labels and valid flags (equal)
    and the 14 x 14 mask probabilities (1e-4) against the unnormalized
    class table."""
    batch = tiny_batch()
    images, sizes, table = batch["images"], batch["image_sizes"], batch["class_embeddings"]
    m = f32["model"]
    ref = jax.jit(lambda p, i, s, c: m.apply(p, i, s, class_embeddings=c, train=False))(
        f32["params"], images, sizes, table)
    model = f32["trainer"].model.eval()
    with torch.no_grad():
        out = model(torch.from_numpy(images), torch.from_numpy(sizes), torch.from_numpy(table))
    model.train()
    rd, od = ref.detections, out.detections
    valid = np.asarray(rd.valid)
    assert valid.sum(axis=1).min() > 0, "the tiny model should detect something per image"
    np.testing.assert_array_equal(od.valid.numpy(), valid)
    np.testing.assert_array_equal(od.labels.numpy(), np.asarray(rd.labels))
    np.testing.assert_allclose(od.boxes.numpy(), np.asarray(rd.boxes), rtol=0, atol=1e-3)
    np.testing.assert_allclose(od.scores.numpy(), np.asarray(rd.scores), rtol=0, atol=1e-5)
    assert out.mask_probs.shape == (2, 100, 14, 14)
    np.testing.assert_allclose(out.mask_probs.numpy(), np.asarray(ref.mask_probs), rtol=0, atol=1e-4)


def test_predictor_serves_the_teacher(f32):
    """``Predictor`` builds the teacher from its config and answers with
    the module's detections and masks."""
    pred = Predictor(TEACHER, TRAIN_OPTS, device="cpu")
    assert isinstance(pred.model, GeneralizedRCNN) and not pred.model.training
    pred.load_flax_params(f32["tree"])
    batch = tiny_batch(seed=2)
    args = (batch["images"], batch["image_sizes"], batch["class_embeddings"])
    dets, masks = pred(*args)
    with torch.no_grad():
        out = pred.model(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(dets.boxes, out.detections.boxes.numpy())
    np.testing.assert_array_equal(dets.valid, out.detections.valid.numpy())
    np.testing.assert_array_equal(masks, out.mask_probs.numpy())
    assert dets.valid.any()


@pytest.mark.parametrize("variant", ["three_gt", "image_without_gt"])
def test_teacher_loss_dict_matches_jax(f32, variant):
    batch = tiny_batch(variant)
    _, losses, info, draws = jax_grads(f32, batch)
    with torch.no_grad():
        out = port_forward(f32["trainer"].model, batch, draws)
    assert tuple(sorted(out.losses)) == tuple(sorted(LOSSES)) == tuple(sorted(losses))
    assert out.info == {} and dict(info) == {}
    for k in LOSSES:
        np.testing.assert_allclose(out.losses[k].numpy(), np.asarray(losses[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
        assert float(out.losses[k]) > 0, k


def test_teacher_gradients_match_jax(f32):
    """The gradient of the summed losses for every trainable parameter
    (the frozen stem, ``layer1`` and ``emb_pred`` get none), with the
    trunk's and heads' bound from a float64 run of the port."""
    batch = tiny_batch()
    grads, _, _, draws = jax_grads(f32, batch)
    trainer = f32["trainer"]
    trainer.model.zero_grad(set_to_none=True)
    out = port_forward(trainer.model, batch, draws)
    sum(out.losses.values()).backward()
    ref = bridge.state_dict_from_flax(trainer.model, jax.tree_util.tree_map(np.asarray, grads))
    exact = float64_grads(f32, batch, draws)
    groups = set()
    for name, p in trainer.model.named_parameters():
        if not p.requires_grad:
            assert p.grad is None and name.startswith(FROZEN), name
            continue
        vs_jax = _rel_norm(p.grad.numpy(), ref[name].numpy())
        if name.startswith(PREDICTORS):
            assert vs_jax <= 1e-5, (name, vs_jax)
        else:
            own = _rel_norm(p.grad.numpy().astype(np.float64), exact[name].numpy())
            jax_own = _rel_norm(ref[name].numpy().astype(np.float64), exact[name].numpy())
            assert own <= 5e-3 and vs_jax <= 2 * max(own, jax_own), (name, own, jax_own, vs_jax)
        groups.add(".".join(name.split(".")[:3]))
    assert {"backbone.body.layer2", "backbone.body.layer3", "rpn_head.conv.weight",
            "roi_extractor.layer4.block0", "box_predictor.bbox_pred.weight",
            "mask_predictor.conv5_mask.weight"} <= groups
    trainer.model.zero_grad(set_to_none=True)


def test_trainer_steps_match_jax_train_step():
    """Two ``Trainer.step`` calls against two steps of the jitted JAX
    ``build_train_step`` with ``make_optimizer``: the losses, the norm of
    the trainable gradients, each trainable parameter's update, and the
    frozen parameters and buffers bit for bit."""
    setup = make_setup("float32")
    trainer, cfg = setup["trainer"], setup["cfg"]
    prefixes = jax_opt.frozen_prefixes_from_cfg(cfg, "GeneralizedRCNN")
    tx, labels = jax_opt.make_optimizer(cfg, setup["params"]["params"], prefixes)
    state = jax_train.create_train_state(setup["params"], tx, jax.random.PRNGKey(0))
    step = jax.jit(jax_train.build_train_step(setup["model"], tx, "GeneralizedRCNN"))
    trainable = jax.tree_util.tree_map(lambda lab: lab != "frozen", labels)
    frozen = {n: p.detach().clone() for n, p in trainer.model.named_parameters() if not p.requires_grad}
    buffers = {n: b.clone() for n, b in trainer.model.named_buffers()}
    start = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    for it, variant in enumerate(["three_gt", "image_without_gt"]):
        batch = tiny_batch(variant, seed=1 + it)
        grads, _, _, _ = jax_grads(setup, batch, state.params, jax.random.fold_in(state.rng, state.step))
        want_norm = float(np.sqrt(sum(
            float(jnp.sum(g.astype(jnp.float32) ** 2)) for g, keep in zip(
                jax.tree_util.tree_leaves(grads["params"]), jax.tree_util.tree_leaves(trainable)) if keep)))
        with JaxDraws() as rec:
            state, metrics = step(state, jax_batch(batch))
            jax.block_until_ready(state.params)
        prev = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        got = trainer.step(batch, rec.draws())
        for k in LOSSES + ("total_loss",):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(metrics[k]), rtol=1e-4, err_msg=k)
        assert abs(float(got["grad_norm"]) / want_norm - 1) < 1e-3
        ref = bridge.state_dict_from_flax(trainer.model, jax.tree_util.tree_map(np.asarray, state.params["params"]))
        for name, p in trainer.model.named_parameters():
            if not p.requires_grad:
                continue
            up = (p.detach() - prev[name]).numpy()
            want = ref[name].numpy() - prev[name].numpy()
            assert _rel_norm(up, want) <= 1e-3, (it, name, _rel_norm(up, want))
    for n, p in trainer.model.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), n
        else:
            assert not torch.equal(p, start[n]), n
    for n, b in trainer.model.named_buffers():
        assert torch.equal(b, buffers[n]), n


def test_teacher_uncertainty_branch_matches_jax():
    """``MODEL.UNCERTAINTY`` with ``compute_uncertain``: the mask logits
    carry the reparameterized samples (the JAX program's normal draws,
    recorded) and the forward reports ``avg_uncertain``.  The mask slots
    cover every sampled roi here (``MASK_POS_CAP`` 16), the only case in
    which the JAX code runs."""
    opts = ["MODEL.UNCERTAINTY", True, "TPU.MASK_POS_CAP", 16]
    setup = make_setup("float32", opts)
    assert hasattr(setup["trainer"].model.mask_predictor, "uncertain_pred")
    batch = tiny_batch()
    b = jax_batch(batch)
    targets = {k: b[k] for k in ("gt_boxes", "gt_labels", "gt_valid", "gt_masks")}
    rngs = {"sampler": jax.random.PRNGKey(1), "uncertainty": jax.random.PRNGKey(2)}
    normal = jax.random.normal

    def eps(key, shape=(), dtype=jnp.float32):
        v = normal(key, shape, dtype)
        jax.debug.callback(lambda x: _SINK.__setitem__("mask_eps", np.array(x, np.float32)), v)
        return v

    m = setup["model"]
    with JaxDraws():
        jax.random.normal = eps
        try:
            ref = jax.jit(lambda p: m.apply(p, b["images"], b["image_sizes"], b["class_embeddings"], targets,
                                            train=True, compute_uncertain=True, rngs=rngs))(setup["params"])
            jax.block_until_ready(ref.losses)
        finally:
            jax.random.normal = normal
    draws = JaxDraws.draws()._replace(mask_eps=torch.from_numpy(_SINK["mask_eps"]))
    model = setup["trainer"].model
    with torch.no_grad():
        out = model(*(torch.from_numpy(batch[k]) for k in ("images", "image_sizes", "class_embeddings")),
                    train=True, batch=device_batch(batch, "cpu", "GeneralizedRCNN"),
                    compute_uncertain=True, draws=draws)
    for k in LOSSES:
        np.testing.assert_allclose(out.losses[k].numpy(), np.asarray(ref.losses[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(out.info["avg_uncertain"].numpy(), np.asarray(ref.info["avg_uncertain"]),
                               rtol=1e-5)
    assert float(out.info["avg_uncertain"]) > 0


def test_bf16_teacher_losses_match_jax():
    """bfloat16 compute (float32 parameters and losses), on the same
    draws: every loss within 2% relative."""
    setup = make_setup("bfloat16")
    batch = tiny_batch()
    with JaxDraws() as rec:
        _, (losses, _) = jax.jit(setup["loss_fn"])(setup["params"], jax_batch(batch), jax.random.PRNGKey(0))
    with torch.no_grad():
        out = port_forward(setup["trainer"].model, batch, rec.draws())
    for k in LOSSES:
        np.testing.assert_allclose(out.losses[k].numpy(), np.asarray(losses[k]), rtol=0.02, err_msg=k)


def test_teacher_optimizer_labels_match_jax():
    """On ``zeroshot_mask.yaml`` the frozen prefixes and every
    parameter's label equal JAX ``label_params``: frozen are the stem,
    ``layer1`` and ``emb_pred`` (``FREEZE_CONV_BODY_AT 2``,
    ``FREEZE_EMB_PRED``) and nothing else; the frozen-BN leaves, buffers
    in the port, are frozen on both sides."""
    tc = _port_cfg(TEACHER, TRAIN_OPTS)
    prefixes = torch_opt.frozen_prefixes_from_cfg(tc, "GeneralizedRCNN")
    assert prefixes == jax_opt.frozen_prefixes_from_cfg(jax_cfg_of(()), "GeneralizedRCNN")
    assert prefixes == ("backbone/body/stem", "backbone/body/layer1", "emb_pred")
    model = build_detection_model(tc)
    tree = bridge.flax_from_state_dict(model)
    ref = {"/".join(k.key for k in path): label for path, label in
           jax.tree_util.tree_flatten_with_path(jax_opt.label_params(tree, prefixes))[0]}
    modules = dict(model.named_modules())
    to_flax = {bridge._port_key(modules, tuple(p.split("/")))[0]: p for p in ref}
    opt = torch_opt.Optimizer(tc, model, prefixes)
    for name, p in model.named_parameters():
        assert opt.labels[name] == ref[to_flax[name]], name
        assert (opt.labels[name] == "frozen") == name.startswith(FROZEN) == (not p.requires_grad), name
    for key, path in to_flax.items():
        if key not in opt.labels:  # a frozen-BN buffer
            assert ref[path] == "frozen", path


@pytest.mark.parametrize("opts,error", [
    (("MODEL.META_ARCHITECTURE", "NoSuchRCNN"), ValueError),
    # RetinaNet's body without RETINANET_ON: JAX's GeneralizedRCNN fails too
    (("MODEL.BACKBONE.CONV_BODY", "R-50-FPN-RETINANET"), ValueError),
])
def test_registry_refuses_what_is_not_ported(opts, error):
    with pytest.raises(error):
        build_detection_model(_port_cfg(TEACHER, TRAIN_OPTS + list(opts)))


@pytest.mark.parametrize("opts", [
    ("MODEL.META_ARCHITECTURE", "SoftTeacher"),
    ("MODEL.META_ARCHITECTURE", "OMP"),
    ("MODEL.META_ARCHITECTURE", "UnbiasedTeacher"),
    ("MODEL.GT_BOX_EVAL", True),
    ("MODEL.RPN_ONLY", True),
    ("MODEL.RETINANET_ON", True),
    ("MODEL.BACKBONE.CONV_BODY", "R-50-C5"),
    ("MODEL.KEYPOINT_ON", True),
    ("MODEL.ROI_BOX_HEAD.WSDDN", True),
])
def test_registry_builds_and_runs_what_it_once_refused(opts):
    """The baselines, ``GT_BOX_EVAL``, the RPN-only detector, RetinaNet,
    the C5 body, the keypoint head and WSDDN, refused before the port had
    them: the registry builds them and they run, a train step for the
    baselines (the top-k teachers on the student-teacher config and
    batch), the RPN-only detector (its RPN losses alone), RetinaNet (over
    the teacher config's C4 body, whose depth it takes: the R-50 RetinaNet
    body), the C5 teacher, the keypoint teacher (its eval forward gives
    keypoints; a batch without gt keypoints trains no keypoint loss, as
    in JAX) and WSDDN (the RPN losses and its image-level classifier
    loss), the eval forward on the gt boxes for ``GT_BOX_EVAL``."""
    from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.retinanet import RetinaNetDetector
    from tests import test_torch_st_train as st

    key, value = opts
    if key == "MODEL.RETINANET_ON":
        trainer = Trainer(TEACHER, TRAIN_OPTS + list(opts) + ["MODEL.RETINANET.NUM_CONVS", 1], device="cpu", seed=0)
        assert isinstance(trainer.model, RetinaNetDetector) and len(trainer.model.net.backbone.body.layer3) == 6
        trainer.load_flax_params(bridge.seeded_flax_params(trainer.model, seed=0))
        metrics = trainer.step(tiny_batch())
        assert sorted(metrics) == ["grad_norm", "loss_retina_cls", "loss_retina_reg", "total_loss"]
        assert all(torch.isfinite(v) for v in metrics.values())
        return
    if value in ("SoftTeacher", "UnbiasedTeacher"):
        trainer = Trainer(ST_CONFIG, st.TRAIN_OPTS + list(opts), device="cpu", seed=0)
        assert isinstance(trainer.model, STGeneralizedRCNN) and type(trainer.model).__name__.startswith(value)
        batch = st.tiny_batch()
    else:
        trainer = Trainer(TEACHER, TRAIN_OPTS + list(opts), device="cpu", seed=0)
        assert isinstance(trainer.model, GeneralizedRCNN)
        batch = tiny_batch()
    trainer.load_flax_params(bridge.seeded_flax_params(trainer.model, seed=0))
    if key == "MODEL.GT_BOX_EVAL":
        pred = Predictor.from_model(trainer.cfg, trainer.model)
        gt_eval = {"boxes": batch["gt_boxes"], "labels": batch["gt_labels"], "valid": batch["gt_valid"]}
        dets, masks = pred(batch["images"], batch["image_sizes"], batch["class_embeddings"], gt_eval)
        assert dets.valid.sum(axis=1).tolist() == [3, 3] and masks.shape[:2] == (2, 100)
        for i in range(2):
            np.testing.assert_array_equal(np.sort(dets.labels[i][dets.valid[i]]), np.sort(batch["gt_labels"][i][:3]))
        return
    metrics = trainer.step(batch)
    assert all(torch.isfinite(v) for v in metrics.values()) and float(metrics["total_loss"]) > 0
    if key == "MODEL.RPN_ONLY":
        assert sorted(metrics) == ["grad_norm", "loss_objectness", "loss_rpn_box_reg", "total_loss"]
    if key == "MODEL.ROI_BOX_HEAD.WSDDN":
        assert sorted(metrics) == ["grad_norm", "loss_classifier", "loss_objectness", "loss_rpn_box_reg",
                                   "total_loss"]
    if key == "MODEL.KEYPOINT_ON":
        assert "loss_kp" not in metrics
        dets, _ = Predictor.from_model(trainer.cfg, trainer.model)(
            batch["images"], batch["image_sizes"], batch["class_embeddings"])
        assert dets.keypoints.shape == (2, 100, 17, 3) and np.isfinite(dets.keypoints).all()


def test_registry_builds_both_detectors_and_the_teacher_checks_its_batch():
    assert isinstance(build_detection_model(_port_cfg(TEACHER, TRAIN_OPTS)), GeneralizedRCNN)
    assert isinstance(build_detection_model(_port_cfg(ST_CONFIG, TRAIN_OPTS)), STGeneralizedRCNN)
    model = build_detection_model(_port_cfg(TEACHER, TRAIN_OPTS))
    batch = tiny_batch()
    args = (torch.from_numpy(batch["images"]), torch.from_numpy(batch["image_sizes"]),
            torch.from_numpy(batch["class_embeddings"]))
    with pytest.raises(ValueError, match="needs `batch`"):
        model(*args, train=True)
    b = device_batch(batch, "cpu", "GeneralizedRCNN")
    with pytest.raises(NotImplementedError, match="class_valid"):
        model(*args, train=True, batch=dict(b, class_valid=torch.ones(6, dtype=torch.bool)))
    with pytest.raises(KeyError, match="gt_masks"):
        device_batch({k: v for k, v in batch.items() if k != "gt_masks"}, "cpu", "GeneralizedRCNN")
    # the teacher's pseudo-label methods run, at JAX's shapes
    # (tests/test_torch_teacher_pseudo.py holds them against JAX)
    with torch.no_grad():
        out = model.run_teacher_pseudo_branch(*args)
        masks = model.predict_masks_for_boxes(args[0], args[1], out.boxes[:, :5])
    p = model.statics.rpn_post_nms_test
    assert out.embeddings.shape == (2, p, 16) and out.class_logits.shape == (2, p, 6)
    assert out.boxes.shape == out.proposals.boxes.shape == (2, p, 4) and masks.shape == (2, 5, 14, 14)


def test_teacher_trainer_draws_from_its_generator_reproducibly():
    """Without explicit draws the step draws the RPN and RoI samplers'
    priorities from the trainer's seeded generator."""
    runs = []
    for _ in range(2):
        trainer = Trainer(TEACHER, TRAIN_OPTS, device="cpu", seed=11)
        trainer.load_flax_params(bridge.seeded_flax_params(trainer.model, seed=0))
        metrics = trainer.step(tiny_batch())
        runs.append((metrics, trainer.model.backbone.body.layer3.block0.conv1.weight.detach().clone()))
    for k in runs[0][0]:
        assert torch.equal(runs[0][0][k], runs[1][0][k]), k
    assert torch.equal(runs[0][1], runs[1][1])
    assert set(runs[0][0]) == set(LOSSES) | {"total_loss", "grad_norm"}
    assert all(torch.isfinite(v) for v in runs[0][0].values())
