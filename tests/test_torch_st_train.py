"""The port's student-teacher train step against the JAX package.

The same flax-layout weights (numpy draws, loaded through ``bridge.py``)
and the same collated numpy batch go through the JAX
``engine/train_step.py`` (``build_loss_fn``, ``build_train_step`` with
``make_optimizer``, jitted on the CPU) and the port's ``Trainer`` on the
CPU, at a narrow width (stem 8, res2 16, width 4, EMB_DIM 16, RPN 128
-> 32, 16 rois per image, 8 mask rois, 64 x 64 images).

The random draws are the JAX program's own: :class:`JaxDraws` wraps the
JAX ``subsample_rois`` to compute, from the key it is given, the
priorities its ``vmap``-ed ``jax.random.uniform`` draws per image, and
wraps ``jax.random.normal`` (the mask uncertainty's samples); both pass
the values out with ``jax.debug.callback``.  The port takes them as a
``TrainDraws``.  The gt masks take the values 0.2 and 0.9, whose
resampled targets do not fall on the 0.5 binarization threshold where
rounding decides (a gt box appended as a proposal resamples its own mask
at half-pixel offsets).

Tolerances (float32): losses 1e-5 relative; gradients per tensor
1e-5 of the JAX gradient's norm for the box and mask predictors, 2e-3 for
the C5 head, whose float32 gradient is itself that far from a float64
run (ReLU boundaries amplify rounding;
``test_c5_head_gradient_is_as_close_to_jax_as_float32_allows``); updates
after one and two steps likewise.  bfloat16 losses: 2% relative, the
bound the other bfloat16 comparisons use.
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
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import st_generalized_rcnn as jax_st
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer, device_batch
from cvpr22_cross_modal_pseudo_labeling_torch.models.backbone import device_normalize
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.st_generalized_rcnn import TrainDraws
from cvpr22_cross_modal_pseudo_labeling_torch.models.rpn.rpn import flatten_rpn_outputs
from tests.test_torch_st_eval import CONFIG, TINY_OPTS

TRAIN_OPTS = TINY_OPTS + [
    "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 128,
    "MODEL.RPN.POST_NMS_TOP_N_TRAIN", 32,
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 16,
    "TPU.MASK_POS_CAP", 8,
    "TPU.MAX_GT", 4,
    "TPU.MAX_CAP_NOUNS", 3,
]
LOSSES = ("loss_classifier_pseudo", "loss_box_reg_pseudo", "loss_mask_pseudo",
          "loss_classifier", "loss_box_reg", "loss_mask")


def tiny_batch(variant="both_branches", seed=1):
    """A collated batch of 2 images (``data/collate.py`` keys) plus the
    two class tables.  ``image_in_neither_branch``: image 1 is neither a
    caption nor a detection image.  ``no_valid_pseudo_word``: no caption
    noun is valid, so the caption branch has no positive.  The
    Conceptual/OpenImages mixture's rows: ``detection_and_caption_images``
    (image 0 a detection image without caption, image 1 a caption image,
    ``det_mask`` False, with ``ConCapDetDataset``'s one dummy box over the
    image labelled 0), ``no_caption_image`` and ``no_detection_image``
    (both images of one kind)."""
    rng = np.random.default_rng(seed)
    b = 2
    gt = np.array([[4, 4, 30, 30], [10, 20, 50, 40], [30, 8, 60, 44], [0, 0, 0, 0]], np.float32)
    batch = dict(
        images=rng.integers(0, 256, (b, 64, 64, 3), dtype=np.uint8),
        image_sizes=np.array([[64, 64], [48, 64]], np.int32),
        gt_boxes=np.tile(gt, (b, 1, 1)),
        gt_labels=rng.integers(1, 6, (b, 4)).astype(np.int32),
        gt_valid=np.array([[1, 1, 1, 0]] * b, bool),
        gt_masks=rng.choice(np.float32([0.2, 0.9]), (b, 4, 28, 28)),
        cap_mask=np.array([True, True]),
        det_mask=np.array([True, True]),
        cap_tok_ids=rng.integers(5, 64, (b, 3, 4)).astype(np.int32),
        cap_tok_mask=np.array([[[1, 1, 0, 0]] * 3] * b, np.int32),
        cap_word_valid=np.array([[1, 1, 0], [1, 0, 0]], bool),
        cap_labels=rng.integers(0, 20, (b, 3)).astype(np.int32),
        image_ids=np.arange(b, dtype=np.int64),
        class_embeddings=rng.standard_normal((6, 16)).astype(np.float32),
        lvis_class_embeddings=rng.standard_normal((20, 16)).astype(np.float32),
    )
    if variant == "image_in_neither_branch":
        batch["cap_mask"] = np.array([True, False])
        batch["det_mask"] = np.array([True, False])
    elif variant == "no_valid_pseudo_word":
        batch["cap_word_valid"][:] = False
    elif variant in ("detection_and_caption_images", "no_caption_image", "no_detection_image"):
        caption = {"detection_and_caption_images": [False, True], "no_caption_image": [False, False],
                   "no_detection_image": [True, True]}[variant]
        for i, is_caption in enumerate(caption):
            batch["cap_mask"][i], batch["det_mask"][i] = is_caption, not is_caption
            if is_caption:
                h, w = batch["image_sizes"][i]
                batch["gt_boxes"][i] = 0
                batch["gt_boxes"][i, 0] = [0, 0, w - 1, h - 1]
                batch["gt_labels"][i] = 0
                batch["gt_valid"][i] = [True, False, False, False]
                batch["gt_masks"][i] = 0
            else:
                batch["cap_word_valid"][i] = False
    else:
        assert variant == "both_branches", variant
    return batch


# the callbacks of a jitted program are fixed when it is traced, so they
# write here and each recorder reads what its own execution wrote
_SINK = {}


class JaxDraws(contextlib.ContextDecorator):
    """Records the JAX train step's random draws, by shape: the pseudo
    branch samples ``P_test`` candidates per image, the GT branch ``P_train
    + MAX_GT``."""

    def __init__(self, pseudo_n):
        self.pseudo_n = pseudo_n

    def __enter__(self):
        _SINK.clear()
        self._sub, self._normal = jax_st.subsample_rois, jax.random.normal
        sub, normal = self._sub, self._normal

        def record(name):
            return lambda x: _SINK.__setitem__(name, np.array(x, np.float32))

        def subsample(proposals, proposal_valid, gt_boxes, gt_labels, gt_valid, key, *a, **k):
            b, n = proposals.shape[:2]
            draws = []
            for kk in jax.random.split(key, b):
                kp, kn = jax.random.split(kk)
                draws.append(jnp.stack([jax.random.uniform(kp, (n,)), jax.random.uniform(kn, (n,))]))
            name = "pseudo_sampler" if n == self.pseudo_n else "gt_sampler"
            jax.debug.callback(record(name), jnp.stack(draws))
            return sub(proposals, proposal_valid, gt_boxes, gt_labels, gt_valid, key, *a, **k)

        def eps(key, shape=(), dtype=jnp.float32):
            v = normal(key, shape, dtype)
            jax.debug.callback(record("mask_eps"), v.astype(jnp.float32))
            return v

        jax_st.subsample_rois, jax.random.normal = subsample, eps
        return self

    def __exit__(self, *exc):
        jax_st.subsample_rois, jax.random.normal = self._sub, self._normal
        return False

    def draws(self, dtype=torch.float32):
        v = _SINK
        return TrainDraws(torch.from_numpy(v["pseudo_sampler"]), torch.from_numpy(v["gt_sampler"]),
                          torch.from_numpy(v["mask_eps"]).to(dtype))


def jax_cfg_of(opts):
    cfg = jax_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(TRAIN_OPTS + list(opts))
    return cfg


def make_setup(dtype="float32", opts=()):
    opts = ["TPU.COMPUTE_DTYPE", dtype] + list(opts)
    trainer = Trainer(CONFIG, TRAIN_OPTS + opts, device="cpu", seed=3)
    tree = bridge.seeded_flax_params(trainer.model, seed=0)
    trainer.load_flax_params(tree)
    cfg = jax_cfg_of(opts)
    model = jax_st.STGeneralizedRCNN(jax_st.st_statics_from_cfg(cfg))
    grad_fn = jax.jit(jax.grad(jax_train.build_loss_fn(model, "STGeneralizedRCNN"), has_aux=True))
    params = {"params": jax.tree_util.tree_map(jnp.asarray, tree)}
    return dict(trainer=trainer, tree=tree, cfg=cfg, model=model, grad_fn=grad_fn, params=params)


def jax_grads(setup, batch, with_eps=True):
    """(grads, losses, info, TrainDraws) of the JAX loss function."""
    rec = JaxDraws(setup["trainer"].model.statics.base.rpn_post_nms_test)
    with rec:
        grads, (losses, info) = setup["grad_fn"](
            setup["params"], jax.tree_util.tree_map(jnp.asarray, batch), jax.random.PRNGKey(0)
        )
        jax.block_until_ready(grads)
    if not with_eps:
        return grads, losses, info, None
    dtype = torch.bfloat16 if setup["cfg"].TPU.COMPUTE_DTYPE == "bfloat16" else torch.float32
    return grads, losses, info, rec.draws(dtype)


def port_forward(trainer, batch, draws):
    b = device_batch(batch, "cpu")
    return trainer.model(
        b["images"], b["image_sizes"], b["class_embeddings"], train=True, batch=b,
        lvis_class_embeddings=b["lvis_class_embeddings"], draws=draws,
    )


@pytest.fixture(scope="module")
def f32():
    return make_setup("float32")


def _rel_norm(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _grad_tol(name):
    return 2e-3 if "roi_extractor" in name else 1e-5


@pytest.mark.parametrize("variant", ["both_branches", "image_in_neither_branch", "no_valid_pseudo_word",
                                     "detection_and_caption_images", "no_caption_image", "no_detection_image"])
def test_train_forward_loss_dict_matches_jax(f32, variant):
    batch = tiny_batch(variant)
    _, losses, info, draws = jax_grads(f32, batch)
    with torch.no_grad():
        out = port_forward(f32["trainer"], batch, draws)
    assert tuple(out.losses) == LOSSES and set(out.info) == {"avg_uncertain", "adaptive_lamb"}
    for k in LOSSES:
        np.testing.assert_allclose(out.losses[k].numpy(), np.asarray(losses[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for k in out.info:
        np.testing.assert_allclose(out.info[k].numpy(), np.asarray(info[k]), rtol=1e-5, err_msg=k)
    assert all(torch.isfinite(v) for v in out.losses.values())
    if variant in ("no_valid_pseudo_word", "no_caption_image"):
        # no positive: avg_uncertain 0 and the adaptive weight 0, not inf
        assert float(out.info["avg_uncertain"]) == 0.0 and float(out.info["adaptive_lamb"]) == 0.0
        assert float(out.losses["loss_classifier_pseudo"]) == 0.0
        assert float(out.losses["loss_mask_pseudo"]) == 0.0
    else:
        assert float(out.info["adaptive_lamb"]) > 0 and float(out.losses["loss_mask_pseudo"]) > 0


def test_fixed_pseudo_weight_without_uncertainty_or_pseudo_mask_matches_jax():
    """``MODEL.UNCERTAINTY False`` (no sigma head, no samples: the
    caption branch is weighted by ``LAMBDA_PSEUDO_LABEL``) with
    ``MODEL.NO_PSEUDO_MASK`` (the pseudo mask loss is zeroed)."""
    setup = make_setup("float32", ["MODEL.UNCERTAINTY", False, "MODEL.NO_PSEUDO_MASK", True])
    assert not hasattr(setup["trainer"].model.student.mask_predictor, "uncertain_pred")
    batch = tiny_batch()
    _, losses, info, _ = jax_grads(setup, batch, with_eps=False)
    draws = TrainDraws(torch.from_numpy(_SINK["pseudo_sampler"]), torch.from_numpy(_SINK["gt_sampler"]))
    with torch.no_grad():
        out = port_forward(setup["trainer"], batch, draws)
    assert set(out.info) == set(info) == {"avg_uncertain"} and float(out.info["avg_uncertain"]) == 1.0
    for k in LOSSES:
        np.testing.assert_allclose(out.losses[k].numpy(), np.asarray(losses[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert float(out.losses["loss_mask_pseudo"]) == 0.0 and float(out.losses["loss_classifier_pseudo"]) > 0


def test_student_gradients_match_jax(f32):
    """The gradient of the summed losses for every trainable parameter;
    the frozen ones (backbone, RPN, teacher, word table) get none."""
    batch = tiny_batch()
    grads, _, _, draws = jax_grads(f32, batch)
    trainer = f32["trainer"]
    trainer.model.zero_grad(set_to_none=True)
    out = port_forward(trainer, batch, draws)
    sum(out.losses.values()).backward()
    ref = bridge.state_dict_from_flax(trainer.model, jax.tree_util.tree_map(np.asarray, grads))
    checked = 0
    for name, p in trainer.model.named_parameters():
        if not p.requires_grad:
            assert p.grad is None, name
            assert name.split(".")[0] in ("backbone", "rpn_head", "teacher", "bert"), name
            continue
        if name == "lambda_exemplar":  # no exemplars: unused
            assert p.grad is None and not ref[name].any()
            continue
        assert _rel_norm(p.grad.numpy(), ref[name].numpy()) <= _grad_tol(name), name
        checked += 1
    assert checked == sum(1 for n, _ in trainer.model.student.named_parameters())
    trainer.model.zero_grad(set_to_none=True)


def test_c5_head_gradient_is_as_close_to_jax_as_float32_allows():
    """The C5 head alone, on the same input and output gradient: the
    port's float32 weight gradients lie within 2e-3 of a float64 run of
    the port, and no farther from JAX's than twice that float32 error
    (plus 1e-6)."""
    from cvpr22_cross_modal_pseudo_labeling_tpu.models import resnet as jax_resnet
    from cvpr22_cross_modal_pseudo_labeling_torch.models import resnet as torch_resnet

    def head():
        return torch_resnet.ResNetRoIHead(in_channels=64, width_per_group=4, prestrided=True)

    tm = head()
    tree = bridge.seeded_flax_params(tm, seed=0)
    bridge.load_flax_params(tm, tree)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 7, 7, 64)).astype(np.float32)
    go = rng.standard_normal((32, 7, 7, 2048)).astype(np.float32)
    jm = jax_resnet.ResNetRoIHead(in_channels=64, width_per_group=4, prestrided=True)
    g = jax.jit(jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, jnp.asarray(x)) * go)))(
        jax.tree_util.tree_map(jnp.asarray, tree))
    ref = bridge.state_dict_from_flax(tm, jax.tree_util.tree_map(np.asarray, g))
    (tm(torch.from_numpy(x)) * torch.from_numpy(go)).sum().backward()
    t64 = head()
    bridge.load_flax_params(t64, tree)
    t64 = t64.double()
    for m in t64.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    (t64(torch.from_numpy(x).double()) * torch.from_numpy(go).double()).sum().backward()
    exact = dict(t64.named_parameters())
    for name, p in tm.named_parameters():
        own = _rel_norm(p.grad.numpy().astype(np.float64), exact[name].grad.numpy())
        vs_jax = _rel_norm(p.grad.numpy(), ref[name].numpy())
        assert own <= 2e-3 and vs_jax <= 2 * own + 1e-6, (name, own, vs_jax)


def test_generate_pseudo_labels_matches_jax(f32):
    """Teacher-regressed boxes (1e-4 px), scores (1e-6), valid flags and
    the binarized teacher masks (exact) of each caption noun."""
    batch = tiny_batch()
    jm, params = f32["model"], f32["params"]

    def run(m, images, sizes, ids, mask, valid, labels):
        x = jax_st.device_normalize(images, sizes)
        feats = m.backbone(x)
        _, _, _, props = m._rpn_proposals(x, sizes, feats, train_selector=False)
        return m.generate_pseudo_labels(feats, props, sizes, ids, mask, valid, labels)

    ref = jax.jit(lambda p, *a: jm.apply(p, *a, method=run))(
        params, *(jnp.asarray(batch[k]) for k in ("images", "image_sizes", "cap_tok_ids",
                                                   "cap_tok_mask", "cap_word_valid", "cap_labels")))
    model = f32["trainer"].model
    sb = model.statics.base
    b = device_batch(batch, "cpu")
    with torch.no_grad():
        x = device_normalize(b["images"], b["image_sizes"], sb.pixel_mean, sb.pixel_std, sb.to_bgr255)
        feats = model.backbone(x)
        obj, reg = flatten_rpn_outputs(*model.rpn_head(feats))
        props = model._proposals(feats, obj, reg, b["image_sizes"], False)
        out = model.generate_pseudo_labels(feats, props, b["image_sizes"], b["cap_tok_ids"],
                                           b["cap_tok_mask"], b["cap_word_valid"], b["cap_labels"])
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref["valid"]))
    np.testing.assert_allclose(out.boxes.numpy(), np.asarray(ref["boxes"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref["scores"]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out.masks.numpy(), np.asarray(ref["masks"]))
    np.testing.assert_array_equal(out.labels.numpy(), batch["cap_labels"])
    assert out.valid.sum() == batch["cap_word_valid"].sum() and out.masks.any()


def test_trainer_steps_match_jax_train_step():
    """Two ``Trainer.step`` calls against two steps of the jitted JAX
    ``build_train_step`` with ``make_optimizer`` (SGD, momentum 0.9,
    warmup, weight decay, bias groups): the metrics, each trainable
    parameter's update, and the frozen parameters and buffers bit for
    bit."""
    setup = make_setup("float32")
    trainer, cfg = setup["trainer"], setup["cfg"]
    tx, _ = jax_opt.make_optimizer(
        cfg, setup["params"]["params"], jax_opt.frozen_prefixes_from_cfg(cfg, "STGeneralizedRCNN"))
    state = jax_train.create_train_state(setup["params"], tx, jax.random.PRNGKey(0))
    step = jax.jit(jax_train.build_train_step(setup["model"], tx, "STGeneralizedRCNN"))
    frozen = {n: p.detach().clone() for n, p in trainer.model.named_parameters() if not p.requires_grad}
    student = {n: p.detach().clone() for n, p in trainer.model.student.named_parameters()}
    buffers = {n: b.clone() for n, b in trainer.model.named_buffers()}
    for it, variant in enumerate(["both_branches", "image_in_neither_branch"]):
        batch = tiny_batch(variant, seed=1 + it)
        rec = JaxDraws(trainer.model.statics.base.rpn_post_nms_test)
        with rec:
            state, metrics = step(state, jax.tree_util.tree_map(jnp.asarray, batch))
            jax.block_until_ready(state.params)
        prev = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        got = trainer.step(batch, rec.draws())
        for k in LOSSES + ("avg_uncertain", "adaptive_lamb", "total_loss"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(metrics[k]), rtol=1e-4, err_msg=k)
        # the JAX norm also counts the student's frozen-BN leaves
        assert abs(float(got["grad_norm"]) / float(metrics["grad_norm"]) - 1) < 5e-3
        ref = bridge.state_dict_from_flax(trainer.model, jax.tree_util.tree_map(np.asarray, state.params["params"]))
        for name, p in trainer.model.named_parameters():
            if not p.requires_grad:
                continue
            up = (p.detach() - prev[name]).numpy()
            want = ref[name].numpy() - prev[name].numpy()
            assert _rel_norm(up, want) <= 10 * _grad_tol(name), (it, name, _rel_norm(up, want))
            np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=0,
                                       atol=1e-5 * max(np.abs(ref[name].numpy()).max(), 1.0), err_msg=name)
    for n, p in trainer.model.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), n
    for n, b in trainer.model.named_buffers():
        assert torch.equal(b, buffers[n]), n
    for n, p in trainer.model.student.named_parameters():
        assert not torch.equal(p, student[n]), n


def test_trainer_draws_from_its_generator_reproducibly():
    """Without explicit draws the step draws from the trainer's seeded
    generator: the same seed gives the same metrics and parameters."""
    runs = []
    for _ in range(2):
        trainer = Trainer(CONFIG, TRAIN_OPTS, device="cpu", seed=11)
        trainer.load_flax_params(bridge.seeded_flax_params(trainer.model, seed=0))
        metrics = trainer.step(tiny_batch())
        runs.append((metrics, trainer.model.student.box_predictor.emb_pred.weight.detach().clone()))
    for k in runs[0][0]:
        assert torch.equal(runs[0][0][k], runs[1][0][k]), k
    assert torch.equal(runs[0][1], runs[1][1])
    assert all(torch.isfinite(v) for v in runs[0][0].values())


def test_bf16_train_loss_dict_matches_jax():
    """bfloat16 compute (float32 parameters and losses), on the same
    draws: every loss within 2% relative."""
    setup = make_setup("bfloat16")
    batch = tiny_batch()
    _, losses, info, draws = jax_grads(setup, batch)
    assert draws.mask_eps.dtype == torch.bfloat16
    with torch.no_grad():
        out = port_forward(setup["trainer"], batch, draws)
    for k in LOSSES:
        np.testing.assert_allclose(out.losses[k].numpy(), np.asarray(losses[k]), rtol=0.02, err_msg=k)
    np.testing.assert_allclose(out.info["avg_uncertain"].numpy(), np.asarray(info["avg_uncertain"]), rtol=0.02)


def test_trainer_needs_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(CONFIG, TRAIN_OPTS)
    with pytest.raises(KeyError, match="cap_mask"):
        device_batch({k: v for k, v in tiny_batch().items() if k != "cap_mask"}, "cpu")


def mixture_batch(tmp_path, monkeypatch):
    """A collated batch of 2 of the Conceptual/OpenImages mixture's
    loader (the port's, on the tiny tree of
    ``tests/test_torch_openimages.py``), one detection and one caption
    image, uint8, with this file's class tables: 13 rows (12 seen classes
    and the background) and the 1203 LVIS rows the caption nouns index.
    Its binary gt masks take the values 0.2 and 0.9, as ``tiny_batch``'s
    do: resampled at the sampled boxes, a 0/1 mask lands on the 0.5
    binarization threshold, where the last bit of either package's
    bilinear weights decides the target pixel."""
    from cvpr22_cross_modal_pseudo_labeling_torch.config import get_default_cfg
    from cvpr22_cross_modal_pseudo_labeling_torch.data import make_data_loader
    from tests.test_torch_openimages import STUDENT as OI_STUDENT
    from tests.test_torch_openimages import write_tiny_tree

    monkeypatch.setenv("CMPL_TPU_DATA_DIR", str(write_tiny_tree(tmp_path)))
    cfg = get_default_cfg()
    cfg.merge_from_file(OI_STUDENT)
    cfg.merge_from_list(["INPUT.MIN_SIZE_TRAIN", (64,), "INPUT.MAX_SIZE_TRAIN", 96, "TPU.IMAGE_BUCKETS", ((96, 96),),
                         "TPU.MAX_GT", 4, "TPU.MAX_CAP_NOUNS", 3, "SOLVER.IMS_PER_BATCH", 2,
                         "SOLVER.MAX_ITER", 20, "DATALOADER.NUM_WORKERS", 1])
    loader, _ = make_data_loader(cfg, is_train=True)
    batch = next(b for b, _ in loader if b["det_mask"].sum() == 1)
    rng = np.random.default_rng(5)
    keys = set(tiny_batch()) - {"class_embeddings", "lvis_class_embeddings"}
    batch["gt_masks"] = np.where(batch["gt_masks"] > 0.5, np.float32(0.9), np.float32(0.2))
    return dict({k: batch[k] for k in keys},
                class_embeddings=rng.standard_normal((13, 16)).astype(np.float32),
                lvis_class_embeddings=rng.standard_normal((1203, 16)).astype(np.float32))


def test_mixture_batch_loss_dict_and_gradients_match_jax(f32, tmp_path, monkeypatch):
    """A real batch of the mixture (a caption image with its dummy box,
    ``det_mask`` False, beside a detection image): every loss and the
    student's gradients against JAX's, at this file's tolerances."""
    batch = mixture_batch(tmp_path, monkeypatch)
    assert batch["images"].dtype == np.uint8 and batch["cap_word_valid"][~batch["det_mask"]].any()
    grads, losses, info, draws = jax_grads(f32, batch)
    trainer = f32["trainer"]
    trainer.model.zero_grad(set_to_none=True)
    out = port_forward(trainer, batch, draws)
    for k in LOSSES:
        np.testing.assert_allclose(out.losses[k].detach().numpy(), np.asarray(losses[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
        assert torch.isfinite(out.losses[k])
    assert float(out.losses["loss_classifier_pseudo"].detach()) > 0 and float(out.losses["loss_classifier"].detach()) > 0
    sum(out.losses.values()).backward()
    ref = bridge.state_dict_from_flax(trainer.model, jax.tree_util.tree_map(np.asarray, grads))
    for name, p in trainer.model.student.named_parameters():
        if name != "lambda_exemplar":
            assert _rel_norm(p.grad.numpy(), ref["student." + name].numpy()) <= _grad_tol(name), name
    trainer.model.zero_grad(set_to_none=True)
