"""The port's comparison baselines against the JAX package, on the CPU.

``SoftTeacher`` and ``UnbiasedTeacher`` (the top-2 confident-region
teachers) on ``student_teacher_mask_rcnn_uncertainty.yaml`` at the
narrow width of ``tests/test_torch_st_train.py``: their pseudo-labels
and their train steps on JAX's replayed draws, against the JAX
``baselines.py`` modules on the same weights and batch.  The three
``GeneralizedRCNN`` skeletons (``SBBaseline``, ``OMP``, ``BA_RPN``) on
``zeroshot_mask.yaml`` build and step as the teacher does.

Tolerances (float32), those of ``tests/test_torch_st_train.py``:
pseudo boxes 1e-4 px, scores and weights 1e-6, labels, valid flags and
binarized masks equal; losses 1e-5 relative (1e-4 after a step); each
student parameter's update within 10x its gradient tolerance of JAX's
(1e-4 of its norm, 2e-2 for the C5 head).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.config import get_default_cfg as jax_cfg
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import optimizer as jax_opt
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import train_step as jax_train
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import baselines as jax_baselines
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import build_detection_model as jax_build
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import st_generalized_rcnn as jax_st
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer, device_batch
from cvpr22_cross_modal_pseudo_labeling_torch.models.backbone import device_normalize
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector import baselines
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.generalized_rcnn import GeneralizedRCNN
from cvpr22_cross_modal_pseudo_labeling_torch.models.rpn.rpn import flatten_rpn_outputs
from tests.test_torch_st_train import CONFIG, LOSSES, TRAIN_OPTS, JaxDraws, _grad_tol, _rel_norm, tiny_batch
from tests.test_torch_teacher import TEACHER
from tests.test_torch_teacher import TRAIN_OPTS as TEACHER_OPTS
from tests.test_torch_teacher import tiny_batch as teacher_batch

TOP_K = ("SoftTeacher", "UnbiasedTeacher")


def make_setup(arch):
    opts = TRAIN_OPTS + ["MODEL.META_ARCHITECTURE", arch]
    trainer = Trainer(CONFIG, opts, device="cpu", seed=3)
    tree = bridge.seeded_flax_params(trainer.model, seed=0)
    trainer.load_flax_params(tree)
    cfg = jax_cfg()
    cfg.merge_from_file(CONFIG)
    cfg.merge_from_list(opts)
    model = jax_build(cfg)
    params = {"params": jax.tree_util.tree_map(jnp.asarray, tree)}
    return dict(trainer=trainer, tree=tree, cfg=cfg, model=model, params=params)


@pytest.fixture(scope="module")
def setups():
    return {arch: make_setup(arch) for arch in TOP_K}


def pseudo_batch():
    """``tiny_batch`` with tied caption nouns (two identical word
    pieces) and a second image whose caption has no valid noun."""
    batch = tiny_batch()
    batch["cap_tok_ids"][0, 1] = batch["cap_tok_ids"][0, 0]
    batch["cap_word_valid"][1] = False
    return batch


@pytest.mark.parametrize("arch", TOP_K)
def test_top_k_pseudo_labels_match_jax(setups, arch):
    """The two most confident regions of each image, their nouns' LVIS
    ids, sigmoid scores (the SoftTeacher weights), valid flags (none on
    the image without a noun) and binarized teacher masks."""
    setup = setups[arch]
    batch = pseudo_batch()
    jm, params = setup["model"], setup["params"]
    assert type(jm).__name__ == {"SoftTeacher": "SoftTeacherRCNN", "UnbiasedTeacher": "UnbiasedTeacherRCNN"}[arch]

    def run(m, images, sizes, ids, mask, valid, labels):
        x = jax_st.device_normalize(images, sizes)
        feats = m.backbone(x)
        _, _, _, props = m._rpn_proposals(x, sizes, feats, train_selector=False)
        return m.generate_pseudo_labels(feats, props, sizes, ids, mask, valid, labels)

    ref = jax.jit(lambda p, *a: jm.apply(p, *a, method=run))(
        params, *(jnp.asarray(batch[k]) for k in ("images", "image_sizes", "cap_tok_ids",
                                                   "cap_tok_mask", "cap_word_valid", "cap_labels")))
    model = setup["trainer"].model
    assert isinstance(model, baselines._TopKTeacherRCNN)
    sb = model.statics.base
    b = device_batch(batch, "cpu")
    with torch.no_grad():
        x = device_normalize(b["images"], b["image_sizes"], sb.pixel_mean, sb.pixel_std, sb.to_bgr255)
        feats = model.backbone(x)
        obj, reg = flatten_rpn_outputs(*model.rpn_head(feats))
        props = model._proposals(feats, obj, reg, b["image_sizes"], False)
        out = model.generate_pseudo_labels(feats, props, b["image_sizes"], b["cap_tok_ids"],
                                           b["cap_tok_mask"], b["cap_word_valid"], b["cap_labels"])
    assert out.boxes.shape == (2, 2, 4) and out.masks.shape[:2] == (2, 2)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref["valid"]))
    np.testing.assert_array_equal(out.labels.numpy(), np.asarray(ref["labels"]))
    np.testing.assert_allclose(out.boxes.numpy(), np.asarray(ref["boxes"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref["scores"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.weights.numpy(), np.asarray(ref["weights"]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(out.masks.numpy(), np.asarray(ref["masks"]))
    assert out.valid[0].all() and not out.valid[1].any()
    assert set(out.labels[0].tolist()) <= set(batch["cap_labels"][0][:2].tolist())


@pytest.mark.parametrize("arch", TOP_K)
def test_top_k_loss_dict_matches_jax(setups, arch):
    """Every loss and the info on JAX's draws; the caption branch's
    classification loss is the variant's own (weighted, or focal)."""
    setup = setups[arch]
    batch = tiny_batch()
    rec = JaxDraws(setup["trainer"].model.statics.base.rpn_post_nms_test)
    loss_fn = jax_train.build_loss_fn(setup["model"], arch)
    with rec:
        _, (losses, info) = jax.jit(loss_fn)(
            setup["params"], jax.tree_util.tree_map(jnp.asarray, batch), jax.random.PRNGKey(0))
        jax.block_until_ready(losses)
    b = device_batch(batch, "cpu")
    with torch.no_grad():
        out = setup["trainer"].model(
            b["images"], b["image_sizes"], b["class_embeddings"], train=True, batch=b,
            lvis_class_embeddings=b["lvis_class_embeddings"], draws=rec.draws())
    assert tuple(out.losses) == LOSSES
    for k in LOSSES:
        np.testing.assert_allclose(out.losses[k].numpy(), np.asarray(losses[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    for k in out.info:
        np.testing.assert_allclose(out.info[k].numpy(), np.asarray(info[k]), rtol=1e-5, err_msg=k)
    assert float(out.losses["loss_classifier_pseudo"]) > 0


def test_the_two_teachers_weigh_the_caption_branch_differently(setups):
    """The same weights, batch and draws: the pseudo-labels agree, the
    caption branch's classification loss does not (SoftTeacher weighs
    each positive by its target's confidence, UnbiasedTeacher applies
    the focal factor); the other losses agree."""
    batch = tiny_batch()
    outs = {}
    for arch in TOP_K:
        trainer = setups[arch]["trainer"]
        gen = torch.Generator().manual_seed(5)
        b = device_batch(batch, "cpu")
        with torch.no_grad():
            outs[arch] = trainer.model(
                b["images"], b["image_sizes"], b["class_embeddings"], train=True, batch=b,
                lvis_class_embeddings=b["lvis_class_embeddings"], generator=gen).losses
    soft, unbiased = outs["SoftTeacher"], outs["UnbiasedTeacher"]
    assert float(soft["loss_classifier_pseudo"]) != float(unbiased["loss_classifier_pseudo"])
    for k in ("loss_box_reg_pseudo", "loss_mask_pseudo", "loss_classifier", "loss_box_reg", "loss_mask"):
        assert torch.equal(soft[k], unbiased[k]), k


@pytest.mark.parametrize("arch", TOP_K)
def test_top_k_trainer_step_matches_jax_train_step(arch):
    """One ``Trainer.step`` against one step of the jitted JAX
    ``build_train_step``: the metrics and each student parameter's
    update; the frozen parameters do not move."""
    setup = make_setup(arch)
    trainer, cfg = setup["trainer"], setup["cfg"]
    tx, _ = jax_opt.make_optimizer(cfg, setup["params"]["params"], jax_opt.frozen_prefixes_from_cfg(cfg, arch))
    state = jax_train.create_train_state(setup["params"], tx, jax.random.PRNGKey(0))
    step = jax.jit(jax_train.build_train_step(setup["model"], tx, arch))
    frozen = {n: p.detach().clone() for n, p in trainer.model.named_parameters() if not p.requires_grad}
    batch = tiny_batch()
    rec = JaxDraws(trainer.model.statics.base.rpn_post_nms_test)
    with rec:
        state, metrics = step(state, jax.tree_util.tree_map(jnp.asarray, batch))
        jax.block_until_ready(state.params)
    prev = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    got = trainer.step(batch, rec.draws())
    for k in LOSSES + ("avg_uncertain", "adaptive_lamb", "total_loss"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(metrics[k]), rtol=1e-4, err_msg=k)
    ref = bridge.state_dict_from_flax(trainer.model, jax.tree_util.tree_map(np.asarray, state.params["params"]))
    for name, p in trainer.model.named_parameters():
        if not p.requires_grad:
            assert torch.equal(p, frozen[name]), name
            continue
        up = (p.detach() - prev[name]).numpy()
        want = ref[name].numpy() - prev[name].numpy()
        assert _rel_norm(up, want) <= 10 * _grad_tol(name), (name, _rel_norm(up, want))


@pytest.mark.parametrize("arch,cls", [
    ("SBBaseline", baselines.SBBaseline), ("OMP", baselines.OMPBaseline), ("BA_RPN", baselines.BARPNBaseline),
])
def test_skeleton_baselines_build_and_step_as_the_teacher(arch, cls):
    """``zeroshot_mask.yaml`` under each skeleton's name: the JAX class of
    the same name, the port's ``GeneralizedRCNN`` subclass, one step with
    the teacher's losses, update and checkpoint layout on the same
    weights, batch and generator."""
    cfg = jax_cfg()
    cfg.merge_from_file(TEACHER)
    cfg.merge_from_list(TEACHER_OPTS + ["MODEL.META_ARCHITECTURE", arch])
    assert type(jax_build(cfg)).__name__ == cls.__name__
    assert issubclass(getattr(jax_baselines, cls.__name__), jax_baselines.GeneralizedRCNN)
    runs = []
    for name in (arch, "GeneralizedRCNN"):
        trainer = Trainer(TEACHER, TEACHER_OPTS + ["MODEL.META_ARCHITECTURE", name], device="cpu", seed=11)
        trainer.load_flax_params(bridge.seeded_flax_params(trainer.model, seed=0))
        runs.append((trainer, trainer.step(teacher_batch())))
    (trainer, got), (teacher, want) = runs
    assert type(trainer.model) is cls and isinstance(trainer.model, GeneralizedRCNN)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    sd, ref = trainer.model.state_dict(), teacher.model.state_dict()
    assert list(sd) == list(ref) and all(torch.equal(sd[k], ref[k]) for k in ref)
