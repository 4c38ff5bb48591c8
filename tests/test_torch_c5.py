"""Both detector families on the R-50-C5 body against the JAX package on
the CPU, plain (res5 at stride 32, anchors and pooler at 1/32) and
dilated (``RES5_DILATION 2``: res5 at stride 16, the pooler at 1/16
emitting every bin, as ``pool_prestride`` is off).

- The parameter trees, leaf for leaf (names and shapes), at the narrow
  widths of ``tests/test_torch_teacher.py`` and, for the teacher, at full
  width: the RPN conv maps the trunk's 2048 channels to
  ``BACKBONE_OUT_CHANNELS`` (1024), and the RoI head's block 0 reads the
  2048-wide pooled features through a ``downsample_conv`` (its statics'
  ``in_channels`` is 1024, not its 2048 output).
- The teacher's (``zeroshot_mask.yaml``) five training losses on the JAX
  program's own draws, within 1e-5 relative; the gradients of its box and
  mask predictors within 1e-5 of the JAX gradient's norm, of every other
  trained parameter (res3 to res5 of the trunk, the RPN, the RoI head)
  within 1e-3 (each sums many convolutions in its own order); its eval
  detections (boxes 1e-3 px, scores 1e-5) and masks (1e-4).
- The student-teacher model's (``student_teacher_mask_rcnn_uncertainty
  .yaml``) losses within 1e-5 relative and its eval as the teacher's.
  JAX builds its C5 trunk without ``RES5_DILATION``
  (``st_generalized_rcnn.py:186-190``) while its RoI heads dilate res5;
  the port builds the same model.
- The importers on a C5 teacher's own checkpoint: the port fills the
  trunk's res5, which JAX's importer leaves partly unfilled.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.config import get_default_cfg as jax_cfg
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import checkpoint as jax_ckpt
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import train_step as jax_train
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import generalized_rcnn as jax_grcnn
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import statics as jax_statics
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.config import get_default_cfg as torch_cfg
from cvpr22_cross_modal_pseudo_labeling_torch.engine import checkpoint as torch_ckpt
from cvpr22_cross_modal_pseudo_labeling_torch.models.backbone import ResNetBackbone
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector import build_detection_model
from tests import test_torch_st_train as st
from tests import test_torch_teacher as teacher
from tests.test_torch_fpn import STUDENT, TEACHER, TREE_WIDTHS, _cfg, _jax_tree_shapes

BODIES = {
    "plain": ["MODEL.BACKBONE.CONV_BODY", "R-50-C5", "MODEL.RPN.ANCHOR_STRIDE", (32,),
              "MODEL.ROI_BOX_HEAD.POOLER_SCALES", (0.03125,)],
    "dilated": ["MODEL.BACKBONE.CONV_BODY", "R-50-C5", "MODEL.RESNETS.RES5_DILATION", 2,
                "MODEL.ROI_BOX_HEAD.POOLER_SCALES", (0.0625,)],
}
NARROW = ["MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 16]


def _port_shapes(model):
    """Each port key's flax path and flax-layout shape, without copying
    the weights (broadcast views stand for them)."""
    modules = dict(model.named_modules())
    out = {}
    for key, value in model.state_dict().items():
        path, kind = bridge._flax_path(modules, key)
        view = np.broadcast_to(np.zeros((), np.uint8), tuple(value.shape))
        out["/".join(path)] = tuple(bridge._to_flax(view, kind).shape)
    return out


@pytest.mark.parametrize("body", sorted(BODIES))
@pytest.mark.parametrize("family", ["teacher", "student"])
def test_c5_trees_match_jax_leaf_for_leaf(family, body):
    config = TEACHER if family == "teacher" else STUDENT
    opts = TREE_WIDTHS + BODIES[body] + ["TPU.MAX_GT", 1, "TPU.MAX_CAP_NOUNS", 2, "TPU.COMPUTE_DTYPE", "float32"]
    want = _jax_tree_shapes(family, _cfg(jax_cfg, config, opts))
    model = build_detection_model(_cfg(torch_cfg, config, opts))
    got = _port_shapes(model)
    if family == "student":
        got["bert/word_embeddings"] = want["bert/word_embeddings"]  # the vocab the JAX init was cut to
    assert got == want, set(got) ^ set(want)
    assert isinstance(model.backbone, ResNetBackbone) and len(model.backbone.body.layer4) == 3
    # the trunk's C5 (res2 16 -> 128 channels) under a 16-channel RPN, and
    # the RoI head's block 0 reading the 128-wide pooled features
    assert got["rpn_head/conv/kernel"] == (3, 3, 128, 16)
    heads = ["roi_extractor"] if family == "teacher" else ["teacher/roi_extractor", "student/roi_extractor"]
    for h in heads:
        assert got[f"{h}/layer4/block0/downsample_conv/kernel"] == (1, 1, 128, 2048)
        assert got[f"{h}/layer4/block0/conv1/kernel"] == (1, 1, 128, 32)
    dilation = model.backbone.body.layer4.block1.conv2.dilation
    assert dilation == ((2, 2) if body == "dilated" and family == "teacher" else (1, 1))


def test_c5_teacher_tree_at_full_width_matches_jax():
    """The dilated C5 teacher at the config's widths: JAX's tree from
    ``jax.eval_shape`` (nothing computed), the port's shapes from its
    state_dict."""
    cfg = _cfg(jax_cfg, TEACHER, BODIES["dilated"])
    m = jax_grcnn.GeneralizedRCNN(jax_statics.statics_from_cfg(cfg))
    images, sizes = jnp.zeros((1, 64, 64, 3)), jnp.array([[64, 64]], jnp.int32)
    tree = jax.eval_shape(lambda: m.init({"params": jax.random.PRNGKey(0)}, images, sizes,
                                         jnp.zeros((3, 768)), train=False))["params"]
    want = {"/".join(p): tuple(v.shape) for p, v in bridge._flatten(tree).items()}
    got = _port_shapes(build_detection_model(_cfg(torch_cfg, TEACHER, BODIES["dilated"])))
    assert got == want, set(got) ^ set(want)
    assert got["rpn_head/conv/kernel"] == (3, 3, 2048, 1024)
    assert got["roi_extractor/layer4/block0/downsample_conv/kernel"] == (1, 1, 2048, 2048)
    assert got["roi_extractor/layer4/block0/conv1/kernel"] == (1, 1, 2048, 512)


@pytest.fixture(scope="module", params=sorted(BODIES))
def c5_teacher(request):
    return request.param, teacher.make_setup("float32", BODIES[request.param] + NARROW)


def test_c5_teacher_losses_and_gradients_match_jax(c5_teacher):
    body, setup = c5_teacher
    batch = teacher.tiny_batch()
    grads, losses, _, draws = teacher.jax_grads(setup, batch)
    hw = 4 if body == "dilated" else 2  # the C5 map of a 64 x 64 image
    assert tuple(draws.rpn_sampler.shape) == (2, 2, hw * hw * 15)
    trainer = setup["trainer"]
    trainer.model.zero_grad(set_to_none=True)
    out = teacher.port_forward(trainer.model, batch, draws)
    for k in teacher.LOSSES:
        np.testing.assert_allclose(out.losses[k].detach().numpy(), np.asarray(losses[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    sum(out.losses.values()).backward()
    ref = bridge.state_dict_from_flax(trainer.model, jax.tree_util.tree_map(np.asarray, grads))
    held = set()
    for name, p in trainer.model.named_parameters():
        if not p.requires_grad:
            assert p.grad is None and name.startswith(teacher.FROZEN), name
            continue
        tol = 1e-5 if name.startswith(teacher.PREDICTORS) else 1e-3
        assert teacher._rel_norm(p.grad.numpy(), ref[name].numpy()) <= tol, name
        held.add(".".join(name.split(".")[:3]))
    assert {"backbone.body.layer2", "backbone.body.layer4", "rpn_head.conv.weight", "roi_extractor.layer4.block0",
            "mask_predictor.conv5_mask.weight"} <= held
    trainer.model.zero_grad(set_to_none=True)


def _eval_pair(setup, batch, jax_model):
    images, sizes, table = batch["images"], batch["image_sizes"], batch["class_embeddings"]
    ref = jax.jit(lambda p, i, s, c: jax_model.apply(p, i, s, class_embeddings=c, train=False))(
        setup["params"], images, sizes, table)
    model = setup["trainer"].model.eval()
    with torch.no_grad():
        out = model(torch.from_numpy(images), torch.from_numpy(sizes), torch.from_numpy(table))
    model.train()
    return ref, out


def _same_eval(ref, out, mask_size):
    rd, od = ref.detections, out.detections
    valid = np.asarray(rd.valid)
    assert valid.sum(axis=1).min() > 0, "the tiny model should detect something per image"
    np.testing.assert_array_equal(od.valid.numpy(), valid)
    np.testing.assert_array_equal(od.labels.numpy(), np.asarray(rd.labels))
    np.testing.assert_allclose(od.boxes.numpy(), np.asarray(rd.boxes), rtol=0, atol=1e-3)
    np.testing.assert_allclose(od.scores.numpy(), np.asarray(rd.scores), rtol=0, atol=1e-5)
    assert out.mask_probs.shape == (2, 100, mask_size, mask_size)
    np.testing.assert_allclose(out.mask_probs.numpy(), np.asarray(ref.mask_probs), rtol=0, atol=1e-4)


def test_c5_teacher_eval_matches_jax(c5_teacher):
    """Masks 14 x 14 from the plain body (the prestrided head at stride 1
    on 7 x 7 bins), 28 x 28 from the dilated one (14 x 14 bins, res5 at
    stride 1)."""
    body, setup = c5_teacher
    ref, out = _eval_pair(setup, teacher.tiny_batch(), setup["model"])
    _same_eval(ref, out, 28 if body == "dilated" else 14)


@pytest.fixture(scope="module", params=sorted(BODIES))
def c5_student(request):
    return request.param, st.make_setup("float32", BODIES[request.param] + NARROW)


def test_c5_student_losses_and_eval_match_jax(c5_student):
    body, setup = c5_student
    batch = st.tiny_batch()
    loss_fn = jax_train.build_loss_fn(setup["model"], "STGeneralizedRCNN")
    rec = st.JaxDraws(setup["trainer"].model.statics.base.rpn_post_nms_test)
    with rec:
        losses, info = jax.jit(lambda p, b, k: loss_fn(p, b, k)[1])(
            setup["params"], jax.tree_util.tree_map(jnp.asarray, batch), jax.random.PRNGKey(0))
        jax.block_until_ready(losses)
    draws = rec.draws()
    trainer = setup["trainer"]
    with torch.no_grad():
        out = st.port_forward(trainer, batch, draws)
    for k in st.LOSSES:
        np.testing.assert_allclose(out.losses[k].numpy(), np.asarray(losses[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    for k in out.info:
        np.testing.assert_allclose(out.info[k].numpy(), np.asarray(info[k]), rtol=1e-5, err_msg=k)
    ref, got = _eval_pair(setup, batch, setup["model"])
    _same_eval(ref, got, 28 if body == "dilated" else 14)


@pytest.mark.parametrize("widths,jax_unfilled", [("narrow", 27), ("full", 48)])
def test_c5_teacher_import_fills_its_trunk_c5_stage(widths, jax_unfilled):
    """A C5 teacher's checkpoint into the same model: JAX's importer
    tries the RoI head before the identity path for every trunk
    ``layer4`` leaf, so the same-shaped ones land on the head and 27 of
    the trunk's 50 stay unfilled at the tests' widths, 48 at the config's;
    the port puts them on the trunk and fills every leaf from its source
    (the divergence kept for the FPN trunk, ROADMAP.md section C)."""
    opts = (TREE_WIDTHS if widths == "narrow" else []) + BODIES["dilated"]
    model = build_detection_model(_cfg(torch_cfg, TEACHER, opts))
    target, source = bridge.seeded_flax_params(model, 1), bridge.seeded_flax_params(model, 2)
    src = bridge._flatten(source)
    trunk = [k for k in src if k[:3] == ("backbone", "body", "layer4")]
    assert len(trunk) == 50
    for importer, unfilled in ((jax_ckpt, jax_unfilled), (torch_ckpt, 0)):
        tree, report = importer.import_flax_params(target, source, load_classifier=True)
        got = bridge._flatten(tree)
        missed = [k for k in trunk if not np.array_equal(got[k], src[k])]
        assert len(missed) == len(report["unfilled_targets"]) == unfilled, importer.__name__
    assert all(np.array_equal(got[k], src[k]) for k in got)  # the port's: every leaf from its source
