"""The port's RetinaNet against the JAX package on the CPU.

- ``sigmoid_focal_loss``: values and gradients with targets -1 (ignored),
  0 (background) and 1..C, within 1e-6 relative (float32).
- ``RetinaNetHead`` at 16 channels and 2 tower convs on five levels:
  float32 within 1e-5 relative; bfloat16 within 2 bfloat16 ulps of each
  output's largest magnitude (flax rounds each conv to bfloat16 before
  it adds the bias, torch adds it first: the towers' activations differ
  by an ulp here and there, which an output near 0 carries as many of
  its own ulps).
- ``retinanet_loss`` on the five levels' anchors of a 64 x 64 image with
  an ignore band, a gt reached only by its low-quality match and padded
  gt slots: both losses within 1e-5 relative.
- ``retinanet_inference`` on logits rounded to a coarse grid, so that
  scores tie inside and across levels: kept indices (as boxes, labels
  and validity) exact, boxes within 1e-5 px.  The stable-sort ``top_k``
  it uses equals ``lax.top_k`` on tied and negative inputs.
- ``RetinaNetDetector`` through ``build_detection_model`` builds JAX's
  parameter tree at full width (the R-50 trunk and 256 FPN channels,
  whatever ``MODEL.RESNETS`` says, as JAX builds it).  At narrow widths
  (stem 8, res2 16, width 4, a 16-channel FPN, one tower conv, 4
  classes; the JAX module subclassed here to take the same trunk) the
  eval forward, the losses and one ``Trainer`` step against JAX's jitted
  train step: detections as the FPN tests hold them (boxes 1e-3 px,
  scores 5e-5), losses 1e-5, updates 1e-3 of the JAX update's norm.
- ``import_torch_state_dict`` of a state dict under maskrcnn_benchmark's
  RetinaNet names, and of a Caffe2 R-50 ``.pkl``: the port fills the
  same leaves with the same values as JAX's importer.
- ``train_net`` (two steps, then a resume to three) and ``test_net
  --ckpt`` on a tiny synthetic COCO tree at full width on 64 x 64
  images: finite losses and metrics, one result per image at least.
"""

import math
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.config import get_default_cfg as jax_cfg
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import c2_loading as jax_c2
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import checkpoint as jax_ckpt
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import optimizer as jax_opt
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import train_step as jax_train
from cvpr22_cross_modal_pseudo_labeling_tpu.models import backbone as jax_backbone
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import build_detection_model as jax_build
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import retinanet as jax_det
from cvpr22_cross_modal_pseudo_labeling_tpu.models.rpn import anchors as jax_anchors
from cvpr22_cross_modal_pseudo_labeling_tpu.models.rpn import retinanet as jax_retina
from cvpr22_cross_modal_pseudo_labeling_tpu.ops.sigmoid_focal_loss import sigmoid_focal_loss as jax_focal
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.config import RETINANET_OPTS
from cvpr22_cross_modal_pseudo_labeling_torch.config import get_default_cfg as torch_cfg
from cvpr22_cross_modal_pseudo_labeling_torch.engine import c2_loading as torch_c2
from cvpr22_cross_modal_pseudo_labeling_torch.engine import checkpoint as torch_ckpt
from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector import build_detection_model
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.retinanet import RetinaNetDetector
from cvpr22_cross_modal_pseudo_labeling_torch.models.rpn import retinanet as torch_retina
from cvpr22_cross_modal_pseudo_labeling_torch.models.rpn.anchors import build_anchors_for_levels
from cvpr22_cross_modal_pseudo_labeling_torch.models.rpn.rpn import top_k
from cvpr22_cross_modal_pseudo_labeling_torch.ops.sigmoid_focal_loss import sigmoid_focal_loss
from cvpr22_cross_modal_pseudo_labeling_torch.tools import test_net
from tests import test_torch_train_net as tn
from tests.tensorboard_stub import tensorboard_compat_reset  # noqa: F401  (an autouse fixture)

NARROW = dict(stem_out_channels=8, res2_out_channels=16, width_per_group=4)
FPN_CHANNELS = 16
STATICS = torch_retina.RetinaNetStatics(num_classes=4, num_convs=1, anchor_sizes=(8, 16, 32, 64, 128),
                                        pre_nms_top_n=200, detections_per_img=50)
LEVEL_HW = ((8, 8), (4, 4), (2, 2), (1, 1), (1, 1))  # P3..P7 of a 64 x 64 image
RETINA_CFG = [*RETINANET_OPTS, "MODEL.RETINANET.NUM_CLASSES", 4, "MODEL.RETINANET.NUM_CONVS", 1,
              "MODEL.RETINANET.ANCHOR_SIZES", (8, 16, 32, 64, 128), "TPU.COMPUTE_DTYPE", "float32",
              "TPU.MAX_GT", 4]


def _jax_statics(s):
    return jax_retina.RetinaNetStatics(**s._asdict())


def _anchors(s=STATICS):
    got = build_anchors_for_levels(LEVEL_HW, s.anchor_strides, torch_retina.retinanet_anchor_sizes(s),
                                   s.aspect_ratios, torch.device("cpu"))
    ref = jax_anchors.build_anchors_for_levels(LEVEL_HW, s.anchor_strides,
                                               jax_retina.retinanet_anchor_sizes(_jax_statics(s)), s.aspect_ratios)
    for a, r in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    return got


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(np.asarray(b)), 1e-30))


# ---------------------------------------------------------------------------
# sigmoid focal loss, the head, the loss, inference
# ---------------------------------------------------------------------------


def test_sigmoid_focal_loss_and_its_gradient_match_jax():
    rng = np.random.default_rng(0)
    n, c = 300, 5
    logits = (rng.standard_normal((n, c)) * 4).astype(np.float32)
    targets = rng.integers(-1, c + 1, n).astype(np.int32)
    assert {-1, 0, 1, c} <= set(targets.tolist())
    weights = rng.uniform(0.5, 2, (n, c)).astype(np.float32)
    ref = jax_focal(jnp.asarray(logits), jnp.asarray(targets), 2.0, 0.25)
    ref_grad = jax.grad(lambda x: jnp.sum(jax_focal(x, jnp.asarray(targets), 2.0, 0.25) * weights))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = sigmoid_focal_loss(x, torch.from_numpy(targets).long(), 2.0, 0.25)
    (got * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad), rtol=1e-6, atol=1e-7)
    assert not got.detach().numpy()[targets < 0].any()
    # batched: [B, N, C] with [B, N] targets is the per-image loss
    batched = sigmoid_focal_loss(x.detach().reshape(3, 100, c), torch.from_numpy(targets).long().reshape(3, 100),
                                 2.0, 0.25)
    np.testing.assert_array_equal(batched.reshape(n, c).numpy(), got.detach().numpy())


def _head_pair(dtype, num_convs=2):
    s = STATICS._replace(num_convs=num_convs)
    head = torch_retina.RetinaNetHead(s, FPN_CHANNELS, dtype)
    tree = bridge.seeded_flax_params(head, 0)
    bridge.load_flax_params(head, tree)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jhead = jax_retina.RetinaNetHead(_jax_statics(s), FPN_CHANNELS, jdt)
    return head, jhead, {"params": jax.tree_util.tree_map(jnp.asarray, tree)}


def test_retinanet_head_init_is_jax_init():
    """normal(0.01) kernels, zero biases, the prior on ``cls_logits``."""
    s = STATICS._replace(num_convs=4)
    head = torch_retina.RetinaNetHead(s, FPN_CHANNELS)
    jhead = jax_retina.RetinaNetHead(_jax_statics(s), FPN_CHANNELS)
    feats = [jnp.zeros((1, 4, 4, FPN_CHANNELS))]
    ref = jax.tree_util.tree_map(np.asarray, jhead.init(jax.random.PRNGKey(0), feats)["params"])
    got = bridge.flax_from_state_dict(head)
    assert jax.tree_util.tree_structure(ref) == jax.tree_util.tree_structure(got)
    for (path, r), g in zip(jax.tree_util.tree_flatten_with_path(ref)[0], jax.tree_util.tree_leaves(got)):
        name = "/".join(p.key for p in path)
        assert r.shape == g.shape, name
        if name.endswith("bias"):
            np.testing.assert_array_equal(g, r, err_msg=name)
        else:
            assert abs(g.std() - 0.01) < 1e-3 and abs(r.std() - 0.01) < 1e-3, name
    assert np.allclose(got["cls_logits"]["bias"], -math.log(99.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_retinanet_head_matches_jax(dtype):
    head, jhead, params = _head_pair(dtype)
    rng = np.random.default_rng(1)
    feats = [rng.standard_normal((2, h, w, FPN_CHANNELS)).astype(np.float32) for h, w in LEVEL_HW]
    ref_logits, ref_reg = jhead.apply(params, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        logits, reg = head([torch.from_numpy(f) for f in feats])
    for got, ref in zip(logits + reg, list(ref_logits) + list(ref_reg)):
        assert got.dtype == dtype and tuple(got.shape) == ref.shape
        g, r = got.float().numpy(), np.asarray(ref, np.float32)
        if dtype == torch.float32:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5 * np.abs(r).max())
        else:
            ulp = np.ldexp(1.0, np.frexp(np.abs(r).max())[1] - 8)
            assert np.abs(g - r).max() <= 2 * ulp, float(np.abs(g - r).max() / ulp)


def _loss_inputs(seed=2):
    """Two images: image 0 has a large box (many positives and an ignore
    band), a small box whose best IoU is under 0.4 (reached only by its
    low-quality match) and a padded slot; image 1 one box and two padded
    slots."""
    rng = np.random.default_rng(seed)
    anchors = torch.cat(_anchors())
    n = anchors.shape[0]
    gt = np.array([[[6, 8, 50, 44], [20, 30, 23, 32], [0, 0, 0, 0]],
                   [[30, 2, 62, 40], [0, 0, 0, 0], [0, 0, 0, 0]]], np.float32)
    valid = np.array([[1, 1, 0], [1, 0, 0]], bool)
    labels = np.array([[2, 3, 0], [1, 0, 0]], np.int32)
    logits = (rng.standard_normal((2, n, STATICS.num_classes - 1)) * 2 - 3).astype(np.float32)
    reg = (rng.standard_normal((2, n, 4)) * 0.5).astype(np.float32)
    return anchors, logits, reg, gt, labels, valid


def test_retinanet_loss_matches_jax():
    anchors, logits, reg, gt, labels, valid = _loss_inputs()
    a = jnp.asarray(anchors.numpy())
    ref = jax.jit(lambda *x: jax_retina.retinanet_loss(*x, _jax_statics(STATICS)))(
        a, jnp.asarray(logits), jnp.asarray(reg), jnp.asarray(gt), jnp.asarray(labels), jnp.asarray(valid))
    got = torch_retina.retinanet_loss(anchors, torch.from_numpy(logits), torch.from_numpy(reg), torch.from_numpy(gt),
                                      torch.from_numpy(labels), torch.from_numpy(valid), STATICS)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-5)
        assert float(g) > 0
    # the inputs reach every branch: positives, the ignore band, a
    # low-quality match, padded gt slots
    from cvpr22_cross_modal_pseudo_labeling_torch.core.boxes import box_iou
    from cvpr22_cross_modal_pseudo_labeling_torch.core.matcher import match_boxes

    iou = box_iou(torch.from_numpy(gt), anchors)
    matched = match_boxes(iou, torch.from_numpy(valid), 0.5, 0.4, allow_low_quality_matches=True)
    assert (matched == -2).any() and (matched[0] == 0).any() and (matched[1] == 0).any()
    assert float(iou[0, 1].max()) < 0.4 and (matched[0] == 1).sum() >= 1


def _tied_head_outputs(seed=3):
    """Per-level logits on a 0.5 grid (scores tie within and across
    levels) and box regression, for two images."""
    rng = np.random.default_rng(seed)
    a = len(STATICS.aspect_ratios) * STATICS.scales_per_octave
    c = STATICS.num_classes - 1
    logits = [np.round(rng.standard_normal((2, h, w, a * c)) * 2) / 2 - 1 for h, w in LEVEL_HW]
    reg = [rng.standard_normal((2, h, w, a * 4)) * 0.3 for h, w in LEVEL_HW]
    return [x.astype(np.float32) for x in logits], [x.astype(np.float32) for x in reg]


def test_retinanet_inference_matches_jax_with_ties():
    anchors = _anchors()
    logits, reg = _tied_head_outputs()
    sizes = np.array([[64, 64], [48, 56]], np.int32)
    s = STATICS._replace(inference_th=0.3, detections_per_img=300)
    ref = jax.jit(lambda al, lg, rg, sz: jax_retina.retinanet_inference(al, lg, rg, sz, _jax_statics(s)))(
        [jnp.asarray(x.numpy()) for x in anchors], [jnp.asarray(x) for x in logits], [jnp.asarray(x) for x in reg],
        jnp.asarray(sizes))
    got = torch_retina.retinanet_inference(anchors, [torch.from_numpy(x) for x in logits],
                                           [torch.from_numpy(x) for x in reg], torch.from_numpy(sizes), s)
    flat = np.concatenate([torch.sigmoid(torch.from_numpy(x)).numpy().reshape(2, -1) for x in logits], 1)
    assert len(np.unique(flat)) < 20, "the scores should tie"
    valid = np.asarray(ref.valid)
    assert 0 < valid.sum(1).min() and valid.sum(1).max() < s.detections_per_img
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    assert got.labels.dtype == torch.int32 and set(np.unique(got.labels.numpy()[valid])) <= {1, 2, 3}
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(ref.scores))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(ref.boxes), rtol=0, atol=1e-5)


@pytest.mark.parametrize("k", [1, 7, 64, 300])
def test_top_k_is_lax_top_k_on_ties(k):
    """The stable-sort ``top_k`` that the RPN and RetinaNet's inference
    run equals ``lax.top_k`` exactly, values and indices: ties keep the
    lower index first, negatives order below 0.0, and -0.0 orders below
    0.0 (the sort runs on the floats' total order), in float32 and
    bfloat16."""
    rng = np.random.default_rng(k)
    x = np.round(rng.standard_normal((3, 300)) * 2) / 2 + 0.0  # no -0.0
    x[1, ::5] = 0.0
    signed = x.copy()
    signed[1, ::10] = -0.0
    signed[2, ::7] = -0.0
    signed[2, 3::7] = 0.0
    for rows in (x, signed):
        for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            t = torch.from_numpy(rows.astype(np.float32)).to(dtype)
            got = top_k(t, k)
            ref = jax.lax.top_k(jnp.asarray(rows.astype(np.float32)).astype(jdtype), k)
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
            np.testing.assert_array_equal(got[0].float().numpy(), np.asarray(ref[0].astype(jnp.float32)))
            # the signed zeros come out where lax.top_k puts them
            np.testing.assert_array_equal(np.signbit(got[0].float().numpy()),
                                          np.signbit(np.asarray(ref[0].astype(jnp.float32))))
    assert (np.signbit(signed) & (signed == 0)).any()


# ---------------------------------------------------------------------------
# the detector
# ---------------------------------------------------------------------------


def test_registry_builds_jax_retinanet_tree_at_full_width():
    """``RETINANET_ON`` strips the body's suffix and builds the R-50 trunk
    with 256 FPN channels, P6 from C5, whatever the trunk widths say."""
    narrow = ["MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
              "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 16]
    opts = RETINA_CFG + narrow + ["MODEL.BACKBONE.CONV_BODY", "R-50-FPN"]
    tc, jc = torch_cfg(), jax_cfg()
    for c in (tc, jc):
        c.merge_from_list(opts)
    model = build_detection_model(tc)
    assert isinstance(model, RetinaNetDetector) and model.net.head.cls_logits.weight.dtype == torch.float32
    images, sizes = jnp.zeros((1, 64, 64, 3), jnp.uint8), jnp.array([[64, 64]], jnp.int32)
    shapes = jax.eval_shape(lambda: jax_build(jc).init(jax.random.PRNGKey(0), images, sizes, train=False))
    want = {"/".join(p.key for p in path): tuple(v.shape)
            for path, v in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    got = {"/".join(p): tuple(np.shape(v)) for p, v in bridge._flatten(bridge.flax_from_state_dict(model)).items()}
    assert got == want
    assert got["net/backbone/fpn/fpn_p6/kernel"] == (3, 3, 2048, 256)
    assert got["net/head/cls_logits/kernel"] == (3, 3, 256, 9 * 3)
    tc.defrost()
    tc.merge_from_list(["TPU.COMPUTE_DTYPE", "bfloat16", "MODEL.BACKBONE.CONV_BODY", "R-101-FPN-RETINANET"])
    deep = build_detection_model(tc)
    assert len(deep.net.backbone.body.layer3) == 23 and deep.net.head.cls_tower0.compute_dtype == torch.bfloat16


class _NarrowJaxRetinaNet(jax_retina.RetinaNet):
    """JAX's RetinaNet on a narrow trunk (the port's ``trunk`` argument)."""

    def setup(self):
        self.backbone = jax_backbone.ResNetFPNBackbone(depth=self.backbone_depth,
                                                       out_channels=self.backbone_out_channels,
                                                       retinanet=True, dtype=self.dtype, **NARROW)
        self.head = jax_retina.RetinaNetHead(self.statics, self.backbone_out_channels, self.dtype)


class _NarrowJaxDetector(jax_det.RetinaNetDetector):
    """On the narrow trunk; takes (and drops) the ``class_valid`` keyword
    that JAX's loss function passes and its detector refuses
    (:func:`test_jax_train_step_cannot_step_its_own_retinanet`)."""

    def setup(self):
        self.net = _NarrowJaxRetinaNet(self.statics, backbone_depth=self.backbone_depth,
                                       backbone_out_channels=FPN_CHANNELS, dtype=self.dtype)

    def __call__(self, images, image_sizes, class_embeddings=None, targets=None, train=False, gt_eval=None,
                 class_valid=None):
        return super().__call__(images, image_sizes, class_embeddings, targets, train, gt_eval)


# INFERENCE_TH 0 for the random weights, whose scores spread around the
# 0.01 prior
NARROW_OPTS = ["MODEL.RETINANET.INFERENCE_TH", 0.0, "SOLVER.BASE_LR", 0.01, "SOLVER.WARMUP_ITERS", 0]


def _narrow_pair():
    tc = torch_cfg()
    tc.merge_from_list(RETINA_CFG + NARROW_OPTS)
    tc.freeze()
    s = torch_retina.retinanet_statics_from_cfg(tc)
    model = RetinaNetDetector(s, backbone_out_channels=FPN_CHANNELS, trunk=NARROW)
    trainer = Trainer(tc, device="cpu", model=model)
    tree = bridge.seeded_flax_params(model, 0)
    trainer.load_flax_params(tree)
    jc = jax_cfg()
    jc.merge_from_list(RETINA_CFG + NARROW_OPTS)
    jmodel = _NarrowJaxDetector(jax_retina.retinanet_statics_from_cfg(jc))
    return trainer, jc, jmodel, {"params": jax.tree_util.tree_map(jnp.asarray, tree)}


def _batch(seed=4):
    rng = np.random.default_rng(seed)
    gt = np.array([[[4, 6, 40, 50], [30, 8, 60, 30], [20, 20, 24, 25], [0, 0, 0, 0]],
                   [[10, 10, 44, 40], [0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]]], np.float32)
    valid = np.array([[1, 1, 1, 0], [1, 0, 0, 0]], bool)
    return dict(images=rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
                image_sizes=np.array([[64, 64], [56, 64]], np.int32), gt_boxes=gt,
                gt_labels=np.array([[1, 3, 2, 0], [2, 0, 0, 0]], np.int32), gt_valid=valid,
                gt_masks=np.zeros((2, 4, 28, 28), np.float32))


def test_retinanet_detector_eval_losses_and_trainer_step_match_jax():
    trainer, jc, jmodel, params = _narrow_pair()
    model = trainer.model
    batch = _batch()
    images, sizes = batch["images"], batch["image_sizes"]
    ref = jax.jit(lambda p, i, s: jmodel.apply(p, i, s, train=False))(params, jnp.asarray(images), jnp.asarray(sizes))
    model.eval()
    with torch.no_grad():
        out = model(torch.from_numpy(images), torch.from_numpy(sizes))
    model.train()
    assert out.mask_probs is None
    rd, od = ref.detections, out.detections
    assert np.asarray(rd.valid).sum(1).min() > 10
    np.testing.assert_array_equal(od.valid.numpy(), np.asarray(rd.valid))
    np.testing.assert_array_equal(od.labels.numpy(), np.asarray(rd.labels))
    np.testing.assert_allclose(od.boxes.numpy(), np.asarray(rd.boxes), rtol=0, atol=1e-3)
    np.testing.assert_allclose(od.scores.numpy(), np.asarray(rd.scores), rtol=0, atol=5e-5)

    prefixes = jax_opt.frozen_prefixes_from_cfg(jc, "GeneralizedRCNN")
    tx, _ = jax_opt.make_optimizer(jc, params["params"], prefixes)
    state = jax_train.create_train_state(params, tx, jax.random.PRNGKey(0))
    state, metrics = jax.jit(jax_train.build_train_step(jmodel, tx, "GeneralizedRCNN"))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    prev = {n: p.detach().clone() for n, p in model.named_parameters()}
    got = trainer.step(batch)
    assert set(got) == {"loss_retina_cls", "loss_retina_reg", "total_loss", "grad_norm"}
    for k in ("loss_retina_cls", "loss_retina_reg", "total_loss"):
        np.testing.assert_allclose(float(got[k]), float(metrics[k]), rtol=1e-5, err_msg=k)
    want = bridge.state_dict_from_flax(model, jax.tree_util.tree_map(np.asarray, state.params["params"]))
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert frozen and all(n.startswith(("net.backbone.body.stem.", "net.backbone.body.layer1.")) for n in frozen)
    moved = 0
    for name, p in model.named_parameters():
        up = (p.detach() - prev[name]).numpy()
        ref_up = (want[name] - prev[name]).numpy()
        if not p.requires_grad:
            assert not up.any() and not ref_up.any(), name
            continue
        if not ref_up.any():  # a gradient of 0 (a dead ReLU) and no decay
            assert not up.any(), name
            continue
        moved += 1
        assert _rel(up, ref_up) < 1e-3, (name, _rel(up, ref_up))
    assert moved > 0.9 * sum(p.requires_grad for p in model.parameters())


def test_jax_train_step_cannot_step_its_own_retinanet():
    """JAX's loss function passes ``class_valid`` to every
    GeneralizedRCNN-family model (``tpu/engine/train_step.py:87-96``);
    its ``RetinaNetDetector`` takes no such keyword
    (``tpu/models/detector/retinanet.py:30-37``), so JAX's ``train_net``
    cannot train RetinaNet (ROADMAP.md section C).  The port's ``Trainer``
    steps it."""
    jc = jax_cfg()
    jc.merge_from_list(RETINA_CFG)
    model = jax_det.RetinaNetDetector(jax_retina.retinanet_statics_from_cfg(jc))
    loss_fn = jax_train.build_loss_fn(model, "GeneralizedRCNN")
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    with pytest.raises(TypeError, match="class_valid"):
        jax.eval_shape(loss_fn, {"params": {}}, batch, jax.random.PRNGKey(0))


def _reference_state_dict(model):
    """``model``'s weights under maskrcnn_benchmark's RetinaNet names:
    the trunk's blocks and downsample, the FPN's inner and layer blocks
    numbered by stage (C3 is 2) with ``top_blocks.p6``/``p7``, the towers
    as Sequentials of conv and ReLU, the anchors' buffers."""
    out = {}
    for key, value in model.state_dict().items():
        k = key[len("net."):]
        parts = k.split(".")
        if parts[0] == "backbone" and parts[1] == "body":
            k = k.replace(".block", ".").replace("downsample_conv", "downsample.0").replace("downsample_bn", "downsample.1")
        elif parts[0] == "backbone" and parts[1] == "fpn":
            mod = parts[2]
            if mod in ("fpn_p6", "fpn_p7"):
                mod = "top_blocks." + mod[4:]
            else:
                mod = mod[:-1] + str(int(mod[-1]) + 1)
            k = ".".join(["backbone", "fpn", mod, parts[3]])
        else:
            mod = parts[1]
            if mod.startswith(("cls_tower", "bbox_tower")):
                tower, i = mod.rstrip("0123456789"), int(mod[len(mod.rstrip("0123456789")):])
                mod = f"{tower}.{2 * i}"
            k = ".".join(["rpn", "head", mod, parts[2]])
        out[k] = value.numpy() + np.float32(0.5)  # not the target's own values
    for i in range(5):
        out[f"rpn.anchor_generator.cell_anchors.{i}"] = np.zeros((9, 4), np.float32)
    return out


def _same_import(port_result, jax_result):
    (got, got_report), (ref, ref_report) = port_result, jax_result
    assert got_report["matched"] == ref_report["matched"] > 0
    assert got_report["missed_source_keys"] == ref_report["missed_source_keys"]
    assert sorted(got_report["unfilled_targets"]) == sorted(ref_report["unfilled_targets"])
    g, r = bridge._flatten(got), bridge._flatten(jax.tree_util.tree_map(np.asarray, ref))
    assert g.keys() == r.keys()
    for p in g:
        np.testing.assert_array_equal(g[p], r[p], err_msg="/".join(p))
    return got_report


def test_reference_and_caffe2_retinanet_weights_import_as_jax_imports_them(tmp_path):
    """The leaves matched, their values, the source keys missed and the
    targets left unfilled equal JAX's.  JAX's suffix matcher fills the
    trunk and ``cls_logits``/``bbox_pred``; it matches the reference's
    FPN blocks by their stage numbers onto the levels one above (and
    misses the mismatched shapes and the top blocks), and misses the
    towers, whose Sequential indices name no flax scope (ROADMAP.md
    section C)."""
    s = STATICS._replace(num_convs=4)
    model = RetinaNetDetector(s, backbone_out_channels=FPN_CHANNELS, trunk=NARROW)
    tree = bridge.seeded_flax_params(model, 0)
    sd = _reference_state_dict(model)
    report = _same_import(torch_ckpt.import_torch_state_dict(tree, sd), jax_ckpt.import_torch_state_dict(tree, sd))
    unfilled = set(report["unfilled_targets"])
    assert not any(u.startswith("net/backbone/body/") for u in unfilled)
    assert {"net/head/cls_logits/kernel", "net/head/bbox_pred/bias"}.isdisjoint(unfilled)
    assert {f"net/head/{t}{i}/kernel" for t in ("cls_tower", "bbox_tower") for i in range(4)} <= unfilled
    assert {"net/backbone/fpn/fpn_p6/kernel", "net/backbone/fpn/fpn_inner1/kernel"} <= unfilled
    missed = set(report["missed_source_keys"])
    assert "rpn.head.cls_tower.0.weight" in missed and "backbone.fpn.top_blocks.p6.weight" in missed

    # a Caffe2 ImageNet R-50 .pkl: the stem and a block's convs and
    # affine BN, a downsample, and the classifier it does not match
    rng = np.random.default_rng(5)
    blobs = {}
    for name, key in (("conv1_w", "stem.conv1.weight"), ("res_conv1_bn_s", "stem.bn1.weight"),
                      ("res_conv1_bn_b", "stem.bn1.bias"), ("res2_0_branch2a_w", "layer1.block0.conv1.weight"),
                      ("res2_0_branch2a_bn_s", "layer1.block0.bn1.weight"),
                      ("res2_0_branch1_w", "layer1.block0.downsample_conv.weight"),
                      ("res5_2_branch2c_w", "layer4.block2.conv3.weight")):
        blobs[name] = rng.standard_normal(model.state_dict()["net.backbone.body." + key].shape).astype(np.float32)
    blobs["pred_w"] = np.zeros((1000, 2048), np.float32)
    path = tmp_path / "R-50.pkl"
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs}, f)
    report = _same_import(torch_c2.import_c2_imagenet_weights(tree, str(path)),
                          jax_c2.import_c2_imagenet_weights(tree, str(path)))
    assert report["matched"] == 11  # 7 blobs, and two BNs' mean and var


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth_coco")
    subprocess.run(
        [sys.executable, str(tn.REPO / "tools/synth_coco.py"), "--out", str(out), "--train", "4",
         "--val", "4", "--seen", "3", "--unseen", "2"],
        check=True, capture_output=True, timeout=300,
    )
    return out


# RetinaNet on the tree's seen split (3 classes and the background) at
# full width on 64 x 64 images; INFERENCE_TH 0 for the random weights
RETINA_TRAIN = [
    *RETINA_CFG, "MODEL.RETINANET.INFERENCE_TH", 0.0,
    "DATASETS.TRAIN", ("coco_zeroshot_train",), "DATASETS.TEST", ("coco_not_zeroshot_val",),
    "INPUT.MIN_SIZE_TRAIN", (64,), "INPUT.MAX_SIZE_TRAIN", 64, "INPUT.MIN_SIZE_TEST", 64,
    "INPUT.MAX_SIZE_TEST", 64, "TPU.IMAGE_BUCKETS", ((64, 64),), "SOLVER.IMS_PER_BATCH", 2,
    "TEST.IMS_PER_BATCH", 2, "SOLVER.LOG_PERIOD", 1, "SOLVER.TEST_PERIOD", 0, "DATALOADER.NUM_WORKERS", 2,
    "DATALOADER.ASPECT_RATIO_GROUPING", False,
]


def test_retinanet_through_train_net_a_resume_and_test_net(tree, tmp_path, monkeypatch):
    from cvpr22_cross_modal_pseudo_labeling_torch.tools import train_net

    monkeypatch.setenv("CMPL_TPU_DATA_DIR", str(tree))
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    out = tmp_path / "retina"
    common = ["--skip-test", "--device", "cpu", *map(str, RETINA_TRAIN), "OUTPUT_DIR", str(out)]
    rec = train_net.main([*common, "SOLVER.MAX_ITER", "2", "SOLVER.CHECKPOINT_PERIOD", "2"])
    assert isinstance(rec["trainer"].model, RetinaNetDetector) and rec["start_iter"] == 0
    rec = train_net.main([*common, "SOLVER.MAX_ITER", "3", "SOLVER.CHECKPOINT_PERIOD", "3",
                          "MODEL.LOAD_TRAINER_STATE", "True"])
    assert rec["start_iter"] == 2
    logged = tn.logged(out)
    assert [r["step"] for r in logged] == [1, 2, 3]
    assert all(math.isfinite(r["loss_retina_cls"]) and math.isfinite(r["loss_retina_reg"]) for r in logged)
    assert "resumed from" in tn.log_text(out)
    name = "coco_not_zeroshot_val"
    got = test_net.main(["--device", "cpu", "--ckpt", str(out / "model_0000003.pth"), *map(str, RETINA_TRAIN),
                         "OUTPUT_DIR", str(tmp_path / "eval")])[name]
    assert "bbox/AP" in got and "segm/AP" not in got
    assert all(math.isfinite(v) or "AP50_class" in k for k, v in got.items())
    preds = __import__("json").loads((tmp_path / "eval" / f"predictions_{name}.json").read_text())
    assert len({p["image_id"] for p in preds}) == 4 and len(preds) <= 4 * 100
