"""The port's FPN modules against the JAX package on the CPU: the neck
(both top blocks), ``ResNetFPNBackbone``, the multi-level anchors,
``assign_fpn_levels`` (with the 112 / 224 / 448 boundaries),
``select_proposals_multi_level`` (test time; training with the per-batch
quirk at 1 and 2 groups; ties), the multi-level ``pool_rois`` and its
gradient with respect to every level, the parameter trees of both
detector families with and without the trunk and FPN options JAX's
detectors ignore, and ``check_ported``.

The same numpy draws go through both: inputs from a seed, weights as a
flax tree loaded into the port through ``bridge.py``.  Tolerances
(float32): the neck and the trunk 1e-5 of each level's largest value
(both sum the convolutions in their own orders); anchors, levels and the
selected proposals' validity and scores exactly, boxes 1e-5 px; pooled
features 1e-5 of the maps' largest value (JAX's golden gather sums each
bin's samples, the port contracts per-axis weights: other orders, as on
the card); their gradients 1e-5 of each level's largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.config import get_default_cfg as jax_cfg
from cvpr22_cross_modal_pseudo_labeling_tpu.models import backbone as jax_backbone
from cvpr22_cross_modal_pseudo_labeling_tpu.models import fpn as jax_fpn
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import generalized_rcnn as jax_grcnn
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import st_generalized_rcnn as jax_st
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import statics as jax_statics
from cvpr22_cross_modal_pseudo_labeling_tpu.models.roi_heads import pooler as jax_pooler
from cvpr22_cross_modal_pseudo_labeling_tpu.models.rpn import anchors as jax_anchors
from cvpr22_cross_modal_pseudo_labeling_tpu.models.rpn import rpn as jax_rpn
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.config import R50_FPN_OPTS
from cvpr22_cross_modal_pseudo_labeling_torch.config import get_default_cfg as torch_cfg
from cvpr22_cross_modal_pseudo_labeling_torch.models.backbone import ResNetFPNBackbone
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector import build_detection_model
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.generalized_rcnn import check_ported
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.statics import statics_from_cfg
from cvpr22_cross_modal_pseudo_labeling_torch.models.fpn import FPN
from cvpr22_cross_modal_pseudo_labeling_torch.models.roi_heads import pooler as torch_pooler
from cvpr22_cross_modal_pseudo_labeling_torch.models.rpn import anchors as torch_anchors
from cvpr22_cross_modal_pseudo_labeling_torch.models.rpn import rpn as torch_rpn

TEACHER = "configs/coco_cap_det/zeroshot_mask.yaml"
STUDENT = "configs/coco_cap_det/student_teacher_mask_rcnn_uncertainty.yaml"
SCALES = (0.25, 0.125, 0.0625, 0.03125)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close_per_level(got, want, rel=1e-5):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * np.abs(w).max(), err_msg=f"level {i}")


# ---------------------------------------------------------------------------
# the neck and the body


@pytest.mark.parametrize("top_block,p6p7_on_c5", [("maxpool", True), ("p6p7", True), ("p6p7", False)])
def test_fpn_neck_matches_jax(top_block, p6p7_on_c5):
    """Odd map sizes, so that the top-down merge crops."""
    rng = np.random.default_rng(0)
    chans = (8, 16, 24, 32)
    sizes = ((17, 23), (9, 12), (5, 6), (3, 3))
    feats = [rng.standard_normal((2, h, w, c)).astype(np.float32) for (h, w), c in zip(sizes, chans)]
    neck = FPN(chans, 16, top_block=top_block, p6p7_on_c5=p6p7_on_c5)
    tree = bridge.seeded_flax_params(neck, seed=1)
    bridge.load_flax_params(neck, tree)
    ref = jax_fpn.FPN(in_channels_list=chans, out_channels=16, top_block=top_block,
                      p6p7_on_c5=p6p7_on_c5).apply({"params": tree}, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        out = neck([torch.from_numpy(f) for f in feats])
    assert len(out) == {"maxpool": 5, "p6p7": 6}[top_block]
    _close_per_level([o.numpy() for o in out], ref)


@pytest.mark.parametrize("retinanet", [False, True])
def test_resnet_fpn_backbone_matches_jax(retinanet):
    """R-50 depth at narrow widths on a 64 x 96 image: P2..P6 (P3..P7 for
    the RetinaNet body), the flax tree leaf for leaf."""
    widths = dict(stem_out_channels=8, res2_out_channels=16, width_per_group=4)
    body = ResNetFPNBackbone("R-50", out_channels=16, retinanet=retinanet, **widths)
    jmod = jax_backbone.ResNetFPNBackbone(depth="R-50", out_channels=16, retinanet=retinanet, **widths)
    x = np.random.default_rng(2).standard_normal((2, 64, 96, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))["params"]
    tree = bridge.seeded_flax_params(body, seed=3)
    assert jax.tree_util.tree_structure(_np(shapes)) == jax.tree_util.tree_structure(tree)
    assert jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda a: a.shape, shapes)) == \
        jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda a: a.shape, tree))
    bridge.load_flax_params(body, tree)
    ref = jax.jit(jmod.apply)({"params": tree}, jnp.asarray(x))
    with torch.no_grad():
        out = body(torch.from_numpy(x))
    assert [tuple(o.shape[1:3]) for o in out] == (
        [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)] if retinanet else [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)])
    _close_per_level([o.numpy() for o in out], ref)


# ---------------------------------------------------------------------------
# anchors, levels, proposal selection


def test_multi_level_anchors_match_jax():
    shapes = [(16, 24), (8, 12), (4, 6), (2, 3), (1, 2)]
    strides, sizes, ratios = (4, 8, 16, 32, 64), (32, 64, 128, 256, 512), (0.5, 1.0, 2.0)
    got = torch_anchors.build_anchors_for_levels(shapes, strides, sizes, ratios, torch.device("cpu"))
    want = jax_anchors.build_anchors_for_levels(shapes, strides, sizes, ratios)
    assert len(got) == 5
    for g, w, (h, wd) in zip(got, want, shapes):
        assert g.shape == (h * wd * 3, 4)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # a tuple of sizes on a level, and the single-stride C4 layout
    multi = ((32, 40), 64, 128, 256, 512)
    for g, w in zip(torch_anchors.build_anchors_for_levels(shapes, strides, multi, ratios, torch.device("cpu")),
                    jax_anchors.build_anchors_for_levels(shapes, strides, multi, ratios)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="anchor strides"):
        torch_anchors.build_anchors_for_levels(shapes[:4], strides, sizes, ratios, torch.device("cpu"))
    with pytest.raises(ValueError, match="anchor sizes"):
        torch_anchors.build_anchors_for_levels(shapes, strides, sizes[:4], ratios, torch.device("cpu"))


def _boundary_boxes():
    """Boxes whose sqrt(area) is exactly 112, 224 and 448 (legacy +1
    widths), their neighbours a pixel and a float32 ulp away, degenerate
    and padded boxes, and random boxes over every level."""
    rows = []
    for side in (112.0, 224.0, 448.0):
        for d in (0.0, -1.0, 1.0):
            rows.append([10.0, 20.0, 10.0 + side - 1.0 + d, 20.0 + side - 1.0 + d])
        for x2 in np.nextafter(np.float32(10.0 + side - 1.0), [np.float32(0), np.float32(1e6)]):
            rows.append([10.0, 20.0, float(x2), 20.0 + side - 1.0])
    rows.append([0.0, 0.0, 55.0, 223.0])  # 56 x 224: sqrt 112
    rows.append([0.0, 0.0, 0.0, 0.0])
    rows.append([5.0, 5.0, 3.0, 2.0])
    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 800, (40, 2))
    wh = rng.uniform(1, 900, (40, 2))
    rows.extend(np.concatenate([xy, xy + wh], -1).tolist())
    return np.asarray(rows, np.float32)


def test_assign_fpn_levels_matches_jax_at_the_boundaries():
    boxes = _boundary_boxes()
    got = torch_pooler.assign_fpn_levels(torch.from_numpy(boxes), 2, 5).numpy()
    want = np.asarray(jax_pooler.assign_fpn_levels(jnp.asarray(boxes), 2, 5))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    # sqrt(area) 112 -> k 3, 224 -> k 4, 448 -> k 5, each at its own level
    assert got[0] == 1 and got[5] == 2 and got[10] == 3
    # a pixel less: the level below
    assert got[1] == 0 and got[6] == 1 and got[11] == 2
    assert set(got.tolist()) == {0, 1, 2, 3}


def _level_inputs(seed, b=2, per_level=(300, 120, 40, 12, 3), ties=False):
    """Per-level anchors inside a 128 x 160 image, objectness (on a coarse
    grid when ``ties``) and box deltas."""
    rng = np.random.default_rng(seed)
    anchors = []
    for n, size in zip(per_level, (16, 32, 64, 128, 256)):
        ctr = rng.uniform(0, [160, 128], (n, 2))
        wh = rng.uniform(0.5, 1.5, (n, 2)) * size
        anchors.append(np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32))
    total = sum(per_level)
    obj = rng.standard_normal((b, total)).astype(np.float32)
    if ties:
        obj = np.round(obj * 2) / 2
    reg = (rng.standard_normal((b, total, 4)) * 0.2).astype(np.float32)
    sizes = np.array([[128, 160], [100, 150]][:b], np.int32)
    return anchors, obj, reg, sizes


@pytest.mark.parametrize("case", ["test", "train_groups_1", "train_groups_2", "ties", "train_ties",
                                  "gcd_fallback"])
def test_select_proposals_multi_level_matches_jax(case):
    anchors, obj, reg, sizes = _level_inputs(5, ties="ties" in case)
    per_batch = case.startswith("train") or case == "gcd_fallback"
    # 3 groups do not divide a batch of 2: gcd grouping, one group
    groups = {"train_groups_2": 2, "gcd_fallback": 3}.get(case, 1)
    # per level 64 -> 20, then 48 over the levels: the cross-level top-N cuts
    args = (64, 20, 0.7, 0.0)
    kw = dict(fpn_post_nms_top_n=48, fpn_post_nms_per_batch=per_batch, per_batch_groups=groups)
    got = torch_rpn.select_proposals_multi_level(
        [torch.from_numpy(a) for a in anchors], torch.from_numpy(obj), torch.from_numpy(reg),
        torch.from_numpy(sizes), *args, **kw)
    want = jax_rpn.select_proposals_multi_level(
        [jnp.asarray(a) for a in anchors], jnp.asarray(obj), jnp.asarray(reg), jnp.asarray(sizes),
        *args, nms_tile=64, **kw)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=0, atol=1e-5)
    assert got.boxes.shape == (2, 48, 4)
    n_valid = got.valid.sum(1)
    assert int(n_valid.min()) > 0
    if per_batch:
        # the batch-global cut leaves at most 48 a group
        g = 2 if case == "train_groups_2" else 1
        assert all(int(c.sum()) <= 48 for c in n_valid.reshape(g, -1))
    else:
        assert int(n_valid.min()) == 48


def test_single_level_selection_is_the_c4_selector():
    anchors, obj, reg, sizes = _level_inputs(6, per_level=(400,))
    t = lambda a: torch.from_numpy(a)
    a = torch_rpn.select_proposals_multi_level([t(anchors[0])], t(obj), t(reg), t(sizes), 100, 30, 0.7, 0.0,
                                               fpn_post_nms_top_n=10, fpn_post_nms_per_batch=True)
    b = torch_rpn.select_proposals_single_level(t(anchors[0]), t(obj), t(reg), t(sizes), 100, 30, 0.7, 0.0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the multi-level pooler


def _pyramid(seed, c=8):
    rng = np.random.default_rng(seed)
    feats = [rng.standard_normal((2, 256 // s, 320 // s, c)).astype(np.float32) for s in (4, 8, 16, 32)]
    xy = rng.uniform(-20, 300, (2, 24, 2))
    wh = rng.uniform(4, 400, (2, 24, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[0, 0] = [10, 20, 120, 131]  # sqrt(area) 112
    boxes[1, 0] = [0, 0, 223, 223]  # 224
    boxes[1, 1] = [0, 0, 0, 0]  # a padded slot
    boxes[1, 2] = [5, 10, 604, 509]  # P5
    return feats, boxes


@pytest.mark.parametrize("bin_stride", [1, 2])
def test_multi_level_pool_rois_matches_jax(bin_stride):
    """Every level in use; ``bin_stride`` is ignored on the multi-level
    path, by both."""
    feats, boxes = _pyramid(7)
    levels = torch_pooler.assign_fpn_levels(torch.from_numpy(boxes), 2, 5)
    assert set(levels.flatten().tolist()) == {0, 1, 2, 3}
    got = torch_pooler.pool_rois([torch.from_numpy(f) for f in feats], torch.from_numpy(boxes), (14, 14),
                                 SCALES, 2, bin_stride=bin_stride)
    want = jax_pooler.pool_rois([jnp.asarray(f) for f in feats], jnp.asarray(boxes), (14, 14), SCALES, 2,
                                bin_stride=bin_stride)
    assert got.shape == (48, 14, 14, 8)
    fmax = max(float(np.abs(f).max()) for f in feats)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5 * fmax)


def test_multi_level_pool_rois_gradient_matches_jax_for_every_level():
    """The gradient of ``sum(pool_rois(...) * g)`` with respect to each of
    the four levels against ``jax.grad`` of JAX's masked sum; P6, passed
    but past the scales, gets none."""
    feats, boxes = _pyramid(8)
    p6 = np.random.default_rng(9).standard_normal((2, 4, 5, 8)).astype(np.float32)
    g = np.random.default_rng(10).standard_normal((48, 14, 14, 8)).astype(np.float32)

    def jax_loss(fs):
        out = jax_pooler.pool_rois(list(fs), jnp.asarray(boxes), (14, 14), SCALES, 2)
        return jnp.sum(out * g)

    want = jax.grad(jax_loss)([jnp.asarray(f) for f in feats])
    fs = [torch.from_numpy(f).requires_grad_() for f in feats + [p6]]
    out = torch_pooler.pool_rois(fs, torch.from_numpy(boxes), (14, 14), SCALES, 2)
    torch.sum(out * torch.from_numpy(g)).backward()
    assert fs[4].grad is None
    _close_per_level([f.grad.numpy() for f in fs[:4]], want)
    assert all(float(np.abs(np.asarray(w)).max()) > 0 for w in want)


def test_level_filtered_plain_versions_pool_and_differentiate_one_level():
    """``roi_align_plain`` with a level filter pools that level's rois and
    zeroes the other rows; ``roi_align_backward_plain`` gives the gradient
    of those rois only; the levels' sum is ``roi_align_levels``."""
    from cvpr22_cross_modal_pseudo_labeling_torch.ops import roi_align as ra

    feats, boxes = _pyramid(11)
    t = [torch.from_numpy(f) for f in feats]
    rois = torch.from_numpy(boxes)
    levels = torch_pooler.assign_fpn_levels(rois, 2, 5)
    whole = ra.roi_align_levels(t, rois, levels, (14, 14), SCALES, 2)
    for lvl in range(4):
        part = ra.roi_align_plain(t[lvl], rois, (14, 14), SCALES[lvl], 2, 8, 1, levels, lvl)
        mine = levels == lvl
        assert torch.equal(part[mine], whole[mine]) and not part[~mine].any()
        full = ra.roi_align_plain(t[lvl], rois, (14, 14), SCALES[lvl], 2)
        assert torch.equal(part[mine], full[mine])
        g = torch.randn(part.shape, generator=torch.Generator().manual_seed(lvl))
        d = ra.roi_align_backward_plain(g, rois, t[lvl].shape, torch.float32, (14, 14), SCALES[lvl], 2, 8, 1,
                                        levels, lvl)
        masked = ra.roi_align_backward_plain(g * mine[..., None, None, None], rois, t[lvl].shape, torch.float32,
                                             (14, 14), SCALES[lvl], 2)
        np.testing.assert_allclose(d.numpy(), masked.numpy(), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the detectors' parameter trees and what they refuse


def _cfg(make, config, opts):
    cfg = make()
    cfg.merge_from_file(config)
    cfg.merge_from_list(list(opts))
    return cfg


TREE_WIDTHS = [
    "MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
    "MODEL.RESNETS.WIDTH_PER_GROUP", 4, "MODEL.ROI_BOX_HEAD.EMB_DIM", 16,
    "MODEL.ROI_MASK_HEAD.CONV_LAYERS", (8,), "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 16,
]
# each changes the tree of JAX's build_backbone, none a detector's: all
# four set at once, against none
IGNORED_OPTIONS = {
    "none": [],
    "dcn_gn_fpn_gn_fpn_relu": [
        "MODEL.RESNETS.STAGE_WITH_DCN", (False, True, True, True),
        "MODEL.RESNETS.TRANS_FUNC", "BottleneckWithGN",
        "MODEL.FPN.USE_GN", True,
        "MODEL.FPN.USE_RELU", True,
    ],
}


def _jax_tree_shapes(family, cfg):
    """The flax leaf shapes of JAX's init of the family (train mode for
    the student-teacher model, which creates the word table there too)."""
    b, hw = 1, 64
    images = jnp.zeros((b, hw, hw, 3))
    sizes = jnp.array([[hw, hw]], jnp.int32)
    if family == "teacher":
        m = jax_grcnn.GeneralizedRCNN(jax_statics.statics_from_cfg(cfg))
        init = lambda: m.init({"params": jax.random.PRNGKey(0)}, images, sizes, jnp.zeros((3, 16)), train=False)
    else:
        m = jax_st.STGeneralizedRCNN(jax_st.st_statics_from_cfg(cfg)._replace(vocab_size=64, lvis_vocab=4))
        batch = {
            "cap_mask": jnp.array([True]), "det_mask": jnp.array([True]),
            "cap_tok_ids": jnp.ones((b, 2, 3), jnp.int32), "cap_tok_mask": jnp.ones((b, 2, 3), jnp.int32),
            "cap_word_valid": jnp.array([[True, False]]), "cap_labels": jnp.zeros((b, 2), jnp.int32),
            "gt_boxes": jnp.array([[[4.0, 4.0, 30.0, 30.0]]]), "gt_labels": jnp.ones((b, 1), jnp.int32),
            "gt_valid": jnp.array([[True]]), "gt_masks": jnp.ones((b, 1, 28, 28)),
        }
        rngs = {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1),
                "uncertainty": jax.random.PRNGKey(2)}
        init = lambda: m.init(rngs, images, sizes, batch, jnp.zeros((3, 16)), jnp.zeros((4, 16)), train=True)
    tree = jax.eval_shape(init)["params"]
    return {"/".join(k.key for k in p): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("family", ["teacher", "student"])
@pytest.mark.parametrize("body", ["C4", "FPN"])
def test_both_families_build_jax_parameter_tree_with_or_without_ignored_options(family, body):
    """DCN, the GN trunk and the FPN's GN and ReLU reach no JAX detector:
    with them set, both families build the tree they build without them,
    in JAX and in the port alike (JAX's ``build_backbone`` would add the
    DCN offsets and the GN scales)."""
    config = TEACHER if family == "teacher" else STUDENT
    base = TREE_WIDTHS + (R50_FPN_OPTS + ["MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 16] if body == "FPN" else [])
    base += ["MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 64, "MODEL.RPN.POST_NMS_TOP_N_TRAIN", 16,
             "MODEL.RPN.PRE_NMS_TOP_N_TEST", 64, "MODEL.RPN.POST_NMS_TOP_N_TEST", 16,
             "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 16, "TPU.MAX_GT", 1, "TPU.MASK_POS_CAP", 8,
             "TPU.MAX_CAP_NOUNS", 2, "TPU.COMPUTE_DTYPE", "float32"]
    reference = None
    for name, opts in IGNORED_OPTIONS.items():
        want = _jax_tree_shapes(family, _cfg(jax_cfg, config, base + opts))
        model = build_detection_model(_cfg(torch_cfg, config, base + opts))
        got = {"/".join(p): tuple(np.shape(v)) for p, v in bridge._flatten(bridge.flax_from_state_dict(model)).items()}
        if family == "student":
            got["bert/word_embeddings"] = want["bert/word_embeddings"]  # the vocab the JAX init was cut to
        assert got == want, (name, set(got) ^ set(want))
        reference = reference or got
        assert got == reference, name
    assert any(k.startswith("backbone/fpn/fpn_inner1/") for k in reference) == (body == "FPN")


@pytest.mark.parametrize("opts", [
    ("MODEL.BACKBONE.CONV_BODY", "R-50-C5"),
    ("MODEL.BACKBONE.CONV_BODY", "R-50-FPN-RETINANET"),
    ("MODEL.KEYPOINT_ON", True),
    ("MODEL.ROI_BOX_HEAD.WSDDN", True),
])
@pytest.mark.parametrize("config", [TEACHER, STUDENT])
def test_check_ported_admits_fpn_and_refuses_the_rest(config, opts):
    """The FPN bodies and ``RPN_ONLY`` pass, and so do the C5 body,
    ``KEYPOINT_ON`` and ``WSDDN``, which the port has run since it got
    them; RetinaNet's body without ``RETINANET_ON``, which JAX cannot run
    either, is refused (ValueError)."""
    check_ported(statics_from_cfg(_cfg(torch_cfg, config, R50_FPN_OPTS)))
    check_ported(statics_from_cfg(_cfg(torch_cfg, config, ["MODEL.BACKBONE.CONV_BODY", "R-101-FPN"])))
    check_ported(statics_from_cfg(_cfg(torch_cfg, config, R50_FPN_OPTS + ["MODEL.RPN_ONLY", True])))
    statics = statics_from_cfg(_cfg(torch_cfg, config, R50_FPN_OPTS + list(opts)))
    if opts[1] != "R-50-FPN-RETINANET":
        check_ported(statics)
        return
    with pytest.raises(ValueError, match="RETINANET_ON"):
        check_ported(statics)
