"""The keypoint head (``MODEL.KEYPOINT_ON``) and the WSDDN box head
(``MODEL.ROI_BOX_HEAD.WSDDN``) against the JAX package on the CPU.

- The heads alone, on seeded numpy inputs and the JAX init's weights
  carried by ``bridge.py``: ``KeypointPredictor`` (the transposed conv
  and the 2x bilinear upscale, on odd map sizes) within 1e-5 of the
  logits' scale; ``keypoints_to_heatmap_targets`` exactly, on points on
  each roi edge, just outside it, unlabeled and in degenerate rois;
  ``keypoint_loss`` within 1e-6 relative; ``keypoint_inference``'s
  coordinates within 1e-4 px and scores 1e-6; ``WSDDNHead``'s proposal
  and image scores within 1e-6, ``wsddn_loss`` 1e-6 relative and
  ``wsddn_inference``'s detections exactly (scores 1e-7).
- ``GeneralizedRCNN`` with each option over ``zeroshot_mask.yaml`` at the
  narrow widths of ``tests/test_torch_teacher.py``, on the JAX program's
  own sampler draws: the losses (``loss_kp``; WSDDN's image-level
  ``loss_classifier``) within 1e-5 relative, the new heads' gradients
  within 1e-5 of the JAX gradient's norm (the keypoint logits' bias and
  WSDDN's detection-stream bias, whose gradients are zero but for
  rounding, within 1e-6 of zero on both sides); the eval forward's
  detections
  (boxes 1e-3 px, scores 1e-5) and keypoints (1e-3 px, scores 1e-5).
- JAX's cross-stage importer and the port's fill the same leaves of both
  options' trees from a checkpoint of the same model.
- ``train_net`` then ``test_net --ckpt`` for each option on a tiny
  synthetic tree: keypoints on R-50-FPN over ``tools/
  synth_coco_keypoints.py``'s person tree, with ``keypoints/AP`` in the
  metrics; WSDDN over the COCO tree of ``tools/synth_coco.py``.
"""

import math
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.engine import checkpoint as jax_ckpt
from cvpr22_cross_modal_pseudo_labeling_tpu.models.roi_heads import keypoint_head as jax_kp
from cvpr22_cross_modal_pseudo_labeling_tpu.models.roi_heads import wsddn_head as jax_ws
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.config import R50_FPN_OPTS
from cvpr22_cross_modal_pseudo_labeling_torch.engine import checkpoint as torch_ckpt
from cvpr22_cross_modal_pseudo_labeling_torch.engine.inference import Predictor
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.generalized_rcnn import TrainDraws
from cvpr22_cross_modal_pseudo_labeling_torch.models.roi_heads import keypoint_head as torch_kp
from cvpr22_cross_modal_pseudo_labeling_torch.models.roi_heads import wsddn_head as torch_ws
from cvpr22_cross_modal_pseudo_labeling_torch.tools import synth_coco_keypoints, test_net, train_net
from tests import test_torch_teacher as teacher
from tests import test_torch_train_net as tn
from tests.tensorboard_stub import tensorboard_compat_reset  # noqa: F401  (an autouse fixture)

K = 5  # keypoints of the narrow models
KEYPOINT = ["MODEL.KEYPOINT_ON", True, "MODEL.ROI_KEYPOINT_HEAD.NUM_CLASSES", K,
            "MODEL.ROI_HEADS.DETECTIONS_PER_IMG", 8]
WSDDN = ["MODEL.ROI_BOX_HEAD.WSDDN", True, "MODEL.MASK_ON", False, "MODEL.ROI_HEADS.SCORE_THRESH", 0.0,
         "MODEL.ROI_HEADS.DETECTIONS_PER_IMG", 8]


def _close(got, want, tol, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * max(float(np.abs(want).max()), 1e-30),
                               err_msg=err_msg)


# ---------------------------------------------------------------------------
# the heads alone


@pytest.mark.parametrize("hw", [(7, 7), (5, 9), (1, 1)])
def test_keypoint_predictor_matches_jax(hw):
    """The 4x4 stride-2 transposed conv (flax's unflipped kernel, SAME
    padding) and the 2x bilinear upscale, borders included, on maps of
    odd sizes: logits within 1e-5 of their largest magnitude."""
    rng = np.random.default_rng(sum(hw))
    pooled = rng.standard_normal((3, *hw, 12)).astype(np.float32)
    m = jax_kp.KeypointPredictor(num_keypoints=K, conv_layers=(8, 6))
    params = m.init(jax.random.PRNGKey(1), jnp.asarray(pooled))
    # a bias per output keypoint, so that the borders see one too
    params = jax.tree_util.tree_map(np.asarray, params)
    params["params"]["kps_score_lowres"]["bias"] = rng.standard_normal(K).astype(np.float32)
    want = np.asarray(m.apply(params, jnp.asarray(pooled)))
    port = torch_kp.KeypointPredictor(12, K, (8, 6))
    bridge.load_flax_params(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(pooled)).numpy()
    assert got.shape == want.shape == (3, 4 * hw[0], 4 * hw[1], K)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("hw", [(7, 7), (4, 9), (3, 1)])
def test_upscale_is_jax_bilinear_resize(hw):
    """``F.interpolate`` at 2x, half-pixel, equals ``jax.image.resize``'s
    bilinear on every pixel, the first and last rows and columns
    included."""
    x = np.random.default_rng(hw[0] * 10 + hw[1]).standard_normal((2, *hw, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 2 * hw[0], 2 * hw[1], 3), "bilinear"))
    got = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2,
                                          mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
    _close(got, want, 1e-6)
    np.testing.assert_allclose(got[:, 0, 0], x[:, 0, 0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[:, -1, -1], x[:, -1, -1], rtol=0, atol=1e-6)


def _edge_keypoints():
    """Rois (the last degenerate) and keypoints on each edge, just past
    the right and bottom edges, inside, unlabeled."""
    rois = np.array([[0.0, 0.0, 56.0, 56.0], [10.5, 4.25, 38.0, 71.0], [3.0, 3.0, 3.0, 9.0]], np.float32)
    kps = np.zeros((3, 8, 3), np.float32)
    for i, (x0, y0, x1, y1) in enumerate(rois):
        kps[i] = [[x0, y0, 2], [x1, y1, 2], [x1, y0, 1], [x0, y1, 2],
                  [np.nextafter(x1, np.float32(1e9)), (y0 + y1) / 2, 2],
                  [(x0 + x1) / 2, np.nextafter(y1, np.float32(1e9)), 2],
                  [(x0 + x1) / 2, (y0 + y1) / 2, 2], [(x0 + x1) / 2, (y0 + y1) / 2, 0]]
    return rois, kps


def test_heatmap_targets_match_jax_on_edge_points():
    rois, kps = _edge_keypoints()
    want_t, want_v = (np.asarray(a) for a in jax_kp.keypoints_to_heatmap_targets(jnp.asarray(kps), jnp.asarray(rois), 14))
    got_t, got_v = torch_kp.keypoints_to_heatmap_targets(torch.from_numpy(kps), torch.from_numpy(rois), 14)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_t.numpy()[want_v], want_t[want_v])
    # the right and bottom edges snap to the last bin; past them, invalid
    assert want_v[:2, :4].all() and not want_v[:2, 4:6].any() and not want_v[:, 7].any()
    assert want_t[0, 1] == 14 * 14 - 1


def test_keypoint_loss_and_inference_match_jax():
    rng = np.random.default_rng(3)
    s, h = 6, 14
    logits = (rng.standard_normal((s, h, h, K)) * 3).astype(np.float32)
    x0 = rng.uniform(0, 50, (s, 2))
    rois = np.concatenate([x0, x0 + rng.uniform(5, 60, (s, 2))], 1).astype(np.float32)
    kps = np.concatenate([rng.uniform(x0[:, None], (x0 + 70)[:, None], (s, K, 2)),
                          rng.integers(0, 3, (s, K, 1))], -1).astype(np.float32)
    roi_valid = np.array([1, 1, 1, 0, 1, 1], bool)
    want = float(jax_kp.keypoint_loss(*(jnp.asarray(a) for a in (logits, kps, rois, roi_valid))))
    got = float(torch_kp.keypoint_loss(*(torch.from_numpy(a) for a in (logits, kps, rois, roi_valid))))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-6)
    want_xy, want_s = jax_kp.keypoint_inference(jnp.asarray(logits), jnp.asarray(rois))
    got_xy, got_s = torch_kp.keypoint_inference(torch.from_numpy(logits), torch.from_numpy(rois))
    np.testing.assert_allclose(got_xy.numpy(), np.asarray(want_xy), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=0, atol=1e-6)


def test_wsddn_head_loss_and_inference_match_jax():
    rng = np.random.default_rng(4)
    b, s, d, c = 2, 40, 24, 6
    vec = rng.standard_normal((b, s, d)).astype(np.float32)
    valid = rng.uniform(size=(b, s)) > 0.2
    m = jax_ws.WSDDNHead(num_classes=c)
    params = m.init(jax.random.PRNGKey(2), jnp.asarray(vec), jnp.asarray(valid))
    want_p, want_i = (np.array(a) for a in m.apply(params, jnp.asarray(vec), jnp.asarray(valid)))
    port = torch_ws.WSDDNHead(d, c)
    bridge.load_flax_params(port, params)
    with torch.no_grad():
        got_p, got_i = port(torch.from_numpy(vec), torch.from_numpy(valid))
    np.testing.assert_allclose(got_p.numpy(), want_p, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_i.numpy(), want_i, rtol=0, atol=1e-6)
    labels = rng.integers(0, 2, (b, c)).astype(np.float32)
    for bg in (1.0, 0.2):
        want = float(jax_ws.wsddn_loss(jnp.asarray(want_i), jnp.asarray(labels), bg))
        np.testing.assert_allclose(float(torch_ws.wsddn_loss(torch.from_numpy(want_i), torch.from_numpy(labels), bg)),
                                   want, rtol=1e-6)
    xy = rng.uniform(0, 80, (b, s, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 40, (b, s, 2))], -1).astype(np.float32)
    want = jax_ws.wsddn_inference(jnp.asarray(want_p), jnp.asarray(boxes), jnp.asarray(valid), 0.001, 0.5, 10, 64)
    got = torch_ws.wsddn_inference(torch.from_numpy(want_p), torch.from_numpy(boxes), torch.from_numpy(valid),
                                   0.001, 0.5, 10)
    assert np.asarray(want.valid).sum(1).min() >= 5
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-7)


# ---------------------------------------------------------------------------
# the detector with each option


def kp_batch(seed=1):
    """``tests/test_torch_teacher.py``'s batch with ``K`` keypoints a gt
    box: inside each box, some past its edge, a quarter unlabeled."""
    batch = teacher.tiny_batch(seed=seed)
    rng = np.random.default_rng(seed + 10)
    boxes = batch["gt_boxes"]
    u = rng.uniform(-0.1, 1.1, (*boxes.shape[:2], K, 2))
    xy = boxes[..., None, :2] + u * (boxes[..., None, 2:] - boxes[..., None, :2])
    vis = np.where(rng.uniform(size=(*boxes.shape[:2], K, 1)) < 0.25, 0, 2)
    batch["gt_keypoints"] = (np.concatenate([xy, vis], -1) * batch["gt_valid"][..., None, None]).astype(np.float32)
    return batch


@pytest.fixture(scope="module", params=["keypoint", "wsddn"])
def option(request):
    return request.param, teacher.make_setup("float32", KEYPOINT if request.param == "keypoint" else WSDDN)


def test_option_losses_and_gradients_match_jax(option):
    name, setup = option
    batch = kp_batch() if name == "keypoint" else teacher.tiny_batch()
    keys = teacher.RCNN_KEYS + (("gt_keypoints",) if name == "keypoint" else ())
    with teacher.JaxDraws():
        grads, (losses, _) = setup["grad_fn"](setup["params"], {k: jnp.asarray(batch[k]) for k in keys},
                                              jax.random.PRNGKey(0))
        jax.block_until_ready(grads)
        draws = TrainDraws(gt_sampler=torch.from_numpy(teacher._SINK["gt_sampler"]) if name == "keypoint" else None,
                           rpn_sampler=torch.from_numpy(teacher._SINK["rpn_sampler"]))
    want = {"keypoint": teacher.LOSSES + ("loss_kp",),
            "wsddn": ("loss_objectness", "loss_rpn_box_reg", "loss_classifier")}[name]
    assert sorted(losses) == sorted(want)
    trainer = setup["trainer"]
    trainer.model.zero_grad(set_to_none=True)
    out = teacher.port_forward(trainer.model, batch, draws)
    for k in want:
        np.testing.assert_allclose(out.losses[k].detach().numpy(), np.asarray(losses[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    head = "keypoint_predictor." if name == "keypoint" else "wsddn_head."
    assert float(out.losses["loss_kp" if name == "keypoint" else "loss_classifier"].detach()) > 0
    sum(out.losses.values()).backward()
    ref = bridge.state_dict_from_flax(trainer.model, jax.tree_util.tree_map(np.asarray, grads))
    held = [n for n, p in trainer.model.named_parameters() if n.startswith(head)]
    assert len(held) == (18 if name == "keypoint" else 4)
    for n in held:
        grad = trainer.model.get_parameter(n).grad.numpy()
        if n in ("keypoint_predictor.kps_score_lowres.bias", "wsddn_head.det_score.bias"):
            # zero in exact arithmetic: a shift of a heatmap's logits, or
            # of a class's logits over the proposals, leaves the softmax
            # alone; both sides keep their rounding
            assert np.abs(grad).max() < 1e-6 and np.abs(ref[n].numpy()).max() < 1e-6
            continue
        assert teacher._rel_norm(grad, ref[n].numpy()) <= 1e-5, n
    trainer.model.zero_grad(set_to_none=True)


def test_option_eval_matches_jax(option):
    name, setup = option
    batch = teacher.tiny_batch()
    images, sizes, table = batch["images"], batch["image_sizes"], batch["class_embeddings"]
    m = setup["model"]
    ref = jax.jit(lambda p, i, s, c: m.apply(p, i, s, class_embeddings=c, train=False))(
        setup["params"], images, sizes, table)
    dets, masks = Predictor.from_model(setup["trainer"].cfg, setup["trainer"].model)(images, sizes, table)
    setup["trainer"].model.train()
    rd = ref.detections
    valid = np.asarray(rd.valid)
    assert valid.sum(axis=1).min() > 0 and dets.boxes.shape == (2, 8, 4)
    np.testing.assert_array_equal(dets.valid, valid)
    np.testing.assert_array_equal(dets.labels, np.asarray(rd.labels))
    np.testing.assert_allclose(dets.boxes, np.asarray(rd.boxes), rtol=0, atol=1e-3)
    np.testing.assert_allclose(dets.scores, np.asarray(rd.scores), rtol=0, atol=1e-5)
    if name == "wsddn":
        assert masks is None and dets.keypoints is None and ref.keypoints is None
        return
    want = np.asarray(ref.keypoints)
    assert dets.keypoints.shape == want.shape == (2, 8, K, 3)
    np.testing.assert_allclose(dets.keypoints[..., :2], want[..., :2], rtol=0, atol=1e-3)
    np.testing.assert_allclose(dets.keypoints[..., 2], want[..., 2], rtol=0, atol=1e-5)
    np.testing.assert_allclose(masks, np.asarray(ref.mask_probs), rtol=0, atol=1e-4)


def test_importers_fill_the_same_leaves_of_both_options(option):
    """A checkpoint of the same model (other seeded weights) into a fresh
    tree: JAX's ``import_flax_params`` and the port's fill the same
    leaves with the same values and skip the same classifier leaves
    (``load_classifier`` False), the new heads' included."""
    name, setup = option
    target = bridge.seeded_flax_params(setup["trainer"].model, seed=7)
    source = bridge.seeded_flax_params(setup["trainer"].model, seed=8)
    head = "keypoint_predictor" if name == "keypoint" else "wsddn_head"
    assert head in source
    for load_classifier in (False, True):
        want, want_report = jax_ckpt.import_flax_params(target, source, load_classifier=load_classifier)
        got, got_report = torch_ckpt.import_flax_params(target, source, load_classifier=load_classifier)
        assert got_report == want_report
        flat_w, flat_g = bridge._flatten(want), bridge._flatten(got)
        assert set(flat_w) == set(flat_g)
        for k in flat_w:
            np.testing.assert_array_equal(flat_g[k], flat_w[k], err_msg="/".join(k))
        filled = {"/".join(k) for k in flat_w if np.array_equal(flat_w[k], bridge._flatten(source)[k])}
        heads = {k for k in map("/".join, flat_w) if k.startswith(head + "/")}
        skipped = {k for k in heads if "cls_score" in k and not load_classifier}
        assert heads - skipped <= filled and not skipped & filled
        assert sorted(got_report["unfilled_targets"]) == sorted(
            k for k in map("/".join, flat_w) if "cls_score" in k and not load_classifier)


# ---------------------------------------------------------------------------
# through train_net and test_net

KP_TINY = [
    "MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16, "MODEL.RESNETS.WIDTH_PER_GROUP", 4,
    "MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 16, "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 64,
    "MODEL.RPN.POST_NMS_TOP_N_TRAIN", 16, "MODEL.RPN.PRE_NMS_TOP_N_TEST", 64, "MODEL.RPN.POST_NMS_TOP_N_TEST", 16,
    "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", 32, "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", 32,
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 16, "MODEL.ROI_HEADS.SCORE_THRESH", 0.0,
    "MODEL.ROI_HEADS.DETECTIONS_PER_IMG", 4, "TPU.MASK_POS_CAP", 4, "TPU.MAX_GT", 4, "TPU.COMPUTE_DTYPE", "float32",
    "INPUT.MIN_SIZE_TRAIN", (64,), "INPUT.MAX_SIZE_TRAIN", 96, "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 96,
    "TPU.IMAGE_BUCKETS", ((96, 96),), "SOLVER.IMS_PER_BATCH", 2, "TEST.IMS_PER_BATCH", 2, "SOLVER.LOG_PERIOD", 1,
    "DATALOADER.ASPECT_RATIO_GROUPING", False,
]
# maskrcnn_benchmark's e2e_keypoint_rcnn_R_50_FPN_1x as the port reads it:
# the FPN body, keypoints, no masks, person and background
KEYPOINT_RCNN = R50_FPN_OPTS + ["MODEL.KEYPOINT_ON", True, "MODEL.MASK_ON", False,
                                "MODEL.ROI_BOX_HEAD.NUM_CLASSES", 2, "DATASETS.TRAIN", ("coco_zeroshot_train",),
                                "DATASETS.TEST", ("coco_not_zeroshot_val",)]


def _train_then_test(flags, opts, out, name):
    """Two steps with the final test, then ``test_net`` on the saved
    checkpoint: its metrics are the final test's."""
    rec = train_net.main([*flags, *opts, "SOLVER.MAX_ITER", "2", "SOLVER.CHECKPOINT_PERIOD", "2",
                          "OUTPUT_DIR", str(out / "t")])
    assert [r["step"] for r in tn.logged(out / "t")] == [1, 2]
    got = test_net.main([*flags, "--ckpt", str(out / "t" / "model_0000002.pth"), *opts,
                         "OUTPUT_DIR", str(out / "e")])[name]
    for k, v in rec["test"][name].items():
        if not k.startswith(("time/", "total_eval")):
            assert got[k] == v or (math.isnan(got[k]) and math.isnan(v)), k
    return tn.logged(out / "t"), got


def test_keypoint_rcnn_through_train_net_and_test_net(tmp_path, monkeypatch):
    tree = tmp_path / "kp"
    synth_coco_keypoints.write_tree(str(tree), train=4, val=4, sizes=((96, 72), (72, 96)), seed=0)
    monkeypatch.setenv("CMPL_TPU_DATA_DIR", str(tree))
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    logged, got = _train_then_test(["--device", "cpu"], [*map(str, KEYPOINT_RCNN + KP_TINY)], tmp_path,
                                   "coco_not_zeroshot_val")
    assert all(math.isfinite(r["loss_kp"]) and r["loss_kp"] > 0 for r in logged)
    assert math.isfinite(got["keypoints/AP"]) and math.isfinite(got["bbox/AP"]) and got["time/images"] == 4


def test_wsddn_through_train_net_and_test_net(tmp_path, monkeypatch):
    tree = tmp_path / "coco"
    subprocess.run([sys.executable, str(tn.REPO / "tools/synth_coco.py"), "--out", str(tree), "--train", "4",
                    "--val", "4", "--seen", "3", "--unseen", "2"], check=True, capture_output=True, timeout=300)
    monkeypatch.setenv("CMPL_TPU_DATA_DIR", str(tree))
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    opts = [*map(str, tn.TINY + WSDDN), "DATASETS.TEST", "('coco_generalized_zeroshot_val',)"]
    logged, got = _train_then_test(["--config-file", tn.TEACHER, "--device", "cpu"], opts, tmp_path,
                                   "coco_generalized_zeroshot_val")
    assert all(set(r) >= {"loss_objectness", "loss_classifier"} and "loss_box_reg" not in r for r in logged)
    assert math.isfinite(got["bbox/AP"]) and "segm/AP" not in got and got["time/images"] == 4
