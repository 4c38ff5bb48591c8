"""The port's test-time augmentation against the JAX package's
``engine/bbox_aug.py`` and ``compute_on_dataset_bbox_aug``.

- ``merge_and_filter``: the port's one label-gated NMS over the union
  (``ops/nms.py``; the plain version on the CPU) gives JAX's per-class
  host NMS result bit for bit, boxes, scores and labels in JAX's order,
  on seeded detections with tied scores and heavy overlap, through JAX's
  native NMS and through its numpy fallback; ``flip_boxes_np`` and the
  variant loop ``im_detect_bbox_aug`` too.
- ``compute_on_dataset_bbox_aug`` on a tiny student-teacher model with
  JAX's weights bridged into the port (as ``tests/test_torch_eval.py``
  does), on the tiny OpenImages val set of ``tests/test_torch_openimages.py``
  at two scales and their flips: some variants land on the one (96, 96)
  bucket, the larger scale on the fallback of its own size.  The results
  have the same (image_id, category_id) in order; each has its JAX
  result's box within 1e-3 px of the model's input frame times the
  image's resize factor and its score within 1e-5
  (``tests/test_torch_eval.py``'s tolerances), up to swaps of results
  whose scores are that close.
- ``test_net`` with ``TEST.BBOX_AUG.ENABLED`` on the CPU: box-only
  results, at most ``DETECTIONS_PER_IMG`` an image, the bbox metrics.
"""

import importlib
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cvpr22_cross_modal_pseudo_labeling_tpu.config import get_default_cfg as jax_cfg
from cvpr22_cross_modal_pseudo_labeling_tpu.data import build as jax_build
from cvpr22_cross_modal_pseudo_labeling_tpu.data import paths_catalog as jax_catalog
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import bbox_aug as jax_aug
from cvpr22_cross_modal_pseudo_labeling_tpu.utils import native as jax_native
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.config import get_default_cfg as torch_cfg
from cvpr22_cross_modal_pseudo_labeling_torch.data import build as torch_build
from cvpr22_cross_modal_pseudo_labeling_torch.data.transforms import get_resize_hw
from cvpr22_cross_modal_pseudo_labeling_torch.engine import bbox_aug as torch_aug
from cvpr22_cross_modal_pseudo_labeling_torch.engine import inference as torch_inference
from cvpr22_cross_modal_pseudo_labeling_torch.tools import test_net
from tests.native_libs import ensure_native_libs
from tests.test_torch_openimages import STUDENT, write_tiny_tree

# the JAX package's engine/__init__.py exports a function of this name
jax_inference = importlib.import_module("cvpr22_cross_modal_pseudo_labeling_tpu.engine.inference")

TINY = [
    "MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
    "MODEL.RESNETS.WIDTH_PER_GROUP", 4, "MODEL.ROI_BOX_HEAD.EMB_DIM", 768,
    "MODEL.RPN.PRE_NMS_TOP_N_TEST", 128, "MODEL.RPN.POST_NMS_TOP_N_TEST", 32,
    "MODEL.ROI_MASK_HEAD.CONV_LAYERS", (8,), "TPU.COMPUTE_DTYPE", "float32", "TPU.NMS_TILE", 64,
    "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 96, "TPU.IMAGE_BUCKETS", ((96, 96),),
    "TEST.IMS_PER_BATCH", 3, "DATALOADER.NUM_WORKERS", 2,
]
# the base scale 64, scales 48 and 80 and all flips; 80 leaves the
# (96, 96) bucket for the fallback of its own size (SIZE_DIVISIBILITY 0)
AUG = ["TEST.BBOX_AUG.ENABLED", True, "TEST.BBOX_AUG.H_FLIP", True, "TEST.BBOX_AUG.SCALE_H_FLIP", True,
       "TEST.BBOX_AUG.SCALES", (48, 80), "TEST.BBOX_AUG.MAX_SIZE", 112]


def detections(seed, variants=4, n=60, labels=5, width=200.0):
    """Per-variant detections around a few centers (heavy overlap), with
    scores on a 0.05 grid (ties) and some under the score threshold."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(20, width - 20, (6, 2))
    out = ([], [], [])
    for _ in range(variants):
        c = centers[rng.integers(0, len(centers), n)] + rng.normal(0, 4, (n, 2))
        wh = rng.uniform(10, 40, (n, 2))
        out[0].append(np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32))
        out[1].append((np.round(rng.uniform(0, 1, n) / 0.05) * 0.05).astype(np.float32))
        out[2].append(rng.integers(1, labels + 1, n).astype(np.int32))
    return out


@pytest.mark.parametrize("native", [True, False], ids=["jax_native_nms", "jax_numpy_nms"])
@pytest.mark.parametrize("seed,variants,keep", [(0, 4, 100), (1, 6, 100), (2, 2, 30), (3, 1, 100), (4, 6, 500)])
def test_merge_and_filter_matches_jax_bit_for_bit(monkeypatch, native, seed, variants, keep):
    if not native:
        monkeypatch.setattr(jax_native, "native_nms", lambda *a: None)
    elif jax_native.get_lib() is None:
        pytest.skip("the JAX package's native library does not build here")
    args = detections(seed, variants)
    ref = jax_aug.merge_and_filter(*args, nms_thresh=0.5, detections_per_img=keep)
    got = torch_aug.merge_and_filter(*args, nms_thresh=0.5, detections_per_img=keep)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    merged = sum(len(s) for s in args[1])
    assert 0 < len(got[0]) <= min(keep, merged)


def test_merge_and_filter_of_nothing_matches_jax():
    args = ([np.zeros((3, 4), np.float32)], [np.full(3, 0.01, np.float32)], [np.ones(3, np.int32)])
    got, ref = torch_aug.merge_and_filter(*args), jax_aug.merge_and_filter(*args)
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (0,) + r.shape[1:] and g.dtype == r.dtype


def test_flip_and_the_variant_loop_match_jax():
    boxes = np.float32([[3, 4, 50, 60], [0, 0, 99, 10]])
    np.testing.assert_array_equal(torch_aug.flip_boxes_np(boxes, 100.0), jax_aug.flip_boxes_np(boxes, 100.0))
    image = np.zeros((300, 400, 3), np.uint8)
    args = detections(9, variants=6)

    def runner(calls):
        def run(img, hw, flipped):
            calls.append((hw, flipped))
            i = len(calls) - 1
            return args[0][i], args[1][i], args[2][i]
        return run

    jc, tc = [], []
    kw = dict(scales=(400, 600), max_size=1000, h_flip=True, scale_h_flip=True, base_scale=300)
    ref = jax_aug.im_detect_bbox_aug(runner(jc), image, **kw)
    got = torch_aug.im_detect_bbox_aug(runner(tc), image, **kw)
    assert tc == jc and len(tc) == 6 and tc[1] == ((300, 400), True)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.fixture(scope="module", autouse=True)
def native_libs():
    """Both packages' native image and mask libraries, loaded before
    the first comparison (``tests/native_libs.py``)."""
    ensure_native_libs()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tree = write_tiny_tree(tmp_path_factory.mktemp("synth_oi"))
    mp = pytest.MonkeyPatch()
    mp.setenv("CMPL_TPU_DATA_DIR", str(tree))
    mp.setattr(jax_catalog, "DATA_DIR", str(tree))
    yield tree
    mp.undo()


def cfg_pair(opts):
    out = []
    for get in (jax_cfg, torch_cfg):
        cfg = get()
        cfg.merge_from_file(STUDENT)
        cfg.merge_from_list(list(opts))
        cfg.freeze()
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def aug_runs(tree):
    from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import build_detection_model

    jc, tc = cfg_pair(TINY + AUG)
    (jd,) = jax_build.build_dataset(jc, jc.DATASETS.TEST, None, False)
    (td,) = torch_build.build_dataset(tc, tc.DATASETS.TEST, None, False)
    model = build_detection_model(jc)
    params = jax.jit(
        lambda r, im, sz, ce: model.init(r, im, sz, class_embeddings=ce, train=False)
    )({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 96, 96, 3)), jnp.asarray([[64, 85]], jnp.int32),
      jnp.asarray(jd.class_emb_mtx))
    params = jax.tree_util.tree_map(np.asarray, params)
    aug = torch_inference.bbox_aug_options(tc)
    ref = jax_inference.compute_on_dataset_bbox_aug(model, params, jd, jd.class_emb_mtx, aug)

    predictor = torch_inference.Predictor(STUDENT, TINY + AUG, device="cpu")
    tree_ = bridge.seeded_flax_params(predictor.model, 0)

    def overlay(dst, src):
        for k, v in src.items():
            if isinstance(v, dict):
                overlay(dst[k], v)
            else:
                dst[k] = v

    overlay(tree_, params["params"])
    predictor.load_flax_params(tree_)
    shapes = []
    call = predictor.__call__

    class Recording(type(predictor)):
        def __call__(self, images, image_sizes, class_embeddings):
            shapes.append((images.shape, images.dtype))
            return call(images, image_sizes, class_embeddings)

    predictor.__class__ = Recording
    got, stats = torch_inference.compute_on_dataset_bbox_aug(predictor, td, td.class_emb_mtx, aug)
    return ref, got, stats, shapes, td


def test_compute_on_dataset_bbox_aug_matches_jax(aug_runs):
    """Each JAX result has its own port result of the same image and
    class, score within 1e-5 and box within the limit.  The order is
    JAX's up to swaps of results whose scores differ by less than 1e-5
    (near 1.0 on these random weights, where the two forwards' last bits
    decide which of two tied boxes the merge lists first)."""
    ref, got, stats, shapes, dataset = aug_runs
    assert len(got) == len(ref) > 0
    assert {r["image_id"] for r in got} <= set(dataset.id_to_img_map.values())
    scale = {}
    for img_id, info in dataset.coco.imgs.items():
        nh, nw = get_resize_hw((info["height"], info["width"]), 48, 112)
        scale[img_id] = 1e-3 * max(info["height"] / nh, info["width"] / nw)
    unmatched = list(range(len(got)))
    for i, r in enumerate(ref):
        near = [j for j in unmatched if got[j]["image_id"] == r["image_id"]
                and got[j]["category_id"] == r["category_id"] and abs(got[j]["score"] - r["score"]) <= 1e-5
                and np.abs(np.subtract(got[j]["bbox"], r["bbox"])).max() <= scale[r["image_id"]]]
        assert near, (i, r)
        j = min(near, key=lambda j: abs(j - i))
        ties = [k for k in range(min(i, j), max(i, j) + 1) if abs(ref[k]["score"] - r["score"]) <= 1e-5]
        assert len(ties) == abs(j - i) + 1, (i, j)
        unmatched.remove(j)
    assert [(r["image_id"], r["category_id"]) for r in got] == [(r["image_id"], r["category_id"]) for r in ref]
    # one call per variant at batch 1, host-normalized, on the bucket or the fallback
    assert stats["images"] == len(dataset) and stats["variants_per_img"] == 6 == len(shapes) / len(dataset)
    assert all(s[0][0] == 1 and s[1] == np.float32 for s in shapes)
    assert {s[0][1:3] for s in shapes} == {(96, 96), (80, 106), (106, 80)}
    per_image = {}
    for r in got:
        per_image[r["image_id"]] = per_image.get(r["image_id"], 0) + 1
    assert max(per_image.values()) <= 100 and "segmentation" not in got[0]


def test_test_net_runs_the_augmentation_box_only(tree, tmp_path):
    out = tmp_path / "aug"
    metrics = test_net.main(["--config-file", STUDENT, "--device", "cpu", *map(str, TINY + AUG),
                             "TEST.BBOX_AUG.SCALES", "(48,)", "OUTPUT_DIR", str(out)])
    (m,) = metrics.values()
    assert "bbox/AP" in m and not any(k.startswith("segm/") for k in m)
    assert m["time/variants_per_img"] == 4 and m["time/images"] == 6
    assert all(math.isfinite(v) or "AP50_class_" in k for k, v in m.items())
    with open(out / "predictions_openimages_zeroshot_val.json") as f:
        preds = json.load(f)
    assert preds and all("segmentation" not in p for p in preds)
