"""The port's evaluation path against the JAX package's.

On a tiny synthetic COCO zero-shot tree (``tools/synth_coco.py``: 8 val
JPEGs, 3 seen and 2 unseen classes with 768-d embeddings):

- the port's evaluator returns the same metrics dict as JAX's on the
  same COCO results list (bbox and segm, per-class and per-split AP50),
  exactly, and its result conversion, proposal recall and expected-results
  check equal JAX's;
- the slice as a whole: the port's ``inference`` over ``Predictor(device=
  "cpu")`` against JAX's ``inference`` on the same tree with the same
  flax params (JAX's init, loaded into the port through
  ``bridge.load_flax_params``; the leaves JAX's eval init does not make,
  which the eval forward does not read, are seeded draws), at the narrow ST config of
  ``tests/test_torch_st_eval.py`` with 768-d class embeddings and one
  (96, 96) bucket (64-96 px images).  The results lists have the same
  length and the same (image_id, category_id) in order; boxes agree
  within 1e-3 px of the model's input frame (times the image's resize
  factor, 6-10 here, in the COCO results' original frame) and scores
  within 1e-5 (only the convolutions' summation order differs); at most 0.5% of the pixels of the pasted
  masks' image frames differ (mask probabilities near the 0.5
  threshold); every metric is equal (on random weights every AP is 0,
  so this holds the pass's wiring into the evaluator; the evaluator's
  numerics are held at nonzero AP by ``test_evaluate_matches_jax``);
- the port's ``test_net`` runs on the CPU and writes its two JSON files
  (test-time augmentation is held in ``tests/test_torch_bbox_aug.py``,
  ``MODEL.RPN_ONLY``'s proposal evaluation in
  ``tests/test_torch_rpn_only.py``).
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.config import get_default_cfg as jax_cfg
from cvpr22_cross_modal_pseudo_labeling_tpu.data import build as jax_build
from cvpr22_cross_modal_pseudo_labeling_tpu.data import paths_catalog as jax_catalog
from cvpr22_cross_modal_pseudo_labeling_tpu.data import evaluation as jax_evaluation
from cvpr22_cross_modal_pseudo_labeling_tpu.data.evaluation import box_proposals as jax_props
from cvpr22_cross_modal_pseudo_labeling_tpu.data.evaluation import prepare as jax_prepare
from cvpr22_cross_modal_pseudo_labeling_tpu.utils import rle as jax_rle
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.config import get_default_cfg as torch_cfg
from cvpr22_cross_modal_pseudo_labeling_torch.data import build as torch_build
from cvpr22_cross_modal_pseudo_labeling_torch.data.transforms import get_resize_hw
from cvpr22_cross_modal_pseudo_labeling_torch.data import evaluation as torch_evaluation
from cvpr22_cross_modal_pseudo_labeling_torch.data.evaluation import box_proposals as torch_props
from cvpr22_cross_modal_pseudo_labeling_torch.data.evaluation import prepare as torch_prepare
from cvpr22_cross_modal_pseudo_labeling_torch.engine import inference as torch_inference
from cvpr22_cross_modal_pseudo_labeling_torch.tools import test_net
from cvpr22_cross_modal_pseudo_labeling_torch.utils import rle as torch_rle
from tests.native_libs import ensure_native_libs

REPO = Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "configs/coco_cap_det/student_teacher_mask_rcnn_uncertainty.yaml")
DATASETS = ("coco_zeroshot_val", "coco_not_zeroshot_val", "coco_generalized_zeroshot_val")
TINY_EVAL_OPTS = [
    "MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
    "MODEL.RESNETS.WIDTH_PER_GROUP", 4, "MODEL.ROI_BOX_HEAD.EMB_DIM", 768,
    "MODEL.RPN.PRE_NMS_TOP_N_TEST", 128, "MODEL.RPN.POST_NMS_TOP_N_TEST", 32,
    "MODEL.ROI_MASK_HEAD.CONV_LAYERS", (8,), "TPU.COMPUTE_DTYPE", "float32",
    "TPU.NMS_TILE", 64,
    "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 96, "TPU.IMAGE_BUCKETS", ((96, 96),),
    "DATASETS.TEST", ("coco_generalized_zeroshot_val",), "TEST.IMS_PER_BATCH", 4,
    "DATALOADER.NUM_WORKERS", 2,
]


@pytest.fixture(scope="module", autouse=True)
def native_libs():
    """Both packages' native image and mask libraries, loaded before
    the first comparison (``tests/native_libs.py``)."""
    ensure_native_libs()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth_coco")
    subprocess.run(
        [sys.executable, str(REPO / "tools/synth_coco.py"), "--out", str(out), "--train", "8",
         "--val", "8", "--seen", "3", "--unseen", "2"],
        check=True, capture_output=True, timeout=300,
    )
    return out


@pytest.fixture(scope="module")
def catalogs(tree):
    """Both packages' catalogs on the tree for the module's tests."""
    mp = pytest.MonkeyPatch()
    mp.setenv("CMPL_TPU_DATA_DIR", str(tree))
    mp.setattr(jax_catalog, "DATA_DIR", str(tree))
    yield tree
    mp.undo()


def cfg_pair(opts):
    out = []
    for get in (jax_cfg, torch_cfg):
        cfg = get()
        cfg.merge_from_file(CONFIG)
        cfg.merge_from_list(list(opts))
        cfg.freeze()
        out.append(cfg)
    return out


def datasets_pair(name):
    jc, tc = cfg_pair(["DATASETS.TEST", (name,)])
    return (jax_build.build_dataset(jc, (name,), None, False)[0],
            torch_build.build_dataset(tc, (name,), None, False)[0])


def synthetic_results(dataset, seed):
    """COCO results near the ground truth (jittered boxes, shifted masks,
    some wrong classes, random scores with ties) plus false positives."""
    rng = np.random.default_rng(seed)
    cats = dataset.coco.get_cat_ids()
    out = []
    for ann in dataset.coco.anns.values():
        info = dataset.coco.imgs[ann["image_id"]]
        h, w = info["height"], info["width"]
        x, y, bw, bh = ann["bbox"]
        cat = ann["category_id"] if rng.uniform() < 0.8 else int(rng.choice(cats))
        mask = jax_rle.coco_segmentation_to_mask(ann["segmentation"], h, w)
        mask = np.roll(mask, tuple(rng.integers(-3, 4, 2)), axis=(0, 1))
        out.append({
            "image_id": ann["image_id"], "category_id": cat,
            "bbox": [x + rng.normal(0, 3), y + rng.normal(0, 3), bw * rng.uniform(0.8, 1.2),
                     bh * rng.uniform(0.8, 1.2)],
            "score": float(np.round(rng.uniform(), 1)),
            "segmentation": jax_rle.encode_mask(mask),
        })
    for img_id, info in dataset.coco.imgs.items():
        for _ in range(3):
            x, y = rng.uniform(0, info["width"] - 40), rng.uniform(0, info["height"] - 40)
            mask = np.zeros((info["height"], info["width"]), np.uint8)
            mask[int(y):int(y) + 30, int(x):int(x) + 30] = 1
            out.append({"image_id": img_id, "category_id": int(rng.choice(cats)),
                        "bbox": [x, y, 30.0, 30.0], "score": float(rng.uniform(0, 0.5)),
                        "segmentation": jax_rle.encode_mask(mask)})
    return out


def assert_metrics_equal(got, ref, atol=0.0):
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        if isinstance(v, float) and math.isnan(v):
            assert math.isnan(got[k]), k
        else:
            assert abs(got[k] - v) <= atol, (k, got[k], v)


@pytest.mark.parametrize("name", DATASETS)
def test_evaluate_matches_jax(catalogs, name):
    jd, td = datasets_pair(name)
    results = synthetic_results(jd, seed=len(name))
    ref = jax_evaluation.evaluate(jd, json.loads(json.dumps(results)), iou_types=("bbox", "segm"))
    got = torch_evaluation.evaluate(td, json.loads(json.dumps(results)), iou_types=("bbox", "segm"))
    assert ref["bbox/AP"] > 0.05 and ref["segm/AP"] > 0.05
    assert any("AP50_class_" in k for k in ref) and any("AP50_split_" in k for k in ref)
    assert_metrics_equal(got, ref)


@pytest.mark.parametrize("with_masks", [True, False])
def test_detections_to_coco_results_matches_jax(with_masks):
    rng = np.random.default_rng(3)
    d = 30
    x1, y1 = rng.uniform(-10, 90, d), rng.uniform(-10, 60, d)
    boxes = np.stack([x1, y1, x1 + rng.uniform(1, 40, d), y1 + rng.uniform(1, 30, d)], 1)
    args = (boxes.astype(np.float32), rng.uniform(0, 1, d).astype(np.float32),
            rng.integers(1, 6, d).astype(np.int32), rng.uniform(0, 1, d) > 0.2,
            rng.uniform(0, 1, (d, 14, 14)).astype(np.float32) if with_masks else None)
    kw = dict(image_id=7, input_hw=(72, 96), original_hw=(480, 640),
              contiguous_to_json={1: 11, 2: 12, 3: 13, 4: 14, 5: 15})
    assert torch_prepare.detections_to_coco_results(*args, **kw) == \
        jax_prepare.detections_to_coco_results(*args, **kw)


def test_box_proposals_match_jax(catalogs):
    jd, td = datasets_pair("coco_generalized_zeroshot_val")
    rng = np.random.default_rng(5)
    props = {}
    for img_id, info in jd.coco.imgs.items():
        x1, y1 = rng.uniform(0, info["width"], 50), rng.uniform(0, info["height"], 50)
        props[img_id] = np.stack([x1, y1, x1 + rng.uniform(5, 200, 50),
                                  y1 + rng.uniform(5, 200, 50), rng.uniform(0, 1, 50)], 1)
    for area in ("all", "small", "medium", "large"):
        assert torch_props.evaluate_box_proposals(props, td.coco, area=area, limit=20) == \
            jax_props.evaluate_box_proposals(props, jd.coco, area=area, limit=20)


def test_check_expected_results_matches_jax():
    results = {"bbox/AP": 0.31, "segm/AP": 0.2}
    expected = (("bbox", "AP", 0.3, 0.01), ("segm", "AP", 0.3, 0.01), ("bbox", "AR@1", 0.1, 0.1))
    got = torch_evaluation.check_expected_results(results, expected, 4.0)
    assert got == jax_evaluation.check_expected_results(results, expected, 4.0)
    assert len(got) == 2


@pytest.fixture(scope="module")
def slice_runs(catalogs):
    """JAX's and the port's inference on the same tree and params."""
    import jax
    import jax.numpy as jnp

    from cvpr22_cross_modal_pseudo_labeling_tpu.engine.inference import inference as jax_inf
    from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import build_detection_model

    jc, tc = cfg_pair(TINY_EVAL_OPTS)
    (jl,), (jd,) = jax_build.make_data_loader(jc, is_train=False)
    model = build_detection_model(jc)
    sample = jd[0]
    params = jax.jit(
        lambda r, im, sz, ce: model.init(r, im, sz, class_embeddings=ce, train=False)
    )({"params": jax.random.PRNGKey(0)}, jnp.asarray(sample["image"][None]),
      jnp.asarray([sample["image"].shape[:2]], jnp.int32), jnp.asarray(jd.class_emb_mtx))
    params = jax.tree_util.tree_map(np.asarray, params)
    jax_out = str(catalogs / "jax_predictions.json")
    jax_metrics = jax_inf(model, params, jl, jd, iou_types=("bbox", "segm"), output_file=jax_out)

    # JAX's eval init makes only the leaves the eval forward reads; the
    # modules it skips (the BERT table, the training-only heads) take
    # seeded draws, which the eval forward never reads either
    predictor = torch_inference.Predictor(CONFIG, TINY_EVAL_OPTS, device="cpu")
    tree = bridge.seeded_flax_params(predictor.model, 0)

    def overlay(dst, src):
        for k, v in src.items():
            if isinstance(v, dict):
                overlay(dst[k], v)
            else:
                assert dst[k].shape == v.shape, k
                dst[k] = v

    overlay(tree, params["params"])
    predictor.load_flax_params(tree)
    (tl,), (td,) = torch_build.make_data_loader(tc, is_train=False)
    port_out = str(catalogs / "port_predictions.json")
    port_metrics = torch_inference.inference(
        predictor, tl, td, iou_types=("bbox", "segm"), output_file=port_out)
    with open(jax_out) as f, open(port_out) as g:
        return json.load(f), jax_metrics, json.load(g), port_metrics, td


def test_inference_results_match_jax(slice_runs):
    ref, _, got, _, dataset = slice_runs
    assert len(got) == len(ref) > 0
    assert {r["image_id"] for r in got} == set(dataset.id_to_img_map.values())
    assert [(r["image_id"], r["category_id"]) for r in got] == \
        [(r["image_id"], r["category_id"]) for r in ref]
    # 1e-3 px in the model's input frame, scaled to the original image
    scale = {}
    for img_id, info in dataset.coco.imgs.items():
        nh, nw = get_resize_hw((info["height"], info["width"]), 64, 96)
        scale[img_id] = max(info["height"] / nh, info["width"] / nw)
    diff = np.abs(np.array([r["bbox"] for r in got]) - np.array([r["bbox"] for r in ref]))
    limit = 1e-3 * np.array([scale[r["image_id"]] for r in ref])[:, None]
    assert (diff <= limit).all(), float((diff - limit).max())
    np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in ref],
                               rtol=0, atol=1e-5)


def test_inference_masks_match_jax(slice_runs):
    ref, _, got, _, _ = slice_runs
    differ = total = 0
    for r, g in zip(ref, got):
        a, b = torch_rle.decode_rle(g["segmentation"]), jax_rle.decode_rle(r["segmentation"])
        differ += int((a != b).sum())
        total += a.size
    assert differ <= 0.005 * total, (differ, total)


def test_inference_metrics_match_jax(slice_runs):
    _, ref, _, got, _ = slice_runs
    assert {k for k in got if k.startswith("time/")} >= {
        "time/e2e_images_per_s", "time/steady_images_per_s", "time/device_s_per_img",
        "time/device_busy_share", "time/evaluate_s"}
    got = {k: v for k, v in got.items() if not k.startswith("time/") and k != "total_eval_seconds"}
    ref = {k: v for k, v in ref.items() if k != "total_eval_seconds"}
    assert_metrics_equal(got, ref)


class _NumpyPredictor:
    """A stand-in ``Predictor``: one detection per image, whose box and
    score come from the image's pixels."""

    def __call__(self, images, image_sizes, class_embeddings):
        b = images.shape[0]
        mean = images.reshape(b, -1).mean(1).astype(np.float32)
        boxes = np.tile(np.float32([[[2, 2, 40, 30]]]), (b, 1, 1)) + mean[:, None, None] / 50
        dets = torch_inference.NumpyDetections(
            boxes=boxes, scores=(mean / 255)[:, None], labels=np.ones((b, 1), np.int32),
            valid=np.ones((b, 1), bool))
        return dets, np.full((b, 1, 14, 14), 0.7, np.float32)


def test_compute_on_dataset_keeps_order_under_backpressure(catalogs, monkeypatch):
    """One conversion worker, batches of 1: the FIFO drain keeps the
    results in loader order, and every image of the dataset has one."""
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    _, tc = cfg_pair(TINY_EVAL_OPTS + ["TEST.IMS_PER_BATCH", 1])
    (tl,), (td,) = torch_build.make_data_loader(tc, is_train=False)
    results, stats = torch_inference.compute_on_dataset(_NumpyPredictor(), tl, td, td.class_emb_mtx)
    assert [r["image_id"] for r in results] == [td.id_to_img_map[i] for i in range(len(td))]
    assert stats["images"] == len(td) == 8 and 0 < stats["device_busy_share"] <= 1
    assert all("segmentation" in r for r in results)


def run_test_net(out_dir):
    return test_net.main(["--config-file", CONFIG, "--device", "cpu", "--seed", "1",
                          *map(str, TINY_EVAL_OPTS), "TEST.IMS_PER_BATCH", "3",
                          "OUTPUT_DIR", str(out_dir)])


def test_test_net_on_cpu_writes_predictions_and_metrics(catalogs, tmp_path):
    metrics = run_test_net(tmp_path)
    name = "coco_generalized_zeroshot_val"
    assert list(metrics) == [name]
    with open(tmp_path / f"predictions_{name}.json") as f:
        preds = json.load(f)
    with open(tmp_path / f"metrics_{name}.json") as f:
        saved = json.load(f)
    assert len({p["image_id"] for p in preds}) == 8  # a ragged final batch of 2 included
    assert "bbox/AP" in saved and "segm/AP" in saved and "time/evaluate_s" in saved
    assert saved["bbox/AP"] == metrics[name]["bbox/AP"]


@pytest.mark.parametrize("how", ["ckpt", "last_checkpoint", "weight"])
def test_test_net_refuses_checkpoints(catalogs, tmp_path, how):
    """An orbax checkpoint of the JAX package, however it is named, raises
    rather than being ignored: the port reads only its own checkpoints
    (loaded by ``tests/test_torch_train_net.py``)."""
    orbax = tmp_path / "jax_out" / "model_0000001"
    orbax.mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    extra, out = [], tmp_path / "eval"
    if how == "ckpt":
        extra = ["--ckpt", str(orbax)]
    elif how == "last_checkpoint":
        (tmp_path / "jax_out" / "last_checkpoint").write_text(str(orbax))
        out = tmp_path / "jax_out"
    else:
        extra = ["MODEL.WEIGHT", str(tmp_path / "jax_out")]
        (tmp_path / "jax_out" / "last_checkpoint").write_text(str(orbax))
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md queue A item 9"):
        test_net.main(["--config-file", CONFIG, "--device", "cpu", *extra, *map(str, TINY_EVAL_OPTS),
                       "OUTPUT_DIR", str(out)])


def test_test_net_needs_a_card_unless_cpu_is_asked_for(catalogs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_net.main(["--config-file", CONFIG, "OUTPUT_DIR", str(tmp_path)])


def test_test_net_without_test_datasets_returns_early(tmp_path):
    assert test_net.main(["--config-file", CONFIG, "DATASETS.TEST", "()",
                          "OUTPUT_DIR", str(tmp_path / "none")]) == {}
    assert not (tmp_path / "none").exists()

