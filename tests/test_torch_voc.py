"""The port's VOC and Cityscapes data, the VOC evaluator and the
supervised class-specific configurations end to end, against the JAX
package where it has a counterpart, on the CPU.

- A tiny VOC2007 tree (the port's ``tools/synth_voc.py``: 6 train and 6
  test JPEGs at 100 x 75, 75 x 100 and 100 x 67, 1-6 objects each, some
  ``difficult``) is read by both packages' ``PascalVOCDataset``: the
  samples (with and without ``use_difficult``), the image infos and the
  COCO view are equal, the port's uint8 pixels equal to JAX's float ones
  times 255, rounded.  Both loaders, with ``INPUT.DEVICE_NORMALIZE
  False`` (both normalize on the host), give equal batches, the images
  within one grey level (JAX's resize casts its float image to uint8 by
  truncation).
- A tiny Cityscapes tree written here (two cities, ``...group`` labels,
  a ``road`` polygon and a polygon under ``min_area``): samples and
  ``to_coco_index`` equal JAX's.
- ``voc_eval`` and the ``evaluate`` dispatch: the same detections (boxes
  near the ground truth, false positives, matches of difficult objects)
  give JAX's metrics exactly, both interpolations.
- ``train_net`` then ``test_net --ckpt`` on the CPU at narrow widths:
  maskrcnn_benchmark's VOC Faster R-CNN (21 classes, batch 1) on the VOC
  tree, and the class-specific COCO Mask R-CNN (81 classes) on the
  seen split of ``tools/synth_coco.py``'s tree.  Random weights put each
  class's probability near 1/C, below the default 0.05, so these runs
  set ``MODEL.ROI_HEADS.SCORE_THRESH`` 0.0.
"""

import json
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from cvpr22_cross_modal_pseudo_labeling_tpu.config import get_default_cfg as jax_cfg
from cvpr22_cross_modal_pseudo_labeling_tpu.data import build as jax_build
from cvpr22_cross_modal_pseudo_labeling_tpu.data import evaluation as jax_evaluation
from cvpr22_cross_modal_pseudo_labeling_tpu.data import paths_catalog as jax_catalog
from cvpr22_cross_modal_pseudo_labeling_tpu.data.datasets import cityscapes as jax_cityscapes
from cvpr22_cross_modal_pseudo_labeling_tpu.data.datasets import voc as jax_voc
from cvpr22_cross_modal_pseudo_labeling_tpu.data.evaluation import voc_eval as jax_voc_eval
from cvpr22_cross_modal_pseudo_labeling_torch.config import get_default_cfg as torch_cfg
from cvpr22_cross_modal_pseudo_labeling_torch.data import build as torch_build
from cvpr22_cross_modal_pseudo_labeling_torch.data import evaluation as torch_evaluation
from cvpr22_cross_modal_pseudo_labeling_torch.data.datasets import cityscapes as torch_cityscapes
from cvpr22_cross_modal_pseudo_labeling_torch.data.datasets import voc as torch_voc
from cvpr22_cross_modal_pseudo_labeling_torch.data.evaluation import voc_eval as torch_voc_eval
from cvpr22_cross_modal_pseudo_labeling_torch.tools import synth_voc, test_net, train_net

REPO = Path(__file__).resolve().parents[1]
SIZES = ((100, 75), (75, 100), (100, 67))
# maskrcnn_benchmark's configs/pascal_voc/e2e_faster_rcnn_R_50_C4_1x_1_gpu_voc.yaml
VOC = [
    "MODEL.ROI_BOX_HEAD.NUM_CLASSES", 21, "MODEL.RPN.PRE_NMS_TOP_N_TEST", 6000,
    "MODEL.RPN.POST_NMS_TOP_N_TEST", 300, "MODEL.RPN.ANCHOR_SIZES", (128, 256, 512),
    "DATASETS.TRAIN", ("voc_2007_train",), "DATASETS.TEST", ("voc_2007_test",),
    "SOLVER.IMS_PER_BATCH", 1, "TEST.IMS_PER_BATCH", 1, "SOLVER.BASE_LR", 0.001,
]
# maskrcnn_benchmark's configs/e2e_mask_rcnn_R_50_C4_1x.yaml on the seen split
COCO = [
    "MODEL.MASK_ON", True, "DATASETS.TRAIN", ("coco_zeroshot_train",),
    "DATASETS.TEST", ("coco_not_zeroshot_val",),
]
# narrow widths, small images; SCORE_THRESH 0.0 for the random weights
TINY = [
    "MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
    "MODEL.RESNETS.WIDTH_PER_GROUP", 4, "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 128,
    "MODEL.RPN.POST_NMS_TOP_N_TRAIN", 32, "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 16,
    "MODEL.ROI_HEADS.SCORE_THRESH", 0.0, "TPU.MASK_POS_CAP", 8, "TPU.MAX_GT", 8,
    "MODEL.ROI_MASK_HEAD.CONV_LAYERS", (8,), "TPU.COMPUTE_DTYPE", "float32",
    "INPUT.MIN_SIZE_TRAIN", (64,), "INPUT.MAX_SIZE_TRAIN", 96, "INPUT.MIN_SIZE_TEST", 64,
    "INPUT.MAX_SIZE_TEST", 96, "TPU.IMAGE_BUCKETS", ((96, 96),), "SOLVER.LOG_PERIOD", 1,
    "SOLVER.TEST_PERIOD", 0, "DATALOADER.NUM_WORKERS", 2,
]
# one grey level after the BGR255 normalization, and float rounding
GREY_LEVEL_ATOL = 1.0 + 1e-3


@pytest.fixture(scope="module")
def voc_tree(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth_voc")
    wrote = synth_voc.write_tree(str(out), train=6, test=6, sizes=SIZES, seed=0)
    assert wrote["difficult"] > 0
    return out


@pytest.fixture
def both_catalogs(voc_tree, monkeypatch):
    monkeypatch.setenv("CMPL_TPU_DATA_DIR", str(voc_tree))
    monkeypatch.setattr(jax_catalog, "DATA_DIR", str(voc_tree))
    monkeypatch.setitem(sys.modules, "tensorflow", None)


def voc_pair(tree, split, use_difficult=False):
    d = str(tree / "voc" / "VOC2007")
    return (jax_voc.PascalVOCDataset(d, split, use_difficult=use_difficult),
            torch_voc.PascalVOCDataset(d, split, use_difficult=use_difficult))


@pytest.mark.parametrize("use_difficult", [False, True])
def test_voc_samples_equal_jax(voc_tree, use_difficult):
    """0-based boxes from the 1-based XML, labels, masks and infos equal;
    difficult objects only with ``use_difficult``."""
    jd, td = voc_pair(voc_tree, "train", use_difficult)
    assert len(td) == len(jd) == 6 and td.ids == jd.ids and td.class_names == jd.class_names
    assert td.categories == jd.categories and td.id_to_img_map == jd.id_to_img_map
    assert td.eval_protocol == jd.eval_protocol == "voc"
    n_boxes = 0
    for i in range(len(td)):
        js, ts = jd[i], td[i]
        assert sorted(js) == sorted(ts)
        assert ts["image"].dtype == np.uint8
        np.testing.assert_array_equal(ts["image"], np.round(js["image"] * 255).astype(np.uint8))
        for k in ("boxes", "labels", "gt_masks"):
            assert ts[k].dtype == js[k].dtype, k
            np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
        for k in ("image_id", "is_det", "caption", "nn_caption", "ids_cap"):
            assert ts[k] == js[k], k
        assert td.get_img_info(i) == jd.get_img_info(i)
        n_boxes += len(ts["boxes"])
    all_objects = sum(len(td._annotation(i)["objects"]) for i in range(len(td)))
    assert (n_boxes == all_objects) == use_difficult
    xml = (voc_tree / "voc/VOC2007/Annotations" / f"{td.ids[0]}.xml").read_text()
    xmin = int(xml.split("<xmin>")[1].split("<")[0])
    assert td[0]["boxes"][0, 0] == xmin - 1


def test_voc_coco_view_equals_jax(voc_tree):
    """Every object, the difficult ones as ``iscrowd``."""
    jd, td = voc_pair(voc_tree, "test")
    assert td.coco.dataset == jd.coco.dataset
    assert td.coco.imgs == jd.coco.imgs and td.coco.anns == jd.coco.anns and td.coco.cats == jd.coco.cats
    assert dict(td.coco.img_to_anns) == dict(jd.coco.img_to_anns)
    assert any(a["iscrowd"] for a in td.coco.anns.values())


def loader_cfgs(opts):
    out = []
    for get in (jax_cfg, torch_cfg):
        cfg = get()
        cfg.merge_from_list(VOC + TINY + ["INPUT.DEVICE_NORMALIZE", False, "SOLVER.MAX_ITER", 4,
                                          "INPUT.MIN_SIZE_TRAIN", (64, 72)] + list(opts))
        cfg.freeze()
        out.append(cfg)
    return out


@pytest.mark.parametrize("is_train", [False, True])
def test_voc_loader_batches_equal_jax(both_catalogs, monkeypatch, is_train):
    """``voc_2007_test`` (eval) and ``voc_2007_train`` (4 iterations of
    batch 1, flips and scales from the same per-index generator): every
    key equal, the host-normalized images within one grey level."""
    for mod in (jax_voc, torch_voc):
        monkeypatch.setattr(mod, "visit_rng", lambda index: random.Random(1000 + index))
    jc, tc = loader_cfgs(())
    if is_train:
        (jl, _), (tl, td) = jax_build.make_data_loader(jc, True), torch_build.make_data_loader(tc, True)
        jb, tb = list(jl), list(tl)
        assert len(tb) == 4
    else:
        ((jl,), _), ((tl,), (td,)) = jax_build.make_data_loader(jc, False), torch_build.make_data_loader(tc, False)
        jb, tb = list(jl), list(tl)
        assert len(tb) == 6
    assert type(td).__name__ == "PascalVOCDataset"
    for (jbatch, ji), (tbatch, ti) in zip(jb, tb):
        assert list(ji) == list(ti) and sorted(jbatch) == sorted(tbatch)
        for k in jbatch:
            assert jbatch[k].dtype == tbatch[k].dtype, k
            if k == "images":
                np.testing.assert_allclose(tbatch[k], jbatch[k], rtol=0, atol=GREY_LEVEL_ATOL)
            else:
                np.testing.assert_array_equal(tbatch[k], jbatch[k], err_msg=k)
    assert sum(int(b["gt_valid"].sum()) for b, _ in tb) > 0


def write_cityscapes(root: Path):
    """Two cities, three images: person, cargroup (a car), rider and bus
    instances, a road polygon (not a thing class) and a car under 16
    px^2 (dropped)."""
    rng = np.random.RandomState(0)
    objects = [
        [{"label": "person", "polygon": [[10, 12], [30, 14], [28, 50], [12, 48]]},
         {"label": "cargroup", "polygon": [[40, 30], [90, 32], [88, 60], [42, 58]]},
         {"label": "road", "polygon": [[0, 60], [120, 60], [120, 80], [0, 80]]}],
        [{"label": "rider", "polygon": [[5, 5], [25, 5], [25, 40], [5, 40]]},
         {"label": "car", "polygon": [[50, 50], [52, 50], [52, 52], [50, 52]]}],
        [{"label": "bus", "polygon": [[20, 10], [100, 12], [98, 70], [22, 68]]}],
    ]
    for i, (city, objs) in enumerate(zip(("aachen", "aachen", "bochum"), objects)):
        stem = f"{city}_{i:06d}_000019"
        img_dir = root / "leftImg8bit" / "train" / city
        ann_dir = root / "gtFine" / "train" / city
        img_dir.mkdir(parents=True, exist_ok=True)
        ann_dir.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.randint(0, 256, (80, 120, 3), np.uint8)).save(img_dir / f"{stem}_leftImg8bit.png")
        with open(ann_dir / f"{stem}_gtFine_polygons.json", "w") as f:
            json.dump({"imgHeight": 80, "imgWidth": 120, "objects": objs}, f)


def test_cityscapes_samples_and_coco_index_equal_jax(tmp_path):
    write_cityscapes(tmp_path)
    args = (str(tmp_path / "leftImg8bit"), str(tmp_path / "gtFine"), "train")
    jd, td = jax_cityscapes.CityScapesDataset(*args), torch_cityscapes.CityScapesDataset(*args)
    assert len(td) == len(jd) == 3 and td.class_names == jd.class_names and td.categories == jd.categories
    labels = []
    for i in range(len(td)):
        js, ts = jd[i], td[i]
        assert sorted(js) == sorted(ts) and ts["image"].dtype == np.uint8
        np.testing.assert_array_equal(ts["image"], np.round(js["image"] * 255).astype(np.uint8))
        for k in ("boxes", "labels", "gt_masks"):
            np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
        assert td.get_img_info(i) == jd.get_img_info(i)
        labels += ts["labels"].tolist()
    assert labels == [1, 3, 2, 5]  # person, car (from cargroup), rider, bus
    ti, ji = td.to_coco_index(), jd.to_coco_index()
    assert ti.dataset == ji.dataset and ti.anns == ji.anns and ti.imgs == ji.imgs
    assert td.coco.dataset == ji.dataset
    assert all(isinstance(a["segmentation"]["counts"], str) for a in ti.anns.values())


def synthetic_detections(dataset, seed=0):
    """Per image: each object's box jittered (difficult ones included),
    a duplicate, a far-off false positive and a wrong-class box, with
    random scores; COCO format (xywh)."""
    rng = np.random.RandomState(seed)
    out = []
    for img_id, anns in dataset.coco.img_to_anns.items():
        for a in anns:
            x, y, w, h = a["bbox"]
            for cat in (a["category_id"], a["category_id"], (a["category_id"] % 20) + 1):
                jit = rng.uniform(-0.15, 0.15, 4) * [w, h, w, h]
                out.append({"image_id": img_id, "category_id": int(cat), "score": float(rng.rand()),
                            "bbox": [float(x + jit[0]), float(y + jit[1]), float(w + jit[2]), float(h + jit[3])]})
        out.append({"image_id": img_id, "category_id": int(rng.randint(1, 21)), "score": float(rng.rand()),
                    "bbox": [0.0, 0.0, 5.0, 5.0]})
    return out


def assert_same(got, ref):
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert (np.isnan(v) and np.isnan(got[k])) or got[k] == v, k


def test_voc_eval_matches_jax(voc_tree):
    """Per-class AP and mAP by both interpolations, and the dispatch of
    ``evaluate`` for a VOC dataset: equal to JAX's, NaN for a class
    without positives."""
    jd, td = voc_pair(voc_tree, "test")
    dets = synthetic_detections(td)
    got = torch_voc_eval.eval_detection_voc_all_metrics(json.loads(json.dumps(dets)), td.coco)
    ref = jax_voc_eval.eval_detection_voc_all_metrics(json.loads(json.dumps(dets)), jd.coco)
    for g, r in zip(got, ref):
        assert_same(g, r)
    cont, points11 = got
    assert 0 < cont["mAP"] < 1 and 0 < points11["mAP"] < 1 and cont["mAP"] != points11["mAP"]
    assert any(np.isnan(v) for v in cont.values())
    for use_07, want in ((False, cont), (True, points11)):
        assert_same(torch_voc_eval.eval_detection_voc(dets, td.coco, use_07_metric=use_07), want)
    m = torch_evaluation.evaluate(td, json.loads(json.dumps(dets)), iou_types=("bbox", "segm"))
    r = jax_evaluation.evaluate(jd, json.loads(json.dumps(dets)), iou_types=("bbox", "segm"))
    assert {"bbox/mAP", "bbox/mAP_07metric", "expected_results_failures"} <= set(m)
    assert_same(m, r)


def test_a_difficult_match_is_neither_true_nor_false():
    """One image, a plain and a difficult object of one class: a
    detection on the difficult one is ignored (AP 1.0 with a detection
    on the plain one ranked below it), where a miss would count."""
    from cvpr22_cross_modal_pseudo_labeling_torch.data.coco_index import CocoIndex

    index = CocoIndex.__new__(CocoIndex)
    anns = [{"id": 1, "image_id": 0, "category_id": 1, "bbox": [0, 0, 10, 10], "iscrowd": 0},
            {"id": 2, "image_id": 0, "category_id": 1, "bbox": [50, 50, 10, 10], "iscrowd": 1}]
    index.imgs = {0: {"id": 0}}
    index.cats = {1: {"id": 1}}
    index.img_to_anns = {0: anns}
    dets = [{"image_id": 0, "category_id": 1, "score": 0.9, "bbox": [50, 50, 10, 10]},
            {"image_id": 0, "category_id": 1, "score": 0.8, "bbox": [0, 0, 10, 10]}]
    got = torch_voc_eval.eval_detection_voc(dets, index)
    assert got == jax_voc_eval.eval_detection_voc(dets, index) and got["mAP"] == 1.0
    miss = [{"image_id": 0, "category_id": 1, "score": 0.9, "bbox": [80, 0, 10, 10]}, dets[1]]
    assert torch_voc_eval.eval_detection_voc(miss, index)["mAP"] == 0.5


def finite_metrics(metrics):
    return {k: v for k, v in metrics.items() if isinstance(v, float) and "_class_" not in k
            and not k.startswith("time/") and k != "total_eval_seconds"}


def test_voc_faster_rcnn_train_net_then_test_net(both_catalogs, tmp_path):
    """The VOC Faster R-CNN over the default config (no YAML): 3 steps at
    batch 1, a checkpoint, then ``test_net --ckpt`` at batch 1: both VOC
    metrics finite, the results file holding them, a result per image."""
    out = tmp_path / "voc"
    rec = train_net.main(["--device", "cpu", *map(str, VOC + TINY), "SOLVER.MAX_ITER", "3",
                          "OUTPUT_DIR", str(out)])
    trainer = rec["trainer"]
    assert type(trainer.model).__name__ == "GeneralizedRCNN" and trainer.class_tables == {}
    assert trainer.model.box_predictor.cls_score.weight.shape == (21, 2048)
    assert not hasattr(trainer.model, "mask_predictor")
    assert {"bbox/mAP", "bbox/mAP_07metric"} <= set(rec["test"]["voc_2007_test"])
    got = test_net.main(["--device", "cpu", "--ckpt", str(out / "model_0000003.pth"), *map(str, VOC + TINY),
                         "OUTPUT_DIR", str(tmp_path / "eval")])
    m = got["voc_2007_test"]
    assert all(np.isfinite(m[k]) for k in ("bbox/mAP", "bbox/mAP_07metric"))
    assert m["time/images"] == 6.0
    saved = json.loads((tmp_path / "eval" / "metrics_voc_2007_test.json").read_text())
    assert saved["bbox/mAP"] == m["bbox/mAP"] and saved["bbox/mAP_07metric"] == m["bbox/mAP_07metric"]
    preds = json.loads((tmp_path / "eval" / "predictions_voc_2007_test.json").read_text())
    assert {p["image_id"] for p in preds} == set(range(6))
    assert all(1 <= p["category_id"] <= 20 for p in preds)
    for k, v in finite_metrics(rec["test"]["voc_2007_test"]).items():
        assert v == m[k], k  # run_test and test_net on the same checkpoint


def test_coco_mask_rcnn_train_net_then_test_net(tmp_path, monkeypatch):
    """The class-specific COCO Mask R-CNN (81 classes, no class table) on
    the seen split: 2 steps of 2 with the in-training evaluation and the
    validation-loss pass at 2, then ``test_net --ckpt``: bbox and segm
    metrics finite (but a class without ground truth's AP50), a result
    and a mask per image."""
    subprocess.run([sys.executable, str(REPO / "tools/synth_coco.py"), "--out", str(tmp_path / "coco"),
                    "--train", "8", "--val", "8", "--seen", "3", "--unseen", "2"],
                   check=True, capture_output=True, timeout=300)
    monkeypatch.setenv("CMPL_TPU_DATA_DIR", str(tmp_path / "coco"))
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    opts = [*map(str, COCO + TINY), "SOLVER.IMS_PER_BATCH", "2", "TEST.IMS_PER_BATCH", "4",
            "DATALOADER.ASPECT_RATIO_GROUPING", "False"]
    rec = train_net.main(["--skip-test", "--device", "cpu", *opts, "SOLVER.MAX_ITER", "2",
                          "SOLVER.TEST_PERIOD", "2", "OUTPUT_DIR", str(tmp_path / "out")])
    # the in-training evaluation and validation-loss pass, without a class table
    assert list(rec["evals"]) == [2] and np.isfinite(rec["evals"][2]["coco_not_zeroshot_val"]["bbox/AP"])
    assert list(rec["val_losses"]) == [2] and np.isfinite(rec["val_losses"][2])
    model = rec["trainer"].model
    assert model.box_predictor.bbox_pred.weight.shape == (4 * 81, 2048)
    assert model.mask_predictor.mask_fcn_logits.weight.shape[0] == 81 and rec["trainer"].class_tables == {}
    got = test_net.main(["--device", "cpu", "--ckpt", str(tmp_path / "out" / "model_0000002.pth"), *opts,
                         "OUTPUT_DIR", str(tmp_path / "eval")])
    m = got["coco_not_zeroshot_val"]
    assert {"bbox/AP", "segm/AP"} <= set(m)
    bad = [k for k, v in finite_metrics(m).items() if not np.isfinite(v)]
    assert not bad, bad
    preds = json.loads((tmp_path / "eval" / "predictions_coco_not_zeroshot_val.json").read_text())
    ds = json.loads((tmp_path / "coco/coco/zero-shot/instances_val2017_seen_2.json").read_text())
    assert {p["image_id"] for p in preds} == {im["id"] for im in ds["images"]}
    assert all("segmentation" in p for p in preds)


def test_gt_box_eval_through_test_net(both_catalogs, voc_tree, tmp_path):
    """``MODEL.GT_BOX_EVAL`` through ``test_net``: each batch's gt boxes
    replace the proposals, so every image's results are its
    non-difficult objects, one each, at their own classes."""
    got = test_net.main(["--device", "cpu", *map(str, VOC + TINY), "MODEL.GT_BOX_EVAL", "True",
                         "OUTPUT_DIR", str(tmp_path)])
    assert np.isfinite(got["voc_2007_test"]["bbox/mAP"])
    preds = json.loads((tmp_path / "predictions_voc_2007_test.json").read_text())
    _, td = voc_pair(voc_tree, "test")
    for i in range(len(td)):
        want = sorted(int(x) for x in td[i]["labels"])
        have = sorted(p["category_id"] for p in preds if p["image_id"] == i)
        assert have == want and all(p["score"] > 1.0 for p in preds if p["image_id"] == i), i
