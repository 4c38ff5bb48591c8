"""The port's OpenImages and Conceptual Captions data against the JAX
package's.

A tiny synthetic tree (``tools/synth_openimages.py`` of the port: 12
OpenImages train and 6 val JPEGs at 96 x 72 and 72 x 96, 12 seen and 4
unseen long-tailed classes with 768-d embeddings, PNG and inline
instance masks, an image-level CSV that leaves a class of each image
out, 24 Conceptual JPEGs at 80 x 60 and 60 x 80 with captions of LVIS nouns) is read by both
packages:

- ``OpenImagesDataset``'s samples (PNG and inline masks), repeat factors,
  image-level table and class splits; ``ConCapDetDataset``'s fields; the
  mixture's index order; ``ListDataset`` and
  ``ConceptualCaptionsDataset``: equal.  A caption image is uint8 in the
  port and float32 in 0..1 in JAX (a divergence kept on purpose): the
  port's pixels equal JAX's times 255, rounded.
- The teacher's loader (``openimages_zeroshot_train`` with its
  repeat-factor sampler) and the mixture's loader
  (``conceptual_openimages_train``) over 3 iterations with
  ``INPUT.DEVICE_NORMALIZE False``, where JAX normalizes every row on the
  host: every key equal, the images of detection rows exactly and those
  of caption rows within one grey level (1.0 after the BGR255
  normalization, plus 1e-3 of float rounding), since JAX's resize casts
  its float caption image to uint8 by truncation
  (``tpu/data/transforms.py:57``).
- With the default ``DEVICE_NORMALIZE True``: JAX's mixed batch is
  float32 with its detection rows raw RGB beside normalized caption rows
  (ROADMAP.md section C); the port's is uint8, and its device
  normalization equals its host normalization exactly.
- The samplers' groups of the mixture equal JAX's, with and without the
  sizes in the caption index.
- ``evaluate`` with the image-level filter, bbox and segm: the metrics
  dict equals JAX's, and the filter drops detections.
"""

import importlib
import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.config import get_default_cfg as jax_cfg
from cvpr22_cross_modal_pseudo_labeling_tpu.data import build as jax_build
from cvpr22_cross_modal_pseudo_labeling_tpu.data import evaluation as jax_evaluation
from cvpr22_cross_modal_pseudo_labeling_tpu.data import paths_catalog as jax_catalog
from cvpr22_cross_modal_pseudo_labeling_tpu.data import samplers as jax_samplers
from cvpr22_cross_modal_pseudo_labeling_tpu.data.datasets import coco as jax_coco
from cvpr22_cross_modal_pseudo_labeling_tpu.data.datasets import conceptual as jax_conceptual
from cvpr22_cross_modal_pseudo_labeling_tpu.data.datasets import list_dataset as jax_list
from cvpr22_cross_modal_pseudo_labeling_tpu.models.backbone import device_normalize as jax_device_normalize
from cvpr22_cross_modal_pseudo_labeling_torch.config import get_default_cfg as torch_cfg
from cvpr22_cross_modal_pseudo_labeling_torch.data import build as torch_build
from cvpr22_cross_modal_pseudo_labeling_torch.data import evaluation as torch_evaluation
from cvpr22_cross_modal_pseudo_labeling_torch.data import samplers as torch_samplers
from cvpr22_cross_modal_pseudo_labeling_torch.data.datasets import coco as torch_coco
from cvpr22_cross_modal_pseudo_labeling_torch.data.datasets import conceptual as torch_conceptual
from cvpr22_cross_modal_pseudo_labeling_torch.data.datasets import list_dataset as torch_list
from cvpr22_cross_modal_pseudo_labeling_torch.models.backbone import device_normalize
from cvpr22_cross_modal_pseudo_labeling_torch.tools import synth_openimages

REPO = Path(__file__).resolve().parents[1]
TEACHER = str(REPO / "configs/conceptual_openimages_det/zeroshot_mask.yaml")
STUDENT = str(REPO / "configs/conceptual_openimages_det/student_teacher_mask_rcnn_uncertainty.yaml")
TINY_TREE = dict(train=12, val=6, captions=24, seen=12, unseen=4, det_sizes=((96, 72), (72, 96)),
                 cap_sizes=((80, 60), (60, 80)))
TRAIN_OPTS = [
    "INPUT.MIN_SIZE_TRAIN", (64, 72), "INPUT.MAX_SIZE_TRAIN", 96,
    "TPU.IMAGE_BUCKETS", ((96, 96), (72, 96), (96, 72)), "TPU.MAX_GT", 6,
    "INPUT.BRIGHTNESS", 0.2, "INPUT.CONTRAST", 0.2, "INPUT.SATURATION", 0.2,
    "SOLVER.IMS_PER_BATCH", 4, "SOLVER.MAX_ITER", 3, "DATALOADER.NUM_WORKERS", 2,
]
# one grey level after the BGR255 normalization, and float rounding
CAPTION_ROW_ATOL = 1.0 + 1e-3


def write_tiny_tree(out: Path, **kw) -> Path:
    synth_openimages.write_tree(str(out), **{**TINY_TREE, **kw})
    return out


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tiny_tree(tmp_path_factory.mktemp("synth_oi"))


@pytest.fixture
def both_catalogs(tree, monkeypatch):
    monkeypatch.setenv("CMPL_TPU_DATA_DIR", str(tree))
    monkeypatch.setattr(jax_catalog, "DATA_DIR", str(tree))
    return tree


@pytest.fixture
def fixed_visits(monkeypatch):
    """Both packages' datasets draw a sample's transforms from the same
    per-index generator."""
    for mod in (jax_coco, torch_coco, jax_conceptual, torch_conceptual):
        monkeypatch.setattr(mod, "visit_rng", lambda index: random.Random(1000 + index))


def cfgs(config, opts):
    out = []
    for get in (jax_cfg, torch_cfg):
        cfg = get()
        cfg.merge_from_file(config)
        cfg.merge_from_list(list(opts))
        cfg.freeze()
        out.append(cfg)
    return out


def datasets_pair(config, name, is_train=False):
    jc, tc = cfgs(config, [])
    return (jax_build.build_dataset(jc, (name,), None, is_train)[0],
            torch_build.build_dataset(tc, (name,), None, is_train)[0])


def assert_samples_equal(jax_sample, port_sample):
    assert sorted(jax_sample) == sorted(port_sample)
    for k, v in jax_sample.items():
        if isinstance(v, np.ndarray):
            assert v.dtype == port_sample[k].dtype, k
            np.testing.assert_array_equal(port_sample[k], v, err_msg=k)
        else:
            assert port_sample[k] == v, k


@pytest.mark.parametrize("name", ["openimages_zeroshot_train", "openimages_zeroshot_val"])
def test_openimages_dataset_matches_jax(both_catalogs, name):
    jd, td = datasets_pair(TEACHER, name, is_train=name.endswith("train"))
    assert type(td).__name__ == "OpenImagesDataset" and len(td) == len(jd) > 0
    png = [a for a in td.coco.anns.values() if "iseg_file_name" in a]
    inline = [a for a in td.coco.anns.values() if "segmentation" in a]
    assert png and inline
    for i in range(len(td)):
        j, t = jd.raw_sample(i), td.raw_sample(i)
        assert_samples_equal(j, t)
        assert t["gt_masks"].shape[0] == len(t["boxes"]) and t["gt_masks"].any(axis=(1, 2)).all()
    np.testing.assert_array_equal(td.repeat_factors, jd.repeat_factors)
    assert td.repeat_factors.dtype == np.float64 and (td.repeat_factors >= 1).all()
    assert td.imagelevel == jd.imagelevel
    assert td.class_splits == jd.class_splits and td.class_names == jd.class_names
    np.testing.assert_array_equal(td.class_emb_mtx, jd.class_emb_mtx)
    if name.endswith("val"):
        assert set(td.class_splits) == {"seen", "unseen"} and len(td.imagelevel) == len(td)
        # the CSV leaves one ground-truth class out of every image that has two
        gt = {i: {a["category_id"] for a in td.coco.load_anns_for_image(i)} for i in td.ids}
        assert any(set(td.imagelevel[i]) < gt[i] for i in td.ids)
    else:
        assert set(td.class_splits) == {"seen"} and td.imagelevel == {}
        assert (td.repeat_factors > 1).any()


def test_openimages_png_mask_is_read_through_encode_mask(both_catalogs):
    """An annotation with an ``iseg_file_name`` reads the PNG under
    ``dirname(root)/masks``; without the file it falls back to the
    inline segmentation (None here), as in JAX."""
    jd, td = datasets_pair(TEACHER, "openimages_zeroshot_val")
    ann = next(a for a in td.coco.anns.values() if "iseg_file_name" in a)
    seg = td._segmentation_for_ann(ann)
    assert seg == jd._segmentation_for_ann(ann) and isinstance(seg, dict) and seg["size"][0] > 0
    assert td.mask_root == str(both_catalogs / "openimages" / "masks")
    missing = dict(ann, iseg_file_name="absent.png")
    assert td._segmentation_for_ann(missing) is None is jd._segmentation_for_ann(missing)


def test_concapdet_dataset_matches_jax(both_catalogs):
    jd, td = datasets_pair(STUDENT, "conceptual_cap_train")
    assert type(td).__name__ == "ConCapDetDataset" and len(td) == len(jd) == 24
    for i in range(len(td)):
        j, t = jd[i], td[i]
        assert td.get_img_info(i) == jd.get_img_info(i)
        assert t["image"].dtype == np.uint8 and j["image"].dtype == np.float32
        np.testing.assert_array_equal(t["image"], np.round(j["image"] * 255).astype(np.uint8))
        assert_samples_equal({k: v for k, v in j.items() if k != "image"},
                             {k: v for k, v in t.items() if k != "image"})
        assert t["is_det"] == "No" and t["labels"].tolist() == [0] and t["nn_caption"] and t["ids_cap"]
        h, w = t["image"].shape[:2]
        assert t["boxes"].tolist() == [[0.0, 0.0, w - 1.0, h - 1.0]]


def test_mixture_index_order_and_metadata_match_jax(both_catalogs):
    jd, td = datasets_pair(STUDENT, "conceptual_openimages_train", is_train=True)
    assert type(td).__name__ == "ConceptualOpenImagesDetDataset"
    # 12 detection images repeated 24 // 12 = 2 times, and 24 caption images
    assert td.index == jd.index and len(td) == 48
    assert sum(k == "det" for k, _ in td.index) == 24
    for attr in ("class_names", "class_splits", "json_category_id_to_contiguous_id",
                 "contiguous_category_id_to_json_id"):
        assert getattr(td, attr) == getattr(jd, attr), attr
    np.testing.assert_array_equal(td.class_emb_mtx, jd.class_emb_mtx)
    assert td.class_emb_mtx.shape == (13, 768) and not hasattr(td, "repeat_factors")
    for i in range(len(td)):
        assert td.get_img_info(i) == jd.get_img_info(i)
    for seed in (1, 7):
        port = torch_conceptual.ConceptualOpenImagesDetDataset(td.det, td.cap, seed=seed)
        ref = jax_conceptual.ConceptualOpenImagesDetDataset(jd.det, jd.cap, seed=seed)
        assert port.index == ref.index != td.index


def test_list_datasets_match_jax(both_catalogs):
    paths = sorted(str(p) for p in (both_catalogs / "openimages" / "val").glob("*.jpg"))[:3]
    index = str(both_catalogs / "conceptual" / "index_train.json")
    root = str(both_catalogs / "conceptual" / "images")
    pairs = [(jax_list.ListDataset(paths), torch_list.ListDataset(paths)),
             (jax_list.ConceptualCaptionsDataset(index, root),
              torch_list.ConceptualCaptionsDataset(index, root))]
    for jd, td in pairs:
        assert len(td) == len(jd) > 0
        for i in range(len(td)):
            assert td.get_img_info(i) == jd.get_img_info(i)
            assert_samples_equal(jd[i], td[i])
            assert td[i]["image"].dtype == np.uint8


def test_build_dataset_builds_every_ported_factory(both_catalogs, tmp_path):
    """The catalog's OpenImages and Conceptual entries, and a
    ``PATHS_CATALOG`` of one's own for the two list datasets, which no
    shipped entry names (they take no empty-image filter)."""
    _, tc = cfgs(STUDENT, [])
    built = {n: type(torch_build.build_dataset(tc, (n,), None, False)[0]).__name__
             for n in ("openimages_zeroshot_train", "openimages_zeroshot_val", "conceptual_cap_train",
                       "conceptual_openimages_train")}
    assert built == {"openimages_zeroshot_train": "OpenImagesDataset",
                     "openimages_zeroshot_val": "OpenImagesDataset",
                     "conceptual_cap_train": "ConCapDetDataset",
                     "conceptual_openimages_train": "ConceptualOpenImagesDetDataset"}
    catalog = tmp_path / "my_catalog.py"
    paths = sorted(str(p) for p in (both_catalogs / "openimages" / "val").glob("*.jpg"))
    catalog.write_text(
        "class DatasetCatalog:\n"
        "    @staticmethod\n"
        "    def get(name):\n"
        f"        return {{'images': {{'factory': 'ListDataset', 'args': {{'image_paths': {paths!r}}}}},\n"
        f"                'captions': {{'factory': 'ConceptualCaptionsDataset', 'args': {{\n"
        f"                    'index_file': {str(both_catalogs / 'conceptual/index_train.json')!r},\n"
        f"                    'root': {str(both_catalogs / 'conceptual/images')!r}}}}}}}[name]\n")
    _, tc = cfgs(STUDENT, ["PATHS_CATALOG", str(catalog)])
    for is_train in (False, True):
        lst, cap = (torch_build.build_dataset(tc, (n,), None, is_train)[0] for n in ("images", "captions"))
        assert type(lst).__name__ == "ListDataset" and len(lst) == len(paths)
        assert type(cap).__name__ == "ConceptualCaptionsDataset" and len(cap) == 24


def _loader_batches(config, opts):
    jc, tc = cfgs(config, opts)
    jl, jd = jax_build.make_data_loader(jc, is_train=True)
    tl, td = torch_build.make_data_loader(tc, is_train=True)
    return list(jl), list(tl), jd, td


def test_teacher_loader_batches_match_jax(both_catalogs, fixed_visits):
    """openimages_zeroshot_train through the repeat-factor sampler:
    bucket-grouped batches over 3 iterations, equal key by key with the
    host normalization (exactly: detection images are uint8 in both) and
    with the device's (uint8)."""
    for normalize_on_device in (False, True):
        jb, tb, _, td = _loader_batches(TEACHER, TRAIN_OPTS + ["INPUT.DEVICE_NORMALIZE", normalize_on_device])
        assert td.repeat_factors is not None and len(tb) == len(jb) == 3
        want = np.uint8 if normalize_on_device else np.float32
        for (j, ji), (t, ti) in zip(jb, tb):
            assert list(ji) == list(ti) and sorted(j) == sorted(t)
            assert t["images"].dtype == want and t["det_mask"].all() and not t["cap_mask"].any()
            for k in j:
                assert j[k].dtype == t[k].dtype, k
                np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    # the sampler draws each image's repeats anew every epoch
    sampler = torch_samplers.DistributedSampler(len(td), repeat_factors=td.repeat_factors)
    ref = jax_samplers.DistributedSampler(len(td), repeat_factors=td.repeat_factors)
    for epoch in (0, 1, 5):
        sampler.set_epoch(epoch), ref.set_epoch(epoch)
        assert list(sampler) == list(ref) and len(list(sampler)) >= len(td)


def _mixed(batch):
    return bool(batch["det_mask"].any() and (~batch["det_mask"]).any())


def test_mixture_loader_batches_match_jax(both_catalogs, fixed_visits):
    """conceptual_openimages_train with the host normalization in both
    packages: caption rows within one grey level, everything else equal."""
    jb, tb, _, _ = _loader_batches(STUDENT, TRAIN_OPTS + ["INPUT.DEVICE_NORMALIZE", False])
    assert len(tb) == len(jb) == 3 and any(_mixed(t) for t, _ in tb)
    caption_rows = 0
    for (j, ji), (t, ti) in zip(jb, tb):
        assert list(ji) == list(ti) and sorted(j) == sorted(t)
        for k in j:
            assert j[k].dtype == t[k].dtype, k
            if k != "images":
                np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        det = t["det_mask"]
        np.testing.assert_array_equal(t["images"][det], j["images"][det])
        np.testing.assert_allclose(t["images"][~det], j["images"][~det], rtol=0, atol=CAPTION_ROW_ATOL)
        caption_rows += int((~det).sum())
        # a caption row: one dummy box over the (resized) image, labelled 0
        for i in np.nonzero(~det)[0]:
            h, w = t["image_sizes"][i]
            assert t["gt_valid"][i].sum() == 1 and t["gt_labels"][i, 0] == 0 and t["cap_mask"][i]
            np.testing.assert_allclose(t["gt_boxes"][i, 0], [0, 0, w - 1, h - 1], atol=1.0)
    assert caption_rows > 0


def test_jax_mixed_batch_leaves_detection_rows_raw(both_catalogs, fixed_visits):
    """The JAX fault (ROADMAP.md section C): with DEVICE_NORMALIZE True a
    batch that holds a caption image is float32, its caption rows are
    normalized on the host, its detection rows are the raw RGB pixels, and
    the device normalization returns the batch unchanged."""
    jb, tb, _, _ = _loader_batches(STUDENT, TRAIN_OPTS)
    jax_mixed = [j for j, _ in jb if _mixed(j)]
    assert jax_mixed
    for j in jax_mixed:
        assert j["images"].dtype == np.float32
        det = j["det_mask"]
        port = next(t for t, _ in tb if np.array_equal(t["image_ids"], j["image_ids"]))
        # the detection rows: raw RGB, as the port's uint8 rows hold them
        np.testing.assert_array_equal(j["images"][det], port["images"][det].astype(np.float32))
        assert j["images"][det].min() >= 0 and j["images"][~det].min() < 0
        out = np.asarray(jax_device_normalize(j["images"], j["image_sizes"]))
        np.testing.assert_array_equal(out, j["images"])


def test_port_mixed_batch_is_uint8_and_normalizes_on_the_device_as_on_the_host(both_catalogs, fixed_visits):
    _, on_device, _, _ = _loader_batches(STUDENT, TRAIN_OPTS)
    _, on_host, _, _ = _loader_batches(STUDENT, TRAIN_OPTS + ["INPUT.DEVICE_NORMALIZE", False])
    assert any(_mixed(t) for t, _ in on_device)
    cfg = torch_cfg()
    for (d, di), (h, hi) in zip(on_device, on_host):
        assert list(di) == list(hi) and d["images"].dtype == np.uint8
        got = device_normalize(torch.from_numpy(d["images"]), torch.from_numpy(d["image_sizes"]),
                               cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD, cfg.INPUT.TO_BGR255)
        np.testing.assert_array_equal(got.numpy(), h["images"])


@pytest.mark.parametrize("sizes_in_index", [True, False])
def test_mixture_sampler_groups_match_jax(tmp_path, monkeypatch, sizes_in_index):
    """Aspect-ratio and bucket groups of the mixture; an index without
    sizes gives height and width 0, which both packages group alike."""
    tree = write_tiny_tree(tmp_path, cap_sizes_in_index=sizes_in_index)
    monkeypatch.setenv("CMPL_TPU_DATA_DIR", str(tree))
    monkeypatch.setattr(jax_catalog, "DATA_DIR", str(tree))
    jd, td = datasets_pair(STUDENT, "conceptual_openimages_train", is_train=True)
    assert (td.cap.get_img_info(0)["height"] > 0) == sizes_in_index
    assert torch_samplers.compute_aspect_ratio_groups(td) == jax_samplers.compute_aspect_ratio_groups(jd)
    buckets = ((96, 96), (72, 96), (96, 72))
    got = torch_samplers.compute_bucket_groups(td, buckets, 72, 96)
    assert got == jax_samplers.compute_bucket_groups(jd, buckets, 72, 96) and len(set(got)) >= 2


def synthetic_results(dataset, seed):
    """Boxes near the ground truth with some wrong classes, and false
    positives of every class, with tied scores; each with a mask filling
    its box."""
    from cvpr22_cross_modal_pseudo_labeling_tpu.utils.rle import encode_mask

    rng = np.random.default_rng(seed)
    cats = dataset.coco.get_cat_ids()
    out = []

    def result(img_id, cat, box, score):
        info = dataset.coco.imgs[img_id]
        mask = np.zeros((info["height"], info["width"]), np.uint8)
        x, y, w, h = (int(round(v)) for v in box)
        mask[max(y, 0):y + max(h, 1), max(x, 0):x + max(w, 1)] = 1
        return {"image_id": img_id, "category_id": int(cat), "bbox": list(box), "score": score,
                "segmentation": encode_mask(mask)}

    for ann in dataset.coco.anns.values():
        x, y, w, h = ann["bbox"]
        cat = ann["category_id"] if rng.uniform() < 0.8 else int(rng.choice(cats))
        out.append(result(ann["image_id"], cat, [x + rng.normal(0, 2), y + rng.normal(0, 2),
                                                  w * rng.uniform(0.8, 1.2), h * rng.uniform(0.8, 1.2)],
                          float(np.round(rng.uniform(), 1))))
    for img_id, info in dataset.coco.imgs.items():
        for cat in cats:
            x, y = rng.uniform(0, info["width"] - 20), rng.uniform(0, info["height"] - 20)
            out.append(result(img_id, cat, [x, y, 16.0, 16.0], float(rng.uniform(0, 0.5))))
    return out


def test_evaluate_with_the_imagelevel_filter_matches_jax(both_catalogs):
    jd, td = datasets_pair(STUDENT, "openimages_zeroshot_val")
    results = synthetic_results(jd, seed=3)
    kept = torch_evaluation.filter_predictions_imagelevel(results, td.imagelevel)
    assert kept == jax_evaluation.filter_predictions_imagelevel(results, jd.imagelevel)
    assert 0 < len(kept) < len(results)
    ref = jax_evaluation.evaluate(jd, json.loads(json.dumps(results)), iou_types=("bbox", "segm"))
    got = torch_evaluation.evaluate(td, json.loads(json.dumps(results)), iou_types=("bbox", "segm"))
    assert sorted(got) == sorted(ref)
    assert {"bbox/AP50_split_seen", "bbox/AP50_split_unseen", "segm/AP50_split_seen"} <= set(got)
    assert ref["bbox/AP"] > 0.05 and ref["segm/AP"] > 0.01
    for k, v in ref.items():
        assert (np.isnan(v) and np.isnan(got[k])) or got[k] == v, k


def test_every_dataset_of_the_jax_package_is_registered(tmp_path, monkeypatch):
    """The VOC factory, refused until the port had the class-specific
    heads, builds through ``build_dataset`` and the catalog; the
    registry exports every dataset class of the JAX package."""
    from cvpr22_cross_modal_pseudo_labeling_torch.tools import synth_voc

    synth_voc.write_tree(str(tmp_path), train=2, test=2, sizes=((100, 75),))
    monkeypatch.setenv("CMPL_TPU_DATA_DIR", str(tmp_path))
    _, tc = cfgs(STUDENT, [])
    (ds,) = torch_build.build_dataset(tc, ("voc_2007_test",), None, False)
    assert type(ds).__name__ == "PascalVOCDataset" and len(ds) == 2 and ds.eval_protocol == "voc"
    port = importlib.import_module("cvpr22_cross_modal_pseudo_labeling_torch.data.datasets").__all__
    ref = importlib.import_module("cvpr22_cross_modal_pseudo_labeling_tpu.data.datasets").__all__
    assert sorted(port) == sorted(ref)
