"""The port's data pipeline against the JAX package's.

A tiny synthetic COCO zero-shot tree (``tools/synth_coco.py``: 8 train
and 8 val JPEGs at COCO's sizes, 3 seen and 2 unseen classes with 768-d
embeddings, polygon instances, LVIS nouns in the captions) is read by
both packages' loaders.  Batches are compared key by key and must be
equal: images, boxes, masks, caption tokens and ``image_ids`` exactly.
The training loader draws its flips, scales and color jitter from
``visit_rng``, which seeds from the process and a visit counter; both
packages' datasets get the same per-index generator instead.

The host helpers under the loader (image decode, resize, instance-mask
rasterization, mask paste and RLE encode) equal JAX's exactly, through
the native library and through its PIL fallback.
"""

import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from cvpr22_cross_modal_pseudo_labeling_tpu.config import get_default_cfg as jax_cfg
from cvpr22_cross_modal_pseudo_labeling_tpu.data import build as jax_build
from cvpr22_cross_modal_pseudo_labeling_tpu.data import collate as jax_collate
from cvpr22_cross_modal_pseudo_labeling_tpu.data import parser as jax_parser
from cvpr22_cross_modal_pseudo_labeling_tpu.data import paths_catalog as jax_catalog
from cvpr22_cross_modal_pseudo_labeling_tpu.data import transforms as jax_transforms
from cvpr22_cross_modal_pseudo_labeling_tpu.data.datasets import coco as jax_coco
from cvpr22_cross_modal_pseudo_labeling_tpu.ops import masks as jax_masks
from cvpr22_cross_modal_pseudo_labeling_tpu.utils import rle as jax_rle
from cvpr22_cross_modal_pseudo_labeling_torch.config import get_default_cfg as torch_cfg
from cvpr22_cross_modal_pseudo_labeling_torch.data import build as torch_build
from cvpr22_cross_modal_pseudo_labeling_torch.data import collate as torch_collate
from cvpr22_cross_modal_pseudo_labeling_torch.data import parser as torch_parser
from cvpr22_cross_modal_pseudo_labeling_torch.data import transforms as torch_transforms
from cvpr22_cross_modal_pseudo_labeling_torch.data.datasets import coco as torch_coco
from cvpr22_cross_modal_pseudo_labeling_torch.utils import native_image, native_loader
from cvpr22_cross_modal_pseudo_labeling_torch.utils import rle as torch_rle
from tests.native_libs import ensure_native_libs

REPO = Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "configs/coco_cap_det/student_teacher_mask_rcnn_uncertainty.yaml")
EVAL_OPTS = [
    "INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 96, "TPU.IMAGE_BUCKETS", ((96, 96),),
    "DATASETS.TEST", ("coco_generalized_zeroshot_val",), "TEST.IMS_PER_BATCH", 3,
    "DATALOADER.NUM_WORKERS", 2,
]
TRAIN_OPTS = [
    "INPUT.MIN_SIZE_TRAIN", (64, 72), "INPUT.MAX_SIZE_TRAIN", 96,
    "TPU.IMAGE_BUCKETS", ((96, 96), (72, 96), (96, 72)), "TPU.MAX_GT", 6,
    "INPUT.BRIGHTNESS", 0.2, "INPUT.CONTRAST", 0.2, "INPUT.SATURATION", 0.2,
    "SOLVER.IMS_PER_BATCH", 2, "SOLVER.MAX_ITER", 3, "DATALOADER.NUM_WORKERS", 2,
]


def make_tree(out: Path) -> Path:
    subprocess.run(
        [sys.executable, str(REPO / "tools/synth_coco.py"), "--out", str(out), "--train", "8",
         "--val", "8", "--seen", "3", "--unseen", "2"],
        check=True, capture_output=True, timeout=300,
    )
    return out


@pytest.fixture(scope="module", autouse=True)
def native_libs():
    """Both packages' native image and mask libraries, loaded before
    the first comparison (``tests/native_libs.py``)."""
    ensure_native_libs()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("synth_coco"))


@pytest.fixture
def both_catalogs(tree, monkeypatch):
    monkeypatch.setenv("CMPL_TPU_DATA_DIR", str(tree))
    monkeypatch.setattr(jax_catalog, "DATA_DIR", str(tree))


def cfgs(opts):
    out = []
    for get in (jax_cfg, torch_cfg):
        cfg = get()
        cfg.merge_from_file(CONFIG)
        cfg.merge_from_list(list(opts))
        cfg.freeze()
        out.append(cfg)
    return out


def assert_batches_equal(jax_batches, torch_batches):
    assert len(jax_batches) == len(torch_batches) > 0
    for (jb, ji), (tb, ti) in zip(jax_batches, torch_batches):
        assert list(ji) == list(ti)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype, k
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def test_eval_loader_batches_equal_jax(both_catalogs):
    jc, tc = cfgs(EVAL_OPTS)
    (jl,), (jd,) = jax_build.make_data_loader(jc, is_train=False)
    (tl,), (td,) = torch_build.make_data_loader(tc, is_train=False)
    jb, tb = list(jl), list(tl)
    assert [len(i) for _, i in tb] == [3, 3, 2]  # a ragged final batch
    assert tb[0][0]["images"].shape == (3, 96, 96, 3) and tb[0][0]["images"].dtype == np.uint8
    assert_batches_equal(jb, tb)
    np.testing.assert_array_equal(td.class_emb_mtx, jd.class_emb_mtx)
    assert td.class_splits == jd.class_splits and td.class_names == jd.class_names


def test_train_loader_batches_equal_jax(both_catalogs, monkeypatch):
    """COCOCapDetDataset with captions, flips, multi-scale and jitter,
    bucket-grouped batches over 3 iterations."""
    for mod in (jax_coco, torch_coco):
        monkeypatch.setattr(mod, "visit_rng", lambda index: random.Random(1000 + index))
    jc, tc = cfgs(TRAIN_OPTS)
    jl, jd = jax_build.make_data_loader(jc, is_train=True)
    tl, td = torch_build.make_data_loader(tc, is_train=True)
    jb, tb = list(jl), list(tl)
    assert len(tb) == 3 and type(td).__name__ == "COCOCapDetDataset"
    assert all(b["cap_mask"].all() and b["cap_word_valid"].any() for b, _ in tb)
    assert_batches_equal(jb, tb)


@pytest.mark.parametrize("name,factory", [
    ("voc_2007_train", "PascalVOCDataset"),
])
def test_class_specific_datasets_build_as_in_jax(tmp_path, monkeypatch, name, factory):
    """A catalog entry of a dataset without class embeddings (refused
    until the port had the class-specific heads): both packages build
    it, and their first eval batches hold the same gt."""
    from cvpr22_cross_modal_pseudo_labeling_torch.tools import synth_voc

    synth_voc.write_tree(str(tmp_path), train=3, test=3, sizes=((100, 75), (75, 100)))
    monkeypatch.setenv("CMPL_TPU_DATA_DIR", str(tmp_path))
    monkeypatch.setattr(jax_catalog, "DATA_DIR", str(tmp_path))
    jc, tc = cfgs(EVAL_OPTS + ["DATASETS.TEST", (name,)])
    ((jl,), (jd,)), ((tl,), (td,)) = (jax_build.make_data_loader(jc, is_train=False),
                                      torch_build.make_data_loader(tc, is_train=False))
    assert type(td).__name__ == type(jd).__name__ == factory and getattr(td, "class_emb_mtx", None) is None
    (jb, ji), (tb, ti) = next(iter(jl)), next(iter(tl))
    assert list(ji) == list(ti) and tb["images"].dtype == np.uint8
    for k in ("gt_boxes", "gt_labels", "gt_valid", "image_sizes"):
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    assert tb["gt_valid"].any()


def test_grain_loader_raises(both_catalogs, monkeypatch):
    """``DATALOADER.USE_GRAIN`` raised before the grain stream was ported;
    now it builds the grain loader (``data/grain_loader.py``, without
    grain), for test and for training, and both give JAX's grain
    loader's batches on the tree."""
    for mod in (jax_coco, torch_coco):
        monkeypatch.setattr(mod, "visit_rng", lambda index: random.Random(1000 + index))
    from cvpr22_cross_modal_pseudo_labeling_torch.data.grain_loader import GrainLoader

    jc, tc = cfgs(EVAL_OPTS + ["DATALOADER.USE_GRAIN", True])
    (jl,), _ = jax_build.make_data_loader(jc, is_train=False)
    (tl,), _ = torch_build.make_data_loader(tc, is_train=False)
    assert isinstance(tl, GrainLoader) and len(tl) == len(jl) == 3
    assert_batches_equal(list(jl), list(tl))
    jc, tc = cfgs(TRAIN_OPTS + ["DATALOADER.USE_GRAIN", True, "DATALOADER.ASPECT_RATIO_GROUPING", False])
    jl, _ = jax_build.make_data_loader(jc, is_train=True)
    tl, _ = torch_build.make_data_loader(tc, is_train=True)
    assert isinstance(tl, GrainLoader)
    assert_batches_equal(list(jl), list(tl))
    assert tl.get_state() == jl.get_state() == {"next_index": 3}


@pytest.mark.parametrize("hw", [(480, 640), (640, 427), (612, 612), (1100, 900), (30, 2000)])
def test_select_bucket_matches_jax(hw):
    buckets = torch_cfg().TPU.IMAGE_BUCKETS
    for min_size in (600, 800):
        nh, nw = torch_transforms.get_resize_hw(hw, min_size, 1333)
        assert (nh, nw) == jax_transforms.get_resize_hw(hw, min_size, 1333)
        assert torch_collate.select_bucket(nh, nw, buckets, 64) == jax_collate.select_bucket(
            nh, nw, buckets, 64)


@pytest.mark.parametrize("caption", [
    "a man skiing down a snowy hill", "two cats sleeping on a sofa next to a laptop",
    "salad dressing in glass bottles", "A bus and some people near the station.",
])
def test_parser_matches_jax(caption):
    assert torch_parser.get_parser().parse(caption) == jax_parser.get_parser().parse(caption)


def test_native_libraries_build_into_build_native():
    """The port reads ``native/*.cpp`` and writes its libraries to
    ``build/native/``, never next to the sources, where the JAX package
    keeps its own."""
    assert Path(native_loader.BUILD_DIR) == REPO / "build" / "native"
    assert Path(native_loader.SOURCE_DIR) == REPO / "native"
    from cvpr22_cross_modal_pseudo_labeling_torch.utils import native

    for lib in (native._loader, native_image._loader):
        assert Path(lib.lib_path).parent == REPO / "build" / "native"
        assert Path(lib.src).parent == REPO / "native"
    if native.get_lib() is not None:
        assert Path(native._loader.lib_path).exists()


def test_native_library_first_use_from_threads_waits_for_the_build(tmp_path):
    """The loader's threads call ``get()`` at once on first use: every
    one gets the library, none falls back while g++ runs."""
    import concurrent.futures as cf

    from cvpr22_cross_modal_pseudo_labeling_torch.utils import native

    lib = native_loader.NativeLib("maskops.cpp", "libmaskops.so", register=native._register)
    lib.lib_path = str(tmp_path / "libmaskops.so")
    if native.get_lib() is None:
        pytest.skip("no g++ on this machine: the native library cannot build")
    with cf.ThreadPoolExecutor(8) as pool:
        got = list(pool.map(lambda _: lib.get(), range(8)))
    assert all(g is not None for g in got) and len({id(g) for g in got}) == 1


@pytest.mark.parametrize("src_hw,out_hw", [
    ((480, 640), (800, 1066)), ((427, 640), (64, 96)), ((37, 53), (37, 90)),
    ((90, 41), (23, 41)), ((64, 64), (64, 64)),
])
def test_resize_image_matches_jax(src_hw, out_hw):
    rng = np.random.default_rng(sum(src_hw))
    img = rng.integers(0, 256, (*src_hw, 3), dtype=np.uint8)
    out = torch_transforms.resize_image(img, *out_hw)
    assert out.dtype == np.uint8 and out.shape == (*out_hw, 3)
    np.testing.assert_array_equal(out, jax_transforms.resize_image(img, *out_hw))


@pytest.mark.parametrize("path", ["native", "pil", "png"])
def test_load_image_rgb_matches_jax(tree, tmp_path, monkeypatch, path):
    """A JPEG of the tree through the native decoder (or PIL where it
    does not build) and through PIL alone, and a PNG, which always takes
    PIL."""
    from PIL import Image

    from cvpr22_cross_modal_pseudo_labeling_tpu.utils import native_image as jax_native_image

    jpeg = str(sorted((tree / "coco" / "val2017").glob("*.jpg"))[0])
    if path == "png":
        jpeg = str(tmp_path / "im.png")
        Image.fromarray(np.random.default_rng(0).integers(0, 256, (37, 53, 3), np.uint8)).save(jpeg)
    if path == "pil":
        for mod in (native_image, jax_native_image):
            monkeypatch.setattr(mod._loader, "_lib", None)
            monkeypatch.setattr(mod._loader, "_tried", True)
    out = native_image.load_image_rgb(jpeg)
    assert out.dtype == np.uint8 and out.ndim == 3 and out.shape[2] == 3
    np.testing.assert_array_equal(out, jax_native_image.load_image_rgb(jpeg))


@pytest.mark.parametrize("kind", ["rle", "polygon"])
def test_rasterize_instance_mask_matches_jax(kind):
    h, w = 60, 80
    box = np.array([15.0, 12.0, 65.0, 48.0], np.float32)
    if kind == "rle":
        yy, xx = np.mgrid[:h, :w]
        mask = (((xx - 40) / 25.0) ** 2 + ((yy - 30) / 18.0) ** 2 <= 1).astype(np.uint8)
        seg = {"counts": torch_rle.mask_to_counts(mask).tolist(), "size": [h, w]}
    else:
        seg = [[15.0, 12.0, 65.0, 12.0, 40.0, 48.0]]
    out = torch_coco.rasterize_instance_mask(seg, box, (h, w))
    assert out.shape == (28, 28) and 0 < out.sum() < out.size
    np.testing.assert_array_equal(out, jax_coco.rasterize_instance_mask(seg, box, (h, w)))


@pytest.mark.parametrize("use_cv2", [True, False])
def test_paste_and_encode_match_jax(use_cv2, monkeypatch):
    if not use_cv2:  # both sides take their numpy branch
        monkeypatch.setitem(sys.modules, "cv2", None)
    rng = np.random.default_rng(7)
    for _ in range(20):
        probs = rng.uniform(0, 1, (14, 14)).astype(np.float32)
        x1, y1 = rng.uniform(-20, 300, 2)
        box = np.array([x1, y1, x1 + rng.uniform(1, 200), y1 + rng.uniform(1, 150)], np.float32)
        ref = jax_masks.paste_mask_box_local(probs, box, (240, 320))
        out = torch_rle.paste_mask_box_local(probs, box, (240, 320))
        if ref is None:
            assert out is None
            continue
        np.testing.assert_array_equal(out[0], ref[0])
        assert out[1:] == ref[1:]
        assert torch_rle.encode_pasted_mask(probs, box, (240, 320)) == jax_rle.encode_pasted_mask(
            probs, box, (240, 320))
