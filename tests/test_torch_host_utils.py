"""The port's host utilities against the JAX package's, on the CPU.

- ``utils/visualization.py``: every drawing pixel-equal to JAX's
  (``denormalize_image``, ``overlay_detections`` with masks, labels and
  scores, ``uncertainty_heatmap``, ``save_visualization``);
- ``tools/visualize.py``: the panels of a two-image predictions JSON on
  the tiny COCO tree equal JAX's ``tools/visualize.py``'s, pixel for
  pixel;
- ``core/image_list.py``: the padded batch equal to JAX's, the same
  oversize refusal;
- ``utils/registry.py`` and ``utils/logged_module.py``: registration,
  statistics within float32 rounding (1e-6 of the value) and the same
  printed line, the non-finite guard naming the leaf;
- ``utils/profiler.py``: a Chrome trace, ``profile_steps``, the memory
  stats (empty without a card), the peak table keyed by the card's name
  (raising for another card), ``mfu_metrics``; ``step_flops`` equals
  XLA's ``compiled_step_flops`` on one matmul and one unpadded
  convolution (exactly: both count two FLOPs a multiply-add; on a padded
  convolution XLA leaves out the taps that read the padding, the
  counter does not).
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cvpr22_cross_modal_pseudo_labeling_tpu.core import image_list as jax_image_list
from cvpr22_cross_modal_pseudo_labeling_tpu.data import paths_catalog as jax_catalog
from cvpr22_cross_modal_pseudo_labeling_tpu.utils import logged_module as jax_logged
from cvpr22_cross_modal_pseudo_labeling_tpu.utils import profiler as jax_profiler
from cvpr22_cross_modal_pseudo_labeling_tpu.utils import visualization as jax_viz
from cvpr22_cross_modal_pseudo_labeling_torch.core import image_list
from cvpr22_cross_modal_pseudo_labeling_torch.tools import visualize
from cvpr22_cross_modal_pseudo_labeling_torch.utils import logged_module, profiler, registry
from cvpr22_cross_modal_pseudo_labeling_torch.utils import visualization as viz
from cvpr22_cross_modal_pseudo_labeling_torch.utils.rle import encode_mask
from tests.test_torch_train_net import STUDENT, TINY, tree  # noqa: F401  (tree: a fixture)

REPO = Path(__file__).resolve().parents[1]


def scene(seed=0, h=48, w=64, n=5):
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    xy = rng.uniform(0, [w - 10, h - 10], (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 20, (n, 2))], 1).astype(np.float32)
    masks = rng.random((n, h, w)) < 0.3
    scores = rng.uniform(0.2, 1.0, n).astype(np.float32)
    return image, boxes, masks, scores, rng


def test_visualization_is_jaxs_pixel_for_pixel(tmp_path):
    image, boxes, masks, scores, rng = scene()
    names = ["cat", "dog", "bird"]
    labels = np.array([0, 1, 2, 7, 1])
    for kw in (dict(), dict(scores=scores, labels=labels, class_names=names, masks=masks, score_thresh=0.4),
               dict(labels=labels, masks=masks, mask_alpha=0.7)):
        np.testing.assert_array_equal(viz.overlay_detections(image, boxes, **kw),
                                      jax_viz.overlay_detections(image, boxes, **kw))
    umaps = rng.random((5, 14, 14)).astype(np.float32)
    np.testing.assert_array_equal(viz.uncertainty_heatmap(image, boxes, umaps),
                                  jax_viz.uncertainty_heatmap(image, boxes, umaps, alpha=0.6))
    normalized = rng.normal(0, 50, image.shape).astype(np.float32)
    for bgr in (True, False):
        np.testing.assert_array_equal(viz.denormalize_image(normalized, to_bgr255=bgr),
                                      jax_viz.denormalize_image(normalized, to_bgr255=bgr))
    assert viz.denormalize_image(image) is image
    viz.save_visualization(str(tmp_path / "a/b.png"), image)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a/b.png")), image)


def predictions(dataset, img_ids, seed=0):
    """COCO-format detections with RLE masks on the first images."""
    rng = np.random.default_rng(seed)
    cats = sorted(dataset.coco.cats)
    out = []
    for img_id in img_ids:
        info = dataset.coco.imgs[img_id]
        h, w = info["height"], info["width"]
        for k in range(4):
            x, y = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            bw, bh = rng.uniform(10, w / 2), rng.uniform(10, h / 2)
            m = np.zeros((h, w), np.uint8)
            m[int(y):int(y + bh), int(x):int(x + bw)] = 1
            out.append({"image_id": img_id, "category_id": cats[k % len(cats)], "score": float(rng.uniform(0.3, 1)),
                        "bbox": [x, y, bw, bh], "segmentation": encode_mask(m)})
    return out


def test_visualize_tool_renders_jaxs_panels(tree, tmp_path, monkeypatch):
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import visualize as jax_tool
    finally:
        sys.path.remove(str(REPO / "tools"))
    from cvpr22_cross_modal_pseudo_labeling_torch.config import get_default_cfg
    from cvpr22_cross_modal_pseudo_labeling_torch.data.build import build_dataset

    monkeypatch.setenv("CMPL_TPU_DATA_DIR", str(tree))
    monkeypatch.setattr(jax_catalog, "DATA_DIR", str(tree))
    opts = [*map(str, TINY)]
    cfg = get_default_cfg()
    cfg.merge_from_file(STUDENT)
    cfg.merge_from_list(opts)
    dataset = build_dataset(cfg, cfg.DATASETS.TEST[:1], None, False)[0]
    ids = dataset.coco.get_img_ids()[:2]
    preds = tmp_path / "predictions_coco_generalized_zeroshot_val.json"
    preds.write_text(json.dumps(predictions(dataset, ids)))
    common = ["--config-file", STUDENT, "--predictions", str(preds), "--limit", "2", "--score-thresh", "0.4"]
    paths = visualize.main(common + ["--out", str(tmp_path / "port"), *opts])
    assert [Path(p).name for p in paths] == [f"{i:012d}.png" for i in ids]
    monkeypatch.setattr(sys, "argv", ["visualize.py", *common, "--out", str(tmp_path / "jax"), *opts])
    jax_tool.main()
    for p in paths:
        got = np.asarray(Image.open(p))
        ref = np.asarray(Image.open(tmp_path / "jax" / Path(p).name))
        info = dataset.coco.imgs[int(Path(p).stem)]
        assert got.shape == (info["height"], 2 * info["width"], 3)
        np.testing.assert_array_equal(got, ref)


def test_image_batch_is_jaxs():
    rng = np.random.default_rng(1)
    images = [rng.random((h, w, 3)).astype(np.float32) for h, w in ((30, 41), (50, 20))]
    for kw in (dict(), dict(size_divisible=32), dict(bucket_hw=(64, 96)), dict(bucket_hw=(64, 96), size_divisible=32)):
        got, ref = image_list.to_image_batch(images, **kw), jax_image_list.to_image_batch(images, **kw)
        np.testing.assert_array_equal(got.tensors.numpy(), np.asarray(ref.tensors))
        np.testing.assert_array_equal(got.image_sizes.numpy(), np.asarray(ref.image_sizes))
        assert got.batch == ref.batch and got.padded_hw == ref.padded_hw
    for mod in (image_list, jax_image_list):
        with pytest.raises(ValueError, match=r"exceeds the forced bucket \(40, 96\)"):
            mod.to_image_batch(images, bucket_hw=(40, 96))


def test_registry():
    r = registry.Registry()
    assert r.register("a", 1) == 1

    @r.register("b")
    def b():
        return 2

    assert r["a"] == 1 and r["b"] is b
    with pytest.raises(KeyError, match="already registered"):
        r.register("a", 3)
    for name in ("BACKBONES", "RPN_HEADS", "ROI_BOX_FEATURE_EXTRACTORS", "ROI_BOX_PREDICTOR",
                 "ROI_MASK_FEATURE_EXTRACTORS", "ROI_MASK_PREDICTOR", "ROI_KEYPOINT_FEATURE_EXTRACTORS",
                 "ROI_KEYPOINT_PREDICTOR", "MMSS_HEADS", "LANGUAGE_BACKBONES"):
        assert isinstance(getattr(registry, name), registry.Registry)


def test_logged_module_is_jaxs(capsys):
    x = np.random.default_rng(2).normal(3.0, 2.0, (7, 11)).astype(np.float32)
    x[0, 0] = np.inf
    got = logged_module.tensor_stats(torch.from_numpy(x))
    ref = jax_logged.tensor_stats(jnp.asarray(x))
    for k in ("min", "max", "mean", "std", "nans"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-6, err_msg=k)
    y = x[1:]
    logged_module.log_stats("y", torch.from_numpy(y))
    jax_logged.log_stats("y", jnp.asarray(y))
    jax.effects_barrier()
    port_line, jax_line = capsys.readouterr().out.splitlines()
    assert port_line == jax_line
    logged_module.log_stats("off", torch.from_numpy(y), enabled=False)
    assert capsys.readouterr().out == ""
    tree = {"a": [torch.ones(2), {"b": torch.tensor([1.0, float("nan")])}], "c": np.zeros(3)}
    with pytest.raises(ValueError, match=r"loss: \['a'\]\[1\]\['b'\]"):
        logged_module.check_finite(tree, "loss")
    logged_module.check_finite({"a": [torch.ones(2)], "c": np.zeros(3)})


def test_profiler_on_the_cpu(tmp_path, monkeypatch):
    with profiler.trace(str(tmp_path / "t")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert json.loads((tmp_path / "t/trace.json").read_text())["traceEvents"]
    calls = []
    metrics, logdir, prof = profiler.profile_steps(lambda b: calls.append(b) or {"n": len(calls)}, "batch",
                                                   n_steps=2, logdir=str(tmp_path / "p"))
    assert metrics == {"n": 3} and calls == ["batch"] * 3 and (Path(logdir) / "trace.json").exists()
    assert profiler.device_memory_stats() == {}
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert profiler.device_peak_flops() == 989e12
    assert profiler.mfu_metrics(989e12, 2.0) == {"tflops_per_sec": 494.5, "mfu_pct": 50.0}
    assert profiler.mfu_metrics(67e12, 1.0, dtype="float32")["mfu_pct"] == 100.0
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(KeyError, match="no published peak"):
        profiler.device_peak_flops()


def test_step_flops_is_xlas_count():
    rng = np.random.default_rng(3)
    a, b = rng.random((64, 96), np.float32), rng.random((96, 40), np.float32)
    ref = jax_profiler.compiled_step_flops(jax.jit(lambda x, y: x @ y), a, b)
    assert profiler.step_flops(torch.matmul, torch.from_numpy(a), torch.from_numpy(b)) == ref == 2 * 64 * 96 * 40
    x, k = rng.random((2, 20, 24, 8), np.float32), rng.random((3, 3, 8, 16), np.float32)  # NHWC, HWIO

    def jax_conv(x, k):
        return jax.lax.conv_general_dilated(x, k, (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"))

    ref = jax_profiler.compiled_step_flops(jax.jit(jax_conv), x, k)
    got = profiler.step_flops(torch.nn.functional.conv2d, torch.from_numpy(x).permute(0, 3, 1, 2),
                              torch.from_numpy(k).permute(3, 2, 0, 1))
    assert got == ref == 2 * 2 * 18 * 22 * 16 * 9 * 8
