"""The traffic generator: a seed fixes the pool, seeds differ only in
order and contents, never in the work."""

import json
from collections import Counter

import numpy as np
import pytest

from cvpr22_cross_modal_pseudo_labeling_torch.config import get_default_cfg
from cvpr22_cross_modal_pseudo_labeling_torch.data.collate import select_bucket
from harness import traffic
from tiny import HERE

BUCKETS = [tuple(b) for b in get_default_cfg().TPU.IMAGE_BUCKETS]
CONFIG = json.loads((HERE / "configs" / "st_r50c4_coco.json").read_text())
SMALL = [[640, 480, 3], [612, 612, 1], [480, 640, 2]]


@pytest.mark.parametrize("mix_name", ["coco_train_b8", "coco_serve_b8"])
def test_same_seed_same_pool_other_seed_other_contents(mix_name):
    mix = dict(json.loads((HERE / "traffic" / f"{mix_name}.json").read_text()), image_sizes=SMALL, batch=2)
    a, ta = traffic.make_pool(3_000_000_007, mix, CONFIG)
    b, tb = traffic.make_pool(3_000_000_007, mix, CONFIG)
    c, tc = traffic.make_pool(3_000_000_008, mix, CONFIG)
    for x, y in zip(a, b):
        assert x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
    assert np.array_equal(ta["class_embeddings"], tb["class_embeddings"])
    assert not np.array_equal(ta["class_embeddings"], tc["class_embeddings"])
    assert any(not np.array_equal(x["images"], y["images"]) for x, y in zip(a, c))
    # the same work: the buckets, in another order at most
    shapes = lambda pool: Counter(x["images"].shape for x in pool)
    assert shapes(a) == shapes(c) == Counter({(2, 800, 1088, 3): 2, (2, 1088, 800, 3): 1})


def test_pool_fits_its_buckets_and_the_collate_keys():
    mix = json.loads((HERE / "traffic" / "coco_train_b8.json").read_text())
    pool, tables = traffic.make_pool(5, dict(mix, batch=2), CONFIG)
    assert len(pool) * 2 == sum(n for _, _, n in mix["image_sizes"])
    for batch in pool:
        h, w = batch["images"].shape[1:3]
        assert (batch["image_sizes"][:, 0] <= h).all() and (batch["image_sizes"][:, 1] <= w).all()
        # the bucket the program's collate would pick for these images
        assert select_bucket(*batch["image_sizes"].max(0), BUCKETS) == (h, w)
        assert 1 <= batch["gt_valid"].sum(1).min() and batch["gt_valid"].sum(1).max() <= mix["max_gt"]
        boxes = batch["gt_boxes"][batch["gt_valid"]]
        assert (boxes[:, 2] > boxes[:, 0]).all() and (boxes[:, 3] > boxes[:, 1]).all()
        assert batch["cap_word_valid"].sum(1).min() >= 1
        assert set(batch) >= {"images", "image_sizes", "gt_boxes", "gt_labels", "gt_valid", "gt_masks",
                              "cap_mask", "det_mask", "cap_tok_ids", "cap_tok_mask", "cap_word_valid", "cap_labels"}
    assert tables["class_embeddings"].shape == (66, 768) and not tables["class_embeddings"][0].any()
    assert tables["lvis_class_embeddings"].shape == (1203, 768)


@pytest.mark.parametrize("wh,hw", [((640, 480), (800, 1066)), ((640, 427), (800, 1199)), ((427, 640), (1199, 800)),
                                   ((612, 612), (800, 800)), ((640, 360), (750, 1333))])
def test_resize_follows_the_configs_rule(wh, hw):
    # INPUT.MIN_SIZE_TRAIN 800, MAX_SIZE_TRAIN 1333, worked by hand
    assert traffic.resized(*wh, 800, 1333) == hw


def test_each_size_falls_in_the_smallest_bucket_that_holds_it():
    mix = json.loads((HERE / "traffic" / "coco_serve_b8.json").read_text())
    by_bucket = traffic.pool_images(mix)
    assert {k: len(v) for k, v in by_bucket.items()} == {(800, 1088): 88, (800, 1216): 32, (1088, 800): 24,
                                                          (1216, 800): 16}
    for bucket, sizes in by_bucket.items():
        assert all(select_bucket(h, w, BUCKETS) == bucket for h, w in sizes)
