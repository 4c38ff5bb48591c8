"""The frozen work counts: analytic FLOPs against PyTorch's counter on a
narrow model, kernel bytes and operations against hand-worked shapes."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import tiny
from harness import traffic, train, weights
from work import flops, kernels


@pytest.mark.parametrize("config", ["teacher_r50c4_coco", "st_r50c4_coco"])
def test_step_flops_match_the_counter_on_a_narrow_step(config):
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer
    from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.generalized_rcnn import TrainDraws

    ctx = tiny.context(config, "coco_train_b8")
    cfg = ctx.config
    trainer = Trainer(str(tiny.HERE.parent / cfg["yaml"]), cfg["opts"], device="cpu", seed=1)
    trainer.model.load_state_dict(weights.draw_state(trainer.model.state_dict(), 1, "cpu"))
    batches, tables = traffic.make_pool(1, ctx.mix, cfg)
    trainer.set_class_tables(**tables)
    batch = batches[0]
    hw = batch["images"].shape[1:3]
    draws = train.make_draws(cfg, hw, ctx.mix["batch"], 1, 0, "cpu")
    with FlopCounterMode(display=False) as counter:
        trainer.step(batch, TrainDraws(**draws))
    counted = counter.get_flop_counts()["Global"]
    by_op = {str(op).split(".")[1]: n for op, n in counted.items()}
    # on the CPU RoIAlign is a batched matmul (a kernel on the card), and so
    # is the region-noun similarity, which the count holds
    m = cfg["model"]
    nouns = 2 * ctx.mix["batch"] * m["rpn_post_nms_test"] * m["max_cap_nouns"] * m["emb_dim"] if cfg["kind"] != "teacher" else 0
    expected = sum(counted.values()) - by_op.get("bmm", 0) + nouns
    analytic = sum(flops.step_flops(cfg, hw, True).values())
    assert analytic == pytest.approx(expected, rel=1e-4)


def test_roi_align_work_by_hand():
    # a 4 x 4 map, one roi over 64 x 64 pixels at 1/16: 3.9375 feature
    # pixels a side, 2 x 2 bins of 2 samples a side; per axis the first
    # bin's samples (0.49, 1.48) tap rows {0, 1} and {1, 2}, the second's
    # (2.46, 3.45) {2, 3} and, at the edge, {3}: 3 + 2 rows, 5 x 5 taps
    rois = torch.tensor([[[0.0, 0.0, 63.0, 63.0]]])
    byts, ops = kernels.roi_align_work((1, 4, 4, 8), 4, rois, (2, 2), 1.0 / 16, 0, 8, 1)
    assert ops == 2 * 25 * 8
    assert byts == (16 * 8 + 4 * 8) * 4 + 16
    # the same roi on an 8 x 8 map: the last sample's upper tap, row 4,
    # is inside now, so 3 + 3 rows a side and 6 x 6 taps; it reads the
    # top-left 5 x 5 of the 64 pixels
    byts, ops = kernels.roi_align_work((1, 8, 8, 8), 4, rois, (2, 2), 1.0 / 16, 0, 8, 1)
    assert ops == 2 * 36 * 8
    assert byts == (25 * 8 + 4 * 8) * 4 + 16
    # two images, one roi each at opposite corners of a 4 x 4 map: the
    # union of each image's tapped rows x columns
    two = torch.tensor([[[0.0, 0.0, 15.0, 15.0]], [[32.0, 32.0, 63.0, 63.0]]])
    taps, bins, pixels = kernels.roi_taps((2, 4, 4, 8), two, (1, 1), 1.0 / 16, 1, 8, 1)
    assert bins == 1 and pixels == 4 + 4
    byts, ops = kernels.roi_align_backward_work((1, 1, 2, 2, 8), 2, rois, (1, 4, 4, 8), (2, 2), 1.0 / 16, 0, 8, 1)
    assert ops == 2 * 25 * 8 and byts == (32 + 128) * 2 + 16


def test_nms_work_by_hand():
    # three valid boxes of one label, the second suppressed: the scan
    # (3 outputs, 2 kept) runs to the end; one suppressed box tested once,
    # and the two kept ones against each other
    scores = torch.tensor([[0.9, 0.8, 0.7]])
    valid = torch.ones((1, 3), dtype=torch.bool)
    idx = torch.tensor([[0, 2, 0]])
    keep = torch.tensor([[True, True, False]])
    byts, ops = kernels.nms_work(scores, valid, None, idx, keep, 3)
    assert ops == kernels.IOU_OPS * 2
    assert byts == 3 * (16 + 4 + 1) + 3 * (4 + 1)
    assert kernels.bound_s(byts, ops) == max(byts / 3.35e12, ops / 67e12)
