"""The float32 reference against the program at narrow widths on the
CPU, through the harness's own loops: with the program in float32 too,
every compared number is at rounding."""

import pytest

import tiny
from harness import serve, train


@pytest.mark.parametrize("config", ["teacher_r50c4_coco", "st_r50c4_coco"])
def test_training_steps_agree(config):
    r = train.run(tiny.context(config, "coco_train_b8", seconds=0.5))
    assert r["steps"] >= 1
    # the student-teacher reference follows the program's choices, and
    # holds the selection stage by itself
    follow = ("rpn_score_gap.eval", "rpn_score_gap.train", "rpn_box_gap.eval", "rpn_box_gap.train",
              "nms_mismatch.eval", "nms_mismatch.train", "pseudo_score_gap") if config == "st_r50c4_coco" else ()
    for k in ("loss_gap", "head_loss_gap", "grad_gap", "update_gap") + follow:
        assert r["numbers"][k] < 1e-4, (k, r["numbers"])


def test_served_detections_agree():
    r = serve.run(tiny.context("st_r50c4_coco", "coco_serve_b8", seconds=0.5))
    assert r["steps"] >= 1 and r["failed"] == 0
    # the reference follows the program's proposals and holds the
    # proposal selection and the detection NMS by themselves
    for k in ("rpn_score_gap", "rpn_box_gap", "nms_mismatch.rpn", "nms_mismatch.det", "score_gap",
              "det_score_gap", "det_box_gap", "det_recall_gap", "mask_gap"):
        assert r["numbers"][k] < 1e-4, (k, r["numbers"])
