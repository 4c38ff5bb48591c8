"""A run whose timed path is broken underneath comes out not correct.

Each test drives the rest of a run as the command does (the loop, the
window, the reference, the cell's limits) on the CPU at narrow widths,
with one fault planted in the program: a training step that leaves its
state unchanged, a step that leaves out half of the batch and takes the
mean over the rest, a served answer altered where it is produced.  The
same run unbroken is correct.  Serving also plants a detection NMS that
suppresses nothing and box deltas shifted before they are decoded.
"""

import pytest
import torch

import run as bench_run
import tiny
from harness import env, serve, train


def line_of(workload, loop):
    spec, cell, config, mix, limits, e2e, per_layer = bench_run.load_cell(env.ROOT, workload)
    r = loop(tiny.context(cell["config"], cell["traffic"], seconds=0.5))
    return bench_run.result_line(r, config, limits, e2e, per_layer, False, 1.0, {})


@pytest.mark.parametrize("workload", ["st_train", "teacher_train"])
def test_unbroken_training_is_correct(workload):
    assert line_of(workload, train.run)["correct"] is True


@pytest.mark.parametrize("workload", ["st_train", "teacher_train"])
def test_a_step_that_leaves_its_state_unchanged(workload, monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)
    assert line_of(workload, train.run)["correct"] is False


@pytest.mark.parametrize("workload", ["st_train", "teacher_train"])
def test_a_step_on_half_of_the_batch(workload, monkeypatch):
    from cvpr22_cross_modal_pseudo_labeling_torch.engine import train_step

    forward = train_step.training_forward

    def half(model, meta_arch, b, draws, generator=None, exemplars=None):
        n = b["images"].shape[0]
        rows = {k: (v[: n // 2] if v.dim() and v.shape[0] == n and not k.endswith("embeddings") else v)
                for k, v in b.items()}
        d = type(draws)(*(None if x is None else (x[:, : x.shape[1] // 2] if x.dim() == 5 else x[: n // 2])
                          for x in draws))
        return forward(model, meta_arch, rows, d, generator, exemplars)

    monkeypatch.setattr(train_step, "training_forward", half)
    assert line_of(workload, train.run)["correct"] is False


def test_unbroken_serving_is_correct():
    assert line_of("st_serve", serve.run)["correct"] is True


def test_a_served_answer_altered(monkeypatch):
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.inference import Predictor

    call = Predictor.__call__

    def relabel(self, images, image_sizes, class_embeddings=None, gt_eval=None):
        dets, masks = call(self, images, image_sizes, class_embeddings, gt_eval)
        classes = class_embeddings.shape[0] - 1
        return dets._replace(labels=dets.labels % classes + 1), masks

    monkeypatch.setattr(Predictor, "__call__", relabel)
    assert line_of("st_serve", serve.run)["correct"] is False


def test_a_detection_nms_that_suppresses_nothing(monkeypatch):
    from cvpr22_cross_modal_pseudo_labeling_torch.models.roi_heads import box_head

    nms = box_head.batched_nms
    monkeypatch.setattr(box_head, "batched_nms",
                        lambda boxes, scores, labels, valid, iou, k: nms(boxes, scores, labels, valid, 1.0, k))
    line = line_of("st_serve", serve.run)
    assert line["correct"] is False and line["compared"]["nms_mismatch.det"][0] > 0


def test_shifted_box_deltas(monkeypatch):
    from cvpr22_cross_modal_pseudo_labeling_torch.models.roi_heads import box_head

    decode = box_head.decode_boxes

    def shifted(codes, boxes, weights):
        shift = torch.zeros(4, dtype=codes.dtype)
        shift[:2] = 1.0
        return decode((codes.reshape(codes.shape[:-1] + (-1, 4)) + shift).reshape(codes.shape), boxes, weights)

    monkeypatch.setattr(box_head, "decode_boxes", shifted)
    assert line_of("st_serve", serve.run)["correct"] is False
