"""The teacher's pseudo-label methods and ``pseudo_sample_weights`` in the
port's ``GeneralizedRCNN`` against the JAX package, on the CPU.

- ``run_teacher_pseudo_branch`` and ``predict_masks_for_boxes`` on the
  configuration of ``tests/test_generalized_rcnn.py::tiny_cfg`` (EMB_DIM
  16, 8 classes, RPN 128 -> 32 at test) at a narrow trunk (stem 8, res2
  16, width 4), with that file's inputs (one zero image of 64 x 64, whose
  objectness ties everywhere) and with 2 random images of which one is
  smaller than the batch: the proposals (boxes within 1e-4 px, scores
  within 1e-6, the valid flags exactly), the region embeddings and class
  logits (1e-5 of their largest value), the regressed boxes (1e-4 px),
  and the masks on the first 8 regressed boxes of each image within
  1e-5;
- the teacher's training losses with ``pseudo_sample_weights`` (a weight
  for each sampled roi's classification loss) and ``lambda_mask``, at the
  narrow width of ``tests/test_torch_teacher.py`` on the JAX program's
  own draws: every loss within 1e-5 relative, the weighted
  classification loss apart from the unweighted one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.config import get_default_cfg as jax_cfg
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import GeneralizedRCNN as JaxRCNN
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import statics_from_cfg as jax_statics
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.config import get_default_cfg as torch_cfg
from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import device_batch
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.generalized_rcnn import (
    GeneralizedRCNN,
    TeacherPseudoOutput,
)
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.statics import statics_from_cfg
from tests.test_torch_teacher import LOSSES, JaxDraws, make_setup, tiny_batch

# tests/test_generalized_rcnn.py::tiny_cfg, at a narrow trunk
CASE_OPTS = [
    "MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16, "MODEL.RESNETS.WIDTH_PER_GROUP", 4,
    "MODEL.MASK_ON", True, "MODEL.CLS_AGNOSTIC_BBOX_REG", True, "MODEL.CLS_AGNOSTIC_MASK", True,
    "MODEL.ROI_BOX_HEAD.EMBEDDING_BASED", True, "MODEL.ROI_BOX_HEAD.EMB_DIM", 16,
    "MODEL.ROI_BOX_HEAD.NUM_CLASSES", 8, "MODEL.ROI_BOX_HEAD.LOSS_WEIGHT_BACKGROUND", 0.2,
    "MODEL.ROI_HEADS.POSITIVE_FRACTION", 1.0, "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 16,
    "MODEL.ROI_HEADS.DETECTIONS_PER_IMG", 8, "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 128,
    "MODEL.RPN.PRE_NMS_TOP_N_TEST", 128, "MODEL.RPN.POST_NMS_TOP_N_TRAIN", 32,
    "MODEL.RPN.POST_NMS_TOP_N_TEST", 32, "TPU.MAX_GT", 4, "TPU.NMS_TILE", 64,
]


def _inputs(case):
    table = np.random.RandomState(0).randn(8, 16).astype(np.float32)
    if case == "zero_image":
        return np.zeros((1, 64, 64, 3), np.float32), np.array([[64, 64]], np.int32), table
    rng = np.random.default_rng(4)
    return (rng.standard_normal((2, 64, 64, 3)).astype(np.float32) * 50,
            np.array([[64, 64], [48, 56]], np.int32), table)


@pytest.fixture(scope="module")
def case_models():
    jc, tc = jax_cfg(), torch_cfg()
    jc.merge_from_list(CASE_OPTS)
    tc.merge_from_list(CASE_OPTS)
    model = GeneralizedRCNN(statics_from_cfg(tc))
    tree = bridge.seeded_flax_params(model, 0)
    bridge.load_flax_params(model, tree)
    jm = JaxRCNN(jax_statics(jc))
    params = {"params": jax.tree_util.tree_map(jnp.asarray, tree)}
    branch = jax.jit(lambda p, im, sz, ce: jm.apply(p, im, sz, ce, method=JaxRCNN.run_teacher_pseudo_branch))
    masks = jax.jit(lambda p, im, sz, bx: jm.apply(p, im, sz, bx, method=JaxRCNN.predict_masks_for_boxes))
    return model.eval(), params, branch, masks


@pytest.mark.parametrize("case", ["zero_image", "random_images"])
def test_teacher_pseudo_branch_and_masks_match_jax(case_models, case):
    model, params, branch, masks = case_models
    images, sizes, table = _inputs(case)
    ref = branch(params, jnp.asarray(images), jnp.asarray(sizes), jnp.asarray(table))
    with torch.no_grad():
        got = model.run_teacher_pseudo_branch(torch.from_numpy(images), torch.from_numpy(sizes),
                                              torch.from_numpy(table))
    assert isinstance(got, TeacherPseudoOutput)
    b = images.shape[0]
    assert got.embeddings.shape == (b, 32, 16) and got.class_logits.shape == (b, 32, 8)
    assert got.proposals.boxes.shape == (b, 32, 4) and got.boxes.shape == (b, 32, 4)
    np.testing.assert_array_equal(got.proposals.valid.numpy(), np.asarray(ref.proposals.valid))
    np.testing.assert_allclose(got.proposals.boxes.numpy(), np.asarray(ref.proposals.boxes), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.proposals.scores.numpy(), np.asarray(ref.proposals.scores), rtol=0, atol=1e-6)
    for name in ("embeddings", "class_logits"):
        r = np.asarray(getattr(ref, name))
        np.testing.assert_allclose(getattr(got, name).numpy(), r, rtol=0, atol=1e-5 * np.abs(r).max(), err_msg=name)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(ref.boxes), rtol=0, atol=1e-4)
    # the regressed boxes lie inside each image
    assert (got.boxes[..., 2] <= torch.from_numpy(sizes[:, 1:2]).float() - 1).all()
    assert (got.boxes[..., 3] <= torch.from_numpy(sizes[:, 0:1]).float() - 1).all()

    boxes = got.boxes[:, :8].contiguous()
    ref_m = masks(params, jnp.asarray(images), jnp.asarray(sizes), jnp.asarray(boxes.numpy()))
    with torch.no_grad():
        got_m = model.predict_masks_for_boxes(torch.from_numpy(images), torch.from_numpy(sizes), boxes)
    assert got_m.shape == (b, 8, 14, 14) == ref_m.shape
    np.testing.assert_allclose(got_m.numpy(), np.asarray(ref_m), rtol=0, atol=1e-5)
    assert ((got_m >= 0) & (got_m <= 1)).all()


def test_pseudo_sample_weights_weigh_the_teacher_losses_as_in_jax():
    setup = make_setup("float32")
    model, jm = setup["trainer"].model, setup["model"]
    batch = tiny_batch()
    s = model.statics
    weights = np.random.default_rng(7).uniform(0.2, 2.0, (2, s.roi_batch_per_image)).astype(np.float32)

    def losses(p, b, w, key):
        targets = {k: b[k] for k in ("gt_boxes", "gt_labels", "gt_valid", "gt_masks")}
        rngs = {"sampler": jax.random.fold_in(key, 0), "uncertainty": jax.random.fold_in(key, 1)}
        out = jm.apply(p, b["images"], b["image_sizes"], b["class_embeddings"], targets, train=True,
                       pseudo_sample_weights=w, lambda_mask=0.5, rngs=rngs)
        return out.losses

    with JaxDraws() as rec:
        ref = jax.jit(losses)(setup["params"], {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(weights),
                              jax.random.PRNGKey(0))
        jax.block_until_ready(ref)
    draws = rec.draws()
    b = device_batch(batch, "cpu", "GeneralizedRCNN")
    args = (b["images"], b["image_sizes"], b["class_embeddings"])
    with torch.no_grad():
        got = model(*args, train=True, batch=b, draws=draws, pseudo_sample_weights=torch.from_numpy(weights),
                    lambda_mask=0.5)
        plain = model(*args, train=True, batch=b, draws=draws)
    assert tuple(got.losses) == LOSSES
    for k in LOSSES:
        np.testing.assert_allclose(got.losses[k].numpy(), np.asarray(ref[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert abs(float(got.losses["loss_classifier"]) / float(plain.losses["loss_classifier"]) - 1) > 1e-3
    for k in ("loss_objectness", "loss_box_reg", "loss_mask"):
        assert torch.equal(got.losses[k], plain.losses[k]), k
