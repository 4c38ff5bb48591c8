"""The student-teacher model (``STGeneralizedRCNN``,
``student_teacher_mask_rcnn_uncertainty.yaml``) on the R-50-FPN body
against the JAX package on the CPU: both branches' training losses, the
adaptive weight and the student's gradients on the JAX program's draws,
and the eval forward with its 28 x 28 masks.  Setup and tolerances as in
``tests/test_torch_fpn_models.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from tests import test_torch_st_train as st
from tests import test_torch_teacher as teacher
from tests.test_torch_fpn_models import FPN, _same_detections


@pytest.fixture(scope="module")
def fpn_student():
    return st.make_setup("float32", FPN)


def _st_jax_grads(setup, batch):
    # the caption branch samples the eval selector's 5 x 32 candidates
    # (the FPN top-N of 2000 keeps them all), the GT branch 5 x 32 + 4
    rec = st.JaxDraws(5 * setup["trainer"].model.statics.base.rpn_post_nms_test)
    with rec:
        grads, (losses, info) = setup["grad_fn"](
            setup["params"], jax.tree_util.tree_map(jnp.asarray, batch), jax.random.PRNGKey(0))
        jax.block_until_ready(grads)
    return grads, losses, info, rec.draws()


@pytest.mark.parametrize("variant", ["both_branches", "no_valid_pseudo_word"])
def test_fpn_student_losses_and_gradients_match_jax(fpn_student, variant):
    """Both branches' losses and the adaptive weight; the student's
    gradients against JAX's, its predictors' within 1e-5 and its RoI
    head's within 1e-4 (the FPN pooling order, as for the teacher); the
    frozen backbone, FPN included, gets none."""
    batch = st.tiny_batch(variant)
    grads, losses, info, draws = _st_jax_grads(fpn_student, batch)
    assert draws.pseudo_sampler.shape[-1] == 160 and draws.gt_sampler.shape[-1] == 164
    trainer = fpn_student["trainer"]
    trainer.model.zero_grad(set_to_none=True)
    out = st.port_forward(trainer, batch, draws)
    for k in st.LOSSES:
        np.testing.assert_allclose(out.losses[k].detach().numpy(), np.asarray(losses[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for k in out.info:
        np.testing.assert_allclose(out.info[k].detach().numpy(), np.asarray(info[k]), rtol=1e-5, err_msg=k)
    if variant != "both_branches":
        return
    assert float(out.losses["loss_mask_pseudo"].detach()) > 0
    sum(out.losses.values()).backward()
    ref = bridge.state_dict_from_flax(trainer.model, jax.tree_util.tree_map(np.asarray, grads))
    held = set()
    for name, p in trainer.model.named_parameters():
        if name.startswith(("backbone.", "rpn_head.", "teacher.", "bert.")):
            assert p.grad is None, name
        elif p.grad is not None and name.startswith("student."):
            tol = 1e-4 if name.startswith("student.roi_extractor.") else 1e-5
            assert teacher._rel_norm(p.grad.numpy(), ref[name].numpy()) <= tol, name
            held.add(name.split(".")[1])
    assert {"roi_extractor", "box_predictor", "mask_predictor"} <= held
    trainer.model.zero_grad(set_to_none=True)


def test_fpn_student_eval_matches_jax(fpn_student):
    images, sizes, table = (st.tiny_batch()[k] for k in ("images", "image_sizes", "class_embeddings"))
    m = fpn_student["model"]
    ref = jax.jit(lambda p, i, s, c: m.apply(p, i, s, class_embeddings=c, train=False))(
        fpn_student["params"], images, sizes, table)
    model = fpn_student["trainer"].model.eval()
    with torch.no_grad():
        out = model(torch.from_numpy(images), torch.from_numpy(sizes), torch.from_numpy(table))
    model.train()
    _same_detections(ref, out)
    assert out.mask_probs.shape == (2, 100, 28, 28)
    np.testing.assert_allclose(out.mask_probs.numpy(), np.asarray(ref.mask_probs), rtol=0, atol=1e-4)
