"""Both detector families on the R-50-FPN body against the JAX package on
the CPU: here the teacher's (``GeneralizedRCNN``, ``zeroshot_mask.yaml``)
eval outputs, with the 28 x 28 masks of the prestrided C5 head and the 14
x 14 masks without ``TPU.POOL_PRESTRIDE``, its training losses, gradients
and two ``Trainer`` steps; in ``tests/test_torch_fpn_student.py`` the
student-teacher model's (``STGeneralizedRCNN``) training losses and
gradients and its eval.

The FPN opts are the port's ``R50_FPN_OPTS`` over each shipped config,
at the narrow widths of ``tests/test_torch_teacher.py`` and
``tests/test_torch_st_train.py`` (stem 8, res2 16, width 4, a 16-channel
FPN, 64 x 64 images, 2 images) in float32, with the same flax-layout
weights and the JAX programs' own random draws (recorded by those files'
``JaxDraws``).  Tolerances as there (boxes 1e-3 px, masks 1e-4; losses
1e-5 relative), but scores 5e-5: JAX pools the FPN levels with its
golden gather ``roi_align``, which sums each bin's samples in another
order than the port's per-axis contraction (and than JAX's own
single-level pooler), so the pooled features differ by up to about 1e-5
of the maps' largest value (``tests/test_torch_fpn.py``) before the C5
head.  For the same reason each gradient of the teacher is held against
JAX's within 3e-4 of the JAX gradient's norm, the predictors' within 5e-5
(the largest distances on these inputs are 8.8e-5, in the trunk's res5,
and 1.4e-5, the mask logits' bias; the C4 teacher's predictors are held
at 1e-5).  The student's gradients: its predictors' within 1e-5 of the
JAX gradient's norm, its RoI head's within 1e-4 (at most 1.9e-5 here).
Updates 1e-3 of the JAX update's norm.
"""

import jax
import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.engine import optimizer as jax_opt
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import train_step as jax_train
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.config import R50_FPN_OPTS
from cvpr22_cross_modal_pseudo_labeling_torch.models.backbone import ResNetFPNBackbone
from tests import test_torch_teacher as teacher

FPN = R50_FPN_OPTS + ["MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 16]


@pytest.fixture(scope="module")
def fpn_teacher():
    return teacher.make_setup("float32", FPN)


def _eval_pair(setup, batch):
    images, sizes, table = batch["images"], batch["image_sizes"], batch["class_embeddings"]
    m = setup["model"]
    ref = jax.jit(lambda p, i, s, c: m.apply(p, i, s, class_embeddings=c, train=False))(
        setup["params"], images, sizes, table)
    model = setup["trainer"].model.eval()
    with torch.no_grad():
        out = model(torch.from_numpy(images), torch.from_numpy(sizes), torch.from_numpy(table))
    model.train()
    return ref, out


def _same_detections(ref, out):
    rd, od = ref.detections, out.detections
    valid = np.asarray(rd.valid)
    assert valid.sum(axis=1).min() > 0, "the tiny model should detect something per image"
    np.testing.assert_array_equal(od.valid.numpy(), valid)
    np.testing.assert_array_equal(od.labels.numpy(), np.asarray(rd.labels))
    np.testing.assert_allclose(od.boxes.numpy(), np.asarray(rd.boxes), rtol=0, atol=1e-3)
    np.testing.assert_allclose(od.scores.numpy(), np.asarray(rd.scores), rtol=0, atol=5e-5)


@pytest.mark.parametrize("prestride", [True, False])
def test_fpn_teacher_eval_matches_jax(fpn_teacher, prestride):
    """Detections and masks: 28 x 28 with the prestrided head (the
    multi-level pooler emits every bin, so res5 runs at stride 1 on 14 x
    14), 14 x 14 without it (res5 strides by 2)."""
    setup = fpn_teacher if prestride else teacher.make_setup("float32", FPN + ["TPU.POOL_PRESTRIDE", False])
    assert isinstance(setup["trainer"].model.backbone, ResNetFPNBackbone)
    ref, out = _eval_pair(setup, teacher.tiny_batch())
    _same_detections(ref, out)
    m = 28 if prestride else 14
    assert out.mask_probs.shape == np.asarray(ref.mask_probs).shape == (2, 100, m, m)
    np.testing.assert_allclose(out.mask_probs.numpy(), np.asarray(ref.mask_probs), rtol=0, atol=1e-4)


def test_fpn_teacher_losses_and_gradients_match_jax(fpn_teacher):
    """The five losses over all five levels' anchors (the RPN sampler's
    draws span them), and the gradient of every trainable parameter, the
    FPN's included, against JAX's."""
    batch = teacher.tiny_batch()
    grads, losses, _, draws = teacher.jax_grads(fpn_teacher, batch)
    n_anchors = sum(h * w * 3 for h, w in ((16, 16), (8, 8), (4, 4), (2, 2), (1, 1)))
    assert tuple(draws.rpn_sampler.shape) == (2, 2, n_anchors)
    trainer = fpn_teacher["trainer"]
    trainer.model.zero_grad(set_to_none=True)
    out = teacher.port_forward(trainer.model, batch, draws)
    for k in teacher.LOSSES:
        np.testing.assert_allclose(out.losses[k].detach().numpy(), np.asarray(losses[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
        assert float(out.losses[k].detach()) > 0, k
    sum(out.losses.values()).backward()
    ref = bridge.state_dict_from_flax(trainer.model, jax.tree_util.tree_map(np.asarray, grads))
    groups = set()
    for name, p in trainer.model.named_parameters():
        if not p.requires_grad:
            assert p.grad is None and name.startswith(teacher.FROZEN), name
            continue
        vs_jax = teacher._rel_norm(p.grad.numpy(), ref[name].numpy())
        assert vs_jax <= (5e-5 if name.startswith(teacher.PREDICTORS) else 3e-4), (name, vs_jax)
        groups.add(".".join(name.split(".")[:3]))
    assert {"backbone.body.layer2", "backbone.body.layer4", "backbone.fpn.fpn_inner1",
            "backbone.fpn.fpn_layer4", "rpn_head.conv.weight", "roi_extractor.layer4.block0",
            "mask_predictor.conv5_mask.weight"} <= groups
    trainer.model.zero_grad(set_to_none=True)


def test_fpn_teacher_trainer_steps_match_jax_train_step():
    """Two ``Trainer.step`` calls against two steps of the jitted JAX
    train step: losses, each trainable parameter's update (the FPN's
    included), the frozen stem and ``layer1`` bit for bit."""
    setup = teacher.make_setup("float32", FPN)
    trainer, cfg = setup["trainer"], setup["cfg"]
    prefixes = jax_opt.frozen_prefixes_from_cfg(cfg, "GeneralizedRCNN")
    tx, _ = jax_opt.make_optimizer(cfg, setup["params"]["params"], prefixes)
    state = jax_train.create_train_state(setup["params"], tx, jax.random.PRNGKey(0))
    step = jax.jit(jax_train.build_train_step(setup["model"], tx, "GeneralizedRCNN"))
    frozen = {n: p.detach().clone() for n, p in trainer.model.named_parameters() if not p.requires_grad}
    assert frozen and not any(n.startswith("backbone.fpn.") for n in frozen)
    for it, variant in enumerate(["three_gt", "image_without_gt"]):
        batch = teacher.tiny_batch(variant, seed=1 + it)
        with teacher.JaxDraws() as rec:
            state, metrics = step(state, teacher.jax_batch(batch))
            jax.block_until_ready(state.params)
        prev = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        got = trainer.step(batch, rec.draws())
        for k in teacher.LOSSES + ("total_loss",):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(metrics[k]), rtol=1e-4, err_msg=k)
        ref = bridge.state_dict_from_flax(trainer.model, jax.tree_util.tree_map(np.asarray, state.params["params"]))
        for name, p in trainer.model.named_parameters():
            if p.requires_grad:
                up = (p.detach() - prev[name]).numpy()
                assert teacher._rel_norm(up, ref[name].numpy() - prev[name].numpy()) <= 1e-3, (it, name)
    for n, p in trainer.model.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), n
    assert not torch.equal(trainer.model.backbone.fpn.fpn_layer1.weight, prev["backbone.fpn.fpn_layer1.weight"])
