"""The port's optimizer, schedule and parameter labels against the JAX
package's optax chain (``engine/optimizer.py::make_optimizer``) on the
same parameters and the same gradient sequence.

torch's SGD adds the weight decay to the gradient before the momentum
trace, as optax's ``add_decayed_weights`` then ``trace`` do: the tests
hold the parameters after every update to 1e-6 relative (the two
libraries may round ``p - lr * trace`` differently in the last bit),
with a warmup, a decay milestone, biases, the uncertainty groups and
frozen parameters, and with the global-norm clip, gradient accumulation
and the uncertainty freeze each switched on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from cvpr22_cross_modal_pseudo_labeling_tpu.config import get_default_cfg as jax_cfg
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import lr_schedule as jax_lr
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import optimizer as jax_opt
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.config import get_default_cfg as torch_cfg
from cvpr22_cross_modal_pseudo_labeling_torch.engine import lr_schedule as torch_lr
from cvpr22_cross_modal_pseudo_labeling_torch.engine import optimizer as torch_opt
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector import st_generalized_rcnn as torch_st
from tests.test_torch_st_eval import CONFIG, tiny_statics


@pytest.mark.parametrize("method", ["linear", "constant"])
def test_warmup_multistep_schedule_matches_jax(method):
    args = (0.005, (7, 3), 0.1, 1.0 / 3, 5, method)
    ref, out = jax_lr.warmup_multistep_schedule(*args), torch_lr.warmup_multistep_schedule(*args)
    for count in range(12):
        assert np.float32(out(count)) == np.asarray(ref(count)), count
    with pytest.raises(ValueError):
        torch_lr.warmup_multistep_schedule(0.1, (1,), warmup_method="cosine")


def _cfgs(opts):
    out = []
    for get in (jax_cfg, torch_cfg):
        cfg = get()
        cfg.merge_from_file(CONFIG)
        cfg.merge_from_list(list(opts))
        out.append(cfg)
    return out


@pytest.mark.parametrize("opts", [
    (),
    ("MODEL.LANGUAGE_BACKBONE.FT_EMB", True, "MODEL.ROI_BOX_HEAD.FREEZE_EMB_PRED", True,
     "MODEL.RPN.DONT_TRAIN", False, "MODEL.BACKBONE.FREEZE_CONV_BODY_AT", 0),
    ("MODEL.ROI_BOX_HEAD.FREEZE_FEATURE_EXTRACTOR", True, "MODEL.BACKBONE.FREEZE_CONV_BODY_AT", 3),
])
@pytest.mark.parametrize("meta_arch", ["STGeneralizedRCNN", "GeneralizedRCNN"])
def test_frozen_prefixes_and_labels_match_jax(opts, meta_arch):
    """Every parameter of the student-teacher model gets the JAX label
    of its flax path; the frozen-BN leaves, buffers in the port, are
    frozen on both sides."""
    jc, tc = _cfgs(opts)
    prefixes = torch_opt.frozen_prefixes_from_cfg(tc, meta_arch)
    assert prefixes == jax_opt.frozen_prefixes_from_cfg(jc, meta_arch)
    _, ts = tiny_statics()
    model = torch_st.STGeneralizedRCNN(ts)
    tree = bridge.flax_from_state_dict(model)
    ref = {}
    for path, label in jax.tree_util.tree_flatten_with_path(jax_opt.label_params(tree, prefixes))[0]:
        ref["/".join(k.key for k in path)] = label
    modules = dict(model.named_modules())
    out = torch_opt.label_params([n for n, _ in model.named_parameters()], prefixes)
    to_flax = {bridge._port_key(modules, tuple(p.split("/")))[0]: p for p in ref}
    for name, label in out.items():
        assert label == ref[to_flax[name]], name
    for key, path in to_flax.items():
        if key not in out:  # a frozen-BN buffer
            assert ref[path] == "frozen", path
    assert set(out.values()) >= {"frozen", "default", "bias", "uncertain", "uncertain_bias"}


class _Net(nn.Module):
    """Parameters under the names the labels distinguish."""

    def __init__(self):
        super().__init__()
        self.student = nn.Module()
        self.student.emb_pred = nn.Linear(5, 4)
        self.student.uncertain_pred = nn.Conv2d(3, 1, 1)
        self.teacher = nn.Module()
        self.teacher.emb_pred = nn.Linear(5, 4)


@pytest.mark.parametrize("opts", [
    (),
    ("SOLVER.CLIP_GRAD_NORM_AT", 0.5),
    ("SOLVER.GRADIENT_ACCUMULATION_STEPS", 2),
    ("MODEL.UNCERTAINTY_TRAIN_ITER", 2, "SOLVER.UNCERTAINTY_LR_FACTOR", 3.0),
])
def test_optimizer_matches_the_optax_chain(opts):
    base = ("SOLVER.BASE_LR", 0.05, "SOLVER.WARMUP_ITERS", 3, "SOLVER.STEPS", (3,),
            "SOLVER.WEIGHT_DECAY", 0.01, "SOLVER.WEIGHT_DECAY_BIAS", 0.002)
    jc, tc = _cfgs(base + opts)
    torch.manual_seed(0)
    net = _Net()
    prefixes = ("teacher/",)
    tree = bridge.flax_from_state_dict(net)
    tx, _ = jax_opt.make_optimizer(jc, tree, prefixes)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(params)
    opt = torch_opt.Optimizer(tc, net, prefixes)
    teacher = {k: v.clone() for k, v in net.teacher.state_dict().items()}
    rng = np.random.RandomState(1)
    for step in range(6):
        grads = jax.tree_util.tree_map(lambda p: rng.normal(0, 1, p.shape).astype(np.float32), tree)
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        port_grads = bridge.state_dict_from_flax(net, grads)
        for name, p in net.named_parameters():
            p.grad = port_grads[name].clone() if p.requires_grad else None
        norm = opt.step()
        want = float(np.sqrt(sum(np.sum(np.square(port_grads[n].numpy()))
                                 for n, p in net.named_parameters() if p.requires_grad)))
        assert abs(float(norm) - want) <= 1e-5 * want
        ref = bridge.state_dict_from_flax(net, jax.tree_util.tree_map(np.asarray, params))
        for name, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=1e-6, atol=1e-7,
                                       err_msg=f"{name} after micro-step {step}")
    for k, v in net.teacher.state_dict().items():
        assert torch.equal(v, teacher[k]), k
    assert not any(p.requires_grad for p in net.teacher.parameters())
    assert opt.updates == (3 if "SOLVER.GRADIENT_ACCUMULATION_STEPS" in opts else 6)
