"""The port's end-to-end noisy pseudo-label ablation against JAX's tool.

``cvpr22_cross_modal_pseudo_labeling_torch/tools/ablate_st_e2e.py`` and
``tools/ablate_st_e2e.py`` (loaded through ``importlib``, as
``tests/test_ablate_st_e2e.py`` loads it) at a narrow width: both tools'
``ablation_cfg`` are patched on the loaded modules to stem 8, res2 16,
width 4 (``TINY_OPTS`` of ``tests/test_torch_st_eval.py``); the file of
JAX's tool is not touched.  The same flax-layout weights (drawn with
numpy, loaded through ``bridge.py``) and JAX's own random draws
(``JaxDraws`` of ``tests/test_torch_st_train.py``) go into two steps of
``ControlledPseudoST`` on each side, 2 images a step and 8
held out (the tools' 8 and 32, cut for time), under JAX's optax chain
(clip at 10, SGD 0.002, momentum 0.9) and the port's ``Optimizer`` with
the tool's ``ablation_cfg`` solver.  The checked conditions are
``sampled_bce`` and ``logmeanexp`` capped and unbounded.

Tolerances (float32): the losses, ``avg_uncertain`` and the gradient
norm of each step 1e-5 relative; the update of every trained tensor
after the two steps 1e-5 of the JAX update's norm, but 2e-3 for the
student's C5 head (``student.roi_extractor``), whose float32 gradient is
itself that far from a float64 run (ReLU boundaries amplify rounding;
``tests/test_torch_st_train.py::
test_c5_head_gradient_is_as_close_to_jax_as_float32_allows``).  The
held-out ``gtbox_metrics`` after the steps: AP50 and class accuracy
equal, mean mask IoU within 1e-3.  The full 400-step study on the port
is marked ``slow``.  JAX's own ``model.init`` (:func:`dump_jax_init`)
loads through the port tool's ``--params`` path leaf for leaf, and the
tool's default init draws from its distributions.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.engine import train_step as jax_train
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.engine.inference import load_cfg
from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import device_batch
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.st_generalized_rcnn import (
    STGeneralizedRCNN,
    st_statics_from_cfg,
)
from cvpr22_cross_modal_pseudo_labeling_torch.tools import ablate_st_e2e as port_tool
from tests.test_torch_st_eval import CONFIG
from tests.test_torch_st_train import TRAIN_OPTS, JaxDraws, tiny_batch
from tests.torch_threads import two_torch_threads  # noqa: F401  (an autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(STEM_OUT_CHANNELS=8, RES2_OUT_CHANNELS=16, WIDTH_PER_GROUP=4)
STEPS = 2
BATCH, N_HELD = 2, 8  # images a step and held-out images (the tools' 8 and 32, cut for time)
CHECKED = ("sampled_bce", "logmeanexp", "logmeanexp_unbounded")
# an ST train step of tests/test_torch_st_train.py's TRAIN_OPTS model on
# tiny_batch() with the generator seeded 3 and seeded_flax_params(seed 0),
# as the port computed it before the _override_pseudo hook existed
BEFORE_HOOK = {
    "loss_classifier_pseudo": 0.02615302987396717,
    "loss_box_reg_pseudo": 0.00969150010496378,
    "loss_mask_pseudo": 7.747261047363281,
    "loss_classifier": 2.052419900894165,
    "loss_box_reg": 0.4047490954399109,
    "loss_mask": 4.240121364593506,
}


def _narrowed(ablation_cfg):
    def cfg():
        c = ablation_cfg()
        for k, v in NARROW.items():
            setattr(c.MODEL.RESNETS, k, v)
        return c

    return cfg


def load_jax_tool():
    spec = importlib.util.spec_from_file_location("ablate_st_e2e", os.path.join(REPO, "tools", "ablate_st_e2e.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    return jax_tool


def dump_jax_init(path, jax_tool=None):
    """JAX's ``run_condition`` init (``model.init`` of an uncertainty
    condition's model with its keys, on the first batch of seed 0; the
    other conditions' leaves are a subset, the same values) as an npz of
    ``/``-joined flax paths, which the port's tool reads with
    ``--params``.  At full width (JAX's tool as it is)::

        JAX_PLATFORMS=cpu python -c "from tests.test_torch_ablate_st_e2e import dump_jax_init; \\
            dump_jax_init('build/jax_init.npz')"
    """
    jax_tool = jax_tool or load_jax_tool()
    rng = np.random.RandomState(0)
    tr = jax_tool.make_detection_data(rng, 64)
    corrupt = rng.rand(64) < 0.5
    table = np.random.RandomState(5).randn(jax_tool.LVIS_SLOTS, jax_tool.EMB).astype(np.float32)
    first = jax_tool.make_batch(*(x[:8] for x in tr), corrupt[:8], table)
    model, _ = jax_tool.build_model(True, "sampled_bce", 1)
    keys = {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1), "uncertainty": jax.random.PRNGKey(2)}
    params = jax.jit(lambda r, b: model.init(
        r, b["images"], b["image_sizes"], {k: v for k, v in b.items() if k not in ("images", "image_sizes")},
        b["class_embeddings"], b["lvis_class_embeddings"], train=True))(keys, first)
    np.savez(path, **{"/".join(str(k.key) for k in p): np.asarray(v)
                      for p, v in jax.tree_util.tree_leaves_with_path(params["params"])})


@pytest.fixture(scope="module")
def tools():
    """(JAX's tool, the port's tool), both at the narrow width."""
    jax_tool = load_jax_tool()
    jax_tool.ablation_cfg = _narrowed(jax_tool.ablation_cfg)
    wide = port_tool.ablation_cfg
    port_tool.ablation_cfg = _narrowed(wide)
    yield jax_tool, port_tool
    port_tool.ablation_cfg = wide


def _jax_run(jax_tool, condition, tree):
    """JAX's ``run_condition`` protocol for ``STEPS`` steps from ``tree``:
    each step's metrics and draws, the trained params and the held-out
    metrics."""
    name, unc, est, ns, rw, sm = condition
    rng = np.random.RandomState(0)
    tr = jax_tool.make_detection_data(rng, 64)
    held = jax_tool.make_detection_data(np.random.RandomState(100), N_HELD)
    corrupt = rng.rand(64) < 0.5
    lvis_table = np.random.RandomState(5).randn(jax_tool.LVIS_SLOTS, jax_tool.EMB).astype(np.float32)
    model, cfg = jax_tool.build_model(unc, est, ns, rw, sm)
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.sgd(cfg.SOLVER.BASE_LR, momentum=0.9))
    state = jax_train.create_train_state({"params": jax.tree_util.tree_map(jnp.asarray, tree)}, tx,
                                         jax.random.PRNGKey(7))
    step = jax.jit(jax_train.build_train_step(model, tx, "STGeneralizedRCNN"))
    order = np.arange(64)
    steps = []
    for it in range(STEPS):
        if it % (64 // BATCH) == 0:
            rng.shuffle(order)
        sel = order[it * BATCH:(it + 1) * BATCH]
        batch = jax_tool.make_batch(tr[0][sel], tr[1][sel], tr[2][sel], tr[3][sel], corrupt[sel], lvis_table)
        rec = JaxDraws(cfg.MODEL.RPN.POST_NMS_TOP_N_TEST)
        with rec:
            state, metrics = step(state, batch)
            jax.block_until_ready(metrics)
        steps.append(({k: float(v) for k, v in metrics.items()}, rec.draws()))
    params = jax.tree_util.tree_map(np.asarray, state.params["params"])
    metrics = jax_tool.gtbox_metrics(model, {"params": state.params["params"]}, *held, lvis_table)
    return steps, params, metrics


@pytest.fixture(scope="module")
def jax_init(tools, tmp_path_factory):
    """The path of JAX's ``model.init`` of the narrow model
    (``dump_jax_init``)."""
    path = str(tmp_path_factory.mktemp("jax_init") / "jax_init.npz")
    dump_jax_init(path, tools[0])
    return path


@pytest.fixture(scope="module")
def runs(tools):
    """Per checked condition: (JAX's run, the port's record and metrics,
    the initial tree)."""
    jax_tool, tool = tools
    out = {}
    for condition in tool.CONDITIONS:
        if condition[0] not in CHECKED:
            continue
        name, unc, est, ns, rw, sm = condition
        model, _ = tool.build_model(unc, est, ns, rw, sm)
        tree = bridge.seeded_flax_params(model, 0)
        jax_steps, jax_params, jax_metrics = _jax_run(jax_tool, condition, tree)
        record = {}
        metrics = tool.run_condition(name, unc, est, ns, STEPS, 0.5, batch_size=BATCH, n_held=N_HELD, reweight=rw,
                                     sigma_max=sm, device="cpu", params=tree, draws=lambda it: jax_steps[it][1],
                                     record=record)
        out[name] = dict(jax_steps=jax_steps, jax_params=jax_params, jax_metrics=jax_metrics, record=record,
                         metrics=metrics, tree=tree)
    return out


def test_make_detection_data_is_bit_equal_to_jax(tools):
    jax_tool, tool = tools
    for seed in (0, 7):
        ours = tool.make_detection_data(np.random.RandomState(seed), 6)
        theirs = jax_tool.make_detection_data(np.random.RandomState(seed), 6)
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert [c[0] for c in tool.CONDITIONS] == [c[0] for c in jax_tool.CONDITIONS]
    assert tool.CONDITIONS == jax_tool.CONDITIONS


def test_jax_init_loads_and_jax_init_params_draws_its_distributions(tools, jax_init):
    """JAX's own ``model.init`` (``dump_jax_init``) loads through the
    port tool's ``load_params`` leaf for leaf (the condition without the
    uncertainty head takes none of its leaves), and ``jax_init_params``
    draws every leaf from the same distribution: per leaf of n >= 1024
    values, the means within 5 standard errors of their difference (5 sd
    sqrt(2 / n)) and the standard deviations within 5 sd / sqrt(n) (16%
    at most: a wrong fan or scale is off by 41% or more); a constant leaf
    equal.  Both draws are fixed, so the check cannot flake."""
    tool, path = tools[1], jax_init
    dump = dict(np.load(path))
    for unc in (True, False):
        model, _ = tool.build_model(unc, "sampled_bce", 1)
        bridge.load_flax_params(model, tool.load_params(path, model))
        flat = {"/".join(k): v for k, v in _flatten(bridge.flax_from_state_dict(model))}
        assert set(flat) == {k for k in dump if unc or "uncertain_pred" not in k}
        assert all(np.array_equal(v, dump[k]) for k, v in flat.items())
    drawn = dict(_flatten_joined(tool.jax_init_params(model, 0)))
    checked = 0
    for k, v in drawn.items():
        ref = dump[k]
        if not ref.std():  # a constant init: the frozen BN, the biases
            assert np.array_equal(v, ref), k
        elif ref.size >= 1024:
            sd, n = float(ref.std()), ref.size
            assert abs(float(v.mean()) - float(ref.mean())) <= 5 * sd * np.sqrt(2 / n), k
            assert abs(float(v.std()) - sd) <= 5 * sd / np.sqrt(n), k
            checked += 1
    assert checked >= 40  # every drawn kernel of 1024 values or more


def _flatten(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, path + (k,))
        else:
            yield path + (k,), v


def _flatten_joined(tree):
    return (("/".join(k), v) for k, v in _flatten(tree))


def test_override_pseudo_is_the_identity_in_the_production_model():
    """The hook is called once a step with the teacher's pseudo-labels and
    hands them on as they are: the ST step's losses are those of the port
    before the hook (``BEFORE_HOOK``), 1e-5 relative."""
    seen = []

    class Spy(STGeneralizedRCNN):
        def _override_pseudo(self, pseudo, batch):
            out = super()._override_pseudo(pseudo, batch)
            seen.append(out is pseudo)
            return out

    model = Spy(st_statics_from_cfg(load_cfg(CONFIG, TRAIN_OPTS + ["TPU.COMPUTE_DTYPE", "float32"])))
    bridge.load_flax_params(model, bridge.seeded_flax_params(model, seed=0))
    generator = torch.Generator()
    generator.manual_seed(3)  # a Trainer's of seed 3
    with torch.no_grad():
        b = device_batch(tiny_batch(), "cpu")
        out = model(b["images"], b["image_sizes"], b["class_embeddings"], train=True, batch=b,
                    lvis_class_embeddings=b["lvis_class_embeddings"], generator=generator)
    assert seen == [True]
    for k, v in BEFORE_HOOK.items():
        np.testing.assert_allclose(float(out.losses[k]), v, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", CHECKED)
def test_two_steps_match_jax(runs, name):
    r = runs[name]
    steps = r["record"]["steps"]
    assert len(steps) == STEPS
    for (ref, _), got in zip(r["jax_steps"], steps):
        for k in ("loss_classifier_pseudo", "loss_box_reg_pseudo", "loss_mask_pseudo", "loss_classifier",
                  "loss_box_reg", "loss_mask", "avg_uncertain", "total_loss", "grad_norm"):
            np.testing.assert_allclose(float(got[k]), ref[k], rtol=1e-5, atol=1e-8, err_msg=k)
        assert ref["loss_mask_pseudo"] > 0 and ref["grad_norm"] > 10.0  # positives matched, the clip acts


@pytest.mark.parametrize("name", CHECKED)
def test_two_step_updates_match_jax(runs, name):
    """Every parameter the port trains (the student's, its frozen-BN
    statistics included) moves as JAX's does; every other one stays."""
    r = runs[name]
    model = r["record"]["model"]
    init = bridge.state_dict_from_flax(model, r["tree"])
    ref = bridge.state_dict_from_flax(model, r["jax_params"])
    moved = 0
    for key, value in model.state_dict().items():
        got = value.detach().numpy() - init[key].numpy()
        want = ref[key].numpy() - init[key].numpy()
        if not key.startswith("student."):
            assert not want.any() and not got.any(), key
            continue
        tol = 2e-3 if key.startswith("student.roi_extractor") else 1e-5
        assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want) + 1e-12, key
        moved += bool(want.any())
    assert moved > 0 and any("frozen" in k or "running_var" in k for k in init)


@pytest.mark.parametrize("name", CHECKED)
def test_gtbox_metrics_after_two_steps_match_jax(runs, name):
    got, ref = runs[name]["metrics"], runs[name]["jax_metrics"]
    assert got["gtbox_mask_ap50"] == ref["gtbox_mask_ap50"]
    assert got["cls_acc"] == ref["cls_acc"]
    assert abs(got["mean_mask_iou"] - ref["mean_mask_iou"]) <= 1e-3


@pytest.mark.slow
def test_full_study_on_the_port_orders_as_jax_pins():
    """The 400-step study on the port at full width on the CPU (the tool's
    command line, one process of 2 threads a condition), held to
    the ordering ``tests/test_ablate_st_e2e.py`` pins for JAX's tool.  One
    such run is one draw of a spread wider than the pinned gaps: on the
    H100, from JAX's own initial weights, the whole ordering held in 3 of
    7 runs that differ only in summation order or a 1-4 ulp nudge of the
    weights (PERF.md section 6), so this test can fail without a fault
    of the port; a fault shows in the two-step tests above and in
    ``tests/torch_ablation_lockstep.py``."""
    names = [c[0] for c in port_tool.CONDITIONS if not c[4]]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-m", port_tool.__name__, "--device", "cpu", "--conditions", n],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for n in names]
    res = {}
    for p in procs:
        out, err = p.communicate()
        assert p.returncode == 0, err[-2000:]
        res.update(json.loads(out.strip().splitlines()[-1])["conditions"])
    print(json.dumps(res))  # shown with the failure, if any
    fixed = res["fixed"]["mean_mask_iou"]
    assert res["sampled_bce"]["mean_mask_iou"] > fixed + 0.02
    assert res["logmeanexp"]["mean_mask_iou"] > fixed + 0.02
    assert res["sampled_bce"]["gtbox_mask_ap50"] >= res["fixed"]["gtbox_mask_ap50"]
    assert res["logmeanexp_unbounded"]["mean_mask_iou"] < 0.2
    assert res["logmeanexp"]["mean_mask_iou"] > 0.35
