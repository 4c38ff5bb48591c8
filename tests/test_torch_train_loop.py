"""The port's training loop against the JAX package's.

- Loop parity: JAX's ``do_train`` with its jitted ``build_train_step`` on
  the narrow student-teacher config of ``tests/test_torch_st_train.py``
  and the port's ``do_train`` over ``Trainer.train_step`` take the same 3
  ``tiny_batch``es; JAX's random draws are recorded by ``JaxDraws`` and
  replayed through the port's ``step_fn``.  The logged ``metrics.jsonl``
  lines have the same steps and keys, the losses agree to 1e-4 relative
  (float32, as ``test_trainer_steps_match_jax_train_step``) and the
  gradient norm to 5e-3 (JAX's norm also counts the frozen-BN leaves);
  the lr each update used agrees to 1e-7 relative; the evaluation and
  checkpoint iterations are equal.
- The counterparts of ``tests/test_trainer_loop.py`` on a stand-in
  trainer: the loop's bookkeeping, zero steps on a finished run, the
  non-finite abort, no diverged checkpoint published, surplus batches
  stopped at ``MAX_ITER``.
- Resume equality: on a fixed-batch loader, 4 straight iterations and 2
  iterations, a restore from the checkpoint and 2 more give the same
  parameters, momentum buffers, ``updates`` and generator state, bit for
  bit.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from cvpr22_cross_modal_pseudo_labeling_tpu.engine import lr_schedule as jax_lr
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import optimizer as jax_opt
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import train_step as jax_train
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import trainer as jax_trainer
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import st_generalized_rcnn as jax_st
from cvpr22_cross_modal_pseudo_labeling_tpu.parallel.mesh import make_mesh
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.config import get_default_cfg
from cvpr22_cross_modal_pseudo_labeling_torch.engine.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    restore_trainer,
)
from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer
from cvpr22_cross_modal_pseudo_labeling_torch.engine.trainer import do_train
from tests.test_torch_st_train import CONFIG, LOSSES, TRAIN_OPTS, JaxDraws, jax_cfg_of, tiny_batch


@pytest.fixture(autouse=True)
def no_tensorflow(monkeypatch):
    """Both writers run without tensorflow: JAX's falls back to its JSONL
    file, TensorBoard to its own stub (importing tensorflow takes most of
    a minute here)."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)


class FakeLoader:
    """``n`` batches of ``batch(i)``, with their indices."""

    def __init__(self, n, batch):
        self.n, self.batch = n, batch

    def __iter__(self):
        for i in range(self.n):
            yield self.batch(i), list(range(2))


def _steps_logged(out_dir):
    with open(os.path.join(out_dir, "tb", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def _saved_steps(out_dir):
    return sorted(int(d.split("_")[1].split(".")[0]) for d in os.listdir(out_dir) if d.startswith("model_"))


LOOP_OPTS = ["SOLVER.MAX_ITER", 3, "SOLVER.LOG_PERIOD", 1, "SOLVER.CHECKPOINT_PERIOD", 2,
             "SOLVER.TEST_PERIOD", 2]


def test_do_train_matches_jax_over_three_replayed_steps(tmp_path):
    trainer = Trainer(CONFIG, TRAIN_OPTS + ["TPU.COMPUTE_DTYPE", "float32"] + LOOP_OPTS, device="cpu", seed=3)
    tree = bridge.seeded_flax_params(trainer.model, seed=0)
    trainer.load_flax_params(tree)
    batches = FakeLoader(3, lambda i: tiny_batch(["both_branches", "image_in_neither_branch",
                                                  "no_valid_pseudo_word"][i], seed=1 + i))

    # JAX: its own loop over the jitted step, recording each step's draws
    cfg = jax_cfg_of(["TPU.COMPUTE_DTYPE", "float32"] + LOOP_OPTS)
    cfg.OUTPUT_DIR = str(tmp_path / "jax")
    model = jax_st.STGeneralizedRCNN(jax_st.st_statics_from_cfg(cfg))
    params = {"params": jax.tree_util.tree_map(jnp.asarray, tree)}
    tx, _ = jax_opt.make_optimizer(
        cfg, params["params"], jax_opt.frozen_prefixes_from_cfg(cfg, "STGeneralizedRCNN"))
    s = cfg.SOLVER
    schedule = jax_lr.warmup_multistep_schedule(s.BASE_LR, s.STEPS, s.GAMMA, s.WARMUP_FACTOR,
                                                s.WARMUP_ITERS, s.WARMUP_METHOD)
    # jitted as JAX's train_net jits it: fixed shardings on a one-device
    # mesh, so the steps after the first reuse its program
    mesh = make_mesh(("data",), (1,), devices=jax.devices()[:1])
    jstep = jax_train.jit_train_step(
        jax_train.build_train_step(model, tx, "STGeneralizedRCNN"), mesh, tiny_batch())
    draws, jax_lrs, jax_evals = [], [], []

    def jax_step(state, batch):
        jax_lrs.append(float(schedule(int(state.step))))
        rec = JaxDraws(trainer.model.statics.base.rpn_post_nms_test)
        with rec:
            state, metrics = jstep(state, batch)
            jax.block_until_ready(metrics)
        draws.append(rec.draws())
        return state, metrics

    jax_trainer.do_train(
        jax_step, jax_train.create_train_state(params, tx, jax.random.PRNGKey(0)), batches, mesh, cfg,
        eval_fn=lambda state, it: jax_evals.append(it), output_dir=cfg.OUTPUT_DIR,
    )

    # the port: the same batches, JAX's draws replayed
    replay, port_lrs, port_evals = iter(draws), [], []

    def port_step(b):
        metrics = trainer.train_step(b, next(replay))
        group = trainer.optimizer.sgd.param_groups[0]
        port_lrs.append(group["lr"] / group["lr_factor"])
        return metrics

    out = str(tmp_path / "port")
    do_train(port_step, trainer, batches, trainer.cfg, eval_fn=lambda t, it: port_evals.append(it),
             output_dir=out)

    ref, got = _steps_logged(cfg.OUTPUT_DIR), _steps_logged(out)
    assert [r["step"] for r in got] == [r["step"] for r in ref] == [1, 2, 3]
    for r, g in zip(ref, got):
        assert set(g) == set(r)
        for k in LOSSES + ("avg_uncertain", "adaptive_lamb", "total_loss"):
            np.testing.assert_allclose(g[k], r[k], rtol=1e-4, err_msg=(r["step"], k))
        assert abs(g["grad_norm"] / r["grad_norm"] - 1) < 5e-3
    np.testing.assert_allclose(port_lrs, jax_lrs, rtol=1e-7)
    assert len(port_lrs) == 3 and port_lrs[0] < port_lrs[1] < port_lrs[2]  # warmup
    assert port_evals == jax_evals == [2]
    assert _saved_steps(out) == _saved_steps(cfg.OUTPUT_DIR) == [2, 3]
    assert latest_checkpoint(out).endswith("model_0000003.pth")


class FakeTrainer:
    """What ``do_train`` reads of a ``Trainer``, around one weight."""

    meta_arch = "GeneralizedRCNN"
    device = torch.device("cpu")
    class_tables = {}

    def __init__(self):
        self.model = nn.Sequential(nn.Linear(3, 1, bias=False))
        nn.init.ones_(self.model[0].weight)
        self.steps = 0

    def host_batch(self, batch):
        return {"images": torch.as_tensor(batch["images"])}

    def state_dict(self):
        return {"model": self.model.state_dict(), "steps": self.steps}

    def load_state_dict(self, state):
        self.model.load_state_dict(state["model"])
        self.steps = state["steps"]

    def step_fn(self, nan_from=None):
        """One SGD-like update of the weight; the loss is the batch's sum,
        or NaN from update ``nan_from`` on."""

        def step(batch):
            with torch.no_grad():
                self.model[0].weight -= 0.1
            self.steps += 1
            loss = batch["images"].sum()
            if nan_from is not None and self.steps >= nan_from:
                loss = torch.tensor(float("nan"))
            return {"total_loss": loss}

        return step


def _loop_cfg(tmp_path, max_iter, log=1, ckpt=0, test=0):
    cfg = get_default_cfg()
    cfg.SOLVER.MAX_ITER = max_iter
    cfg.SOLVER.LOG_PERIOD = log
    cfg.SOLVER.CHECKPOINT_PERIOD = ckpt
    cfg.SOLVER.TEST_PERIOD = test
    cfg.OUTPUT_DIR = str(tmp_path)
    return cfg


def _loader(n=10):
    return FakeLoader(n, lambda i: {"images": np.ones((2, 4, 4, 3), np.float32) * i})


def test_do_train_loop(tmp_path):
    cfg = _loop_cfg(tmp_path, 5, log=2, ckpt=4, test=3)
    trainer, evals = FakeTrainer(), []
    do_train(trainer.step_fn(), trainer, _loader(), cfg, eval_fn=lambda t, it: evals.append(it),
             output_dir=str(tmp_path))
    assert trainer.steps == 5  # stopped at MAX_ITER
    assert evals == [3]
    assert [r["step"] for r in _steps_logged(str(tmp_path))] == [2, 4, 5]
    assert _saved_steps(str(tmp_path)) == [4, 5]
    ckpt = load_checkpoint(latest_checkpoint(str(tmp_path)))
    assert ckpt["iteration"] == 5 and ckpt["trainer"]["steps"] == 5
    assert ckpt["layouts"] == {"0.weight": "dense"} and ckpt["meta_arch"] == "GeneralizedRCNN"


def test_do_train_completed_run_trains_zero_steps(tmp_path):
    cfg = _loop_cfg(tmp_path, 3)
    for start in (3, 7):
        trainer = FakeTrainer()
        do_train(trainer.step_fn(), trainer, _loader(), cfg, output_dir=str(tmp_path), start_iter=start)
        assert trainer.steps == 0
    assert not _saved_steps(str(tmp_path))


def test_do_train_aborts_on_non_finite_loss(tmp_path):
    cfg = _loop_cfg(tmp_path, 10, log=2)
    trainer = FakeTrainer()
    with pytest.raises(FloatingPointError, match="iteration 4"):
        do_train(trainer.step_fn(nan_from=3), trainer, _loader(), cfg, output_dir=str(tmp_path / "a"))
    # the opt-out keeps the reference's log-and-continue behaviour
    cfg.SOLVER.ABORT_ON_NON_FINITE = False
    trainer = FakeTrainer()
    do_train(trainer.step_fn(nan_from=3), trainer, _loader(), cfg, output_dir=str(tmp_path / "b"))
    assert trainer.steps == 10


@pytest.mark.parametrize("ckpt,nan_from,published", [(3, 3, None), (2, 3, None), (3, 5, 3)])
def test_non_finite_abort_does_not_publish_diverged_checkpoint(tmp_path, ckpt, nan_from, published):
    """LOG_PERIOD 2.  NaN from update 3 is seen at iteration 4: a pending
    save at 3 (after the last finite check, at 2) or at exactly 2 (its
    update is not validated) is dropped and nothing is published.  NaN
    from 5 is seen at 6: the save at 3 predates the finite check at 4 and
    is published."""
    cfg = _loop_cfg(tmp_path, 10, log=2, ckpt=ckpt)
    trainer = FakeTrainer()
    with pytest.raises(FloatingPointError):
        do_train(trainer.step_fn(nan_from=nan_from), trainer, _loader(), cfg, output_dir=str(tmp_path))
    last = latest_checkpoint(str(tmp_path))
    if published is None:
        assert last is None and not _saved_steps(str(tmp_path))
    else:
        assert last.endswith(f"model_{published:07d}.pth")
        assert load_checkpoint(last)["trainer"]["steps"] == published


def test_do_train_surplus_loader_batches_respect_max_iter(tmp_path):
    cfg = _loop_cfg(tmp_path, 5)
    trainer = FakeTrainer()
    do_train(trainer.step_fn(), trainer, _loader(), cfg, output_dir=str(tmp_path), start_iter=3)
    assert trainer.steps == 2  # iterations 4 and 5 only


def _resume_trainer(max_iter):
    opts = TRAIN_OPTS + ["SOLVER.MAX_ITER", max_iter, "SOLVER.CHECKPOINT_PERIOD", 2, "SOLVER.LOG_PERIOD", 1,
                         "SOLVER.TEST_PERIOD", 0]
    return Trainer(CONFIG, opts, device="cpu", seed=5)


def _fixed_loader():
    batch = tiny_batch()
    return FakeLoader(4, lambda i: batch)


def test_resumed_run_equals_an_uninterrupted_one(tmp_path):
    straight = _resume_trainer(4)
    tree = bridge.seeded_flax_params(straight.model, seed=0)
    straight.load_flax_params(tree)
    do_train(straight.train_step, straight, _fixed_loader(), straight.cfg, output_dir=str(tmp_path / "a"))

    first = _resume_trainer(2)
    first.load_flax_params(tree)
    do_train(first.train_step, first, _fixed_loader(), first.cfg, output_dir=str(tmp_path / "b"))
    # a fresh trainer with other weights and another generator state
    resumed = _resume_trainer(4)
    resumed.load_flax_params(bridge.seeded_flax_params(resumed.model, seed=9))
    resumed.generator.manual_seed(77)
    last = latest_checkpoint(str(tmp_path / "b"))
    assert restore_trainer(resumed, load_checkpoint(last), last) == 2
    assert resumed.optimizer.updates == 2
    do_train(resumed.train_step, resumed, _fixed_loader(), resumed.cfg, output_dir=str(tmp_path / "b"),
             start_iter=2)

    a, b = straight.state_dict(), resumed.state_dict()
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    assert a["optimizer"]["updates"] == b["optimizer"]["updates"] == 4
    assert set(a["optimizer"]["momentum"]) == set(b["optimizer"]["momentum"]) != set()
    for k, v in a["optimizer"]["momentum"].items():
        assert torch.equal(v, b["optimizer"]["momentum"][k]), k
    assert torch.equal(a["generator"], b["generator"])
    assert [r["step"] for r in _steps_logged(str(tmp_path / "b"))] == [1, 2, 3, 4]
    steps_a = {r["step"]: r["total_loss"] for r in _steps_logged(str(tmp_path / "a"))}
    steps_b = {r["step"]: r["total_loss"] for r in _steps_logged(str(tmp_path / "b"))}
    assert steps_a == steps_b


def test_a_resume_without_the_optimizer_state_restarts_warmup(tmp_path):
    """What the optimizer state carries: with the weights alone the
    schedule restarts at update 0 and the next update differs."""
    trainer = _resume_trainer(2)
    trainer.load_flax_params(bridge.seeded_flax_params(trainer.model, seed=0))
    do_train(trainer.train_step, trainer, _fixed_loader(), trainer.cfg, output_dir=str(tmp_path))
    ckpt = load_checkpoint(latest_checkpoint(str(tmp_path)))
    full, weights_only = _resume_trainer(4), _resume_trainer(4)
    restore_trainer(full, ckpt)
    weights_only.model.load_state_dict(ckpt["trainer"]["model"])
    weights_only.generator.set_state(ckpt["trainer"]["generator"])
    batch = tiny_batch()
    full.step(batch)
    weights_only.step(batch)
    lr = [t.optimizer.sgd.param_groups[0]["lr"] for t in (full, weights_only)]
    assert lr[0] > lr[1]  # update 2 against update 0 of the warmup
    w = [t.model.student.box_predictor.emb_pred.weight for t in (full, weights_only)]
    assert not torch.equal(w[0], w[1])
