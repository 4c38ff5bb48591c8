"""The student-teacher model's exemplar table (``MODEL.EXEMPLARS_ENABLED``)
in the port against the JAX package, on the CPU.

- ``update_exemplar_table`` over three successive updates of a 10-slot
  table: ties in quality (the first occurrence wins), invalid rows,
  repeated labels, labels off the table (clipped), a slot whose stored
  quality beats the batch; ``valid`` and ``quality`` exactly, ``embs``
  within 1e-6;
- ``combine_embs`` with a table: the mixed table within 1e-6, the
  gradient to ``lambda_exemplar`` within 1e-5 relative, none to the
  base table;
- two ``Trainer`` steps with the table against two steps of JAX's
  jitted ``build_train_step`` carrying it in ``TrainState.extra``, on the
  JAX program's own draws and the tiny batches of
  ``tests/test_torch_st_train.py`` (with a 1203-row LVIS table and the
  dataset classes' LVIS slots): losses within 1e-4 relative (the
  tolerance of that file's steps), the table after each step (``valid``
  exactly, ``quality`` within 1e-6, ``embs`` within 1e-5) and
  ``lambda_exemplar`` after each update within 1e-4 relative;
- ``Trainer.val_loss`` neither mixes nor updates the table;
- ``train_net`` with ``EXEMPLARS_ENABLED`` and ``FT_EMB``: 2 steps, a
  save and a resume to 3 give the table, the word table and every
  weight of an uninterrupted 3-step run, bit for bit; a checkpoint
  without the table does not restore into a trainer that has one, nor
  one with the table into a trainer without.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.engine import optimizer as jax_opt
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import train_step as jax_train
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import st_generalized_rcnn as jax_st
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.engine import checkpoint as torch_ckpt
from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector import st_generalized_rcnn as torch_st
from tests.tensorboard_stub import tensorboard_compat_reset  # noqa: F401  (an autouse fixture)
from tests.test_torch_st_train import CONFIG, LOSSES, TRAIN_OPTS, JaxDraws, make_setup, tiny_batch
from tests.test_torch_train_net import STUDENT, TINY, run, tree  # noqa: F401  (tree: a fixture)

EXEMPLARS = ["MODEL.EXEMPLARS_ENABLED", True]
LVIS = 1203


def _table(tbl):
    return {k: np.asarray(v) for k, v in tbl.items()}


def _update_inputs():
    """Three batches of candidates for a 10-slot, 8-wide table."""
    rng = np.random.default_rng(0)
    d = 8
    out = []
    # 1: slot 2 twice with equal quality (the first wins), slot 4 twice
    # (the better wins), an invalid row with the best score, labels -3
    # and 12 clipped onto slots 0 and 9
    out.append(dict(labels=np.array([2, 4, 2, 4, 7, -3, 12, 5], np.int32),
                    scores=np.float32([0.6, 0.3, 0.6, 0.8, 0.99, 0.5, 0.4, 0.2]),
                    valid=np.array([1, 1, 1, 1, 0, 1, 1, 1], bool)))
    # 2: slot 4 stored 0.8 beats 0.7 (kept); slot 2 improves; slot 7
    # valid now; slot 5 ties its stored 0.2 (strictly better only: kept)
    out.append(dict(labels=np.array([4, 2, 7, 7, 5, 1], np.int32),
                    scores=np.float32([0.7, 0.65, 0.1, 0.1, 0.2, 0.05]),
                    valid=np.array([1, 1, 1, 1, 1, 0], bool)))
    # 3: random, with repeats
    out.append(dict(labels=rng.integers(-1, 11, 12).astype(np.int32),
                    scores=rng.uniform(0, 1, 12).astype(np.float32),
                    valid=rng.uniform(size=12) < 0.7))
    for o in out:
        o["embs"] = rng.standard_normal((len(o["labels"]), d)).astype(np.float32)
    return out


def test_update_exemplar_table_matches_jax_over_three_updates():
    ref = jax_st.init_exemplar_table(10, 8)
    got = torch_st.init_exemplar_table(10, 8)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    for i, c in enumerate(_update_inputs()):
        ref = jax_st.update_exemplar_table(ref, *(jnp.asarray(c[k]) for k in ("labels", "scores", "embs", "valid")))
        got = torch_st.update_exemplar_table(got, *(torch.from_numpy(c[k]) for k in ("labels", "scores", "embs",
                                                                                     "valid")))
        r = _table(ref)
        np.testing.assert_array_equal(got["valid"].numpy(), r["valid"], err_msg=str(i))
        np.testing.assert_array_equal(got["quality"].numpy(), r["quality"], err_msg=str(i))
        np.testing.assert_allclose(got["embs"].numpy(), r["embs"], rtol=0, atol=1e-6, err_msg=str(i))
        if i == 0:
            # the first of the tied slot-2 rows, the better slot-4 row
            np.testing.assert_allclose(got["embs"][2].numpy(), c["embs"][0] / np.linalg.norm(c["embs"][0]),
                                       atol=1e-6)
            assert got["quality"][4] == np.float32(0.8) and not got["valid"][7]
            assert got["valid"][0] and got["valid"][9]
        if i == 1:
            assert got["quality"][4] == np.float32(0.8) and got["quality"][5] == np.float32(0.2)
            assert got["valid"][7] and got["quality"][2] == np.float32(0.65)
    assert got["embs"].dtype == torch.float32 and got["valid"].dtype == torch.bool


@pytest.fixture(scope="module")
def ex_setup():
    """The tiny ST trainer with the table and the JAX model, same weights."""
    return make_setup("float32", EXEMPLARS)


def test_combine_embs_with_exemplars_matches_jax(ex_setup):
    rng = np.random.default_rng(3)
    base = rng.standard_normal((12, 16)).astype(np.float32)
    ex = rng.standard_normal((12, 16)).astype(np.float32)
    valid = rng.uniform(size=12) < 0.5
    cot = rng.standard_normal((12, 16)).astype(np.float32)
    lam = np.float32([0.3])
    jm, params = ex_setup["model"], ex_setup["params"]

    def f(lam_, base_):
        p = {"params": dict(params["params"], lambda_exemplar=lam_)}
        out = jm.apply(p, base_, jnp.asarray(ex), jnp.asarray(valid), method=jax_st.STGeneralizedRCNN.combine_embs)
        return jnp.sum(out * cot), out

    (_, ref), (g_lam, g_base) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(jnp.asarray(lam),
                                                                                      jnp.asarray(base))
    model = ex_setup["trainer"].model
    with torch.no_grad():
        model.lambda_exemplar.copy_(torch.from_numpy(lam))
    tb = torch.from_numpy(base).requires_grad_(True)
    model.lambda_exemplar.grad = None
    out = model.combine_embs(tb, torch.from_numpy(ex), torch.from_numpy(valid))
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(model.lambda_exemplar.grad.numpy(), np.asarray(g_lam), rtol=1e-5)
    assert tb.grad is None and not np.asarray(g_base).any()
    assert float(np.abs(np.asarray(g_lam)).max()) > 0
    with torch.no_grad():
        model.lambda_exemplar.zero_()
    model.lambda_exemplar.grad = None


def ex_batch(variant, seed):
    """``tiny_batch`` with a 1203-row LVIS table (the table's size) and
    the dataset classes' LVIS slots: two of the batch's valid caption
    nouns' slots, and classes that are no LVIS noun (-1)."""
    batch = tiny_batch(variant, seed=seed)
    rng = np.random.default_rng(seed + 100)
    batch["lvis_class_embeddings"] = rng.standard_normal((LVIS, 16)).astype(np.float32)
    lab = batch["cap_labels"]
    batch["class_lvis_ids"] = np.array([-1, lab[0, 0], lab[1, 0], -1, 400, lab[0, 1]], np.int32)
    return batch


def test_two_steps_with_the_table_match_jax_train_step(ex_setup):
    setup = ex_setup
    trainer, cfg = setup["trainer"], setup["cfg"]
    trainer.load_flax_params(setup["tree"])
    trainer.exemplars = torch_st.init_exemplar_table(LVIS, 16)
    tx, _ = jax_opt.make_optimizer(
        cfg, setup["params"]["params"], jax_opt.frozen_prefixes_from_cfg(cfg, "STGeneralizedRCNN"))
    state = jax_train.create_train_state(setup["params"], tx, jax.random.PRNGKey(0),
                                         extra=jax_st.init_exemplar_table(LVIS, 16))
    step = jax.jit(jax_train.build_train_step(setup["model"], tx, "STGeneralizedRCNN"))
    lams = []
    for it, variant in enumerate(["both_branches", "both_branches"]):
        batch = ex_batch(variant, seed=1 + it)
        rec = JaxDraws(trainer.model.statics.base.rpn_post_nms_test)
        with rec:
            state, metrics = step(state, jax.tree_util.tree_map(jnp.asarray, batch))
            jax.block_until_ready(state.params)
        assert "exemplars" not in metrics
        got = trainer.step(batch, rec.draws())
        assert "exemplars" not in got
        for k in LOSSES + ("total_loss",):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(metrics[k]), rtol=1e-4, err_msg=f"{it} {k}")
        ref = _table(state.extra)
        np.testing.assert_array_equal(trainer.exemplars["valid"].numpy(), ref["valid"])
        np.testing.assert_allclose(trainer.exemplars["quality"].numpy(), ref["quality"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(trainer.exemplars["embs"].numpy(), ref["embs"], rtol=0, atol=1e-5)
        lam = np.asarray(state.params["params"]["lambda_exemplar"])
        np.testing.assert_allclose(trainer.model.lambda_exemplar.detach().numpy(), lam, rtol=1e-4)
        lams.append(float(lam[0]))
    # three valid nouns on distinct slots a step; the second step's
    # detection branch mixed the first step's slots in (lambda moved)
    assert 3 <= int(trainer.exemplars["valid"].sum()) <= 6 and lams[0] != 0 and lams[1] != lams[0]

    # the validation-loss pass passes no table: the same losses as a
    # trainer without one, and the table as it was
    before = {k: v.clone() for k, v in trainer.exemplars.items()}
    plain = Trainer(CONFIG, TRAIN_OPTS, device="cpu", seed=3)
    plain.model.load_state_dict(trainer.model.state_dict())
    batch = ex_batch("both_branches", seed=5)
    got, want = (t.val_loss(t.device_batch(batch)) for t in (trainer, plain))
    assert set(got) == set(want) and "exemplars" not in got
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for k in before:
        assert torch.equal(trainer.exemplars[k], before[k]), k


def test_train_net_with_both_options_resumes_bit_for_bit(tree, tmp_path, monkeypatch):  # noqa: F811
    """2 steps and a save, then a resume to 3, against 3 steps in one run.
    The sampler reshuffles from the iteration a run starts at (the
    reference's iteration-seeded epochs), so the resumed stream equals the
    uninterrupted one only from an epoch boundary: here every 2 iterations
    (the 8 train images in batches of 4, ungrouped).  Flips off: the
    augmentation's draws come from a per-visit seed that differs from run
    to run."""
    monkeypatch.setenv("CMPL_TPU_DATA_DIR", str(tree))
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    opts = [*EXEMPLARS, "MODEL.LANGUAGE_BACKBONE.FT_EMB", True, "SOLVER.TEST_PERIOD", 0,
            "MODEL.LOAD_TRAINER_STATE", True, "SOLVER.CHECKPOINT_PERIOD", 0, "SOLVER.IMS_PER_BATCH", 4,
            "DATALOADER.ASPECT_RATIO_GROUPING", False, "INPUT.HORIZONTAL_FLIP_PROB_TRAIN", 0.0]
    whole = run(STUDENT, tmp_path / "whole", *opts, "SOLVER.MAX_ITER", 3)["trainer"]
    split = tmp_path / "split"
    first = run(STUDENT, split, *opts, "SOLVER.MAX_ITER", 2)["trainer"]
    assert int(first.exemplars["valid"].sum()) > 0
    log = (split / "log.txt.rank0").read_text()
    assert "exemplar table initialized: 1203 slots x 768 dims" in log
    assert "LVIS class names tokenized" in log and "LVIS class-name table" not in log
    assert first.class_tables["lvis_name_ids"].dtype == torch.int64
    assert first.class_tables["class_lvis_ids"].dtype == torch.int64
    saved = torch_ckpt.load_checkpoint(str(split / "model_0000002.pth"))["trainer"]
    assert saved["exemplars"]["valid"].dtype == torch.bool
    rec = run(STUDENT, split, *opts, "SOLVER.MAX_ITER", 3)
    resumed = rec["trainer"]
    assert rec["start_iter"] == 2 and resumed.optimizer.updates == 3
    assert "LVIS class names tokenized" in (split / "log.txt.rank0").read_text().split("resumed from")[-1]
    for k in whole.exemplars:
        assert torch.equal(resumed.exemplars[k], whole.exemplars[k]), k
    want = whole.model.state_dict()
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert not torch.equal(resumed.model.bert.word_embeddings.detach(), saved["model"]["bert.word_embeddings"])
    # a table run refuses a checkpoint without the table, and the reverse
    state = resumed.state_dict()
    no_table = {k: v for k, v in state.items() if k != "exemplars"}
    with pytest.raises(KeyError, match="exemplar table"):
        resumed.load_state_dict(no_table)
    plain = Trainer(STUDENT, [*TINY, "MODEL.LANGUAGE_BACKBONE.FT_EMB", True], device="cpu")
    with pytest.raises(KeyError, match="exemplar table"):
        plain.load_state_dict(state)
