"""``MODEL.LANGUAGE_BACKBONE.FT_EMB`` in the port against the JAX package,
on the CPU: the student-teacher step rebuilds its LVIS table from the
live word table, so the caption branch's loss trains ``bert``.

- one step at the narrow width of ``tests/test_torch_st_train.py`` on
  the JAX program's own draws, the batch carrying the tokenized LVIS
  names in place of the table: every loss within 1e-5 relative, the
  word table's gradient within 1e-5 of the JAX gradient's norm (that
  file's tolerance for the box and mask predictors), the logged
  ``grad_norm`` within 5e-3 of JAX's (which also counts the student's
  frozen-BN leaves, as there) and counting the word table, and the word
  table's SGD update (momentum, weight decay on every row; a dense
  gradient) within 1e-5 of the update JAX's optimizer makes of the JAX
  gradient, the updated table within 2 float32 ulps of JAX's;
- ``Trainer.set_class_tables`` keeps the tokenized names integer (int64
  ids; a float32 mask), and ``val_loss`` rebuilds the table from the
  live word table;
- ``train_net`` with ``FT_EMB`` alone writes a checkpoint without an
  exemplar table, which a resume restores strictly, computing no
  constant LVIS table.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.engine import optimizer as jax_opt
from cvpr22_cross_modal_pseudo_labeling_torch.engine import checkpoint as torch_ckpt
from cvpr22_cross_modal_pseudo_labeling_torch.engine.optimizer import global_norm
from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import training_forward
from tests.tensorboard_stub import tensorboard_compat_reset  # noqa: F401  (an autouse fixture)
from tests.test_torch_st_train import LOSSES, jax_grads, make_setup, tiny_batch
from tests.test_torch_train_net import STUDENT, run, tree  # noqa: F401  (tree: a fixture)

FT_EMB = ["MODEL.LANGUAGE_BACKBONE.FT_EMB", True]
WORDS = "bert.word_embeddings"


def _rel_norm(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def ft_batch(seed=1):
    """``tiny_batch`` with the 20 LVIS rows as tokenized names (1-3 word
    pieces of the 30522 a row) in place of their table."""
    batch = tiny_batch(seed=seed)
    rng = np.random.default_rng(seed + 200)
    rows = batch.pop("lvis_class_embeddings").shape[0]
    batch["lvis_name_ids"] = rng.integers(1000, 30522, (rows, 8)).astype(np.int32)
    batch["lvis_name_mask"] = (np.arange(8)[None] < rng.integers(1, 4, (rows, 1))).astype(np.int32)
    return batch


@pytest.fixture(scope="module")
def ft():
    return make_setup("float32", FT_EMB)


def test_one_step_matches_jax_with_the_word_table_gradient_and_update(ft):
    trainer, cfg = ft["trainer"], ft["cfg"]
    words = trainer.model.bert.word_embeddings
    assert words.requires_grad and not words.is_sparse
    batch = ft_batch()
    grads, losses, _, draws = jax_grads(ft, batch)
    jax_words = np.asarray(grads["params"]["bert"]["word_embeddings"])
    assert np.abs(jax_words).max() > 0

    trainer.model.zero_grad(set_to_none=True)
    out = training_forward(trainer.model, trainer.meta_arch, trainer.device_batch(batch), draws)
    for k in LOSSES:
        np.testing.assert_allclose(out.losses[k].detach().numpy(), np.asarray(losses[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    sum(out.losses.values()).backward()
    assert _rel_norm(words.grad.numpy(), jax_words) <= 1e-5
    # a dense gradient: only the rows the names read are nonzero
    rows = np.unique(batch["lvis_name_ids"][batch["lvis_name_mask"] > 0])
    assert set(np.flatnonzero(np.abs(words.grad.numpy()).sum(1))) <= set(rows)
    port_grads = [p.grad for p in trainer.optimizer.params if p.grad is not None]
    trainer.model.zero_grad(set_to_none=True)

    tx, _ = jax_opt.make_optimizer(cfg, ft["params"]["params"],
                                   jax_opt.frozen_prefixes_from_cfg(cfg, "STGeneralizedRCNN"))
    assert not any("bert" in p for p in jax_opt.frozen_prefixes_from_cfg(cfg, "STGeneralizedRCNN"))
    updates = jax.jit(lambda g, p: tx.update(g, tx.init(p), p)[0])(grads["params"], ft["params"]["params"])
    before = words.detach().clone()
    metrics = trainer.step(batch, draws)
    # the update before it is added to the float32 table (whose ulps are
    # the update's size): -lr x the momentum trace, g + wd x p at step 1
    group = next(g for g in trainer.optimizer.sgd.param_groups if any(p is words for p in g["params"]))
    up = (-group["lr"] * trainer.optimizer.sgd.state[words]["momentum_buffer"]).numpy()
    want = np.asarray(updates["bert"]["word_embeddings"])
    assert _rel_norm(up, want) <= 1e-5
    # weight decay reaches every row, not only those with a gradient
    assert np.count_nonzero(np.abs(up).sum(1)) == up.shape[0]
    applied = np.asarray(before.numpy() + want)
    np.testing.assert_allclose(words.detach().numpy(), applied, rtol=0, atol=2 * np.spacing(np.abs(applied).max()))
    assert not torch.equal(words.detach(), before)
    # the logged norm counts the word table
    assert torch.allclose(metrics["grad_norm"], global_norm(port_grads), rtol=1e-6)
    assert "bert.word_embeddings" in trainer.optimizer.names
    ref_norm = float(jax.tree_util.tree_reduce(lambda a, g: a + float(jnp.sum(g * g)), grads["params"], 0.0)) ** 0.5
    assert abs(float(metrics["grad_norm"]) / ref_norm - 1) < 5e-3


def test_tokenized_names_stay_integer_and_val_loss_rebuilds_the_table(ft):
    trainer = ft["trainer"]
    batch = ft_batch(seed=2)
    trainer.set_class_tables(lvis_name_ids=batch.pop("lvis_name_ids"), lvis_name_mask=batch.pop("lvis_name_mask"),
                             class_embeddings=batch.pop("class_embeddings"))
    t = trainer.class_tables
    assert t["lvis_name_ids"].dtype == torch.int64 and t["lvis_name_mask"].dtype == torch.float32
    assert t["class_embeddings"].dtype == torch.float32
    b = trainer.device_batch(batch)
    assert b["lvis_name_ids"].dtype == torch.int64 and "lvis_class_embeddings" not in b
    trainer.step(batch)  # the word table moves
    got = trainer.val_loss(b)
    with torch.no_grad():
        table = trainer.model.extract_word_embeddings(t["lvis_name_ids"], t["lvis_name_mask"])
    constant = {k: v for k, v in b.items() if not k.startswith("lvis_name")}
    want = trainer.val_loss(dict(constant, lvis_class_embeddings=table))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    trainer.set_class_tables()
    trainer.load_flax_params(ft["tree"])


def test_train_net_with_ft_emb_alone_resumes_a_checkpoint_without_a_table(tree, tmp_path, monkeypatch):  # noqa: F811
    monkeypatch.setenv("CMPL_TPU_DATA_DIR", str(tree))
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    out = tmp_path / "st"
    opts = [*FT_EMB, "SOLVER.TEST_PERIOD", 0, "MODEL.LOAD_TRAINER_STATE", True, "SOLVER.CHECKPOINT_PERIOD", 1]
    first = run(STUDENT, out, *opts, "SOLVER.MAX_ITER", 1)["trainer"]
    assert first.exemplars is None
    saved = torch_ckpt.load_checkpoint(str(out / "model_0000001.pth"))
    assert "exemplars" not in saved["trainer"]
    rec = run(STUDENT, out, *opts, "SOLVER.MAX_ITER", 2)
    assert rec["start_iter"] == 1 and rec["trainer"].optimizer.updates == 2
    text = (out / "log.txt.rank0").read_text().split("resumed from")[-1]
    assert "LVIS class names tokenized" in text and "LVIS class-name table" not in text
    assert not torch.equal(rec["trainer"].model.bert.word_embeddings.detach(),
                           saved["trainer"]["model"][WORDS])
