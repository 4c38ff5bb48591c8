"""JAX-trained orbax checkpoints in the port, against the JAX package.

``tools/orbax_to_npz.py`` dumps an orbax checkpoint where jax runs; the
port's ``engine/jax_checkpoint.py`` and ``tools/import_jax_checkpoint.py``
make a port checkpoint of the dump.  Four optimizer chains of JAX's
``make_optimizer`` (``tpu/engine/optimizer.py:81``), each over the seeded
tree of a narrow port model:

- ``teacher``: ``zeroshot_mask.yaml`` at the tiny widths of
  ``tests/test_torch_train_net.py`` (``TINY``: the RoI head's embedding at
  the synthetic tree's 768 dims, so that ``train_net`` runs on it);
- ``st_table``: the student-teacher config likewise, with the exemplar
  table; ``UNCERTAINTY`` wraps the uncertain labels in ``_freeze_after``;
- ``mmss_clip``: ``mmss.yaml``'s optimizer (``CLIP_GRAD_NORM_AT`` 5: the
  ``multi_transform`` inside an outer chain) over the narrow MMSS model of
  ``tests/test_torch_mmss.py`` with res2 256 (the C5 stage and ``v_dim``
  2048, the RoI head's width, so that its ``layer4`` and ``v2l`` land on a
  teacher), which no config builds: its import runs
  ``import_jax_checkpoint.convert`` on a ``Trainer`` of that model;
- ``teacher_accum``: the teacher with ``GRADIENT_ACCUMULATION_STEPS`` 2
  (``MultiSteps``), saved between its two micro-steps.

JAX's ``create_train_state`` makes the state; every trace and
accumulated gradient is filled with seeded draws, every count set to N = 5
(the iteration 2N + 1 under accumulation, with ``mini_step`` 1), and JAX's
own ``save_checkpoint`` writes it.  Then:

(a) the port checkpoint's parameters, momentum, ``updates``, micro-step,
    accumulated gradients and exemplar table equal the JAX state's bit
    for bit after the layout change;
(b) one update with the same seeded gradients moves the port's
    parameters and momentum as ``tx.update`` and ``optax.apply_updates``
    move JAX's: max abs diff <= 1e-6 x the leaf's max|value|, float32;
(c) the port's ``import_external_weights`` of the dump equals JAX's of the
    orbax directory leaf for leaf (MMSS -> teacher with
    ``LOAD_EMB_PRED_FROM_MMSS_HEAD``, teacher -> student), and so does
    ``import_language_table`` (MMSS's BERT table -> a student whose table
    has MMSS's shape);
(d) ``train_net --device cpu`` resumes from the converted directory and
    logs ``resumed from ... at iteration N``;
(e) a dump with a trace left out or added, a parameter left out or of
    another shape, counts that disagree, an optimizer leaf of another
    chain, accumulation or an exemplar table the trainer's config lacks,
    or another ``meta_arch``'s tree raises, naming the leaf.

``chip_smoke.py``'s dump writer gives the real dump's keys, shapes and
dtypes for the teacher and the student-teacher model.  The dump widens
bfloat16 leaves and unwraps typed PRNG keys, and records both.  No JAX model
program is built: each state is one jitted ``create_train_state``, and
(b)'s update one jitted optimizer program.
"""

import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.config import get_default_cfg as jax_cfg
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import checkpoint as jax_ckpt
from cvpr22_cross_modal_pseudo_labeling_tpu.engine.optimizer import frozen_prefixes_from_cfg, make_optimizer
from cvpr22_cross_modal_pseudo_labeling_tpu.engine.train_step import create_train_state
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.engine import checkpoint as torch_ckpt
from cvpr22_cross_modal_pseudo_labeling_torch.engine import jax_checkpoint as jck
from cvpr22_cross_modal_pseudo_labeling_torch.engine.inference import load_cfg
from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector import build_detection_model
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector import st_generalized_rcnn as torch_st
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.mmss_gcnn import MMSSGridModel
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.statics import RCNNStatics
from cvpr22_cross_modal_pseudo_labeling_torch.tools import import_jax_checkpoint, train_net
from tests.tensorboard_stub import tensorboard_compat_reset  # noqa: F401  (an autouse fixture)
from tests.test_torch_mmss import narrow_statics
from tests.test_torch_train_net import STUDENT, TEACHER, TINY, tree  # noqa: F401  (tree: a fixture)
from tools import orbax_to_npz

import chip_smoke

REPO = Path(__file__).resolve().parents[1]
MMSS = str(REPO / "configs/coco_cap_det/mmss.yaml")
N = 5  # the updates of every saved state
# (config, opts, the narrow model no config builds, micro-step, iteration)
CHAINS = {
    "teacher": (TEACHER, TINY, None, None, N),
    "st_table": (STUDENT, TINY + ["MODEL.EXEMPLARS_ENABLED", True], None, None, N),
    "mmss_clip": (MMSS, ["TPU.COMPUTE_DTYPE", "float32"], "mmss", None, N),
    "teacher_accum": (TEACHER, TINY + ["SOLVER.GRADIENT_ACCUMULATION_STEPS", 2], None, 1, 2 * N + 1),
}


def mmss_model():
    return MMSSGridModel(narrow_statics(
        backbone=RCNNStatics(conv_body="R-50-C5", stem_out_channels=8, res2_out_channels=256, width_per_group=4,
                             compute_dtype="float32"),
        v_dim=2048))


def make_trainer(name, seed=0):
    config, opts, model, _, _ = CHAINS[name]
    return Trainer(config, opts, device="cpu", seed=seed, model=mmss_model() if model else None)


def jax_cfg_of(config, opts):
    cfg = jax_cfg()
    cfg.merge_from_file(config)
    cfg.merge_from_list(list(opts))
    return cfg


def key_names(path):
    return [str(getattr(k, "name", getattr(k, "key", getattr(k, "idx", k)))) for k in path]


def state_leaves(tree):
    """("/"-joined names, array) of every leaf of a JAX pytree."""
    return [("/".join(key_names(p)), v) for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def fill(opt_state, rng, micro):
    """The optax state with seeded traces and accumulated gradients and
    every count N (``mini_step`` ``micro``)."""

    def leaf(path, x):
        names = key_names(path)
        if "trace" in names or "acc_grads" in names:
            return jnp.asarray(rng.standard_normal(x.shape, np.float32) * np.float32(0.01))
        if names[-1] in ("count", "gradient_step"):
            return jnp.asarray(N, x.dtype)
        assert names[-1] == "mini_step", names
        return jnp.asarray(micro, x.dtype)

    return jax.tree_util.tree_map_with_path(leaf, opt_state)


class Chain:
    """One chain: JAX's state saved by JAX, dumped and imported."""

    def __init__(self, name, root):
        config, opts, _, micro, iteration = CHAINS[name]
        self.name, self.config, self.opts, self.micro, self.iteration = name, config, opts, micro, iteration
        self.trainer = make_trainer(name)
        self.params = bridge.seeded_flax_params(self.trainer.model, 3)  # not the import's seed-0 draw
        self.jcfg = jax_cfg_of(config, opts)
        meta = self.jcfg.MODEL.META_ARCHITECTURE
        self.tx, _ = make_optimizer(self.jcfg, self.params, frozen_prefixes_from_cfg(self.jcfg, meta))
        rng = np.random.default_rng(11)
        extra = None
        if self.trainer.exemplars is not None:
            v, d = self.trainer.exemplars["embs"].shape
            valid = rng.random(v) < 0.5
            extra = {"embs": np.where(valid[:, None], rng.standard_normal((v, d), np.float32), 0).astype(np.float32),
                     "quality": np.where(valid, rng.random(v, np.float32), -np.inf).astype(np.float32),
                     "valid": valid}
        # jitted: one program's compile in place of an eager zeros_like's
        # compile per leaf shape
        state = jax.jit(create_train_state, static_argnums=1)({"params": self.params}, self.tx,
                                                              jax.random.PRNGKey(42), extra)
        self.state = state.replace(opt_state=fill(state.opt_state, rng, micro), step=jnp.int32(iteration))
        self.jax_dir, self.dump, self.port_dir = root / "jax_out", root / "dump.npz", root / "port_out"
        jax_ckpt.save_checkpoint(str(self.jax_dir), {"state": self.state, "iteration": iteration}, iteration)
        orbax_to_npz.main([str(self.jax_dir), "--out", str(self.dump)])
        if CHAINS[name][2]:
            self.logs = []
            got = import_jax_checkpoint.convert(make_trainer(name), str(self.dump), str(self.port_dir), 0,
                                                self.logs.append)
        else:
            got = import_jax_checkpoint.main(["--config-file", config, "--dump", str(self.dump), "--out",
                                              str(self.port_dir), "--device", "cpu", "--seed", "0",
                                              *map(str, opts)])
        self.ckpt = got["path"]
        self.modules = dict(self.trainer.model.named_modules())

    def port(self, path, value):
        """A flax-layout array of ``path`` in the port's layout."""
        key, kind = bridge._port_key(self.modules, tuple(path.split("/")))
        return key, torch.from_numpy(np.array(bridge._to_port(np.asarray(value), kind), order="C"))

    def named(self, tree, field):
        """{port name: port-layout tensor} of the leaves under ``field``
        (``trace``, ``acc_grads``) of an optax state."""
        out = {}
        for names, v in state_leaves(tree):
            parts = names.split("/")
            if field in parts:
                key, t = self.port("/".join(parts[parts.index(field) + 1:]), v)
                out[key] = t
        return out


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    built = {}

    def get(name):
        if name not in built:
            built[name] = Chain(name, tmp_path_factory.mktemp(name))
        return built[name]

    return get


@pytest.mark.parametrize("name", list(CHAINS))
def test_port_checkpoint_equals_the_jax_state(chains, name):
    c = chains(name)
    blob = torch_ckpt.load_checkpoint(c.ckpt)
    assert blob["iteration"] == c.iteration and blob["meta_arch"] == c.jcfg.MODEL.META_ARCHITECTURE
    model, opt = blob["trainer"]["model"], blob["trainer"]["optimizer"]
    want = bridge.state_dict_from_flax(c.trainer.model, c.params)
    assert set(model) == set(want)
    for k in want:
        assert torch.equal(model[k], want[k]), k
    momentum = c.named(c.state.opt_state, "trace")
    assert set(opt["momentum"]) == set(momentum) == set(c.trainer.optimizer.names)
    for k, v in momentum.items():
        assert torch.equal(opt["momentum"][k], v), k
    assert opt["updates"] == N and opt["micro"] == (c.micro or 0)
    if c.micro:
        acc = c.named(c.state.opt_state, "acc_grads")
        assert set(opt["acc"]) == set(c.trainer.optimizer.names)
        for k in opt["acc"]:
            assert torch.equal(opt["acc"][k], acc[k]), k
    else:
        assert opt["acc"] == {}
    if c.state.extra is not None:
        table = blob["trainer"]["exemplars"]
        assert set(table) == set(c.state.extra)
        for k, v in c.state.extra.items():
            np.testing.assert_array_equal(table[k].numpy(), np.asarray(v), err_msg=k)
    else:
        assert "exemplars" not in blob["trainer"]


@pytest.mark.parametrize("name", list(CHAINS))
def test_one_update_matches_optax(chains, name):
    c = chains(name)
    trainer = make_trainer(name, seed=1)
    torch_ckpt.restore_trainer(trainer, torch_ckpt.load_checkpoint(c.ckpt), c.ckpt)
    rng = np.random.default_rng(17)
    grads = jax.tree_util.tree_map(lambda x: rng.standard_normal(x.shape, np.float32), c.params)

    def update(g, state, p):
        updates, state = c.tx.update(g, state, p)
        return optax.apply_updates(p, updates), state

    # one jitted optimizer program: its compile costs less than the eager
    # update's op-by-op compiles
    params, opt_state = jax.tree_util.tree_map(np.asarray, jax.jit(update)(grads, c.state.opt_state, c.params))
    flat_grads = {"/".join(p): g for p, g in torch_ckpt._flatten_params(grads).items()}
    for n, p in zip(trainer.optimizer.names, trainer.optimizer.params):
        path, _ = bridge._flax_path(c.modules, n)
        p.grad = c.port("/".join(path), flat_grads["/".join(path)])[1]
    trainer.optimizer.step()
    assert trainer.optimizer.updates == N + 1 and trainer.optimizer._micro == 0
    got = trainer.model.state_dict()
    for path, v in torch_ckpt._flatten_params(params).items():
        key, want = c.port("/".join(path), v)
        limit = 1e-6 * float(want.abs().max())
        assert float((got[key] - want).abs().max()) <= limit, key
    momentum = c.named(opt_state, "trace")
    by_name = dict(zip(trainer.optimizer.names, trainer.optimizer.params))
    for key, want in momentum.items():
        buf = trainer.optimizer.sgd.state[by_name[key]]["momentum_buffer"]
        assert float((buf - want).abs().max()) <= 1e-6 * float(want.abs().max()), key


def _tree_equal(got, want):
    got, want = torch_ckpt._flatten_params(got), torch_ckpt._flatten_params(want)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg="/".join(k))


def _target(config, opts, seed=7):
    return bridge.seeded_flax_params(build_detection_model(load_cfg(config, list(opts))), seed)


@pytest.mark.parametrize("route", ["mmss_to_teacher", "teacher_to_student"])
def test_import_external_weights_matches_jax(chains, route):
    if route == "mmss_to_teacher":
        src = chains("mmss_clip")
        config = TEACHER
        opts = TINY + ["MODEL.RESNETS.RES2_OUT_CHANNELS", 256, "MODEL.ROI_BOX_HEAD.EMB_DIM", 64,
                       "MODEL.LOAD_EMB_PRED_FROM_MMSS_HEAD", True]
    else:
        src, config, opts = chains("teacher"), STUDENT, TINY
    target = _target(config, opts)
    got, msg = torch_ckpt.import_external_weights(target, str(src.dump), load_cfg(config, opts))
    want, jax_msg = jax_ckpt.import_external_weights(target, str(src.jax_dir), jax_cfg_of(config, opts))
    _tree_equal(got, jax.tree_util.tree_map(np.asarray, want))
    matched = int(jax_msg.split()[1])
    assert msg.startswith(f"imported {matched} leaves from JAX dump {src.dump} (") and matched > 0
    if route == "mmss_to_teacher":
        # the C5 layer4 on the RoI extractor and v2l on emb_pred
        mmss = torch_ckpt._flatten_params(src.params)
        flat = torch_ckpt._flatten_params(got)
        for path, v in mmss.items():
            if path[:3] == ("backbone", "body", "layer4"):
                np.testing.assert_array_equal(flat[("roi_extractor",) + path[2:]], v)
        np.testing.assert_array_equal(flat[("box_predictor", "emb_pred", "kernel")],
                                      mmss[("v2l_projection", "kernel")])


def test_import_language_table_matches_jax(chains):
    """MMSS's BERT table into a student-teacher model whose table has its
    shape (the narrow vocabulary of 128 words at 64 dims)."""
    src = chains("mmss_clip")
    statics = torch_st.st_statics_from_cfg(load_cfg(STUDENT, TINY + ["MODEL.ROI_BOX_HEAD.EMB_DIM", 64]))
    target = bridge.seeded_flax_params(torch_st.STGeneralizedRCNN(statics._replace(vocab_size=128)), 7)
    got, report = torch_ckpt.import_language_table(target, str(src.dump))
    want, jax_report = jax_ckpt.import_language_table(target, str(src.jax_dir))
    _tree_equal(got, want)
    assert report["matched"] == jax_report["matched"] == 1
    for k in ("missed_source_keys", "unfilled_targets"):
        assert sorted(report[k]) == sorted(jax_report[k]), k
    np.testing.assert_array_equal(got["bert"]["word_embeddings"],
                                  src.params["language_backbone"]["word_embeddings"])


@pytest.mark.parametrize("name", ["teacher", "st_table", "teacher_accum"])
def test_train_net_resumes_the_converted_checkpoint(chains, name, tree, tmp_path, monkeypatch):
    monkeypatch.setenv("CMPL_TPU_DATA_DIR", str(tree))
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    c = chains(name)
    out = tmp_path / "resume"
    shutil.copytree(c.port_dir, out)
    rec = train_net.main(["--config-file", c.config, "--skip-test", "--device", "cpu", *map(str, c.opts),
                          "SOLVER.MAX_ITER", str(c.iteration + 1), "MODEL.LOAD_TRAINER_STATE", "True",
                          "SOLVER.TEST_PERIOD", "0", "OUTPUT_DIR", str(out)])
    log = (out / "log.txt.rank0").read_text()
    assert f"resumed from {out}/model_{c.iteration:07d}.pth at iteration {c.iteration}" in log
    assert "not carried: JAX's rng key [0, 42]" in log  # the import's lines, in the same log
    assert rec["start_iter"] == c.iteration
    assert rec["trainer"].optimizer.updates == N + 1 and rec["trainer"].optimizer._micro == 0
    assert (out / f"model_{c.iteration + 1:07d}.pth").exists()


def _first(flat, part):
    return sorted(k for k in flat if part in k)[0]


@pytest.mark.parametrize("case", ["trace_left_out", "stray_trace", "param_left_out", "other_shape",
                                  "counts_disagree", "adam_state", "accumulation", "table_without_the_option",
                                  "other_meta_arch"])
def test_unmatched_dumps_raise_naming_the_leaf(chains, case):
    c = chains("st_table" if case == "table_without_the_option" else "teacher")
    flat, trainer = jck.read_dump(str(c.dump)), c.trainer
    if case == "trace_left_out":
        key = _first(flat, "/trace/box_predictor/bbox_pred/kernel")
        del flat[key]
        match = r"without a momentum trace: box_predictor\.bbox_pred\.weight .*box_predictor/bbox_pred/kernel"
    elif case == "stray_trace":
        key = _first(flat, "/trace/rpn_head/conv/bias").replace("rpn_head/conv/bias", "rpn_head/extra/bias")
        flat[key] = np.zeros(3, np.float32)
        match = "momentum traces with no trainable port parameter: " + key
    elif case == "param_left_out":
        del flat["state/params/params/rpn_head/conv/bias"]
        match = "leaves 1 parameters unfilled: rpn_head/conv/bias"
    elif case == "other_shape":
        flat["state/params/params/rpn_head/conv/bias"] = np.zeros(3, np.float32)
        match = r"rpn_head/conv/bias \(3,\)"
    elif case == "counts_disagree":
        key = _first(flat, "/count")
        flat[key] = np.asarray(N + 1, np.int32)
        match = f"counts disagree: .*{key} = {N + 1}"
    elif case == "adam_state":
        flat["state/opt_state/0/mu/rpn_head/conv/bias"] = np.zeros(64, np.float32)
        match = "no part of make_optimizer's chain: .*state/opt_state/0/mu/rpn_head/conv/bias"
    elif case == "accumulation":
        trainer = chains("teacher_accum").trainer
        match = "this trainer accumulates 2 micro-steps"
    elif case == "table_without_the_option":
        trainer = Trainer(STUDENT, TINY, device="cpu")
        match = r"holds an exemplar table .*this trainer has none"
    else:
        trainer = chains("st_table").trainer
        match = r"does not hold a STGeneralizedRCNN model .*box_predictor/"
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    with pytest.raises((RuntimeError, ValueError), match=match):
        jck.load_into_trainer(trainer, flat, lambda _: None)
    assert all(torch.equal(v, before[k]) for k, v in trainer.model.state_dict().items())


def test_an_eval_dump_loads_as_weights_only(chains, tmp_path):
    """A bare parameter tree: the optimizer stays fresh, iteration 0, and
    the leaves it lacks keep the trainer's values, listed in the log."""
    c = chains("teacher")
    params = dict(c.params)
    del params["rpn_head"]
    jax_ckpt.save_checkpoint(str(tmp_path / "eval"), {"params": {"params": params}}, 0)
    info = orbax_to_npz.main([str(tmp_path / "eval"), "--out", str(tmp_path / "eval.npz")])
    assert info["iteration"] == -1
    trainer = make_trainer("teacher")
    kept = {k: v.clone() for k, v in trainer.model.state_dict().items() if k.startswith("rpn_head.")}
    logs = []
    assert jck.load_into_trainer(trainer, jck.read_dump(str(tmp_path / "eval.npz")), logs.append) == 0
    assert trainer.optimizer.updates == 0 and not trainer.optimizer.sgd.state
    assert "weights only" in logs[0] and "6 leaves it lacks keep their values" in logs[0] and "rpn_head/bbox_pred/bias" in logs[0]
    sd = trainer.model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in kept.items())
    assert torch.equal(sd["roi_extractor.layer4.block0.conv1.weight"],
                       c.port("roi_extractor/layer4/block0/conv1/kernel",
                              c.params["roi_extractor"]["layer4"]["block0"]["conv1"]["kernel"])[1])


@pytest.mark.parametrize("name", ["teacher", "st_table"])
def test_chip_smoke_dump_writer_is_the_real_dump(chains, name):
    c = chains(name)
    real = jck.read_dump(str(c.dump))
    made = chip_smoke.jax_train_state_dump(c.trainer, 0, N, "made")
    assert made.keys() == real.keys()
    for k, v in real.items():
        assert made[k].shape == v.shape, k
        assert made[k].dtype == v.dtype or made[k].dtype.kind == v.dtype.kind == "U", k
    # what the writer's arrays mean: the import reads them as it reads
    # JAX's, every count N and one trace a trainable parameter
    traces, counts, micro, acc = jck.optimizer_leaves(made)
    assert set(counts.values()) == {N} and micro is None and not acc
    assert len(traces) == len(c.trainer.optimizer.names)


def test_orbax_to_npz_widens_bfloat16_and_unwraps_typed_keys(tmp_path):
    """Every array of the dump is of a dtype numpy reads alone, and the
    dump records what it changed."""
    tree = {"state": {"w": jnp.full((2, 3), 1.5, jnp.bfloat16), "n": jnp.arange(3, dtype=jnp.int32),
                      "rng": jax.random.key(7)}, "iteration": 3}
    jax_ckpt.save_checkpoint(str(tmp_path / "jax_out"), tree, 3)
    info = orbax_to_npz.main([str(tmp_path / "jax_out"), "--out", str(tmp_path / "d.npz")])
    assert info["iteration"] == 3 and info["widened"] == ["state/w"] and info["key_data"] == ["state/rng"]
    flat = jck.read_dump(str(tmp_path / "d.npz"))
    assert flat["state/w"].dtype == np.float32 and (flat["state/w"] == 1.5).all()
    np.testing.assert_array_equal(flat["state/rng"], np.asarray(jax.random.key_data(jax.random.key(7))))
    np.testing.assert_array_equal(flat["state/n"], np.arange(3, dtype=np.int32))
    assert list(flat["__dump__/widened_from"]) == ["bfloat16"]
    assert str(flat["__dump__/source"]) == str(tmp_path / "jax_out" / "model_0000003")
