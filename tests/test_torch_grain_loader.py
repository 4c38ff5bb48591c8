"""The port's grain stream (``data/index_shuffle.py``,
``data/grain_loader.py``) against grain and the JAX package's
``GrainLoader``, and ``train_net`` resumed mid-epoch under
``DATALOADER.USE_GRAIN``.

- ``index_shuffle`` equals grain's compiled ``index_shuffle`` for every
  index of ``[0, max_index]`` (exactly: integers), and ``shuffle_seed``
  the seed of a grain shuffle one node below ``.seed(s)``.
- The port's ``GrainLoader`` yields JAX's dataset indices batch for batch,
  with equal collated batches and equal ``get_state()`` dicts, over
  repeats crossing epochs, shards, repeat factors, ``drop_last`` on and
  off, ``start_iter`` slices, eval passes run twice and a failing record;
  a JAX loader's state set into the port continues as JAX's does.
- ``train_net`` on a tiny teacher (flips off) stopped after 2 of 4 steps,
  mid-epoch, and resumed gives the uninterrupted run's indices, batches
  and losses; JAX's loader on the same tree writes the same state after
  2 batches and continues with the same indices, and
  ``import_jax_checkpoint --loader-state`` with that file resumes the
  stream there.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

from grain._src.python.experimental.index_shuffle.python import index_shuffle_module as grain_shuffle
import grain

from cvpr22_cross_modal_pseudo_labeling_tpu.config import get_default_cfg as jax_cfg
from cvpr22_cross_modal_pseudo_labeling_tpu.data import build as jax_build
from cvpr22_cross_modal_pseudo_labeling_tpu.data import grain_loader as jax_grain
from cvpr22_cross_modal_pseudo_labeling_tpu.data import paths_catalog as jax_catalog
from cvpr22_cross_modal_pseudo_labeling_torch import data as port_data
from cvpr22_cross_modal_pseudo_labeling_torch.data import grain_loader as port_grain
from cvpr22_cross_modal_pseudo_labeling_torch.data.index_shuffle import epoch_permutation, index_shuffle, shuffle_seed
from cvpr22_cross_modal_pseudo_labeling_torch.tools import import_jax_checkpoint, train_net
from tests.tensorboard_stub import tensorboard_compat_reset  # noqa: F401  (an autouse fixture)
from tests.test_torch_train_net import TEACHER, TINY, tree  # noqa: F401  (tree: a fixture)
from tests.torch_threads import two_torch_threads  # noqa: F401  (an autouse fixture)

SEEDS = (0, 5, 2**31 + 7, 2**32 - 1)


@pytest.mark.parametrize("max_index", [1, 2, 3, 9, 255, 256, 65535, 65536, 100003])
def test_index_shuffle_is_grains_compiled_shuffle(max_index):
    """Every index, exactly, for four seeds (rounds 4, as the shuffle
    calls it, and 6 on the smaller spaces)."""
    everything = np.arange(max_index + 1)
    for seed in SEEDS:
        for rounds in (4, 6) if max_index < 1000 else (4,):
            ref = np.array([grain_shuffle.index_shuffle(i, max_index=max_index, seed=seed, rounds=rounds)
                            for i in range(max_index + 1)])
            np.testing.assert_array_equal(index_shuffle(everything, max_index, seed, rounds), ref)
            assert index_shuffle(int(max_index // 2), max_index, seed, rounds) == ref[max_index // 2]
    np.testing.assert_array_equal(epoch_permutation(max_index + 1, 5),
                                  index_shuffle(everything, max_index, 5))


def test_shuffle_seed_is_the_seed_of_a_grain_shuffle():
    for seed in (0, 1, 7, 123456, 2**32 - 1):
        ds = grain.MapDataset.range(10).seed(seed).shuffle()
        assert shuffle_seed(seed) == ds._seed
    assert shuffle_seed(0) == 3964924996


class TinyDataset:
    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise ValueError("corrupt")
        return {"x": np.full((2,), i, np.float32), "y": np.arange(3, dtype=np.int64) * i}


def collate(samples):
    return {k: np.stack([s[k] for s in samples]) for k in ("x", "y")}


CASES = {
    # train streams crossing 3+ epochs; n=3 and batch 2 repeat a record
    "repeat_7": dict(n=7, batch_size=2, num_iters=12, seed=0),
    "repeat_3": dict(n=3, batch_size=2, num_iters=7, seed=0),
    "shard_0_of_2": dict(n=7, batch_size=2, num_iters=10, seed=5, shard_index=0, shard_count=2),
    "shard_1_of_2": dict(n=7, batch_size=2, num_iters=10, seed=5, shard_index=1, shard_count=2),
    "repeat_factors": dict(n=6, batch_size=2, num_iters=10, seed=1, repeat_factors=[0.2, 1.5, 2.0, 1.0, 3.4, 0.7]),
    "drop_last_off": dict(n=10, batch_size=3, num_iters=8, seed=3, drop_last=False),
    "start_iter": dict(n=10, batch_size=3, num_iters=9, start_iter=4, seed=3),
    "start_past_end": dict(n=10, batch_size=3, num_iters=3, start_iter=4, seed=3),
    "failing_record": dict(n=8, batch_size=3, num_iters=8, seed=2, fail_at=3),
    # eval passes
    "eval_tail": dict(n=10, batch_size=3, shuffle=False, drop_last=False),
    "eval_drop_last_shard": dict(n=10, batch_size=3, shuffle=False, drop_last=True, shard_index=2, shard_count=3),
    "eval_shuffled": dict(n=10, batch_size=4, shuffle=True, seed=9, drop_last=False),
}


def loaders(case):
    kw = dict(CASES[case])
    n, fail_at = kw.pop("n"), kw.pop("fail_at", None)
    return (jax_grain.GrainLoader(TinyDataset(n, fail_at), collate, num_threads=2, **kw),
            port_grain.GrainLoader(TinyDataset(n, fail_at), collate, num_threads=3, **kw))


def drain(loader):
    out = []
    for batch, idx in loader:
        out.append((list(idx), batch, loader.get_state()))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_loader_is_jaxs_batch_for_batch(case):
    """Indices, collated batches and the state after each batch; an eval
    loader's second pass equals its first."""
    jl, tl = loaders(case)
    assert len(tl) == len(jl)
    passes = 2 if "num_iters" not in CASES[case] else 1
    for _ in range(passes):
        got, ref = drain(tl), drain(jl)
        assert [g[0] for g in got] == [r[0] for r in ref]
        for (_, gb, gs), (_, rb, rs) in zip(got, ref):
            assert gs == rs
            for k in rb:
                np.testing.assert_array_equal(gb[k], rb[k])
        assert len(got) == len(jl)
    assert tl.get_state() == jl.get_state()
    eb, ei = tl.example_batch()
    jb, ji = jl.example_batch()
    assert list(ei) == list(ji)
    np.testing.assert_array_equal(eb["x"], jb["x"])


@pytest.mark.parametrize("k", [0, 3, 5, 11])
def test_a_jax_state_continues_in_the_port_as_in_jax(k):
    """After k batches of JAX's loader its state, JSON-round-tripped and set
    into a fresh port loader, yields JAX's remaining batches."""
    kw = dict(batch_size=2, num_iters=12, seed=0)
    jl = jax_grain.GrainLoader(TinyDataset(7), collate, num_threads=2, **kw)
    it = iter(jl)
    for _ in range(k):
        next(it)
    state = json.loads(json.dumps(jl.get_state()))
    assert state == {"next_index": k}
    tl = port_grain.GrainLoader(TinyDataset(7), collate, num_threads=4, **kw)
    for _ in range(2):
        next(iter(tl))  # read ahead, then repositioned by the state
    tl.set_state(state)
    assert [list(i) for _, i in tl] == [list(i) for _, i in it]
    assert tl.get_state() == jl.get_state() == {"next_index": 12}


def test_reading_ahead_does_not_move_the_state():
    tl = port_grain.GrainLoader(TinyDataset(50), collate, batch_size=2, num_iters=20, num_threads=4,
                                prefetch_batches=8)
    it = iter(tl)
    next(it)
    assert tl.get_state() == {"next_index": 1}
    assert len(tl.iterator()._ahead) == 8  # batches 1-8 read ahead


# -- train_net under USE_GRAIN, stopped mid-epoch and resumed -----------
GRAIN = [*map(str, TINY), "DATALOADER.USE_GRAIN", "True", "DATALOADER.GRAIN_SEED", "3",
         "INPUT.HORIZONTAL_FLIP_PROB_TRAIN", "0.0", "SOLVER.TEST_PERIOD", "0"]


class Recorder:
    """The train loader, recording each batch it hands out."""

    def __init__(self, loader, log):
        self.loader, self.log = loader, log

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch, idx in self.loader:
            self.log.append((list(idx), batch["images"].copy()))
            yield batch, idx

    def get_state(self):
        return self.loader.get_state()

    def set_state(self, state):
        self.loader.set_state(state)


def run(out: Path, max_iter: int, log, *extra):
    rec = train_net.main(["--config-file", TEACHER, "--skip-test", "--device", "cpu", *GRAIN, *extra,
                          "SOLVER.MAX_ITER", str(max_iter), "MODEL.LOAD_TRAINER_STATE", "True",
                          "OUTPUT_DIR", str(out)])
    losses = {}
    for line in (out / "tb/metrics.jsonl").read_text().splitlines():
        row = json.loads(line)
        losses[row["step"]] = row["total_loss"]
    return rec, losses


def test_train_net_resumes_mid_epoch_from_its_own_state_and_from_jaxs(tree, tmp_path, monkeypatch):
    import chip_smoke

    monkeypatch.setenv("CMPL_TPU_DATA_DIR", str(tree))
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    monkeypatch.setattr(jax_catalog, "DATA_DIR", str(tree))
    log = []
    make = port_data.make_data_loader

    def recording(cfg, is_train=True, **kw):
        loader, ds = make(cfg, is_train=is_train, **kw)
        return (Recorder(loader, log), ds) if is_train else (loader, ds)

    monkeypatch.setattr(port_data, "make_data_loader", recording)

    _, whole = run(tmp_path / "whole", 4, log)
    ref, log[:] = list(log), []
    rec, _ = run(tmp_path / "cut", 2, log)
    assert len(log) == 2
    state = json.loads((tmp_path / "cut/loader_state.json").read_text())
    assert state == {"next_index": 2}
    _, resumed = run(tmp_path / "cut", 4, log)
    assert "data stream resumed from loader_state.json" in (tmp_path / "cut/log.txt.rank0").read_text()
    assert [i for i, _ in log] == [i for i, _ in ref]
    for (_, a), (_, b) in zip(log, ref):
        np.testing.assert_array_equal(a, b)
    assert resumed[3] == whole[3] and resumed[4] == whole[4]

    # JAX's loader on the same tree and config: the same stream and state
    cfg = jax_cfg()
    cfg.merge_from_file(TEACHER)
    cfg.merge_from_list(GRAIN + ["SOLVER.MAX_ITER", "4"])
    jl, _ = jax_build.make_data_loader(cfg, is_train=True)
    it = iter(jl)
    first = [list(next(it)[1]) for _ in range(2)]
    jax_state = jl.get_state()
    assert jax_state == state
    assert first == [i for i, _ in ref[:2]]
    assert [list(i) for _, i in it] == [i for i, _ in ref[2:]]
    state_file = tmp_path / "jax_run" / "loader_state.json"
    state_file.parent.mkdir()
    state_file.write_text(json.dumps(jax_state))

    # a JAX train state at iteration 2 with JAX's stream state: the port
    # resumes the stream where the JAX run left it
    dump = tmp_path / "dump.npz"
    np.savez(dump, **chip_smoke.jax_train_state_dump(rec["trainer"], 0, 2, str(dump)))
    got = import_jax_checkpoint.main(["--config-file", TEACHER, "--dump", str(dump), "--out",
                                      str(tmp_path / "imported"), "--loader-state", str(state_file.parent),
                                      "--device", "cpu", *GRAIN])
    assert got["iteration"] == 2 and got["loader_states"] == [str(tmp_path / "imported/loader_state.json")]
    log[:] = []
    rec, _ = run(tmp_path / "imported", 4, log)
    assert rec["start_iter"] == 2
    assert [i for i, _ in log] == [i for i, _ in ref[2:]]


def test_import_loader_states_refuses_what_is_not_a_stream_state(tmp_path):
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.jax_checkpoint import import_loader_states

    (tmp_path / "src").mkdir()
    (tmp_path / "src/loader_state.json").write_text(json.dumps({"next_index": 7}))
    (tmp_path / "src/loader_state_1.json").write_text(json.dumps({"next_index": 7}))
    (tmp_path / "src/other.json").write_text("{}")
    written = import_loader_states(str(tmp_path / "src"), str(tmp_path / "out"), log=lambda _: None)
    assert [Path(p).name for p in written] == ["loader_state.json", "loader_state_1.json"]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"position": 3}))
    with pytest.raises(ValueError, match="not a grain stream state"):
        import_loader_states(str(bad), str(tmp_path / "out2"), log=lambda _: None)
    with pytest.raises(FileNotFoundError):
        import_loader_states(str(tmp_path / "out2"), str(tmp_path / "out3"), log=lambda _: None)
