"""MMSS pretraining on 2 gloo ranks against JAX's mesh step, on the CPU.

JAX runs the MMSS step as one SPMD program over the global batch: the
grounding head pairs every caption with every image and takes its
cross-entropy over both axes, the guard's ceiling is a max over the whole
pair matrix, the transformer head encodes all B^2 pairs, and the MLM loss
divides by the global count of masked tokens.  The port runs one process
a rank: each rank pairs its captions with every rank's images through
``parallel/dist.py::gather_rows_grad``, whose backward reduces the
gradient back to each rank's rows, and returns its share of each loss.

- The gather alone: ``gather_rows_grad`` on 2 ranks with 3 + 1 rows, in
  float64 (its backward against ``torch.cat``'s gradient on one process,
  which ``autograd.gradcheck`` holds), bool and bfloat16 exactly; with
  ``row_counts``, ``global_max`` and ``from_primary``.
- ``GroundingHead`` alone on 2 ranks, for the two loss types the config
  does not use: ``matching`` (``LOCAL_METRIC cosine``, 2 + 2 rows) and
  ``triplet`` with random negatives (3 + 1 rows): the ranks' losses sum
  to the JAX head's on the global batch within 1e-5 relative, the
  accuracies are JAX's exactly, the gradient of each rank's inputs is
  the one-process head's rows within 1e-5 of its norm; without given
  draws, the random negatives are rank 0's draw on every rank.
- ``tests/test_torch_mmss.py``'s narrow ``MMSSGridModel`` under
  ``mmss.yaml``'s optimizer (clip at 5, frozen BERT) on 2 ranks, 2
  images a rank of a global batch of 4, 2 steps.  Rank 1's counts differ
  from rank 0's: its second caption is ``[CLS] [SEP]`` (no word to ground
  and no MLM target, so its pairs are the guard's) and its first image
  is 40 x 40 pixels (4 of 16 grid cells).  With the config's
  cross-entropy loss, against the JAX step jitted on a 2-device mesh
  (``jit_train_step`` over ``make_mesh(devices=jax.devices()[:2])``) on
  its own draws (``JaxMMSSDraws``, each rank taking its rows), with
  ``tests/test_torch_mmss_train.py``'s tolerances: losses 1e-5 relative,
  accuracies exactly, ``grad_norm`` 1e-5 of JAX's norm without the
  frozen-BN leaves, each update 1e-3 of JAX's update norm plus an ulp of
  the weight, the frozen BERT and the BN buffers bit for bit.  For each
  of the three loss types against the port's one-process step on the
  same 4 images and draws: losses and ``grad_norm`` within 1e-5
  relative.  The ranks bit-equal after every step, and the MLM count
  each rank reduces the sum of unequal counts.
- The validation-loss pass on JAX's ``build_val_loss_step`` draws: on
  2 + 2 rows and on 3 + 1 rows (the unpadded stripes' tail), within
  1e-5 of JAX's loss and of the one-process pass.

The ranks are two processes of this file (``python
tests/test_torch_ddp_mmss.py --worker RANK WORLD DIR``, a ``file://``
rendezvous in DIR), started once for the module; they import no jax and
read their inputs, written by this process, from DIR: first the heads'
(quick), then the model's, while this process runs the JAX mesh program
and then the one-process steps.
"""

import argparse
import importlib
import pathlib
import sys

import numpy as np
import pytest
import torch

from tests.torch_threads import two_torch_threads  # noqa: F401  (an autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 2
STEPS = 2
MMSS_CONFIG = str(ROOT / "configs/coco_cap_det/mmss.yaml")
OPTS = ["TPU.COMPUTE_DTYPE", "float32"]
GATHER_SPLITS = (3, 1)
# the grounding loss types of the model runs: the config's and the two
# others, their statics over tests/test_torch_mmss.py's narrow ones
LOSS_TYPES = {
    "cross_entropy": {},
    "matching": dict(loss_type="matching", local_metric="cosine"),
    "triplet": dict(loss_type="triplet", negative_mining="random"),
}
HEAD_CASES = {
    "matching": (dict(local_metric="cosine", loss_type="matching"), (2, 2)),
    "triplet": (dict(local_metric="euclidean", loss_type="triplet", negative_mining="random"), (3, 1)),
}
VAL_SPLITS = ((2, 2), (3, 1))
TRANSFORMER_HEAD = "cvpr22_cross_modal_pseudo_labeling_torch.models.mmss.transformer_head"


def rows_of(x, splits, r):
    return x[sum(splits[:r]):sum(splits[:r + 1])]


def batch_rows(batch, splits, r):
    return {k: rows_of(v, splits, r) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the inputs both sides build (numpy, seeded)


def gather_inputs():
    rng = np.random.default_rng(11)
    return dict(x=rng.standard_normal((4, 2, 3)), weights=rng.standard_normal((WORLD, 4, 2, 3)),
                mask=rng.uniform(size=(4, 5)) < 0.5, half=rng.standard_normal((4, 7)).astype(np.float32))


def head_inputs(seed):
    """The grounding head's inputs for 4 rows: caption 3 empty (the guard),
    image 1 with padded regions."""
    b, w, r, d = 4, 6, 5, 8
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((b, r, d)).astype(np.float32)
    cap = rng.standard_normal((b, w, d)).astype(np.float32)
    cmask = (rng.uniform(size=(b, w)) < 0.8).astype(np.int32)
    cmask[0, 0] = 1
    cmask[3] = 0
    rmask = np.ones((b, r), bool)
    rmask[1, 3:] = False
    return img, rmask, cap, cmask


def global_batch(seed):
    """``tests/test_torch_mmss.py``'s batch at 4 images; rank 1's first
    image 40 x 40 pixels, its second caption ``[CLS] [SEP]``."""
    from tests.test_torch_mmss import mmss_batch

    batch = mmss_batch(seed=seed, b=4)
    batch["image_sizes"][2] = (40, 40)
    for k in ("input_ids", "attention_mask", "special_tokens_mask"):
        batch[k][3] = 0
    batch["input_ids"][3, :2] = (101, 102)
    batch["attention_mask"][3, :2] = 1
    batch["special_tokens_mask"][3, :2] = 1
    return batch


# ---------------------------------------------------------------------------
# the ranks (no jax here)


def gather_on_rank(rank_):
    from cvpr22_cross_modal_pseudo_labeling_torch.parallel import dist as pdist

    g = gather_inputs()
    x = torch.from_numpy(rows_of(g["x"], GATHER_SPLITS, rank_)).requires_grad_(True)
    y = pdist.gather_rows_grad(x)
    (torch.from_numpy(g["weights"][rank_]) * y).sum().backward()
    half = torch.from_numpy(rows_of(g["half"], GATHER_SPLITS, rank_)).to(torch.bfloat16)
    return dict(
        y=y.detach().numpy(), grad=x.grad.numpy(), dtype=str(y.dtype),
        mask=pdist.gather_rows_grad(torch.from_numpy(rows_of(g["mask"], GATHER_SPLITS, rank_))).numpy(),
        half=pdist.gather_rows_grad(half).to(torch.float32).numpy(),
        counts=pdist.row_counts(GATHER_SPLITS[rank_]),
        max=float(pdist.global_max(torch.tensor([1.0, -5.0 * rank_, 3.0 * rank_]))),
        primary=pdist.from_primary(torch.tensor([rank_ + 7, 2])).tolist(),
    )


def head_on_rank(case, rank_):
    """The head on this rank's rows with the case's draws: losses, info
    and the gradients of its image and caption rows; then the losses
    without draws from a generator seeded 100 + rank."""
    from cvpr22_cross_modal_pseudo_labeling_torch.models.mmss import grounding_head as gh

    splits = case["splits"]
    rows = [torch.from_numpy(rows_of(a, splits, rank_)) for a in case["args"]]
    rows[0].requires_grad_(True)
    rows[2].requires_grad_(True)
    head = gh.GroundingHead(case["statics"], rows[0].shape[-1])
    triplet = None if case["triplet"] is None else torch.from_numpy(case["triplet"])
    info, losses = head(*rows, draws=gh.AlignmentDraws(triplet=triplet))
    sum(losses.values()).backward()
    g = torch.Generator().manual_seed(100 + rank_)
    _, drawn = head(*[r.detach() for r in rows], generator=g)
    return dict(losses={k: float(v) for k, v in losses.items()}, info={k: float(v) for k, v in info.items()},
                grads=[rows[0].grad.numpy(), rows[2].grad.numpy()],
                drawn={k: float(v) for k, v in drawn.items()})


def mmss_trainer(spec, loss_type):
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer
    from cvpr22_cross_modal_pseudo_labeling_torch.models.detector import mmss_gcnn

    s = spec["statics"]
    s = s._replace(grounding=s.grounding._replace(**LOSS_TYPES[loss_type]))
    trainer = Trainer(MMSS_CONFIG, OPTS, device="cpu", seed=3, model=mmss_gcnn.MMSSGridModel(s))
    trainer.model.load_state_dict(spec["state"])
    return trainer


def mmss_draws(d):
    from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.mmss_gcnn import MMSSDraws
    from cvpr22_cross_modal_pseudo_labeling_torch.models.mmss.grounding_head import AlignmentDraws

    d = {k: torch.from_numpy(v) for k, v in d.items()}
    return MMSSDraws(dropout=d["dropout"], mlm_select=d["mlm_select"], mlm_mask=d["mlm_mask"],
                     mlm_ids=d["mlm_ids"].to(torch.int64), alignment=AlignmentDraws(triplet=d.get("triplet")))


def steps_on_rank(spec, loss_type, rank_, rec):
    """``STEPS`` steps on this rank's rows: metrics, parameters, buffers
    and the reduced counts after each."""
    trainer = mmss_trainer(spec, loss_type)
    out = []
    for batch, draws in zip(spec["batches"], spec["draws"]):
        rec.clear()
        draws = {**draws, **({"triplet": spec["triplet"]} if loss_type == "triplet" else {})}
        metrics = trainer.step(batch_rows(batch, (2, 2), rank_), mmss_draws(draws))
        out.append(dict(metrics={k: float(v) for k, v in metrics.items()}, counts=list(rec),
                        params={n: p.detach().numpy().copy() for n, p in trainer.model.named_parameters()},
                        buffers={n: b.numpy().copy() for n, b in trainer.model.named_buffers()}))
    return out


def worker(rank_, world, tmp):
    import torch.distributed as dist

    from cvpr22_cross_modal_pseudo_labeling_torch.parallel import dist as pdist
    from tests.test_torch_ddp import dump, wait_load

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank_, world_size=world)
    rec = []

    def recording(x):
        out = pdist.global_sum(x)
        rec.append((x.tolist(), out.tolist()))
        return out

    importlib.import_module(TRANSFORMER_HEAD).global_sum = recording
    result = {"gather": gather_on_rank(rank_)}
    heads = wait_load(tmp / "heads.pkl")
    result["heads"] = {name: head_on_rank(case, rank_) for name, case in heads.items()}
    spec = wait_load(tmp / "model.pkl")
    result["runs"] = {lt: steps_on_rank(spec, lt, rank_, rec) for lt in LOSS_TYPES}
    trainer = mmss_trainer(spec, "cross_entropy")
    result["val"] = {
        splits: {k: float(v) for k, v in trainer.val_loss(
            trainer.device_batch(batch_rows(spec["val_batch"], splits, rank_)), mmss_draws(spec["val_draws"])).items()}
        for splits in VAL_SPLITS}
    dump(result, tmp / f"rank{rank_}.pkl")
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# JAX and the one-process side


def head_references():
    """Each head case (statics, inputs, JAX's triplet draw) and its
    references: the JAX head's losses and info on the global batch, the
    one-process port head's gradients and its losses drawn from a
    generator seeded 100."""
    import jax
    import jax.numpy as jnp

    from cvpr22_cross_modal_pseudo_labeling_torch.models.mmss import grounding_head as gh
    from cvpr22_cross_modal_pseudo_labeling_tpu.models.mmss import grounding_head as jax_gh
    from tests.test_torch_mmss import grounding_draws

    cases, refs = {}, {}
    for i, (name, (opts, splits)) in enumerate(HEAD_CASES.items()):
        opts = dict(temperature=2.0, margin=0.5, alignment="softmax", global_metric="aligned_local", **opts)
        args = head_inputs(20 + i)
        key = jax.random.PRNGKey(20 + i)
        statics = gh.GroundingStatics(**opts)
        draws = grounding_draws(key, statics, 4, 6, 5, opts["loss_type"] != "matching")
        triplet = None if draws.triplet is None else draws.triplet.numpy()
        cases[name] = dict(statics=statics, args=args, splits=splits, triplet=triplet)
        jax_head = jax_gh.GroundingHead(jax_gh.GroundingStatics(**opts), 8)
        want_info, want_losses = jax.jit(lambda *a: jax_head.apply({}, *a[:-1], rng=a[-1]))(
            *map(jnp.asarray, args), key)
        t = [torch.from_numpy(a) for a in args]
        t[0].requires_grad_(True)
        t[2].requires_grad_(True)
        head = gh.GroundingHead(statics, 8)
        _, losses = head(*t, draws=gh.AlignmentDraws(triplet=draws.triplet))
        sum(losses.values()).backward()
        _, drawn = head(*[a.detach() for a in t], generator=torch.Generator().manual_seed(100))
        refs[name] = dict(losses={k: float(v) for k, v in want_losses.items()},
                          info={k: float(v) for k, v in want_info.items()},
                          grads=[t[0].grad.numpy(), t[2].grad.numpy()],
                          drawn={k: float(v) for k, v in drawn.items()})
    return cases, refs


def jax_mesh_run():
    """The narrow model's seeded weights, the global batches, and the JAX
    step on a 2-device mesh, ``STEPS`` times: its draws, metrics, norm
    without the frozen-BN leaves and parameters after each step; then
    ``build_val_loss_step`` on a batch of its own, with its draws."""
    import jax
    import jax.numpy as jnp
    import optax

    from cvpr22_cross_modal_pseudo_labeling_torch import bridge
    from cvpr22_cross_modal_pseudo_labeling_tpu.engine import optimizer as jax_opt
    from cvpr22_cross_modal_pseudo_labeling_tpu.engine import train_step as jax_train
    from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import mmss_gcnn as jax_mmss
    from cvpr22_cross_modal_pseudo_labeling_tpu.parallel.mesh import make_mesh, replicated
    from tests.test_torch_mmss import JaxMMSSDraws, jax_params, narrow_statics
    from tests.test_torch_mmss_train import MMSS, _norm_without, jax_batch, jax_mmss_cfg
    from tests.test_torch_mmss_train import mmss_trainer as seeded_trainer

    port, tree = seeded_trainer()
    spec = dict(statics=port.model.statics, state={k: v.clone() for k, v in port.model.state_dict().items()},
                batches=[global_batch(1 + it) for it in range(STEPS)], val_batch=global_batch(5))
    cfg = jax_mmss_cfg()
    model = jax_mmss.MMSSGridModel(narrow_statics("jax"))
    params = jax_params(tree)
    tx, _ = jax_opt.make_optimizer(cfg, params["params"], jax_opt.frozen_prefixes_from_cfg(cfg, MMSS))
    loss_fn = jax_train.build_loss_fn(model, MMSS)

    def step_and_grads(state, batch):
        # build_train_step's step (tpu/engine/train_step.py:193-207), which
        # also hands out its gradient
        rng = jax.random.fold_in(state.rng, state.step)
        grads, (losses, info) = jax.grad(loss_fn, has_aux=True)(state.params, batch, rng)
        metrics = {**losses, **info}
        metrics["total_loss"] = sum(losses.values())
        metrics["grad_norm"] = optax.global_norm(grads)
        return jax_train._apply_update(state, grads, tx), (metrics, grads)

    mesh = make_mesh(devices=jax.devices()[:WORLD])
    jax_batches = [jax_batch(b) for b in spec["batches"]]
    run = jax_train.jit_train_step(step_and_grads, mesh, jax_batches[0])
    state = jax.device_put(jax_train.create_train_state(params, tx, jax.random.PRNGKey(0)), replicated(mesh))
    ref = {"metrics": [], "params": [], "norm_without_bn": []}
    spec["draws"] = []
    for jb in jax_batches:
        with JaxMMSSDraws() as rec:
            state, (metrics, grads) = run(state, jb)
            jax.block_until_ready(state.params)
        spec["draws"].append({k: v.numpy() for k, v in rec.draws()._asdict().items() if isinstance(v, torch.Tensor)})
        ref["metrics"].append({k: float(v) for k, v in metrics.items()})
        ref["norm_without_bn"].append(_norm_without(grads["params"], lambda p: "frozen_bn" in p))
        ref["params"].append({k: v.numpy() for k, v in bridge.state_dict_from_flax(
            port.model, jax.tree_util.tree_map(np.asarray, state.params["params"])).items()})
    val = jax.jit(jax_train.build_val_loss_step(model, MMSS))
    with JaxMMSSDraws() as rec:
        # the step donated the state, and its params with it
        want = val(jax_params(tree), jax_batch(spec["val_batch"]))
        jax.block_until_ready(want)
    spec["val_draws"] = {k: v.numpy() for k, v in rec.draws()._asdict().items() if isinstance(v, torch.Tensor)}
    ref["val"] = {k: float(v) for k, v in want.items()}
    spec["triplet"] = np.random.default_rng(7).integers(0, 3, (2, 2, 4)).astype(np.int64)
    return spec, ref


def one_process_runs(spec):
    """The port's one-process steps of each loss type and its validation
    pass, on the global batches and the same draws."""
    out = {}
    for loss_type in LOSS_TYPES:
        trainer = mmss_trainer(spec, loss_type)
        start = {n: p.detach().numpy().copy() for n, p in trainer.model.named_parameters()}
        metrics = []
        for batch, draws in zip(spec["batches"], spec["draws"]):
            draws = {**draws, **({"triplet": spec["triplet"]} if loss_type == "triplet" else {})}
            metrics.append({k: float(v) for k, v in trainer.step(batch, mmss_draws(draws)).items()})
        out[loss_type] = dict(metrics=metrics, start=start)
    trainer = mmss_trainer(spec, "cross_entropy")
    out["val"] = {k: float(v) for k, v in trainer.val_loss(trainer.device_batch(spec["val_batch"]),
                                                            mmss_draws(spec["val_draws"])).items()}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from tests.test_torch_ddp import dump, join, start, wait_load

    tmp = tmp_path_factory.mktemp("ddp_mmss")
    procs = [start(["--worker", r, WORLD, tmp], file=__file__) for r in range(WORLD)]
    try:
        cases, head_refs = head_references()
        dump(cases, tmp / "heads.pkl")
        spec, ref = jax_mesh_run()
        dump(spec, tmp / "model.pkl")
        single = one_process_runs(spec)
        for p in procs:
            join(p)
        ranks = [wait_load(tmp / f"rank{r}.pkl") for r in range(WORLD)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return dict(cases=cases, head_refs=head_refs, spec=spec, jax=ref, single=single, ranks=ranks)


# ---------------------------------------------------------------------------
# tests


def test_helpers_are_the_identity_with_one_process():
    from cvpr22_cross_modal_pseudo_labeling_torch.parallel import dist as pdist

    assert not torch.distributed.is_initialized()
    x = torch.arange(6.0).reshape(3, 2).requires_grad_(True)
    assert pdist.gather_rows_grad(x) is x and pdist.from_primary(x) is x
    assert pdist.row_counts(3) == [3]
    assert float(pdist.global_max(x)) == 5.0 and not pdist.global_max(x).requires_grad


def test_gather_rows_grad_is_cat_and_reduces_its_gradient(runs):
    g = gather_inputs()
    x = [torch.from_numpy(rows_of(g["x"], GATHER_SPLITS, r)).requires_grad_(True) for r in range(WORLD)]
    w = torch.from_numpy(g["weights"])

    def every_share(*parts):
        # each rank's share reads every gathered row: their sum
        return sum((w[r] * torch.cat(parts)).sum() for r in range(WORLD))

    assert torch.autograd.gradcheck(every_share, tuple(x))
    every_share(*x).backward()
    for r, out in enumerate(runs["ranks"]):
        got = out["gather"]
        assert got["dtype"] == "torch.float64" and got["counts"] == list(GATHER_SPLITS)
        np.testing.assert_array_equal(got["y"], g["x"])
        np.testing.assert_allclose(got["grad"], x[r].grad.numpy(), rtol=1e-15, atol=0)
        np.testing.assert_array_equal(got["mask"], g["mask"])
        np.testing.assert_array_equal(got["half"], torch.from_numpy(g["half"]).to(torch.bfloat16).float().numpy())
        assert got["max"] == 3.0 and got["primary"] == [7, 2]


@pytest.mark.parametrize("name", list(HEAD_CASES))
def test_grounding_head_on_ranks_matches_jax_head(runs, name):
    ref, case = runs["head_refs"][name], runs["cases"][name]
    got = [out["heads"][name] for out in runs["ranks"]]
    assert set(got[0]["losses"]) == set(ref["losses"]) and set(got[0]["info"]) == set(ref["info"])
    for k, v in ref["losses"].items():
        assert v > 0, k
        np.testing.assert_allclose(sum(g["losses"][k] for g in got), v, rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(sum(g["drawn"][k] for g in got), ref["drawn"][k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for g in got:
        assert g["info"] == ref["info"]
    for i, want in enumerate(ref["grads"]):
        for r, g in enumerate(got):
            rows = rows_of(want, case["splits"], r)
            err = float(np.linalg.norm(g["grads"][i] - rows))
            assert err <= 1e-5 * float(np.linalg.norm(want)), (name, i, r, err)
    if name == "triplet":
        # the random negatives drawn on the ranks are rank 0's: another
        # draw changes the loss
        assert ref["drawn"] != ref["losses"]


def test_two_rank_step_matches_jax_mesh_step(runs):
    got = runs["ranks"][0]["runs"]["cross_entropy"]
    ref, spec = runs["jax"], runs["spec"]
    start = runs["single"]["cross_entropy"]["start"]
    bert = [n for n in start if n.startswith("language_backbone.")]
    assert bert
    for it in range(STEPS):
        metrics = got[it]["metrics"]
        assert set(metrics) == set(ref["metrics"][it])
        for k, v in ref["metrics"][it].items():
            if k == "grad_norm":
                continue
            if "Accuracy" in k:
                assert metrics[k] == v, (it, k)
            else:
                np.testing.assert_allclose(metrics[k], v, rtol=1e-5, atol=1e-7, err_msg=f"{it} {k}")
        assert metrics["Masked Language Modeling Loss"] > 0
        assert abs(metrics["grad_norm"] / ref["norm_without_bn"][it] - 1) < 1e-5
        before = got[it - 1]["params"] if it else start
        for name, p in got[it]["params"].items():
            if name in bert:
                np.testing.assert_array_equal(p, start[name], err_msg=name)
                continue
            up = (p - before[name]).astype(np.float64)
            want = ref["params"][it][name] - before[name]
            ulp = float(np.linalg.norm(np.spacing(before[name])))
            err = float(np.linalg.norm(up - want))
            assert err <= 1e-3 * float(np.linalg.norm(want)) + ulp, (it, name, err)
        for name, b in got[it]["buffers"].items():
            np.testing.assert_array_equal(b, spec["state"][name].numpy(), err_msg=name)


@pytest.mark.parametrize("loss_type", list(LOSS_TYPES))
def test_two_rank_step_matches_one_process_step(runs, loss_type):
    got = runs["ranks"][0]["runs"][loss_type]
    want = runs["single"][loss_type]["metrics"]
    for it in range(STEPS):
        assert set(got[it]["metrics"]) == set(want[it])
        for k, v in want[it].items():
            if "Accuracy" in k:
                assert got[it]["metrics"][k] == v, (it, k)
            else:
                np.testing.assert_allclose(got[it]["metrics"][k], v, rtol=1e-5, atol=1e-7, err_msg=f"{it} {k}")
    loss = {"cross_entropy": "Cross-Entropy Loss (Align Words, Choose Caption)",
            "matching": "Image-Caption Matching Loss (Align Words)",
            "triplet": "Triplet Loss (Align Words, Choose Image)"}[loss_type]
    assert want[0][loss] > 0


@pytest.mark.parametrize("loss_type", list(LOSS_TYPES))
def test_ranks_are_bit_equal_after_every_step(runs, loss_type):
    r0, r1 = (out["runs"][loss_type] for out in runs["ranks"])
    for it, (s0, s1) in enumerate(zip(r0, r1)):
        assert s0["metrics"] == s1["metrics"], it
        for key in ("params", "buffers"):
            for name in s0[key]:
                np.testing.assert_array_equal(s0[key][name], s1[key][name], err_msg=f"{it} {key} {name}")


def test_mlm_count_is_the_sum_of_unequal_rank_counts(runs):
    r0, r1 = (out["runs"]["cross_entropy"] for out in runs["ranks"])
    for s0, s1 in zip(r0, r1):
        assert len(s0["counts"]) == len(s1["counts"]) == 1
        (l0, g0), (l1, g1) = s0["counts"][0], s1["counts"][0]
        assert g0 == g1 == [a + b for a, b in zip(l0, l1)]
        assert l0[0] != l1[0] and g0[0] > 0


@pytest.mark.parametrize("splits", VAL_SPLITS, ids=lambda s: "+".join(map(str, s)))
def test_validation_loss_on_ranks_matches_jax_and_one_process(runs, splits):
    got = runs["ranks"][0]["val"][splits]
    assert got == runs["ranks"][1]["val"][splits]
    assert set(got) == set(runs["jax"]["val"])
    for k, v in runs["jax"]["val"].items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(got[k], runs["single"]["val"][k], rtol=1e-5, atol=1e-7, err_msg=k)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    parser = argparse.ArgumentParser()
    parser.add_argument("--worker", nargs=3, required=True, metavar=("RANK", "WORLD", "DIR"))
    a = parser.parse_args().worker
    worker(int(a[0]), int(a[1]), pathlib.Path(a[2]))
