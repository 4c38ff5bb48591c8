"""The port's data-parallel train step on 2 gloo ranks against JAX's mesh step.

JAX trains one SPMD program whose global batch is sharded over the
mesh's ``data`` axis; its loss normalizers are counts over the global
batch and its exemplar table is updated from every image's candidates.
The port runs one process a rank (``parallel/dist.py``) and must give the
same step: a 2-rank step on a global batch of 4 (2 images a rank) equals
the JAX step jitted on a 2-device mesh (``jit_train_step`` over
``make_mesh(devices=jax.devices()[:2])``) and the port's one-process step
on the same 4 images.

The global batches make the ranks' counts differ, the case that tells a
global normalizer from a per-rank one: on rank 1 one image has no gt box
(and, for the student-teacher model, no valid caption noun), and the
other is 24 x 20 pixels, so that few of its proposals survive.  Each
rank records the local and the global value of every normalizer it
reduces, and the test checks that they differ.

Both families at narrow widths (``tests/test_torch_st_train.py``'s
``TRAIN_OPTS``): the teacher (``zeroshot_mask.yaml``) and the
student-teacher model with the exemplar table on (1203 LVIS rows), 2
steps each on the JAX program's own draws (recorded from the mesh step;
each rank takes its rows).  JAX's gradients come from the same jitted
mesh program: it computes ``build_loss_fn``'s gradient at the step's key
beside ``build_train_step``'s step.  A third run on the ranks, the
student-teacher model with the table and ``FT_EMB`` together (the LVIS
table rebuilt from the live word table in the step), is held to the
port's one-process step and the ranks to each other.

Tolerances, those of the one-process parity tests
(``tests/test_torch_st_train.py``, ``tests/test_torch_teacher.py``):
the losses within 1e-5 relative at the first step (1e-4 after an update);
the first step's gradients within 1e-5 of the JAX gradient's norm per
tensor, 2e-3 for the student's C5 head (``roi_extractor``) and 1e-4 for
``lambda_exemplar`` (a scalar summed over the mixed table; its update is
held so in ``tests/test_torch_exemplars.py``), for the teacher's
predictors, with the rest of the teacher (trunk, RPN, C5 head)
held to the port's one-process step within 1e-5 (``test_torch_teacher.py``
bounds them against a float64 run); the gradient norm within 1e-3 of the
norm of JAX's trainable gradients; each update as the one-process tests
hold it; the exemplar table as ``tests/test_torch_exemplars.py`` does.
Against the port's one-process step: the losses and the gradient norm
within 1e-5 relative, the gradients within 1e-5 of their norm (2e-3 for
``roi_extractor``).  The ranks hold each other bit for bit: metrics,
every parameter, buffer and the exemplar table after every step.

The ranks run as two processes of this file (``python
tests/test_torch_ddp.py --worker ...``, a ``file://`` rendezvous in the
test's directory), started once for the module; they import no jax.  The
teacher's JAX program runs in a third (``--jax teacher``) beside the
student-teacher model's here, and each family's ranks start on its
inputs as soon as they are written.
"""

import argparse
import os
import pathlib
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 2
STEPS = 2
ST_CONFIG = "configs/coco_cap_det/student_teacher_mask_rcnn_uncertainty.yaml"
TEACHER = "configs/coco_cap_det/zeroshot_mask.yaml"
FAMILIES = ("st", "teacher")
# the runs on the ranks: both families, and the student-teacher model
# with the exemplar table and FT_EMB together, held to the port's
# one-process step
RANK_RUNS = ("st", "st_ft_emb", "teacher")
# batch keys that are tables, the same on every rank; the others hold a
# row an image
TABLE_KEYS = ("class_embeddings", "lvis_class_embeddings", "class_lvis_ids", "lvis_name_ids", "lvis_name_mask")
# the modules whose normalizers go through global_sum, by the name each
# imports it under
NORMALIZER_MODULES = (
    "cvpr22_cross_modal_pseudo_labeling_torch.models.rpn.rpn",
    "cvpr22_cross_modal_pseudo_labeling_torch.models.roi_heads.box_head",
    "cvpr22_cross_modal_pseudo_labeling_torch.models.roi_heads.mask_head",
)


def rank_rows(batch, r, world=WORLD):
    """Rank ``r``'s rows of a global numpy batch."""
    n = len(batch["images"]) // world
    return {k: v if k in TABLE_KEYS else v[r * n:(r + 1) * n] for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the ranks (no jax here)
# ---------------------------------------------------------------------------


def _params(model):
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def _run_family(spec, rec):
    """Steps a Trainer through ``spec``'s global batches on this rank:
    metrics, parameters, buffers and the table after each step, and the
    first step's gradients."""
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer
    from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.generalized_rcnn import TrainDraws
    from cvpr22_cross_modal_pseudo_labeling_torch.parallel.dist import rank

    trainer = Trainer(spec["config"], spec["opts"], device="cpu", seed=3)
    trainer.load_flax_params(spec["tree"])
    out = {"steps": []}
    for it, (batch, draws) in enumerate(zip(spec["batches"], spec["draws"])):
        rec.clear()
        draws = TrainDraws(**{k: torch.from_numpy(v) for k, v in draws.items()})
        metrics = trainer.step(rank_rows(batch, rank()), draws)
        step = {
            "metrics": {k: float(v) for k, v in metrics.items()},
            "params": _params(trainer.model),
            "buffers": {n: b.numpy().copy() for n, b in trainer.model.named_buffers()},
            "normalizers": list(rec),
        }
        if trainer.exemplars is not None:
            step["exemplars"] = {k: v.numpy().copy() for k, v in trainer.exemplars.items()}
        if it == 0:
            step["grads"] = {n: p.grad.numpy().copy() for n, p in trainer.model.named_parameters()
                             if p.requires_grad}
        out["steps"].append(step)
    return out


def _rpn_only(spec):
    """2 steps of the RPN-only teacher, whose RoI heads take no gradient,
    on this rank's rows of the teacher's batches, with its generator's
    draws."""
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer
    from cvpr22_cross_modal_pseudo_labeling_torch.parallel.dist import rank

    trainer = Trainer(spec["config"], spec["opts"] + ["MODEL.RPN_ONLY", True], device="cpu", seed=3)
    trainer.load_flax_params(spec["tree"])
    metrics = [{k: float(v) for k, v in trainer.step(rank_rows(b, rank())).items()} for b in spec["batches"]]
    return {"metrics": metrics, "params": _params(trainer.model)}


def dump(obj, path):
    """Pickles ``obj`` to ``path`` through a rename, so that a reader
    waiting for the file never sees half of it."""
    with open(f"{path}.tmp", "wb") as f:
        pickle.dump(obj, f)
    os.replace(f"{path}.tmp", path)


def wait_load(path, timeout=600.0):
    """Unpickles ``path`` once it exists (written by :func:`dump`)."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never came")
        time.sleep(0.1)
    with open(path, "rb") as f:
        return pickle.load(f)


def worker(rank_, world, tmp):
    """One rank: each family's steps as its inputs arrive and the helpers'
    results, pickled to ``tmp/rank{rank_}.pkl``."""
    import importlib

    import torch.distributed as dist

    from cvpr22_cross_modal_pseudo_labeling_torch.parallel import dist as pdist

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank_, world_size=world)
    rec = []

    def recording(x):
        out = pdist.global_sum(x)
        if x.numel() == 1:
            rec.append((float(x), float(out)))
        return out

    for name in NORMALIZER_MODULES:
        importlib.import_module(name).global_sum = recording
    result = {
        "gather_rows": pdist.gather_rows(torch.arange(3) + 10 * rank_).tolist(),
        "gather_rows_bool": pdist.gather_rows(torch.tensor([rank_ == 1, True])).tolist(),
        "gather_objects": pdist.gather_objects({"rank": rank_}),
        "global_sum": float(pdist.global_sum(torch.tensor(float(rank_ + 1)))),
        "families": {name: _run_family(wait_load(tmp / f"inputs_{name}.pkl"), rec) for name in RANK_RUNS},
    }
    result["rpn_only"] = _rpn_only(wait_load(tmp / "inputs_teacher.pkl"))
    dump(result, tmp / f"rank{rank_}.pkl")
    dist.destroy_process_group()


def start(args, threads="2", file=__file__):
    """A test file (this one: ``--worker`` or ``--jax``) as a process."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS=threads)
    return subprocess.Popen([sys.executable, file, *map(str, args)], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def join(proc, timeout=600):
    out, _ = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out[-4000:]


# ---------------------------------------------------------------------------
# the JAX mesh step and the global batches
# ---------------------------------------------------------------------------


def st_global_batch(seed):
    """4 images (2 a rank) with the exemplar test's tables; rank 1's first
    image is 24 x 20 pixels, its second has no gt box and no valid
    caption noun."""
    from tests.test_torch_exemplars import ex_batch

    a, b = ex_batch("both_branches", seed), ex_batch("both_branches", seed + 1)
    batch = {k: a[k] if k in TABLE_KEYS else np.concatenate([a[k], b[k]]) for k in a}
    batch["image_ids"] = np.arange(4, dtype=np.int64)
    batch["image_sizes"][2] = [24, 20]
    batch["gt_valid"][3] = False
    batch["gt_boxes"][3] = 0
    batch["gt_labels"][3] = 0
    batch["cap_word_valid"][3] = False
    return batch


def teacher_global_batch(seed):
    """4 images: rank 1's first 24 x 20 pixels, its second without gt."""
    from tests.test_torch_teacher import tiny_batch

    a, b = tiny_batch("three_gt", seed), tiny_batch("image_without_gt", seed + 1)
    batch = {k: a[k] if k in TABLE_KEYS else np.concatenate([a[k], b[k]]) for k in a}
    batch["image_sizes"][2] = [24, 20]
    return batch


def jax_mesh_run(family):
    """The JAX step on a 2-device mesh, ``STEPS`` times: the port's
    inputs (seeded tree, global batches, recorded draws) and JAX's
    metrics, first-step gradients, parameters and table after each step."""
    import jax
    import jax.numpy as jnp
    import optax

    from cvpr22_cross_modal_pseudo_labeling_torch import bridge
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer
    from cvpr22_cross_modal_pseudo_labeling_tpu.engine import optimizer as jax_opt
    from cvpr22_cross_modal_pseudo_labeling_tpu.engine import train_step as jax_train
    from cvpr22_cross_modal_pseudo_labeling_tpu.parallel.mesh import make_mesh, replicated

    if family == "st":
        from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import st_generalized_rcnn as jax_st
        from tests.test_torch_st_train import TRAIN_OPTS, JaxDraws, jax_cfg_of

        config, arch, opts = ST_CONFIG, "STGeneralizedRCNN", TRAIN_OPTS + ["MODEL.EXEMPLARS_ENABLED", True]
        cfg = jax_cfg_of(["MODEL.EXEMPLARS_ENABLED", True])
        model = jax_st.STGeneralizedRCNN(jax_st.st_statics_from_cfg(cfg))
        extra = jax_st.init_exemplar_table(1203, 16)
        make_batch = st_global_batch
    else:
        from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import generalized_rcnn as jax_grcnn
        from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import statics as jax_statics
        from tests.test_torch_teacher import RCNN_KEYS, TRAIN_OPTS, JaxDraws, jax_cfg_of

        config, arch, opts = TEACHER, "GeneralizedRCNN", TRAIN_OPTS
        cfg = jax_cfg_of(())
        model = jax_grcnn.GeneralizedRCNN(jax_statics.statics_from_cfg(cfg))
        extra = None
        make_batch = teacher_global_batch
    port = Trainer(config, opts, device="cpu", seed=3)
    tree = bridge.seeded_flax_params(port.model, seed=0)
    params = {"params": jax.tree_util.tree_map(jnp.asarray, tree)}
    tx, labels = jax_opt.make_optimizer(cfg, params["params"], jax_opt.frozen_prefixes_from_cfg(cfg, arch))
    loss_fn = jax_train.build_loss_fn(model, arch)
    # the trainable leaves' paths: the program hands out only their
    # gradients (all of them cost it a third more compile time)
    trainable = {path for path, label in jax.tree_util.tree_flatten_with_path(labels)[0] if label != "frozen"}

    def step_and_grads(state, batch):
        # build_train_step's step (tpu/engine/train_step.py:193-207),
        # which also hands out its gradient
        rng = jax.random.fold_in(state.rng, state.step)
        grads, (losses, info) = jax.grad(loss_fn, has_aux=True)(state.params, batch, rng, state.extra)
        new_state = jax_train._apply_update(state, grads, tx)
        new_extra = info.pop("exemplars", None)
        if new_extra is not None:
            new_state = new_state.replace(extra=new_extra)
        metrics = {**losses, **info}
        metrics["total_loss"] = sum(losses.values())
        metrics["grad_norm"] = optax.global_norm(grads)
        flat = jax.tree_util.tree_flatten_with_path(grads["params"])[0]
        return new_state, (metrics, [g for path, g in flat if path in trainable])

    mesh = make_mesh(devices=jax.devices()[:WORLD])
    batches = [make_batch(1 + 2 * it) for it in range(STEPS)]
    keys = [k for k in batches[0] if k != "image_ids"] if family == "st" else list(RCNN_KEYS)
    jax_batches = [{k: jnp.asarray(b[k]) for k in keys} for b in batches]
    run = jax_train.jit_train_step(step_and_grads, mesh, jax_batches[0])
    # replicated from the start, so that both steps run one program
    state = jax.device_put(jax_train.create_train_state(params, tx, jax.random.PRNGKey(0), extra=extra),
                           replicated(mesh))
    ref = {"metrics": [], "params": [], "exemplars": []}
    draws = []
    for it, jb in enumerate(jax_batches):
        rec = JaxDraws(port.model.statics.base.rpn_post_nms_test) if family == "st" else JaxDraws()
        with rec:
            state, (metrics, grads) = run(state, jb)
            jax.block_until_ready(state.params)
        draws.append({k: v.numpy() for k, v in rec.draws()._asdict().items() if v is not None})
        ref["metrics"].append({k: float(v) for k, v in metrics.items() if np.ndim(v) == 0})
        ref["params"].append({k: v.numpy() for k, v in bridge.state_dict_from_flax(
            port.model, jax.tree_util.tree_map(np.asarray, state.params["params"])).items()})
        if extra is not None:
            ref["exemplars"].append({k: np.asarray(v) for k, v in state.extra.items()})
        if it == 0:
            # the trainable gradients in the tree's order, zeros elsewhere
            leaves = iter(grads)
            full = jax.tree_util.tree_map_with_path(
                lambda path, p: np.asarray(next(leaves)) if path in trainable else np.zeros(p.shape, p.dtype),
                tree)
            ref["grads"] = {k: v.numpy() for k, v in bridge.state_dict_from_flax(port.model, full).items()}
    spec = dict(config=config, opts=opts, tree=tree, batches=[{k: b[k] for k in keys} for b in batches],
                draws=draws)
    return spec, ref


def ft_emb_spec(spec, seed=5):
    """The student-teacher spec under ``FT_EMB`` (the exemplar table still
    on): the tokenized LVIS names, 1 to 4 wordpieces each, in place of the
    LVIS table, which the step rebuilds from the live word table.  The
    draws are the plain run's: their shapes follow the batch alone."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((1203, 4)) < 0.6).astype(np.float32)
    mask[:, 0] = 1
    names = dict(lvis_name_ids=rng.integers(1, 500, (1203, 4)).astype(np.int64), lvis_name_mask=mask)
    batches = [{**{k: v for k, v in b.items() if k != "lvis_class_embeddings"}, **names} for b in spec["batches"]]
    return {**spec, "opts": spec["opts"] + ["MODEL.LANGUAGE_BACKBONE.FT_EMB", True], "batches": batches}


def one_process_run(spec):
    """The port's one-process step on the global batches: metrics, the
    first step's gradients and the parameters after each step."""
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer
    from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.generalized_rcnn import TrainDraws

    trainer = Trainer(spec["config"], spec["opts"], device="cpu", seed=3)
    trainer.load_flax_params(spec["tree"])
    out = {"metrics": [], "params": [], "start": _params(trainer.model)}
    for it, (batch, draws) in enumerate(zip(spec["batches"], spec["draws"])):
        metrics = trainer.step(batch, TrainDraws(**{k: torch.from_numpy(v) for k, v in draws.items()}))
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        out["params"].append(_params(trainer.model))
        if it == 0:
            out["grads"] = {n: p.grad.numpy().copy() for n, p in trainer.model.named_parameters() if p.requires_grad}
    return out


def jax_job(family, tmp):
    """``jax_mesh_run`` of ``family``: the port's inputs for the ranks
    and JAX's results, each to its file."""
    spec, ref = jax_mesh_run(family)
    dump(ref, tmp / f"jax_{family}.pkl")
    dump(spec, tmp / f"inputs_{family}.pkl")
    return spec, ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks and the teacher's JAX program start at once, in their own
    processes; the student-teacher model's JAX program runs here.  Each
    family's ranks step as soon as JAX has recorded its draws, and this
    process runs the one-process steps meanwhile."""
    tmp = tmp_path_factory.mktemp("ddp")
    procs = [start(["--worker", r, WORLD, tmp]) for r in range(WORLD)]
    procs.append(start(["--jax", "teacher", tmp], threads="4"))
    try:
        specs, refs = {}, {}
        specs["st"], refs["st"] = jax_job("st", tmp)
        specs["st_ft_emb"] = ft_emb_spec(specs["st"])
        dump(specs["st_ft_emb"], tmp / "inputs_st_ft_emb.pkl")
        single = {name: one_process_run(specs[name]) for name in ("st", "st_ft_emb")}
        join(procs[-1])
        specs["teacher"], refs["teacher"] = wait_load(tmp / "inputs_teacher.pkl"), wait_load(tmp / "jax_teacher.pkl")
        single["teacher"] = one_process_run(specs["teacher"])
        for p in procs[:WORLD]:
            join(p)
        ranks = [wait_load(tmp / f"rank{r}.pkl") for r in range(WORLD)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return dict(specs=specs, jax=refs, single=single, ranks=ranks)


def _rel_norm(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _grad_tol(name):
    if "roi_extractor" in name:
        return 2e-3
    # a scalar summed over every mixed table entry: tests/test_torch_exemplars.py
    # holds it within 1e-4 (its update)
    return 1e-4 if name == "lambda_exemplar" else 1e-5


ST_LOSSES = ("loss_classifier_pseudo", "loss_box_reg_pseudo", "loss_mask_pseudo", "loss_classifier",
             "loss_box_reg", "loss_mask", "total_loss")
LOSSES = {
    "st": ST_LOSSES,
    "st_ft_emb": ST_LOSSES,
    "teacher": ("loss_objectness", "loss_rpn_box_reg", "loss_classifier", "loss_box_reg", "loss_mask",
                "total_loss"),
}


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


def test_helpers_are_the_identity_without_a_process_group():
    from cvpr22_cross_modal_pseudo_labeling_torch.parallel import dist as pdist

    assert not torch.distributed.is_initialized()
    x = torch.arange(6.0).reshape(3, 2)
    assert pdist.world_size() == 1 and pdist.rank() == 0 and pdist.is_primary()
    assert pdist.global_sum(x) is x and pdist.gather_rows(x) is x
    assert pdist.gather_objects({"a": 1}) == [{"a": 1}]
    pdist.barrier()
    with pytest.raises(ValueError, match="nccl backend needs CUDA"):
        pdist.init_from_env("nccl", "cpu")
    with pytest.raises(ValueError, match="dist backend"):
        pdist.init_from_env("mpi", "cpu")


def test_gather_helpers_keep_rank_order(runs):
    for r, out in enumerate(runs["ranks"]):
        assert out["gather_rows"] == [0, 1, 2, 10, 11, 12], r
        assert out["gather_rows_bool"] == [False, True, True, True], r
        assert out["gather_objects"] == [{"rank": 0}, {"rank": 1}], r
        assert out["global_sum"] == 3.0, r


@pytest.mark.parametrize("family", RANK_RUNS)
def test_rank_counts_differ(runs, family):
    """The unequal case is present: every normalizer is reduced, and the
    ranks' own counts differ for some of them at each step."""
    r0, r1 = (out["families"][family]["steps"] for out in runs["ranks"])
    for s0, s1 in zip(r0, r1):
        assert len(s0["normalizers"]) == len(s1["normalizers"]) >= 3
        for (l0, g0), (l1, g1) in zip(s0["normalizers"], s1["normalizers"]):
            assert g0 == g1 == l0 + l1
        assert any(l0 != l1 for (l0, _), (l1, _) in zip(s0["normalizers"], s1["normalizers"]))


@pytest.mark.parametrize("family", RANK_RUNS)
def test_ranks_are_bit_equal_after_every_step(runs, family):
    r0, r1 = (out["families"][family]["steps"] for out in runs["ranks"])
    for it, (s0, s1) in enumerate(zip(r0, r1)):
        assert s0["metrics"] == s1["metrics"], it
        for key in ("params", "buffers", "grads", "exemplars"):
            if key not in s0:
                continue
            assert set(s0[key]) == set(s1[key]), key
            for name in s0[key]:
                np.testing.assert_array_equal(s0[key][name], s1[key][name], err_msg=f"{it} {key} {name}")


def test_rpn_only_detector_steps_on_two_ranks(runs):
    """Its RoI heads take no gradient: DDP looks for them every step, and
    the ranks stay equal."""
    r0, r1 = (out["rpn_only"] for out in runs["ranks"])
    assert r0["metrics"] == r1["metrics"] and len(r0["metrics"]) == STEPS
    assert set(r0["metrics"][0]) == {"loss_objectness", "loss_rpn_box_reg", "total_loss", "grad_norm"}
    assert all(np.isfinite(v) for m in r0["metrics"] for v in m.values())
    for name in r0["params"]:
        np.testing.assert_array_equal(r0["params"][name], r1["params"][name], err_msg=name)


@pytest.mark.parametrize("family", FAMILIES)
def test_two_rank_step_matches_jax_mesh_step(runs, family):
    got = runs["ranks"][0]["families"][family]["steps"]
    ref = runs["jax"][family]
    single = runs["single"][family]
    for it in range(STEPS):
        for k in LOSSES[family]:
            np.testing.assert_allclose(got[it]["metrics"][k], ref["metrics"][it][k], rtol=1e-5 if it == 0 else 1e-4,
                                       err_msg=f"{it} {k}")
    grads = got[0]["grads"]
    want_norm = float(np.sqrt(sum(float(np.sum(ref["grads"][n].astype(np.float64) ** 2)) for n in grads)))
    assert abs(got[0]["metrics"]["grad_norm"] / want_norm - 1) < 1e-3
    for name, g in grads.items():
        if family == "st" or name.startswith(("box_predictor.", "mask_predictor.")):
            assert _rel_norm(g, ref["grads"][name]) <= _grad_tol(name), name
        else:
            # the teacher's trunk, RPN and C5 head: JAX's float32
            # gradient is itself several 1e-5 from a float64 run
            # (tests/test_torch_teacher.py); the port's one-process
            # gradient is the reference here
            assert _rel_norm(g, single["grads"][name]) <= _grad_tol(name), name
    for it in range(STEPS):
        before = got[it - 1]["params"] if it else single["start"]
        for name in grads:
            up = got[it]["params"][name] - before[name]
            want = ref["params"][it][name] - before[name]
            tol = 10 * _grad_tol(name) if family == "st" else 1e-3
            assert _rel_norm(up, want) <= tol, (it, name, _rel_norm(up, want))
    if family == "st":
        for it in range(STEPS):
            table, want = got[it]["exemplars"], ref["exemplars"][it]
            np.testing.assert_array_equal(table["valid"], want["valid"])
            np.testing.assert_allclose(table["quality"], want["quality"], rtol=0, atol=1e-6)
            np.testing.assert_allclose(table["embs"], want["embs"], rtol=0, atol=1e-5)
        # both ranks' candidates reached the table: more slots than one
        # rank's two images fill
        assert int(got[0]["exemplars"]["valid"].sum()) > 0


@pytest.mark.parametrize("family", RANK_RUNS)
def test_two_rank_step_matches_one_process_step(runs, family):
    got = runs["ranks"][0]["families"][family]["steps"]
    single = runs["single"][family]
    for it in range(STEPS):
        for k in LOSSES[family] + ("grad_norm",):
            np.testing.assert_allclose(got[it]["metrics"][k], single["metrics"][it][k], rtol=1e-5,
                                       err_msg=f"{it} {k}")
    for name, g in got[0]["grads"].items():
        assert _rel_norm(g, single["grads"][name]) <= _grad_tol(name), name


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    parser = argparse.ArgumentParser()
    parser.add_argument("--worker", nargs=3, metavar=("RANK", "WORLD", "DIR"))
    parser.add_argument("--jax", nargs=2, metavar=("FAMILY", "DIR"))
    args = parser.parse_args()
    if args.worker:
        worker(int(args.worker[0]), int(args.worker[1]), pathlib.Path(args.worker[2]))
    else:
        import tests.conftest  # noqa: F401  (the 8 CPU devices and the random bits of the suite's JAX)

        jax_job(args.jax[0], pathlib.Path(args.jax[1]))
