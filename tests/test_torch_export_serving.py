"""The port's kernels as ``torch.library`` custom ops, and its serving
export (``cvpr22_cross_modal_pseudo_labeling_torch/tools/export_serving.py``).

On the CPU: ``torch.library.opcheck`` on ``cmpl::nms``,
``cmpl::roi_align``, ``cmpl::roi_align_levels`` and
``cmpl::roi_align_backward`` (schema, fake implementation, autograd
registration, AOT dispatch), and the registered gradients against
autograd of the plain versions (1e-6: the same float32 contraction,
summed in another order).  Then a tiny student-teacher model (through
the tool's ``main`` on a synthetic COCO tree, a port checkpoint and the
dataset's 768-d class table) and a tiny teacher (through
``export_model``) are exported, saved, and served by ``load_and_run`` in
a subprocess in which ``jax``, the JAX package and the port's
``models`` and ``engine`` are blocked: their detections and masks are
bit-equal to ``Predictor``'s on the same inputs, and within the eval
tests' tolerances of JAX's ``model.apply`` on the same weights (boxes
1e-3 px, scores 1e-5, mask probabilities 1e-4; labels and valid flags
equal; ``tests/test_torch_st_eval.py``).  Last, the weight rules the
tool shares with ``test_net`` (``engine/checkpoint.py::
load_eval_weights``).
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.config import get_default_cfg as jax_cfg
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import generalized_rcnn as jax_grcnn
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import st_generalized_rcnn as jax_st
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import statics as jax_statics
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.engine.checkpoint import checkpoint_state, save_checkpoint
from cvpr22_cross_modal_pseudo_labeling_torch.engine.inference import Predictor
from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer
from cvpr22_cross_modal_pseudo_labeling_torch.ops import kernels
from cvpr22_cross_modal_pseudo_labeling_torch.ops import nms as nm
from cvpr22_cross_modal_pseudo_labeling_torch.ops import roi_align as ra
from cvpr22_cross_modal_pseudo_labeling_torch.tools import export_serving
from tests.test_torch_eval import TINY_EVAL_OPTS
from tests.test_torch_st_eval import TINY_OPTS
from tests.torch_threads import two_torch_threads  # noqa: F401  (an autouse fixture)

REPO = Path(__file__).resolve().parents[1]
ST = str(REPO / "configs/coco_cap_det/student_teacher_mask_rcnn_uncertainty.yaml")
TEACHER = str(REPO / "configs/coco_cap_det/zeroshot_mask.yaml")
B, H, W = 2, 64, 96
MANIFEST = {"input_shape", "input_dtype", "platforms", "num_classes", "meta_architecture", "bytes"}
BLOCKED = ("jax", "jaxlib", "flax", "optax", "cvpr22_cross_modal_pseudo_labeling_tpu",
           "cvpr22_cross_modal_pseudo_labeling_torch.models", "cvpr22_cross_modal_pseudo_labeling_torch.engine")


def _rois(rng, b, s, extent):
    xy = rng.uniform(-4, extent, (b, s, 2))
    return torch.from_numpy(np.concatenate([xy, xy + rng.uniform(1, 30, (b, s, 2))], -1).astype(np.float32))


def _op_cases():
    rng = np.random.default_rng(0)
    f = torch.from_numpy(rng.standard_normal((2, 12, 16, 8)).astype(np.float32))
    f2 = torch.from_numpy(rng.standard_normal((2, 6, 8, 8)).astype(np.float32))
    rois = _rois(rng, 2, 5, 48)
    levels = torch.from_numpy(rng.integers(0, 2, (2, 5)).astype(np.int32))
    scores = torch.from_numpy(rng.random((2, 5)).astype(np.float32))
    valid = torch.tensor([[1, 1, 1, 0, 1], [1, 1, 1, 1, 1]], dtype=torch.bool)
    grad = torch.from_numpy(rng.standard_normal((2, 5, 4, 4, 8)).astype(np.float32))
    return {
        "nms": (nm.nms_op, (rois, scores, valid, 0.5, 3, None)),
        "nms_labels": (nm.nms_op, (rois, scores, valid, 0.3, 8, torch.from_numpy(rng.integers(0, 2, (2, 5))))),
        "roi_align": (ra.roi_align_op, (f.clone().requires_grad_(), rois, [7, 7], 0.25, 0, 8, 2)),
        "roi_align_bf16": (ra.roi_align_op, (f.to(torch.bfloat16).requires_grad_(), rois, [7, 7], 0.25, 2, 8, 1)),
        "roi_align_levels": (ra.roi_align_levels_op, ([f.clone().requires_grad_(), f2.clone().requires_grad_()],
                                                      rois, levels, [7, 7], [0.25, 0.125], 2, 8)),
        "roi_align_backward": (ra.roi_align_backward_op,
                               (grad, rois, [2, 12, 16, 8], torch.float32, [7, 7], 0.25, 0, 8, 2, None, 0)),
        "roi_align_backward_level": (ra.roi_align_backward_op, (grad.to(torch.bfloat16), rois, [2, 12, 16, 8],
                                                                torch.bfloat16, [7, 7], 0.25, 0, 8, 2, levels, 1)),
    }


@pytest.mark.parametrize("case", sorted(_op_cases()))
def test_custom_op_passes_opcheck(case):
    op, args = _op_cases()[case]
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_registered_gradients_equal_autograd_of_the_plain_versions():
    """The ops' ``register_autograd`` (the backward op) against autograd
    of the plain forwards, for one level and for two."""
    rng = np.random.default_rng(1)
    f = torch.from_numpy(rng.standard_normal((2, 12, 16, 8)).astype(np.float32))
    f2 = torch.from_numpy(rng.standard_normal((2, 6, 8, 8)).astype(np.float32))
    rois = _rois(rng, 2, 6, 48)
    levels = torch.from_numpy(rng.integers(0, 2, (2, 6)).astype(np.int32))
    g = torch.from_numpy(rng.standard_normal((2, 6, 4, 4, 8)).astype(np.float32))
    a, b = f.clone().requires_grad_(), f.clone().requires_grad_()
    (ra.roi_align_op(a, rois, [7, 7], 0.25, 0, 8, 2) * g).sum().backward()
    (ra.roi_align_plain(b, rois, (7, 7), 0.25, 0, 8, 2) * g).sum().backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=1e-6)
    g1 = torch.from_numpy(rng.standard_normal((2, 6, 7, 7, 8)).astype(np.float32))
    ops = [f.clone().requires_grad_(), f2.clone().requires_grad_()]
    plain = [f.clone().requires_grad_(), f2.clone().requires_grad_()]
    (ra.roi_align_levels_op(ops, rois, levels, [7, 7], [0.25, 0.125], 2, 8) * g1).sum().backward()
    (ra._roi_align_levels_plain(plain, rois, levels, (7, 7), (0.25, 0.125), 2, 8) * g1).sum().backward()
    for x, y in zip(ops, plain):
        assert y.grad.abs().max() > 0
        torch.testing.assert_close(x.grad, y.grad, rtol=0, atol=1e-6)


def test_wrappers_route_cpu_tensors_by_gradient():
    """On the CPU a wrapper calls the op when no gradient is needed and
    runs the plain version under autograd when one is (the CPU training
    numerics stay those the parity tests hold against ``jax.grad``)."""
    rng = np.random.default_rng(2)
    f = torch.from_numpy(rng.standard_normal((1, 12, 16, 8)).astype(np.float32))
    rois = _rois(rng, 1, 3, 48)
    with_grad = ra.roi_align(f.clone().requires_grad_(), rois, (7, 7), 0.25)
    assert "cmpl" not in type(with_grad.grad_fn).__name__.lower()
    with torch.no_grad():
        without = ra.roi_align(f, rois, (7, 7), 0.25)
    assert torch.equal(with_grad.detach(), without)


def _jax_apply(model, tree, images, sizes, table):
    fn = jax.jit(lambda p, i, s, c: model.apply({"params": p}, i, s, class_embeddings=c, train=False))
    out = fn(jax.tree_util.tree_map(jnp.asarray, tree), images, sizes, table)
    return {"boxes": out.detections.boxes, "scores": out.detections.scores, "labels": out.detections.labels,
            "valid": out.detections.valid, "mask_probs": out.mask_probs}


def _jax_model(config, opts, st):
    cfg = jax_cfg()
    cfg.merge_from_file(config)
    cfg.merge_from_list(list(opts))
    if st:
        return jax_st.STGeneralizedRCNN(jax_st.st_statics_from_cfg(cfg))
    return jax_grcnn.GeneralizedRCNN(jax_statics.statics_from_cfg(cfg))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The ST model through ``main`` (a synthetic COCO tree, a port
    checkpoint) and the teacher through ``export_model``; then both
    served in one blocked subprocess.  Per model: the artifact, its
    manifest, the exported program's op names, the inputs, ``Predictor``'s
    outputs, the served outputs and JAX's outputs."""
    out = tmp_path_factory.mktemp("export")
    tree_dir = out / "synth"
    subprocess.run([sys.executable, str(REPO / "tools/synth_coco.py"), "--out", str(tree_dir), "--train", "2",
                    "--val", "4", "--seen", "3", "--unseen", "2"], check=True, capture_output=True, timeout=300)
    mp = pytest.MonkeyPatch()
    mp.setenv("CMPL_TPU_DATA_DIR", str(tree_dir))
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
    sizes = np.array([[H, W], [48, 80]], np.int32)
    res = {}
    launches = {k.name: k.launches for k in kernels.ALL}

    # the student-teacher model through the tool's command line
    st_opts = TINY_EVAL_OPTS
    trainer = Trainer(ST, st_opts, device="cpu")
    tree = bridge.seeded_flax_params(trainer.model, seed=5, emb_pred_std=0.01)
    trainer.load_flax_params(tree)
    ckpt = save_checkpoint(str(out / "ckpt"), checkpoint_state(trainer, 1), 1)
    st_path = str(out / "st.pt2")
    manifest = export_serving.main(["--config-file", ST, "--ckpt", ckpt, "--out", st_path, "--batch", str(B),
                                    "--height", str(H), "--width", str(W), "--device", "cpu", *map(str, st_opts)])
    pred = Predictor(ST, st_opts, device="cpu")
    pred.model.load_state_dict(trainer.model.state_dict())
    table = export_serving.test_class_table(pred.cfg)
    res["st"] = dict(path=st_path, manifest=manifest, table=table, tree=tree, opts=st_opts, config=ST, st=True,
                     predictor=pred(images, sizes, table))

    # the teacher through export_model
    t_opts = TINY_OPTS
    pred = Predictor(TEACHER, t_opts, device="cpu")
    tree = bridge.seeded_flax_params(pred.model, seed=6, emb_pred_std=0.01)
    pred.load_flax_params(tree)
    table = rng.standard_normal((6, 16)).astype(np.float32)
    t_path = str(out / "teacher.pt2")
    manifest = export_serving.export_model(pred.model, table, "GeneralizedRCNN", B, H, W, t_path)
    res["teacher"] = dict(path=t_path, manifest=manifest, table=table, tree=tree, opts=t_opts, config=TEACHER,
                          st=False, predictor=pred(images, sizes, table))
    mp.undo()
    res["launches_unchanged"] = launches == {k.name: k.launches for k in kernels.ALL}

    np.savez(out / "inputs.npz", images=images, sizes=sizes)
    code = (
        "import sys, json\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        f"torch.set_num_threads({torch.get_num_threads()})  # the sums in this process's order\n"
        "from cvpr22_cross_modal_pseudo_labeling_torch.tools.export_serving import load_and_run, load_exported\n"
        f"d = np.load({str(out / 'inputs.npz')!r})\n"
        "ops = {}\n"
        "for name in ('st', 'teacher'):\n"
        f"    path = {str(out)!r} + '/' + name + '.pt2'\n"
        "    served = load_and_run(path, d['images'], d['sizes'])\n"
        f"    np.savez({str(out)!r} + '/' + name + '_served.npz', **{{k: v.numpy() for k, v in served.items()}})\n"
        "    ops[name] = sorted({str(n.target) for n in load_exported(path).graph.nodes\n"
        "                        if str(n.target).startswith('cmpl.')})\n"
        "print(json.dumps(ops))\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.startswith('cvpr22') and sys.modules[m] is not None)))\n"
    )
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    lines = run.stdout.strip().splitlines()
    res["ops"], res["imported"] = json.loads(lines[-2]), json.loads(lines[-1])
    for name in ("st", "teacher"):
        r = res[name]
        r["served"] = dict(np.load(out / f"{name}_served.npz"))
        model = _jax_model(r["config"], r["opts"], r["st"])
        r["jax"] = _jax_apply(model, r["tree"], images, sizes, r["table"])
    return res


def test_export_serving_manifest_has_its_fields(exported):
    st, teacher = exported["st"]["manifest"], exported["teacher"]["manifest"]
    for m, path in ((st, exported["st"]["path"]), (teacher, exported["teacher"]["path"])):
        assert set(m) == MANIFEST and m["input_shape"] == [B, H, W, 3] and m["input_dtype"] == "uint8"
        assert m["platforms"] == ["cpu"] and m["bytes"] == Path(path).stat().st_size > 1000
        assert json.loads(Path(path + ".json").read_text()) == m
    assert st["meta_architecture"] == "STGeneralizedRCNN" and teacher["meta_architecture"] == "GeneralizedRCNN"
    # the synthetic tree's generalized zero-shot val set: 5 classes and the background
    assert st["num_classes"] == exported["st"]["table"].shape[0] == 6 and teacher["num_classes"] == 6


def test_served_process_imports_no_model_code_and_the_graph_calls_the_custom_ops(exported):
    assert not any(m.startswith(("cvpr22_cross_modal_pseudo_labeling_torch.models",
                                 "cvpr22_cross_modal_pseudo_labeling_torch.engine",
                                 "cvpr22_cross_modal_pseudo_labeling_tpu")) for m in exported["imported"])
    for name in ("st", "teacher"):
        assert exported["ops"][name] == ["cmpl.nms.default", "cmpl.roi_align.default"], exported["ops"]
    # tracing ran the fake implementations: no kernel was counted
    assert exported["launches_unchanged"]


@pytest.mark.parametrize("name", ["st", "teacher"])
def test_served_detections_are_bit_equal_to_the_predictor(exported, name):
    r = exported[name]
    dets, masks = r["predictor"]
    served = r["served"]
    assert sorted(served) == ["boxes", "labels", "mask_probs", "scores", "valid"]
    for key in ("boxes", "scores", "labels", "valid"):
        got, want = served[key], getattr(dets, key)
        assert got.dtype == want.dtype and np.array_equal(got, want), key
    assert np.array_equal(served["mask_probs"], masks)
    assert dets.valid.sum(axis=1).min() > 0


@pytest.mark.parametrize("name", ["st", "teacher"])
def test_served_detections_match_jax(exported, name):
    served, ref = exported[name]["served"], exported[name]["jax"]
    np.testing.assert_array_equal(served["valid"], np.asarray(ref["valid"]))
    np.testing.assert_array_equal(served["labels"], np.asarray(ref["labels"]))
    np.testing.assert_allclose(served["boxes"], np.asarray(ref["boxes"]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(served["scores"], np.asarray(ref["scores"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(served["mask_probs"], np.asarray(ref["mask_probs"]), rtol=0, atol=1e-4)


def test_eval_weights_take_a_port_checkpoint_or_imported_weights(tmp_path):
    """``engine/checkpoint.py::load_eval_weights``, shared by ``test_net``
    and ``export_serving``: the ``.npz`` of a flax tree named by ``ckpt``
    is imported leaf for leaf; a port checkpoint loads as it is, and one of
    another meta-architecture raises."""
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.checkpoint import load_eval_weights

    source = Predictor(TEACHER, TINY_OPTS, device="cpu")
    tree = bridge.seeded_flax_params(source.model, seed=6, emb_pred_std=0.01)
    source.load_flax_params(tree)
    flat = dict((("/".join(k), v) for k, v in _flat(tree)))
    np.savez(tmp_path / "weights.npz", **flat)
    target = Predictor(TEACHER, TINY_OPTS, device="cpu")
    load_eval_weights(target, target.cfg, str(tmp_path / "weights.npz"), seed=0)
    want = source.model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in target.model.state_dict().items())

    trainer = Trainer(TEACHER, TINY_OPTS, device="cpu")
    trainer.load_flax_params(tree)
    ckpt = save_checkpoint(str(tmp_path / "ckpt"), checkpoint_state(trainer, 1), 1)
    target = Predictor(TEACHER, TINY_OPTS, device="cpu")
    assert "loaded checkpoint" in load_eval_weights(target, target.cfg, ckpt, seed=0)
    assert all(torch.equal(v, want[k]) for k, v in target.model.state_dict().items())
    st = Predictor(ST, TINY_EVAL_OPTS, device="cpu")
    with pytest.raises(RuntimeError, match="holds a GeneralizedRCNN model"):
        load_eval_weights(st, st.cfg, ckpt, seed=0)


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)
