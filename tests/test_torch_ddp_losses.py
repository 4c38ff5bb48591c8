"""The keypoint, RetinaNet and WSDDN losses over the global batch, on 2
gloo ranks on the CPU.

JAX computes each of these losses in one SPMD program over the global
batch, so its normalizer counts every rank's rows: the visible
keypoints (``keypoint_loss``), the positive anchors and the images
(``retinanet_loss``), the (image, class) entries (``wsddn_loss``).  On
ranks each loss returns the rank's share, its own sum over the global
count (``parallel/dist.py::global_sum``), and the summing comm hook makes
the global gradient the sum of the ranks' gradients.

- Each loss function on each rank's rows, with counts that differ by
  rank (a rank whose rois are mostly invalid, an image without gt, a
  split of 3 + 1 images): the ranks' losses sum to the one-process loss
  on the global rows within 1e-6 relative, the gradient of each rank's
  inputs is the one-process gradient's rows within 1e-6 of its scale,
  and each normalizer the ranks reduce is the sum of their unequal
  counts.
- One ``Trainer`` step of each family on 2 ranks, 2 images a rank of a
  global batch of 4 (rank 1's second image without gt), against the
  port's one-process step on the same weights, batch and draws (the
  samplers' priorities the one-process step drew): the losses and the
  gradient norm within 1e-5 relative, the ranks' weights bit-equal, and
  the normalizers the sums of unequal counts.  The families at narrow
  widths: the C4 teacher with ``MODEL.KEYPOINT_ON`` and with
  ``MODEL.ROI_BOX_HEAD.WSDDN`` (``tests/test_torch_keypoint_wsddn.py``'s
  options) and RetinaNet (``tests/test_torch_retinanet.py``'s narrow
  detector).  Those files hold the one-process steps against JAX.

The ranks are two processes of this file (``python
tests/test_torch_ddp_losses.py --worker RANK WORLD DIR``, a ``file://``
rendezvous in DIR), started once for the module; they import no jax and
take their inputs, written by this process, from DIR.
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
FAMILIES = ("keypoint", "wsddn", "retinanet")
# the modules whose normalizers go through global_sum, by the name each
# imports it under
NORMALIZER_MODULES = (
    "cvpr22_cross_modal_pseudo_labeling_torch.models.rpn.rpn",
    "cvpr22_cross_modal_pseudo_labeling_torch.models.rpn.retinanet",
    "cvpr22_cross_modal_pseudo_labeling_torch.models.roi_heads.box_head",
    "cvpr22_cross_modal_pseudo_labeling_torch.models.roi_heads.keypoint_head",
    "cvpr22_cross_modal_pseudo_labeling_torch.models.roi_heads.wsddn_head",
)
TABLE_KEYS = ("class_embeddings",)


def _split(x, splits, r):
    return x[sum(splits[:r]):sum(splits[:r + 1])]


# ---------------------------------------------------------------------------
# the loss functions' inputs (numpy; the first array is the one whose
# gradient is held), each rank's row counts, and the call


def keypoint_case(seed=3):
    """8 rois of 14 x 14 heatmaps and 5 keypoints, split 5 + 3: most of
    rank 1's rois are invalid."""
    rng = np.random.default_rng(seed)
    s, h, k = 8, 14, 5
    logits = (rng.standard_normal((s, h, h, k)) * 3).astype(np.float32)
    x0 = rng.uniform(0, 50, (s, 2))
    rois = np.concatenate([x0, x0 + rng.uniform(5, 60, (s, 2))], 1).astype(np.float32)
    kps = np.concatenate([rng.uniform(x0[:, None], (x0 + 70)[:, None], (s, k, 2)),
                          rng.integers(0, 3, (s, k, 1))], -1).astype(np.float32)
    roi_valid = np.array([1, 1, 1, 0, 1, 0, 0, 1], bool)
    return dict(args=[logits, kps, rois, roi_valid], splits=[5, 3])


def retinanet_case():
    """``tests/test_torch_retinanet.py``'s loss inputs twice over (4
    images), rank 1's second image without gt, split 2 + 2; the anchors
    whole."""
    from cvpr22_cross_modal_pseudo_labeling_torch.models.rpn import retinanet as torch_retina
    from tests.test_torch_retinanet import STATICS, _loss_inputs

    anchors, logits, reg, gt, labels, valid = _loss_inputs(2)
    _, logits2, reg2, gt2, labels2, valid2 = _loss_inputs(5)
    valid2[1] = False
    cat = [np.concatenate(p) for p in ((logits, logits2), (reg, reg2), (gt, gt2), (labels, labels2),
                                       (valid, valid2))]
    assert isinstance(STATICS, torch_retina.RetinaNetStatics)
    return dict(args=[cat[0], cat[1], *cat[2:]], anchors=anchors.numpy(), statics=STATICS, splits=[2, 2])


def wsddn_case(seed=4):
    """4 images' scores over 6 classes, split 3 + 1."""
    rng = np.random.default_rng(seed)
    scores = rng.uniform(0.01, 0.99, (4, 6)).astype(np.float32)
    labels = rng.integers(0, 2, (4, 6)).astype(np.float32)
    return dict(args=[scores, labels], background_weight=0.2, splits=[3, 1])


def call_loss(name, case, args):
    """The loss of ``name`` on ``args`` (tensors, the case's row layout):
    a 0-d tensor (RetinaNet's two summed)."""
    from cvpr22_cross_modal_pseudo_labeling_torch.models.roi_heads.keypoint_head import keypoint_loss
    from cvpr22_cross_modal_pseudo_labeling_torch.models.roi_heads.wsddn_head import wsddn_loss
    from cvpr22_cross_modal_pseudo_labeling_torch.models.rpn.retinanet import retinanet_loss

    if name == "keypoint":
        return keypoint_loss(*args)
    if name == "wsddn":
        return wsddn_loss(*args, case["background_weight"])
    cls, reg = retinanet_loss(torch.from_numpy(case["anchors"]), *args, case["statics"])
    return cls + reg


def loss_and_grad(name, case, rows):
    """The loss on ``rows`` (numpy arrays) and the gradient of the first."""
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in rows]
    if name == "retinanet":  # the logits and the box regression
        args[1].requires_grad_(True)
    args[0].requires_grad_(True)
    loss = call_loss(name, case, args)
    loss.backward()
    grads = [args[0].grad.numpy().copy()] + ([args[1].grad.numpy().copy()] if name == "retinanet" else [])
    return float(loss.detach()), grads


# ---------------------------------------------------------------------------
# the ranks (no jax here)


def build_trainer(spec, state=None):
    """The family's ``Trainer`` on the CPU, with ``state``'s weights."""
    from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer

    if spec["family"] == "retinanet":
        from cvpr22_cross_modal_pseudo_labeling_torch.config import get_default_cfg
        from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.retinanet import RetinaNetDetector
        from cvpr22_cross_modal_pseudo_labeling_torch.models.rpn.retinanet import retinanet_statics_from_cfg

        cfg = get_default_cfg()
        cfg.merge_from_list(spec["opts"])
        cfg.freeze()
        model = RetinaNetDetector(retinanet_statics_from_cfg(cfg), backbone_out_channels=spec["channels"],
                                  trunk=spec["trunk"])
        trainer = Trainer(cfg, device="cpu", model=model)
    else:
        trainer = Trainer(spec["config"], spec["opts"], device="cpu", seed=3)
    if state is not None:
        trainer.model.load_state_dict(state)
    return trainer


def _draws(spec):
    from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.generalized_rcnn import TrainDraws

    return TrainDraws(**{k: torch.from_numpy(v) for k, v in spec["draws"].items()})


def worker(rank_, world, tmp):
    """One rank: each loss function on its rows, then each family's step
    on its rows, pickled to ``tmp/rank{rank_}.pkl``."""
    import torch.distributed as dist

    from cvpr22_cross_modal_pseudo_labeling_torch.parallel import dist as pdist
    from tests.test_torch_ddp import dump, wait_load

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous", rank=rank_, world_size=world)
    rec = []

    def recording(x):
        out = pdist.global_sum(x)
        rec.extend(zip(x.detach().reshape(-1).tolist(), out.reshape(-1).tolist()))
        return out

    for name in NORMALIZER_MODULES:
        importlib.import_module(name).global_sum = recording
    cases = wait_load(tmp / "cases.pkl")
    result = {"losses": {}, "steps": {}}
    for name, case in cases.items():
        rec.clear()
        rows = [_split(a, case["splits"], rank_) for a in case["args"]]
        loss, grads = loss_and_grad(name, case, rows)
        result["losses"][name] = dict(loss=loss, grads=grads, normalizers=list(rec))
    for family in FAMILIES:
        spec = wait_load(tmp / f"step_{family}.pkl")
        trainer = build_trainer(spec, spec["state"])
        n = len(spec["batch"]["images"]) // world
        rows = {k: v if k in TABLE_KEYS else v[rank_ * n:(rank_ + 1) * n] for k, v in spec["batch"].items()}
        rec.clear()
        metrics = trainer.step(rows, _draws(spec) if spec["draws"] else None)
        result["steps"][family] = dict(
            metrics={k: float(v) for k, v in metrics.items()}, normalizers=list(rec),
            params={n_: p.detach().numpy().copy() for n_, p in trainer.model.named_parameters()})
    dump(result, tmp / f"rank{rank_}.pkl")
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the one-process side


class RecordedDraws:
    """Records the samplers' priorities a one-process step draws (the
    RPN's as ``rpn_sampler``, the RoI sampler's as ``gt_sampler``)."""

    MODULES = {"rpn_sampler": "cvpr22_cross_modal_pseudo_labeling_torch.models.rpn.rpn",
               "gt_sampler": "cvpr22_cross_modal_pseudo_labeling_torch.models.roi_heads.box_head"}

    def __enter__(self):
        self.draws, self._saved = {}, {}
        for key, name in self.MODULES.items():
            mod = importlib.import_module(name)
            self._saved[name] = draw = mod.draw_priorities

            def recording(*a, _key=key, _draw=draw, **kw):
                out = _draw(*a, **kw)
                self.draws[_key] = out.numpy().copy()
                return out

            mod.draw_priorities = recording
        return self

    def __exit__(self, *exc):
        for name, draw in self._saved.items():
            importlib.import_module(name).draw_priorities = draw
        return False


def step_spec(family):
    """The family's spec (config, opts, seeded weights, global batch of 4)
    and its one-process step: metrics, and the draws it made."""
    from cvpr22_cross_modal_pseudo_labeling_torch import bridge
    from tests import test_torch_keypoint_wsddn as kw
    from tests import test_torch_teacher as teacher

    if family == "retinanet":
        from tests import test_torch_retinanet as rt

        spec = dict(family=family, opts=rt.RETINA_CFG + rt.NARROW_OPTS, channels=rt.FPN_CHANNELS, trunk=rt.NARROW)
        a, b = rt._batch(4), rt._batch(5)
        b["gt_valid"][1] = False
    else:
        opts = teacher.TRAIN_OPTS + ["TPU.COMPUTE_DTYPE", "float32"] + (kw.KEYPOINT if family == "keypoint"
                                                                        else kw.WSDDN)
        spec = dict(family=family, config=teacher.TEACHER, opts=opts)
        make = kw.kp_batch if family == "keypoint" else teacher.tiny_batch
        a, b = make(seed=1), make(seed=2)
        b["gt_valid"][1] = False
        if family == "keypoint":
            b["gt_keypoints"][1] = 0
    batch = {k: a[k] if k in TABLE_KEYS else np.concatenate([a[k], b[k]]) for k in a}
    spec["batch"] = batch
    trainer = build_trainer(spec)
    bridge.load_flax_params(trainer.model, bridge.seeded_flax_params(trainer.model, seed=0))
    spec["state"] = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    with RecordedDraws() as rec:
        metrics = trainer.step(batch)
    spec["draws"] = rec.draws
    return spec, {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from tests.test_torch_ddp import dump, join, start, wait_load

    tmp = tmp_path_factory.mktemp("ddp_losses")
    procs = [start(["--worker", r, WORLD, tmp], file=__file__) for r in range(WORLD)]
    try:
        cases = {"keypoint": keypoint_case(), "retinanet": retinanet_case(), "wsddn": wsddn_case()}
        dump(cases, tmp / "cases.pkl")
        single = {name: loss_and_grad(name, case, case["args"]) for name, case in cases.items()}
        steps = {}
        for family in FAMILIES:
            spec, steps[family] = step_spec(family)
            dump(spec, tmp / f"step_{family}.pkl")
        for p in procs:
            join(p)
        ranks = [wait_load(tmp / f"rank{r}.pkl") for r in range(WORLD)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return dict(cases=cases, single=single, steps=steps, ranks=ranks)


# ---------------------------------------------------------------------------
# tests


def _counts_are_summed(n0, n1):
    """Every normalizer reduced on both ranks, each the sum of the ranks'
    counts, and some of those counts unequal."""
    assert len(n0) == len(n1) >= 1
    for (l0, g0), (l1, g1) in zip(n0, n1):
        assert g0 == g1 == l0 + l1, (n0, n1)
    assert any(l0 != l1 for (l0, _), (l1, _) in zip(n0, n1)), (n0, n1)


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_shares_sum_to_the_one_process_loss(runs, name):
    want, want_grads = runs["single"][name]
    got = [out["losses"][name] for out in runs["ranks"]]
    assert want > 0
    np.testing.assert_allclose(sum(g["loss"] for g in got), want, rtol=1e-6)
    splits = runs["cases"][name]["splits"]
    for i, w in enumerate(want_grads):
        scale = float(np.abs(w).max())
        assert scale > 0
        for r, g in enumerate(got):
            np.testing.assert_allclose(g["grads"][i], _split(w, splits, r), rtol=0, atol=1e-6 * scale,
                                       err_msg=f"{name} rank {r} input {i}")
    _counts_are_summed(got[0]["normalizers"], got[1]["normalizers"])


@pytest.mark.parametrize("family", FAMILIES)
def test_two_rank_step_matches_one_process_step(runs, family):
    want = runs["steps"][family]
    r0, r1 = (out["steps"][family] for out in runs["ranks"])
    assert r0["metrics"] == r1["metrics"]
    loss = {"keypoint": "loss_kp", "wsddn": "loss_classifier", "retinanet": "loss_retina_cls"}[family]
    assert loss in want and want[loss] > 0
    assert set(r0["metrics"]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(r0["metrics"][k], v, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("family", FAMILIES)
def test_two_rank_step_keeps_ranks_equal_and_sums_counts(runs, family):
    r0, r1 = (out["steps"][family] for out in runs["ranks"])
    for n in r0["params"]:
        np.testing.assert_array_equal(r0["params"][n], r1["params"][n], err_msg=n)
    _counts_are_summed(r0["normalizers"], r1["normalizers"])


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    parser = argparse.ArgumentParser()
    parser.add_argument("--worker", nargs=3, required=True, metavar=("RANK", "WORLD", "DIR"))
    a = parser.parse_args().worker
    worker(int(a[0]), int(a[1]), pathlib.Path(a[2]))
