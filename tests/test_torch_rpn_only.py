"""The RPN-only detector and proposal evaluation against the JAX package on
the CPU, and the dispatch between proposal and box evaluation.

- ``MODEL.RPN_ONLY`` over ``zeroshot_mask.yaml`` at the narrow widths of
  ``tests/test_torch_teacher.py``, on the C4 body and on the FPN body
  (``R50_FPN_OPTS``, 16 channels): the eval forward returns JAX's
  proposals as detections (validity and label 0 exact, boxes within
  1e-3 px, sigmoid objectness within 1e-5); the training forward returns
  the two RPN losses alone, JAX's within 1e-5 relative on JAX's own
  sampler draws, and launches no proposal selection (JAX's compiled step
  drops it); a ``Trainer`` step gives the RoI heads no gradient, so they
  only decay, as JAX's zero gradient does.
- ``evaluate_proposals`` over the same proposals, batches and dataset
  gives JAX's ``box_proposal/AR_*@1000`` exactly and writes the same
  proposals file.
- ``inference`` dispatches as JAX does: to proposal evaluation on the
  statics' ``rpn_only``, so a RetinaNet config with ``RPN_ONLY`` (as
  maskrcnn_benchmark's RetinaNet configs set it) runs box evaluation.
- The RPN-only teacher through ``train_net`` and ``test_net --ckpt`` on a
  tiny synthetic COCO tree: the recalls finite, the proposals written.
"""

import importlib
import json
import math
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.config import get_default_cfg as jax_cfg
from cvpr22_cross_modal_pseudo_labeling_tpu.data import build as jax_build
from cvpr22_cross_modal_pseudo_labeling_tpu.data import paths_catalog as jax_catalog
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import build_detection_model as jax_build_model
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector.generalized_rcnn import RCNNEvalOutput
from cvpr22_cross_modal_pseudo_labeling_tpu.models.roi_heads.box_head import Detections
from cvpr22_cross_modal_pseudo_labeling_torch.config import R50_FPN_OPTS, RETINANET_OPTS
from cvpr22_cross_modal_pseudo_labeling_torch.config import get_default_cfg as torch_cfg
from cvpr22_cross_modal_pseudo_labeling_torch.data import build as torch_build
from cvpr22_cross_modal_pseudo_labeling_torch.data import make_data_loader
from cvpr22_cross_modal_pseudo_labeling_torch.engine import inference as torch_inference
from cvpr22_cross_modal_pseudo_labeling_torch.engine.inference import NumpyDetections, Predictor
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.retinanet import RetinaNetDetector
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.generalized_rcnn import TrainDraws
from cvpr22_cross_modal_pseudo_labeling_torch.tools import test_net, train_net
from tests import test_torch_teacher as teacher
from tests import test_torch_train_net as tn

# the module (the package's ``inference`` attribute is the function)
jax_inference = importlib.import_module("cvpr22_cross_modal_pseudo_labeling_tpu.engine.inference")
RPN_ONLY = ["MODEL.RPN_ONLY", True]
BODIES = {"C4": [], "FPN": R50_FPN_OPTS + ["MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 16]}
RPN_LOSSES = ("loss_objectness", "loss_rpn_box_reg")


@pytest.fixture(scope="module", params=sorted(BODIES))
def rpn_only(request):
    return request.param, teacher.make_setup("float32", BODIES[request.param] + RPN_ONLY)


def test_rpn_only_eval_returns_jax_proposals(rpn_only):
    body, setup = rpn_only
    batch = teacher.tiny_batch()
    images, sizes = batch["images"], batch["image_sizes"]
    m = setup["model"]
    ref = jax.jit(lambda p, i, s: m.apply(p, i, s, class_embeddings=None, train=False))(
        setup["params"], images, sizes).detections
    pred = Predictor.from_model(setup["trainer"].cfg, setup["trainer"].model)
    dets, masks = pred(images, sizes)
    setup["trainer"].model.train()
    assert masks is None
    n = 32 if body == "C4" else 5 * 32  # POST_NMS_TOP_N_TEST, on each of the FPN's 5 levels
    assert dets.boxes.shape == (2, n, 4) and np.asarray(ref.boxes).shape == (2, n, 4)
    valid = np.asarray(ref.valid)
    assert valid.sum(1).min() > 10
    np.testing.assert_array_equal(dets.valid, valid)
    np.testing.assert_array_equal(dets.labels, np.asarray(ref.labels))
    assert not dets.labels.any() and dets.labels.dtype == np.int32
    np.testing.assert_allclose(dets.boxes[valid], np.asarray(ref.boxes)[valid], rtol=0, atol=1e-3)
    np.testing.assert_allclose(dets.scores[valid], np.asarray(ref.scores)[valid], rtol=0, atol=1e-5)
    assert ((dets.scores[valid] > 0) & (dets.scores[valid] < 1)).all()


def test_rpn_only_trains_the_rpn_losses_alone(rpn_only, monkeypatch):
    body, setup = rpn_only
    batch = teacher.tiny_batch()
    with teacher.JaxDraws():
        losses, _ = jax.jit(lambda p, b, k: setup["loss_fn"](p, b, k)[1])(
            setup["params"], teacher.jax_batch(batch), jax.random.PRNGKey(0))
        jax.block_until_ready(losses)
        assert "gt_sampler" not in teacher._SINK
        draws = TrainDraws(rpn_sampler=torch.from_numpy(teacher._SINK["rpn_sampler"]))
    assert sorted(losses) == sorted(RPN_LOSSES)
    trainer = setup["trainer"]
    called = []
    from cvpr22_cross_modal_pseudo_labeling_torch.models.detector import generalized_rcnn

    select = generalized_rcnn.select_proposals
    monkeypatch.setattr(generalized_rcnn, "select_proposals", lambda *a, **k: called.append(1) or select(*a, **k))
    prev = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    metrics = trainer.step(batch, draws)
    assert not called
    for k in RPN_LOSSES:
        np.testing.assert_allclose(float(metrics[k]), float(losses[k]), rtol=1e-5, err_msg=k)
    assert set(metrics) == {*RPN_LOSSES, "total_loss", "grad_norm"}
    # the RoI heads get no gradient: the first update is the weight decay
    wd, lr = trainer.cfg.SOLVER.WEIGHT_DECAY, trainer.optimizer.sgd.param_groups[0]["lr"]
    heads = [n for n in prev if n.startswith(("roi_extractor.", "box_predictor.bbox_pred.weight"))]
    assert heads
    for name in heads:
        p = trainer.model.get_parameter(name)
        np.testing.assert_allclose(p.detach().numpy(), (prev[name] * (1 - lr * wd)).numpy(), rtol=1e-6, atol=1e-9)
    assert not torch.equal(trainer.model.get_parameter("rpn_head.conv.weight"), prev["rpn_head.conv.weight"])
    trainer.load_flax_params(setup["tree"])  # the module's other tests start from the seeded weights


# ---------------------------------------------------------------------------
# proposal evaluation and the dispatch
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth_coco")
    subprocess.run(
        [sys.executable, str(tn.REPO / "tools/synth_coco.py"), "--out", str(out), "--train", "4",
         "--val", "6", "--seen", "3", "--unseen", "2"],
        check=True, capture_output=True, timeout=300,
    )
    return out


@pytest.fixture
def catalogs(tree, monkeypatch):
    monkeypatch.setenv("CMPL_TPU_DATA_DIR", str(tree))
    monkeypatch.setattr(jax_catalog, "DATA_DIR", str(tree))
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    return tree


def _proposal_batches(dataset, seed=6, per_batch=4, n=40):
    """Batches over the dataset's images at half their size: proposals
    around each gt box, at the image edge and at random, some invalid,
    and the batch's index stamped on its first pixel."""
    rng = np.random.default_rng(seed)
    table, batches = [], []
    order = list(range(len(dataset)))
    for bi, start in enumerate(range(0, len(order), per_batch)):
        idx = order[start:start + per_batch]
        boxes = np.zeros((per_batch, n, 4), np.float32)
        valid = rng.uniform(size=(per_batch, n)) > 0.15
        sizes = np.zeros((per_batch, 2), np.int32)
        for j, i in enumerate(idx):
            info = dataset.get_img_info(i)
            h, w = info["height"] // 2, info["width"] // 2
            sizes[j] = (h, w)
            anns = dataset.coco.load_anns_for_image(dataset.id_to_img_map[i])
            k = 0
            for a in anns:
                x, y, bw, bh = (np.array(a["bbox"]) / 2).tolist()
                for _ in range(3):
                    jitter = rng.normal(0, 0.1 * max(bw, bh), 4)
                    boxes[j, k] = [x, y, x + bw, y + bh] + jitter
                    k += 1
            xy = rng.uniform(0, [w, h], (n - k, 2))
            boxes[j, k:] = np.concatenate([xy, xy + rng.uniform(4, 60, (n - k, 2))], 1)
        scores = np.round(rng.uniform(size=(per_batch, n)), 2).astype(np.float32)
        table.append((boxes, scores, valid))
        images = np.zeros((len(idx), 8, 8, 3), np.uint8)
        images[:, 0, 0, 0] = bi
        batches.append(({"images": images, "image_sizes": sizes[:len(idx)]}, idx))
    return table, batches


class _JaxProposals:
    """A JAX "model" whose eval output is the stamped batch's proposals."""

    def __init__(self, table):
        self.boxes, self.scores, self.valid = (jnp.asarray(np.stack(x)) for x in zip(*table))

    def apply(self, params, images, image_sizes, class_embeddings=None, train=False):
        b = images.shape[0]
        i = images[0, 0, 0, 0].astype(jnp.int32)
        return RCNNEvalOutput(Detections(self.boxes[i][:b], self.scores[i][:b],
                                         jnp.zeros(self.scores[i][:b].shape, jnp.int32), self.valid[i][:b]), None)


class _PortProposals:
    """The same proposals as a ``Predictor``."""

    def __init__(self, table):
        self.table = table

    def __call__(self, images, image_sizes, class_embeddings=None):
        boxes, scores, valid = self.table[int(images[0, 0, 0, 0])]
        b = images.shape[0]
        return NumpyDetections(boxes[:b], scores[:b], np.zeros(scores[:b].shape, np.int32), valid[:b]), None


def test_evaluate_proposals_gives_jax_recalls(catalogs, tmp_path):
    name = "coco_generalized_zeroshot_val"
    jc, tc = jax_cfg(), torch_cfg()
    jd = jax_build.build_dataset(jc, (name,), None, False)[0]
    td = torch_build.build_dataset(tc, (name,), None, False)[0]
    table, batches = _proposal_batches(td)
    ref = jax_inference.evaluate_proposals(_JaxProposals(table), {}, batches, jd,
                                           output_file=str(tmp_path / "jax.json"))
    got = torch_inference.evaluate_proposals(_PortProposals(table), batches, td,
                                             output_file=str(tmp_path / "port.json"))
    keys = [f"box_proposal/AR_{a}@1000" for a in ("all", "small", "medium", "large")]
    assert sorted(ref) == sorted(keys) and ref["box_proposal/AR_all@1000"] > 0.1
    for k in keys:
        assert got[k] == ref[k] or (math.isnan(got[k]) and math.isnan(ref[k])), k
    assert got["time/images"] == len(td)
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads((tmp_path / "jax.json").read_text())


def test_inference_dispatches_on_the_statics_rpn_only_as_jax_does(catalogs):
    """``RPN_ONLY`` alone: proposal recall.  ``RPN_ONLY`` with
    ``RETINANET_ON``: the RetinaNet statics have no ``rpn_only``, in JAX
    and here, so the boxes are scored.  ``GT_BOX_EVAL`` on RetinaNet is
    refused."""
    name = "coco_not_zeroshot_val"
    small = ["INPUT.MIN_SIZE_TEST", 64, "INPUT.MAX_SIZE_TEST", 64, "TPU.IMAGE_BUCKETS", ((64, 64),),
             "TEST.IMS_PER_BATCH", 3, "DATASETS.TEST", (name,), "TPU.COMPUTE_DTYPE", "float32"]
    retina = RETINANET_OPTS + ["MODEL.RETINANET.NUM_CLASSES", 4, "MODEL.RETINANET.NUM_CONVS", 1,
                               "MODEL.RETINANET.INFERENCE_TH", 0.0] + small
    jc = jax_cfg()
    jc.merge_from_list(retina)
    jmodel = jax_build_model(jc)
    assert not getattr(jmodel.statics, "rpn_only", False) and jc.MODEL.RPN_ONLY
    pred = Predictor("", retina, device="cpu")
    assert isinstance(pred.model, RetinaNetDetector) and not hasattr(pred.model.statics, "rpn_only")
    loaders, datasets = make_data_loader(pred.cfg, is_train=False)
    metrics = torch_inference.inference(pred, loaders[0], datasets[0])
    assert "bbox/AP" in metrics and not any(k.startswith("box_proposal") for k in metrics)

    rpn = Predictor(teacher.TEACHER, teacher.TRAIN_OPTS + RPN_ONLY + small, device="cpu")
    assert rpn.model.statics.rpn_only
    metrics = torch_inference.inference(rpn, *(x[0] for x in make_data_loader(rpn.cfg, is_train=False)))
    assert "box_proposal/AR_all@1000" in metrics and "bbox/AP" not in metrics

    cfg = torch_cfg()
    cfg.merge_from_list(retina + ["MODEL.GT_BOX_EVAL", True])
    with pytest.raises(ValueError, match="RETINANET_ON scores no given boxes"):
        torch_inference.check_eval_options(cfg)


def test_rpn_only_through_train_net_and_test_net(catalogs, tmp_path):
    out = tmp_path / "rpn"
    tiny = [*map(str, tn.TINY + RPN_ONLY), "DATASETS.TEST", "('coco_generalized_zeroshot_val',)",
            "TEST.IMS_PER_BATCH", "3"]
    rec = train_net.main(["--config-file", tn.TEACHER, "--device", "cpu", *tiny, "SOLVER.MAX_ITER", "2",
                          "SOLVER.CHECKPOINT_PERIOD", "2", "OUTPUT_DIR", str(out)])
    logged = tn.logged(out)
    assert [r["step"] for r in logged] == [1, 2]
    assert all(set(RPN_LOSSES) <= set(r) and "loss_classifier" not in r for r in logged)
    name = "coco_generalized_zeroshot_val"
    assert math.isfinite(rec["test"][name]["box_proposal/AR_all@1000"])
    got = test_net.main(["--config-file", tn.TEACHER, "--device", "cpu", "--ckpt", str(out / "model_0000002.pth"),
                         *tiny, "OUTPUT_DIR", str(tmp_path / "eval")])[name]
    assert got["box_proposal/AR_all@1000"] == rec["test"][name]["box_proposal/AR_all@1000"]
    assert all(math.isfinite(got[f"box_proposal/AR_{a}@1000"]) or a != "all" for a in ("all", "small", "medium"))
    props = json.loads((tmp_path / "eval" / f"predictions_{name}.json").read_text())
    assert len(props) == 6 and all(len(v) > 0 and len(v[0]) == 5 for v in props.values())
