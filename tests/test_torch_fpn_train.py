"""The R-50-FPN pair through the port's entry points on the CPU, and the
weights that travel between its stages.

- ``train_net`` trains the FPN teacher a step on a tiny synthetic COCO
  tree as in ``tests/test_torch_train_net.py`` (narrow widths, a
  16-channel FPN; 4 val images, one test batch), then the FPN student a
  step from its ``OUTPUT_DIR``: every leaf of the teacher checkpoint is
  imported (the FPN's 16 included) and the teacher's RoI heads are
  copied into the student; the student's trunk, FPN and RPN and its
  teacher bundle equal the teacher's, bit for bit, and stay so after its
  step (all frozen).  ``test_net --ckpt`` then
  scores the student: every metric finite.
- The optimizer's labels on both FPN models equal JAX ``label_params``:
  the teacher's ``FREEZE_CONV_BODY_AT`` prefixes leave its FPN trainable,
  the student's ``backbone/`` prefix freezes it.
- The cross-stage import of an FPN teacher into the FPN student puts the
  teacher's trunk ``layer4`` on the student's trunk.  JAX's importer puts
  its same-shaped leaves on the student's teacher head (its C4 routing of
  an MMSS C5 trunk) and leaves them unfilled on the trunk; the port
  routes a trunk ``layer4`` to the RoI head only when the target's trunk
  has none, and still does so from an MMSS C5 trunk into the C4 teacher.
"""

import math
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.config import get_default_cfg as jax_cfg
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import checkpoint as jax_ckpt
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import optimizer as jax_opt
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.config import R50_FPN_OPTS
from cvpr22_cross_modal_pseudo_labeling_torch.config import get_default_cfg as torch_cfg
from cvpr22_cross_modal_pseudo_labeling_torch.engine import checkpoint as torch_ckpt
from cvpr22_cross_modal_pseudo_labeling_torch.engine import optimizer as torch_opt
from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer
from cvpr22_cross_modal_pseudo_labeling_torch.tools import test_net
from tests import test_torch_train_net as tn
from tests.tensorboard_stub import tensorboard_compat_reset  # noqa: F401  (an autouse fixture)
from tests.test_torch_fpn import TREE_WIDTHS, _cfg

FPN = R50_FPN_OPTS + ["MODEL.RESNETS.BACKBONE_OUT_CHANNELS", 16]
FPN_LEAVES = 16  # fpn_inner1-4 and fpn_layer1-4, a kernel and a bias each
HEADS = ("roi_extractor", "box_predictor", "mask_predictor")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth_coco")
    subprocess.run(
        [sys.executable, str(tn.REPO / "tools/synth_coco.py"), "--out", str(out), "--train", "8",
         "--val", "4", "--seen", "3", "--unseen", "2"],
        check=True, capture_output=True, timeout=300,
    )
    return out


@pytest.fixture(autouse=True)
def catalog(tree, monkeypatch):
    monkeypatch.setenv("CMPL_TPU_DATA_DIR", str(tree))
    monkeypatch.setitem(sys.modules, "tensorflow", None)


def _flat(tree):
    return bridge._flatten(tree)


def test_fpn_teacher_then_student_then_test_net(tmp_path):
    teacher_out, st_out = tmp_path / "teacher", tmp_path / "st"
    tn.run(tn.TEACHER, teacher_out, *FPN, "SOLVER.MAX_ITER", 1, "SOLVER.CHECKPOINT_PERIOD", 1,
           "SOLVER.TEST_PERIOD", 0)
    teacher = torch_ckpt.load_checkpoint(torch_ckpt.latest_checkpoint(str(teacher_out)))
    fpn_keys = [k for k in teacher["trainer"]["model"] if k.startswith("backbone.fpn.")]
    assert len(fpn_keys) == FPN_LEAVES
    assert all(math.isfinite(r["total_loss"]) for r in tn.logged(teacher_out))

    rec = tn.run(tn.STUDENT, st_out, *FPN, "MODEL.WEIGHT", teacher_out, "SOLVER.MAX_ITER", 1,
                 "SOLVER.CHECKPOINT_PERIOD", 1, "SOLVER.TEST_PERIOD", 0)
    text = tn.log_text(st_out)
    leaves = _flat(bridge.flax_tree_from_checkpoint(teacher))
    assert sum(p[:2] == ("backbone", "fpn") for p in leaves) == FPN_LEAVES
    assert (f"imported {len(leaves)} leaves from checkpoint {teacher_out}/model_0000001.pth "
            "(0 source leaves unmatched)") in text
    n_copied = int(text.split("prepare_model: copied ")[1].split()[0])
    assert n_copied == sum(p[0] in HEADS for p in leaves)
    assert all(math.isfinite(r["total_loss"]) for r in tn.logged(st_out))
    st = torch_ckpt.load_checkpoint(str(st_out / "model_0000001.pth"))
    for part in ("backbone.", "rpn_head."):
        got, want = tn._bundle(st, part), tn._bundle(teacher, part)
        assert got.keys() == want.keys() and got
        for k in want:
            assert torch.equal(got[k], want[k]), part + k
    for part in ("roi_extractor.", "box_predictor.", "mask_predictor."):
        got, want = tn._bundle(st, "teacher." + part), tn._bundle(teacher, part)
        assert got.keys() == want.keys() and got
        assert all(torch.equal(got[k], want[k]) for k in want), part

    name = "coco_generalized_zeroshot_val"
    got = test_net.main(["--config-file", tn.STUDENT, "--device", "cpu", "--ckpt", str(st_out / "model_0000001.pth"),
                         *map(str, tn.TINY + FPN), "OUTPUT_DIR", str(tmp_path / "eval")])
    assert "bbox/AP" in got[name] and "segm/AP" in got[name]
    assert all(math.isfinite(v) or "AP50_class" in k for k, v in got[name].items())
    assert rec["trainer"].model.backbone.fpn.fpn_layer1.weight.requires_grad is False


@pytest.mark.parametrize("config,family", [(tn.TEACHER, "GeneralizedRCNN"), (tn.STUDENT, "STGeneralizedRCNN")],
                         ids=["teacher", "student"])
def test_fpn_optimizer_labels_match_jax(config, family):
    opts = TREE_WIDTHS + FPN
    tc = _cfg(torch_cfg, config, opts)
    prefixes = torch_opt.frozen_prefixes_from_cfg(tc, family)
    assert prefixes == jax_opt.frozen_prefixes_from_cfg(_cfg(jax_cfg, config, opts), family)
    trainer = Trainer(tc, device="cpu")
    tree = bridge.flax_from_state_dict(trainer.model)
    ref = {"/".join(k.key for k in path): label for path, label in
           jax.tree_util.tree_flatten_with_path(jax_opt.label_params(tree, prefixes))[0]}
    modules = dict(trainer.model.named_modules())
    to_flax = {bridge._port_key(modules, tuple(p.split("/")))[0]: p for p in ref}
    fpn = [n for n, _ in trainer.model.named_parameters() if n.startswith("backbone.fpn.")]
    assert len(fpn) == FPN_LEAVES
    for name, p in trainer.model.named_parameters():
        assert trainer.optimizer.labels[name] == ref[to_flax[name]], name
    trains = family == "GeneralizedRCNN"
    assert all((trainer.optimizer.labels[n] != "frozen") == trains for n in fpn)
    assert all(trainer.model.get_parameter(n).requires_grad == trains for n in fpn)


def _seeded(config, opts, seed):
    model = Trainer(_cfg(torch_cfg, config, TREE_WIDTHS + opts), device="cpu").model
    return bridge.seeded_flax_params(model, seed)


def test_fpn_teacher_import_puts_the_trunk_c5_stage_on_the_trunk():
    source = _seeded(tn.TEACHER, FPN, 1)
    target = _seeded(tn.STUDENT, FPN, 2)
    got, report = torch_ckpt.import_flax_params(target, source)
    _, jax_report = jax_ckpt.import_flax_params(target, source)
    src, out = _flat(source), _flat(got)
    trunk_c5 = [p for p in _flat(target) if p[:3] == ("backbone", "body", "layer4")]
    assert trunk_c5 and not report["missed_source_keys"] and not jax_report["missed_source_keys"]
    for path in _flat(target):
        if path[0] in ("backbone", "rpn_head"):
            np.testing.assert_array_equal(out[path], src[path], err_msg=str(path))
        elif path[0] == "teacher" and path[1] in HEADS:
            np.testing.assert_array_equal(out[path], src[path[1:]], err_msg=str(path))
    # JAX: the trunk's layer4 leaves of the head's shapes go to the
    # student's teacher head, and the trunk keeps its draws (at full
    # width all but block0's conv1 and downsample kernels)
    same_shape = {p for p in trunk_c5 if np.shape(src.get(("roi_extractor",) + p[2:])) == np.shape(src[p])}
    unfilled = {tuple(u.split("/")) for u in jax_report["unfilled_targets"]}
    assert len(same_shape) == 27 and same_shape <= unfilled
    assert not {tuple(u.split("/")) for u in report["unfilled_targets"]} & set(trunk_c5)


def test_mmss_c5_trunk_still_lands_on_the_c4_teacher_head():
    """The routing JAX's importer was written for, unchanged."""
    from cvpr22_cross_modal_pseudo_labeling_torch.models.detector.mmss_gcnn import MMSSGridModel
    from tests.test_torch_mmss import narrow_statics, seeded_tree

    source = seeded_tree(MMSSGridModel(narrow_statics()))
    target = _seeded(tn.TEACHER, [], 3)
    got, report = torch_ckpt.import_flax_params(target, source)
    want, jax_report = jax_ckpt.import_flax_params(target, source)
    assert report == jax_report and report["matched"] > 0
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
