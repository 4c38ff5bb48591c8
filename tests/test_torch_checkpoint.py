"""The port's checkpoints and weight importers.

- The importers are the JAX package's, copied: on the same inputs they
  give the same flax-layout trees, exactly, and the same reports.  A
  reference-style ``state_dict`` (maskrcnn_benchmark names and layouts,
  with ``module.``, an MMSS ``v2l_projection`` and a classifier to
  exercise the key surgery, and the entries of ``tests/test_checkpoint.py``)
  goes through ``apply_reference_key_surgery`` and
  ``import_torch_state_dict`` of both packages into a narrow teacher's
  tree; the results, through ``bridge.state_dict_from_flax``, are equal.
  The teacher -> student cross-stage import (``import_flax_params`` on
  ``bridge.flax_tree_from_checkpoint`` of a port checkpoint) and
  ``populate_student_from_teacher`` likewise, with the same ``matched``
  and ``missed`` reports; and the Caffe2 importer.
- Round trips of the port's own checkpoints: save, load, prune, pending
  publish and discard; ``torch.load(..., weights_only=True)`` reads them
  and a restore is bit for bit; an orbax directory of the JAX package
  (with the two commands that convert it), a missing file and a
  checkpoint of another model raise.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.engine import c2_loading as jax_c2
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import checkpoint as jax_ckpt
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.engine import c2_loading as torch_c2
from cvpr22_cross_modal_pseudo_labeling_torch.engine import checkpoint as torch_ckpt
from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer
from cvpr22_cross_modal_pseudo_labeling_torch.utils import model_zoo
from tests.test_torch_st_train import CONFIG, TRAIN_OPTS
from tests.test_torch_teacher import TEACHER


def _flat(tree):
    return torch_ckpt._flatten_params(tree)


def assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert np.asarray(fa[k]).dtype == np.asarray(fb[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(fa[k]), np.asarray(fb[k]), err_msg="/".join(k))


@pytest.fixture(scope="module")
def teacher():
    t = Trainer(TEACHER, TRAIN_OPTS, device="cpu", seed=0)
    t.load_flax_params(bridge.seeded_flax_params(t.model, seed=1))
    return t


@pytest.fixture(scope="module")
def student():
    t = Trainer(CONFIG, TRAIN_OPTS, device="cpu", seed=0)
    t.load_flax_params(bridge.seeded_flax_params(t.model, seed=2))
    return t


def reference_names(model):
    """Each port key of ``model`` and its maskrcnn_benchmark name (torch
    layouts are the port's own): layerN.M, downsample.0/1, rpn.head,
    roi_heads.{box,mask}, under ``module.``."""
    out = {}
    for key in model.state_dict():
        k = key
        for i in range(32):
            k = k.replace(f".block{i}.", f".{i}.")
        k = k.replace("downsample_conv", "downsample.0").replace("downsample_bn", "downsample.1")
        k = k.replace("rpn_head.", "rpn.head.")
        k = k.replace("roi_extractor.", "roi_heads.box.feature_extractor.head.")
        k = k.replace("box_predictor.", "roi_heads.box.predictor.").replace("mask_predictor.", "roi_heads.mask.predictor.")
        out[key] = "module." + k
    return out


def test_reference_state_dict_import_matches_jax(teacher):
    model = teacher.model
    names = reference_names(model)
    rng = np.random.default_rng(0)
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    sd = {names[k]: rng.standard_normal(shapes[k]).astype(np.float32) for k in names}
    emb = sd.pop("module.roi_heads.box.predictor.emb_pred.weight")
    sd["mmss_heads.GroundingHead.v2l_projection.weight"] = emb  # surgery: -> emb_pred
    sd["roi_heads.box.predictor.cls_score.weight"] = np.zeros((3, 4), np.float32)  # dropped
    sd["backbone.body.layer9.0.conv1.weight"] = np.zeros((2, 2, 1, 1), np.float32)  # missed
    kw = dict(backbone_prefix="backbone.body.", load_emb_pred_from_mmss_head=True,
              default_mmss_head="GroundingHead", load_classifier=False)
    ref_sd = jax_ckpt.apply_reference_key_surgery(sd, **kw)
    got_sd = torch_ckpt.apply_reference_key_surgery(sd, **kw)
    assert list(got_sd) == list(ref_sd) and not any("cls_score" in k for k in got_sd)
    assert "roi_heads.box.predictor.emb_pred.weight" in got_sd

    target = bridge.flax_from_state_dict(model)
    ref, ref_report = jax_ckpt.import_torch_state_dict(target, ref_sd)
    got, got_report = torch_ckpt.import_torch_state_dict(target, got_sd)
    assert got_report == ref_report
    assert got_report["matched"] == len(names) and got_report["missed_source_keys"] == [
        "backbone.body.layer9.0.conv1.weight"]
    assert_trees_equal(got, ref)
    want = bridge.state_dict_from_flax(model, ref)
    have = bridge.state_dict_from_flax(model, got)
    # every weight is its source's, in the port's own (torch) layout
    for port_key, ref_key in names.items():
        assert torch.equal(have[port_key], want[port_key]), port_key
        src = emb if port_key == "box_predictor.emb_pred.weight" else sd[ref_key]
        assert torch.equal(have[port_key], torch.from_numpy(src)), port_key


def test_test_checkpoint_entries_import_as_in_jax():
    """The synthetic ``state_dict`` and tree of ``tests/test_checkpoint.py``."""
    from tests.test_checkpoint import small_params

    rng = np.random.RandomState(0)
    sd = {
        "backbone.body.stem.conv1.weight": rng.randn(64, 3, 7, 7).astype(np.float32),
        "backbone.body.stem.bn1.weight": rng.randn(64).astype(np.float32),
        "backbone.body.stem.bn1.running_mean": rng.randn(64).astype(np.float32),
        "backbone.body.layer1.0.conv1.weight": rng.randn(64, 64, 1, 1).astype(np.float32),
        "backbone.body.layer1.0.downsample.0.weight": rng.randn(256, 64, 1, 1).astype(np.float32),
        "roi_heads.box.predictor.emb_pred.weight": rng.randn(768, 2048).astype(np.float32),
        "roi_heads.box.predictor.emb_pred.bias": rng.randn(768).astype(np.float32),
    }
    ref, ref_report = jax_ckpt.import_torch_state_dict(small_params(), sd)
    got, got_report = torch_ckpt.import_torch_state_dict(small_params(), sd)
    assert got_report == ref_report and got_report["matched"] == len(sd)
    assert_trees_equal(got, ref)


def test_cross_stage_import_and_student_population_match_jax(teacher, student, tmp_path):
    path = torch_ckpt.save_checkpoint(str(tmp_path), torch_ckpt.checkpoint_state(teacher, 7), 7)
    ckpt = torch_ckpt.load_checkpoint(path)
    src = bridge.flax_tree_from_checkpoint(ckpt)
    assert_trees_equal(src, bridge.flax_from_state_dict(teacher.model))

    target = bridge.flax_from_state_dict(student.model)
    kw = dict(load_emb_pred_from_mmss_head=True, default_mmss_head="GroundingHead", load_classifier=True)
    ref, ref_report = jax_ckpt.import_flax_params(target, src, **kw)
    got, got_report = torch_ckpt.import_flax_params(target, src, **kw)
    assert got_report == ref_report
    # the teacher's trunk, RPN and RoI heads all land; the bundle's
    # leaves go to the student-teacher model's teacher
    assert got_report["matched"] == len(_flat(src)) and not got_report["missed_source_keys"]
    assert_trees_equal(got, ref)
    assert_trees_equal(got["teacher"]["roi_extractor"], src["roi_extractor"])

    ref_pop, ref_n = jax_ckpt.populate_student_from_teacher(ref)
    got_pop, got_n = torch_ckpt.populate_student_from_teacher(got)
    assert got_n == ref_n == len(_flat(got["teacher"]))
    assert_trees_equal(got_pop, ref_pop)
    assert_trees_equal(got_pop["student"]["box_predictor"], src["box_predictor"])

    # through the bridge into the student-teacher model
    sd = bridge.state_dict_from_flax(student.model, got_pop)
    assert torch.equal(sd["teacher.box_predictor.emb_pred.weight"],
                       teacher.model.state_dict()["box_predictor.emb_pred.weight"])

    # and as MODEL.WEIGHT: the directory's last_checkpoint names the save
    cfg = student.cfg
    tree, msg = torch_ckpt.import_external_weights(target, str(tmp_path), cfg)
    assert msg.startswith(f"imported {got_report['matched']} leaves from checkpoint {path}")
    assert_trees_equal(tree, ref)


def test_caffe2_import_matches_jax(teacher, tmp_path):
    rng = np.random.default_rng(3)
    stem = teacher.model.backbone.body.stem
    blobs = {
        "conv1_w": rng.standard_normal(stem.conv1.weight.shape).astype(np.float32),
        "res_conv1_bn_s": rng.standard_normal(stem.bn1.weight.shape).astype(np.float32),
        "res_conv1_bn_b": rng.standard_normal(stem.bn1.weight.shape).astype(np.float32),
        "conv1_w_momentum": np.zeros(1, np.float32),
    }
    path = tmp_path / "R-50.pkl"
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs}, f)
    target = bridge.flax_from_state_dict(teacher.model)
    ref, ref_report = jax_c2.import_c2_imagenet_weights(target, str(path))
    got, got_report = torch_c2.import_c2_imagenet_weights(target, str(path))
    assert got_report == ref_report and got_report["matched"] == 5  # with mean 0 and var 1
    assert_trees_equal(got, ref)
    tree, msg = torch_ckpt.import_external_weights(target, str(path), teacher.cfg)
    assert msg == "imported 5 caffe2 blobs"
    assert_trees_equal(tree, ref)


def test_save_load_prune_publish_and_discard(tmp_path):
    d = str(tmp_path / "ck")

    def state(i):
        return {"w": torch.full((4,), float(i)), "iteration": i, "name": "x", "nested": {"n": torch.arange(i)}}

    path = torch_ckpt.save_checkpoint(d, state(1), 1, keep=2)
    assert torch_ckpt.latest_checkpoint(d) == path and path.endswith("model_0000001.pth")
    back = torch_ckpt.load_checkpoint(path)
    assert torch.equal(back["w"], state(1)["w"]) and back["iteration"] == 1 and back["name"] == "x"
    assert torch.equal(back["nested"]["n"], torch.arange(1))

    # block=False: published by the next save or the flush, never earlier
    torch_ckpt.save_checkpoint(d, state(2), 2, keep=2, block=False)
    assert torch_ckpt.pending_checkpoint_step() == 2
    assert torch_ckpt.latest_checkpoint(d).endswith("model_0000001.pth")
    torch_ckpt.save_checkpoint(d, state(3), 3, keep=2, block=False)
    assert torch_ckpt.latest_checkpoint(d).endswith("model_0000002.pth")
    torch_ckpt.flush_pending_checkpoint()
    assert torch_ckpt.pending_checkpoint_step() is None
    assert torch_ckpt.latest_checkpoint(d).endswith("model_0000003.pth")
    assert sorted(os.listdir(d)) == ["last_checkpoint", "model_0000002.pth", "model_0000003.pth"]  # pruned
    assert torch.equal(torch_ckpt.load_checkpoint(torch_ckpt.latest_checkpoint(d))["w"], state(3)["w"])

    # discard: the unpublished save goes, the tag stays
    torch_ckpt.save_checkpoint(d, state(4), 4, keep=2, block=False)
    torch_ckpt.discard_pending_checkpoint()
    assert torch_ckpt.pending_checkpoint_step() is None
    assert torch_ckpt.latest_checkpoint(d).endswith("model_0000003.pth")
    assert not os.path.exists(os.path.join(d, "model_0000004.pth"))

    # the save is a snapshot: changing the state after a pipelined save
    # does not change what it writes
    s = state(5)
    torch_ckpt.save_checkpoint(d, s, 5, keep=2, block=False)
    s["w"].add_(100.0)
    torch_ckpt.flush_pending_checkpoint()
    assert torch.equal(torch_ckpt.load_checkpoint(torch_ckpt.latest_checkpoint(d))["w"], torch.full((4,), 5.0))
    with pytest.raises(TypeError, match="tensors, ints, strings and dicts"):
        torch_ckpt.save_checkpoint(d, {"w": [1, 2]}, 6)


def test_weights_only_load_restores_a_trainer_bit_for_bit(student, tmp_path):
    student.optimizer.updates = 3
    try:
        path = torch_ckpt.save_checkpoint(str(tmp_path), torch_ckpt.checkpoint_state(student, 3), 3)
    finally:
        student.optimizer.updates = 0
    blob = torch.load(path, map_location="cpu", weights_only=True)
    assert blob["iteration"] == 3 and blob["meta_arch"] == "STGeneralizedRCNN"
    assert blob["layouts"] == bridge.port_layouts(student.model)
    fresh = Trainer(CONFIG, TRAIN_OPTS, device="cpu", seed=1)
    assert torch_ckpt.restore_trainer(fresh, blob, path) == 3
    assert fresh.optimizer.updates == 3
    for k, v in student.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    assert torch.equal(fresh.generator.get_state(), student.generator.get_state())


def test_unreadable_or_mismatched_checkpoints_raise(teacher, student, tmp_path):
    # an orbax checkpoint directory of the JAX package, named by its tag
    orbax = tmp_path / "jax_out" / "model_0000002"
    orbax.mkdir(parents=True)
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    (tmp_path / "jax_out" / "last_checkpoint").write_text(str(orbax))
    target = bridge.flax_from_state_dict(teacher.model)
    for path in (str(tmp_path / "jax_out"), str(orbax)):
        with pytest.raises(NotImplementedError, match=r"tools/orbax_to_npz\.py .*tools\.import_jax_checkpoint"):
            torch_ckpt.import_external_weights(target, path, teacher.cfg)
    with pytest.raises(NotImplementedError, match="orbax"):
        torch_ckpt.load_checkpoint(str(orbax))
    # the dump of a JAX-trained checkpoint is no port checkpoint
    with pytest.raises(ValueError, match="the dump of a JAX-trained checkpoint: .*import_jax_checkpoint"):
        torch_ckpt.load_checkpoint(str(tmp_path / "dump.npz"))
    with pytest.raises(FileNotFoundError):
        torch_ckpt.import_external_weights(target, str(tmp_path / "missing.pth"), teacher.cfg)
    assert torch_ckpt.import_external_weights(target, "", teacher.cfg) == (target, None)
    # a teacher checkpoint cannot resume a student-teacher run
    path = torch_ckpt.save_checkpoint(str(tmp_path / "t"), torch_ckpt.checkpoint_state(teacher, 1), 1)
    with pytest.raises(RuntimeError, match="GeneralizedRCNN model, not STGeneralizedRCNN"):
        torch_ckpt.restore_trainer(student, torch_ckpt.load_checkpoint(path), path)
    # nor one of the same model at other widths
    wide = Trainer(TEACHER, TRAIN_OPTS + ["MODEL.RESNETS.STEM_OUT_CHANNELS", 16], device="cpu")
    with pytest.raises(RuntimeError, match="does not match the current model/optimizer structure"):
        torch_ckpt.restore_trainer(wide, torch_ckpt.load_checkpoint(path), path)


def test_reference_pth_through_import_external_weights(teacher, tmp_path):
    names = reference_names(teacher.model)
    sd = {names[k]: v for k, v in teacher.model.state_dict().items()}
    path = tmp_path / "teacher_reference.pth"
    torch.save({"model": sd, "iteration": 5}, path)
    target = bridge.seeded_flax_params(teacher.model, seed=4)
    tree, msg = torch_ckpt.import_external_weights(target, str(path), teacher.cfg)
    assert msg == f"imported {len(sd)} torch tensors (0 source keys unmatched)"
    got = bridge.state_dict_from_flax(teacher.model, tree)
    for k, v in teacher.model.state_dict().items():
        assert torch.equal(got[k], v), k


def test_weight_cache_resolves_without_downloading(tmp_path, monkeypatch):
    def no_download(*a):
        raise AssertionError("a cached or local weight must not be downloaded")

    monkeypatch.setattr(model_zoo, "_download", no_download)
    cache = tmp_path / "zoo"
    cache.mkdir()
    (cache / "weights-abcdef12.pth").write_bytes(b"x")
    url = "https://example.invalid/models/weights-abcdef12.pth"
    assert model_zoo.cache_url(url, model_dir=str(cache)) == str(cache / "weights-abcdef12.pth")
    monkeypatch.setenv("CMPL_TPU_MODEL_ZOO", str(cache))
    assert model_zoo.resolve_weight_path(url) == str(cache / "weights-abcdef12.pth")
    flat = model_zoo.cached_name("https://example.invalid/35858791/12/model_final.pkl")
    assert flat == "_35858791_12_model_final.pkl"
    assert model_zoo.resolve_weight_path("") == ""
    assert model_zoo.resolve_weight_path("/abs/path.pth") == "/abs/path.pth"
    assert model_zoo.resolve_weight_path("catalog://ImageNetPretrained/MSRA/R-50").endswith("R-50.pkl")
