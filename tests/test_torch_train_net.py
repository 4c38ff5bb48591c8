"""The port's ``train_net`` entry point on the CPU (the counterpart of
``tests/test_cli_resume.py``), in-process through ``main(argv)`` with
``--device cpu`` on a tiny synthetic COCO tree (``tools/synth_coco.py``:
8 train and 8 val JPEGs, 3 seen and 2 unseen classes) at narrow widths:

- the teacher: a fresh 1-step run, a resume to 4 that trains steps 2-4
  only, a relaunch that trains none and writes no checkpoint, and a
  ``MODEL.WEIGHT`` URL that a resume never resolves;
- the paper's two stages: the teacher, then the student from the
  teacher's checkpoint (its teacher bundle equal to the teacher's
  weights, its student a copy of them), with the in-training evaluation
  and the final test, and ``test_net --ckpt`` on the student's
  checkpoint giving ``run_test``'s metrics exactly;
- ``compute_class_name_embeddings`` equals JAX's on the same BERT table
  and tokenizer (the LVIS names, 1203 rows), within 1e-6;
- the entry point needs a card unless the CPU is asked for, and refuses
  the options it does not run; a train sampler that can never fill a
  batch raises instead of hanging.
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpr22_cross_modal_pseudo_labeling_tpu.data.collate import build_tokenizer as jax_tokenizer
from cvpr22_cross_modal_pseudo_labeling_tpu.data.parser import load_lvis_categories as jax_lvis
from cvpr22_cross_modal_pseudo_labeling_tpu.data.parser import normalize_class_names as jax_names
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import trainer as jax_trainer
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import st_generalized_rcnn as jax_st
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.data.collate import build_tokenizer
from cvpr22_cross_modal_pseudo_labeling_torch.data.parser import load_lvis_categories, normalize_class_names
from cvpr22_cross_modal_pseudo_labeling_torch.data.samplers import (
    DistributedSampler,
    GroupedBatchSampler,
    IterationBasedBatchSampler,
)
from cvpr22_cross_modal_pseudo_labeling_torch.engine import checkpoint as torch_ckpt
from cvpr22_cross_modal_pseudo_labeling_torch.engine import trainer as torch_trainer
from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer
from cvpr22_cross_modal_pseudo_labeling_torch.tools import test_net, train_net
from cvpr22_cross_modal_pseudo_labeling_torch.utils import model_zoo
from tests.tensorboard_stub import tensorboard_compat_reset  # noqa: F401  (an autouse fixture)
from tests.test_torch_st_train import TRAIN_OPTS, jax_cfg_of

REPO = Path(__file__).resolve().parents[1]
TEACHER = str(REPO / "configs/coco_cap_det/zeroshot_mask.yaml")
STUDENT = str(REPO / "configs/coco_cap_det/student_teacher_mask_rcnn_uncertainty.yaml")
TINY = [
    "MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
    "MODEL.RESNETS.WIDTH_PER_GROUP", 4, "MODEL.ROI_BOX_HEAD.EMB_DIM", 768,
    "MODEL.RPN.PRE_NMS_TOP_N_TEST", 128, "MODEL.RPN.POST_NMS_TOP_N_TEST", 32,
    "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", 128, "MODEL.RPN.POST_NMS_TOP_N_TRAIN", 32,
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", 16, "TPU.MASK_POS_CAP", 8, "TPU.MAX_GT", 4,
    "TPU.MAX_CAP_NOUNS", 3, "MODEL.ROI_MASK_HEAD.CONV_LAYERS", (8,), "TPU.COMPUTE_DTYPE", "float32",
    "INPUT.MIN_SIZE_TRAIN", (64,), "INPUT.MAX_SIZE_TRAIN", 96, "INPUT.MIN_SIZE_TEST", 64,
    "INPUT.MAX_SIZE_TEST", 96, "TPU.IMAGE_BUCKETS", ((96, 96),),
    "DATASETS.TEST", ("coco_generalized_zeroshot_val",), "TEST.IMS_PER_BATCH", 4,
    "SOLVER.IMS_PER_BATCH", 2, "SOLVER.LOG_PERIOD", 1, "DATALOADER.NUM_WORKERS", 2,
]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth_coco")
    subprocess.run(
        [sys.executable, str(REPO / "tools/synth_coco.py"), "--out", str(out), "--train", "8",
         "--val", "8", "--seen", "3", "--unseen", "2"],
        check=True, capture_output=True, timeout=300,
    )
    return out


@pytest.fixture(autouse=True)
def catalog(tree, monkeypatch):
    monkeypatch.setenv("CMPL_TPU_DATA_DIR", str(tree))
    # TensorBoard writes through its own stub, not tensorflow (importing
    # it takes most of a minute here)
    monkeypatch.setitem(sys.modules, "tensorflow", None)


def run(config, out_dir, *opts, skip_test=True):
    argv = ["--config-file", config, "--device", "cpu", *map(str, TINY), *map(str, opts),
            "OUTPUT_DIR", str(out_dir)]
    return train_net.main((["--skip-test"] if skip_test else []) + argv)


def logged(out_dir):
    with open(Path(out_dir) / "tb" / "metrics.jsonl") as f:
        return [json.loads(line) for line in f if line.strip()]


def log_text(out_dir):
    return (Path(out_dir) / "log.txt.rank0").read_text()


def saves(out_dir):
    return sorted(p.name for p in Path(out_dir).glob("model_*.pth"))


def test_fresh_resume_relaunch_and_an_untouched_weight_on_resume(tmp_path, monkeypatch):
    out = tmp_path / "teacher"
    fixed = ["SOLVER.CHECKPOINT_PERIOD", 1, "MODEL.LOAD_TRAINER_STATE", True, "SOLVER.TEST_PERIOD", 0]
    # 1. a fresh 1-step run
    rec = run(TEACHER, out, "SOLVER.MAX_ITER", 1, *fixed)
    assert rec["start_iter"] == 0 and rec["trainer"].optimizer.updates == 1
    assert [r["step"] for r in logged(out)] == [1]
    assert saves(out) == ["model_0000001.pth"]
    # 2. the budget raised to 4: steps 2-4 exactly
    rec = run(TEACHER, out, "SOLVER.MAX_ITER", 4, *fixed)
    assert rec["start_iter"] == 1 and rec["trainer"].optimizer.updates == 4
    assert f"resumed from {out}/model_0000001.pth at iteration 1" in log_text(out)
    assert [r["step"] for r in logged(out)] == [1, 2, 3, 4]
    assert all(math.isfinite(r["total_loss"]) for r in logged(out))
    assert saves(out)[-1] == "model_0000004.pth"
    before = {p: p.stat().st_mtime_ns for p in out.glob("model_*.pth")}
    # 3. a finished run relaunched: zero steps, no new checkpoint
    rec = run(TEACHER, out, "SOLVER.MAX_ITER", 4, *fixed)
    assert "training already complete" in log_text(out)
    assert [r["step"] for r in logged(out)] == [1, 2, 3, 4]
    assert {p: p.stat().st_mtime_ns for p in out.glob("model_*.pth")} == before
    # 4. a resume never resolves MODEL.WEIGHT
    def no_download(*a):
        raise AssertionError("a resume must not fetch MODEL.WEIGHT")

    monkeypatch.setattr(model_zoo, "_download", no_download)
    monkeypatch.setenv("CMPL_TPU_MODEL_ZOO", str(tmp_path / "empty_zoo"))
    rec = run(TEACHER, out, "SOLVER.MAX_ITER", 4, *fixed, "MODEL.WEIGHT", "http://localhost:9/init.pth")
    assert rec["start_iter"] == 4
    assert [r["step"] for r in logged(out)] == [1, 2, 3, 4]
    # while a fresh run does resolve it, and a URL not in the cache raises
    with pytest.raises(AssertionError, match="must not fetch"):
        run(TEACHER, tmp_path / "fresh", "SOLVER.MAX_ITER", 1, *fixed, "MODEL.WEIGHT",
            "http://localhost:9/init.pth")


def _bundle(ckpt, prefix):
    return {k[len(prefix):]: v for k, v in ckpt["trainer"]["model"].items() if k.startswith(prefix)}


def _without_time(metrics):
    return {k: v for k, v in metrics.items() if not k.startswith("time/") and k != "total_eval_seconds"}


def test_teacher_then_student_then_test_net_from_the_checkpoint(tmp_path):
    teacher_out, st_out = tmp_path / "teacher", tmp_path / "st"
    run(TEACHER, teacher_out, "SOLVER.MAX_ITER", 2, "SOLVER.CHECKPOINT_PERIOD", 2, "SOLVER.TEST_PERIOD", 0)
    teacher = torch_ckpt.load_checkpoint(torch_ckpt.latest_checkpoint(str(teacher_out)))
    assert teacher["iteration"] == 2 and teacher["meta_arch"] == "GeneralizedRCNN"

    rec = run(STUDENT, st_out, "MODEL.WEIGHT", teacher_out, "SOLVER.MAX_ITER", 2, "SOLVER.CHECKPOINT_PERIOD", 2,
              "SOLVER.TEST_PERIOD", 2, skip_test=False)
    text = log_text(st_out)
    assert f"from checkpoint {teacher_out}/model_0000002.pth (0 source leaves unmatched)" in text
    n_copied = int(text.split("prepare_model: copied ")[1].split()[0])
    assert n_copied > 0
    assert [r["step"] for r in logged(st_out)] == [1, 2]
    assert all(math.isfinite(v) for r in logged(st_out) for v in r.values())
    st = torch_ckpt.load_checkpoint(str(st_out / "model_0000002.pth"))
    for part in ("roi_extractor.", "box_predictor.", "mask_predictor."):
        got, want = _bundle(st, "teacher." + part), _bundle(teacher, part)
        assert got.keys() == want.keys() and got
        for k in want:
            assert torch.equal(got[k], want[k]), part + k  # the frozen teacher, bit for bit
    for k in ("body.stem.conv1.weight", "body.layer3.block0.conv1.weight"):
        assert torch.equal(_bundle(st, "backbone.")[k], _bundle(teacher, "backbone.")[k])

    name = "coco_generalized_zeroshot_val"
    assert list(rec["evals"]) == [2] and list(rec["test"]) == [name]
    for metrics in (rec["evals"][2][name], rec["test"][name]):
        assert "bbox/AP" in metrics and "segm/AP" in metrics
        assert all(math.isfinite(v) or "AP50_class" in k for k, v in metrics.items())
    assert _without_time(rec["evals"][2][name]) == _without_time(rec["test"][name])

    got = test_net.main(["--config-file", STUDENT, "--device", "cpu", "--ckpt", str(st_out / "model_0000002.pth"),
                         *map(str, TINY), "OUTPUT_DIR", str(tmp_path / "eval")])
    a, b = _without_time(got[name]), _without_time(rec["test"][name])
    assert a.keys() == b.keys()
    assert all(a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])) for k in a)
    # and from OUTPUT_DIR/last_checkpoint, with a MODEL.WEIGHT it must not read
    again = test_net.main(["--config-file", STUDENT, "--device", "cpu", *map(str, TINY),
                           "MODEL.WEIGHT", str(tmp_path / "missing.pth"), "OUTPUT_DIR", str(st_out)])
    assert _without_time(again[name]).keys() == a.keys()
    assert all(_without_time(again[name])[k] == a[k] or math.isnan(a[k]) for k in a)


def test_class_name_embeddings_match_jax():
    trainer = Trainer(STUDENT, TRAIN_OPTS, device="cpu")
    tree = bridge.seeded_flax_params(trainer.model, seed=0)
    trainer.load_flax_params(tree)
    names = normalize_class_names([c["name"] for c in load_lvis_categories()])
    assert names == jax_names([c["name"] for c in jax_lvis()]) and len(names) == 1203
    cfg = jax_cfg_of([])
    got = torch_trainer.compute_class_name_embeddings(trainer.model, names, build_tokenizer(trainer.cfg))
    model = jax_st.STGeneralizedRCNN(jax_st.st_statics_from_cfg(cfg))
    ref = jax_trainer.compute_class_name_embeddings(
        model, {"params": jax.tree_util.tree_map(jnp.asarray, tree)}, names, jax_tokenizer(cfg))
    assert got.shape == ref.shape == (1203, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    ids, mask = torch_trainer.tokenize_class_names(names, build_tokenizer(trainer.cfg))
    ref_ids, ref_mask = jax_trainer.tokenize_class_names(names, jax_tokenizer(cfg))
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(mask, ref_mask)


def test_train_net_needs_a_card_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_net.main(["--config-file", TEACHER, "OUTPUT_DIR", str(tmp_path)])


@pytest.mark.parametrize("opts,match", [
    (["DATALOADER.USE_GRAIN", True], "USE_GRAIN"),
])
def test_unported_training_options_raise(tmp_path, opts, match):
    with pytest.raises(NotImplementedError, match=match):
        run(STUDENT, tmp_path, "SOLVER.MAX_ITER", 1, *opts)


def test_a_sampler_that_never_fills_a_batch_raises():
    """8 images in groups of 6, 1 and 1, batches of 8 with the partial
    batches dropped: no epoch yields a batch, and the iteration-based
    sampler raises instead of looping for ever."""
    sampler = DistributedSampler(8, shuffle=True)
    grouped = GroupedBatchSampler(sampler, [0, 0, 0, 3, 0, 0, 0, 4], 8, drop_last=True)
    with pytest.raises(ValueError, match="no batch in a whole epoch"):
        next(iter(IterationBasedBatchSampler(grouped, 4)))
    # with groups that fill a batch it yields as before
    grouped = GroupedBatchSampler(sampler, [0] * 6 + [3, 4], 2, drop_last=True)
    assert len(list(IterationBasedBatchSampler(grouped, 5))) == 5


MMSS_CONFIG = str(REPO / "configs/coco_cap_det/mmss.yaml")
# the three stages share a trunk whose C5 has the RoI head's 2048
# channels (res2 256), so that MMSS's layer4 and v2l land on the teacher
WIDE = ["MODEL.RESNETS.RES2_OUT_CHANNELS", 256]
MMSS_TINY = [
    "MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.RESNETS.WIDTH_PER_GROUP", 4, *WIDE,
    "MODEL.WEIGHT", "", "MODEL.MMSS_HEAD.TRANSFORMER.BERT_CONFIG.num_hidden_layers", 1,
    "TPU.COMPUTE_DTYPE", "float32", "TPU.MAX_CAP_TOKENS", 16,
    "INPUT.MIN_SIZE_TRAIN", (64,), "INPUT.MAX_SIZE_TRAIN", 96, "INPUT.MIN_SIZE_TEST", 64,
    "INPUT.MAX_SIZE_TEST", 96, "TPU.IMAGE_BUCKETS", ((96, 96),),
    "SOLVER.IMS_PER_BATCH", 2, "TEST.IMS_PER_BATCH", 2, "SOLVER.LOG_PERIOD", 1, "DATALOADER.NUM_WORKERS", 2,
    "SOLVER.CHECKPOINT_PERIOD", 2, "SOLVER.TEST_PERIOD", 1,
]


def run_mmss(out_dir, *opts):
    argv = ["--config-file", MMSS_CONFIG, "--device", "cpu", *map(str, MMSS_TINY), *map(str, opts),
            "OUTPUT_DIR", str(out_dir)]
    return train_net.main(argv)


def test_mmss_then_teacher_then_student(tmp_path):
    """The paper's three stages through the port's ``train_net`` (the
    counterpart of ``tests/test_cli_pipeline.py``): MMSS pretraining
    with its validation-loss pass at every step, a checkpoint and a
    resume; the teacher from the MMSS ``OUTPUT_DIR`` with
    ``LOAD_EMB_PRED_FROM_MMSS_HEAD`` (at learning rate 0, so that its
    checkpoint holds the imported weights: the C5 ``layer4`` on the RoI
    extractor and ``v2l_projection`` on ``emb_pred``, bit for bit); the
    student from the teacher, with its BERT table from the MMSS
    directory and the validation-loss pass beside its evaluation (on
    the seen classes: the pass reads the training class table)."""
    from tests.test_torch_mmss_train import write_val_captions

    import os

    write_val_captions(Path(os.environ["CMPL_TPU_DATA_DIR"]))
    mmss_out, teacher_out, st_out = tmp_path / "mmss", tmp_path / "teacher", tmp_path / "st"
    rec = run_mmss(mmss_out, "SOLVER.MAX_ITER", 2)
    text = log_text(mmss_out)
    assert list(rec["val_losses"]) == [1, 2] and all(math.isfinite(v) for v in rec["val_losses"].values())
    assert "iter 1 val_loss" in text and "iter 2 val_loss" in text and rec["evals"] == {}
    assert [r["step"] for r in logged(mmss_out)] == [1, 2]
    assert all(math.isfinite(v) for r in logged(mmss_out) for v in r.values())
    assert saves(mmss_out) == ["model_0000002.pth"]
    rec = run_mmss(mmss_out, "SOLVER.MAX_ITER", 3, "MODEL.LOAD_TRAINER_STATE", True)
    assert rec["start_iter"] == 2 and rec["trainer"].optimizer.updates == 3
    assert f"resumed from {mmss_out}/model_0000002.pth at iteration 2" in log_text(mmss_out)
    mmss = torch_ckpt.load_checkpoint(torch_ckpt.latest_checkpoint(str(mmss_out)))
    assert mmss["iteration"] == 3 and mmss["meta_arch"] == "MMSS-GCNN"
    with pytest.raises(ValueError, match="no detection test"):
        run_mmss(tmp_path / "refused", "TEST.DO_EVAL", True)

    run(TEACHER, teacher_out, *WIDE, "MODEL.WEIGHT", mmss_out, "MODEL.LOAD_EMB_PRED_FROM_MMSS_HEAD", True,
        "SOLVER.BASE_LR", 0.0, "SOLVER.MAX_ITER", 1, "SOLVER.TEST_PERIOD", 0)
    text = log_text(teacher_out)
    n = int(text.split("imported ")[1].split()[0])
    teacher = torch_ckpt.load_checkpoint(torch_ckpt.latest_checkpoint(str(teacher_out)))
    src, got = mmss["trainer"]["model"], teacher["trainer"]["model"]
    layer4 = {k: v for k, v in src.items() if k.startswith("backbone.body.layer4.")}
    trunk = [k for k in src if k.startswith("backbone.body.") and not k.startswith("backbone.body.layer4.")]
    # every trunk tensor through layer3, layer4 and the projection
    assert n == len([k for k in trunk if k in got]) + len(layer4) + 2 and len(layer4) == 50
    for k, v in layer4.items():
        assert torch.equal(got[k.replace("backbone.body.", "roi_extractor.")], v), k
    assert torch.equal(got["box_predictor.emb_pred.weight"], src["v2l_projection.weight"])
    assert torch.equal(got["box_predictor.emb_pred.bias"], src["v2l_projection.bias"])
    assert torch.equal(got["backbone.body.layer3.block5.conv2.weight"], src["backbone.body.layer3.block5.conv2.weight"])

    student = [*WIDE, "MODEL.WEIGHT", teacher_out, "MODEL.LANGUAGE_WEIGHT", mmss_out, "SOLVER.MAX_ITER", 1,
               "SOLVER.TEST_PERIOD", 1, "SOLVER.SKIP_VAL_LOSS", False]
    # the pass reads the training class table: a test set of other
    # classes first is refused before training
    with pytest.raises(ValueError, match="training class table"):
        run(STUDENT, tmp_path / "refused_st", *student)
    rec = run(STUDENT, st_out, *student, "DATASETS.TEST", ("coco_not_zeroshot_val",))
    text = log_text(st_out)
    assert "language table: imported 1 leaves" in text and "prepare_model: copied" in text
    assert "iter 1 val_loss" in text and list(rec["val_losses"]) == [1] and list(rec["evals"]) == [1]
    assert math.isfinite(rec["val_losses"][1])
    st = torch_ckpt.load_checkpoint(torch_ckpt.latest_checkpoint(str(st_out)))["trainer"]["model"]
    assert torch.equal(st["bert.word_embeddings"], src["language_backbone.word_embeddings"])


OI_TEACHER = str(REPO / "configs/conceptual_openimages_det/zeroshot_mask.yaml")
OI_STUDENT = str(REPO / "configs/conceptual_openimages_det/student_teacher_mask_rcnn_uncertainty.yaml")
OI_NAME = "openimages_zeroshot_val"
OI = ["DATASETS.TEST", f"('{OI_NAME}',)", "SOLVER.CHECKPOINT_PERIOD", 2, "SOLVER.TEST_PERIOD", 0]


def test_openimages_teacher_then_student_then_test_net_plain_and_augmented(tmp_path, monkeypatch):
    """The Conceptual/OpenImages pair on the tiny tree of
    ``tests/test_torch_openimages.py`` (12 seen and 4 unseen classes):
    the teacher (``NUM_CLASSES 201``, the repeat-factor sampler) 2 steps;
    the student (``NUM_CLASSES -1``) from the teacher's ``OUTPUT_DIR`` 3
    steps on the mixture, batches of detection and caption images
    (``det_mask`` False) among them, its teacher bundle the teacher's bit
    for bit, the pseudo-label loss nonzero on a batch with a caption
    image; ``run_test`` and ``test_net --ckpt`` equal on the val set with
    the image-level filter, and ``test_net`` with ``TEST.BBOX_AUG``
    box-only."""
    from tests.test_torch_openimages import write_tiny_tree

    tree = write_tiny_tree(tmp_path / "oi")
    monkeypatch.setenv("CMPL_TPU_DATA_DIR", str(tree))
    step, batches = Trainer.train_step, []

    def recording_step(self, b, draws=None):
        out = step(self, b, draws)
        det = b.get("det_mask")
        batches.append({"arch": self.meta_arch, "det_mask": None if det is None else det.cpu().numpy().tolist(),
                        "dtype": str(b["images"].dtype), "classes": int(self.class_tables["class_embeddings"].shape[0])})
        return out

    monkeypatch.setattr(Trainer, "train_step", recording_step)
    t_out, s_out = tmp_path / "teacher", tmp_path / "st"
    rec = run(OI_TEACHER, t_out, "SOLVER.MAX_ITER", 2, *OI)
    assert [r["step"] for r in logged(t_out)] == [1, 2]
    assert all(math.isfinite(r["total_loss"]) for r in logged(t_out))
    assert len(batches) == 2 and batches[0]["classes"] == 13
    teacher = torch_ckpt.load_checkpoint(str(t_out / "model_0000002.pth"))

    rec = run(OI_STUDENT, s_out, "MODEL.WEIGHT", t_out, "SOLVER.MAX_ITER", 3, *OI, skip_test=False)
    st_batches = batches[2:]
    assert len(st_batches) == 3 and all(b["dtype"] == "torch.uint8" and b["classes"] == 13 for b in st_batches)
    assert any(not all(b["det_mask"]) for b in st_batches) and any(any(b["det_mask"]) for b in st_batches)
    steps = logged(s_out)
    assert [r["step"] for r in steps] == [1, 2, 3] and all(math.isfinite(v) for r in steps for v in r.values())
    assert any(r["loss_classifier_pseudo"] > 0 for r, b in zip(steps, st_batches) if not all(b["det_mask"]))
    st = torch_ckpt.load_checkpoint(str(s_out / "model_0000003.pth"))
    for part in ("roi_extractor.", "box_predictor.", "mask_predictor."):
        got, want = _bundle(st, "teacher." + part), _bundle(teacher, part)
        assert got.keys() == want.keys() and got and all(torch.equal(got[k], want[k]) for k in want)

    test = rec["test"][OI_NAME]
    assert {"bbox/AP50_split_seen", "bbox/AP50_split_unseen", "segm/AP"} <= set(test)
    assert all(math.isfinite(v) or "AP50" in k for k, v in test.items())
    ckpt = ["--config-file", OI_STUDENT, "--device", "cpu", "--ckpt", str(s_out / "model_0000003.pth"),
            *map(str, TINY), *map(str, OI)]
    got = test_net.main(ckpt + ["OUTPUT_DIR", str(tmp_path / "eval")])[OI_NAME]
    a, b = _without_time(got), _without_time(test)
    assert a.keys() == b.keys() and all(a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])) for k in a)
    aug = test_net.main(ckpt + ["TEST.BBOX_AUG.ENABLED", "True", "TEST.BBOX_AUG.H_FLIP", "True",
                                "TEST.BBOX_AUG.SCALES", "(48, 80)", "OUTPUT_DIR", str(tmp_path / "aug")])[OI_NAME]
    assert aug["time/variants_per_img"] == 4 and not any(k.startswith("segm/") for k in aug)
    with open(tmp_path / "aug" / f"predictions_{OI_NAME}.json") as f:
        preds = json.load(f)
    per_image = {}
    for p in preds:
        per_image[p["image_id"]] = per_image.get(p["image_id"], 0) + 1
    assert preds and max(per_image.values()) <= 100 and all("segmentation" not in p for p in preds)
