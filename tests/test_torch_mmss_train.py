"""MMSS training in the port against the JAX package on the CPU: the
``Trainer`` step, the validation-loss step, the captions dataset and
loader, and the import of an MMSS checkpoint into the teacher.

The model is ``tests/test_torch_mmss.py``'s narrow ``MMSSGridModel``
(handed to the ``Trainer``; the optimizer follows
``configs/coco_cap_det/mmss.yaml``: SGD at 0.01 with warmup, weight
decay 1e-4, the gradient clipped at norm 5, the BERT frozen).  JAX's
draws are replayed through ``JaxMMSSDraws``.

Tolerances (float32): losses 1e-5 relative; the logged ``grad_norm``
1e-5 of JAX's norm without the frozen-BN leaves, and 5e-3 of JAX's
logged norm, which also counts them (they are buffers in the port: about
0.1% of the squared norm at this seed); each trainable parameter's update 1e-3 of the JAX
update's norm plus an ulp of the weight per element; the frozen BERT
and the BN buffers bit for bit.  The
validation losses 1e-5.  Dataset samples and loader batches exactly.
Checkpoint imports: the same leaves matched, bit for bit.
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
from cvpr22_cross_modal_pseudo_labeling_tpu.data import make_data_loader as jax_loader
from cvpr22_cross_modal_pseudo_labeling_tpu.data import paths_catalog as jax_catalog
from cvpr22_cross_modal_pseudo_labeling_tpu.data.datasets import COCOCaptionsDataset as JaxCaptions
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import checkpoint as jax_ckpt
from cvpr22_cross_modal_pseudo_labeling_tpu.engine.inference import compute_on_dataset as jax_compute_on_dataset
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import optimizer as jax_opt
from cvpr22_cross_modal_pseudo_labeling_tpu.engine import train_step as jax_train
from cvpr22_cross_modal_pseudo_labeling_tpu.models.detector import mmss_gcnn as jax_mmss
from cvpr22_cross_modal_pseudo_labeling_torch import bridge
from cvpr22_cross_modal_pseudo_labeling_torch.config import get_default_cfg as torch_cfg
from cvpr22_cross_modal_pseudo_labeling_torch.data import make_data_loader
from cvpr22_cross_modal_pseudo_labeling_torch.data.datasets import COCOCaptionsDataset
from cvpr22_cross_modal_pseudo_labeling_torch.engine import checkpoint as torch_ckpt
from cvpr22_cross_modal_pseudo_labeling_torch.engine.train_step import Trainer, device_batch
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector import build_detection_model
from cvpr22_cross_modal_pseudo_labeling_torch.models.detector import mmss_gcnn as torch_mmss
from tests import test_torch_teacher as teacher_tests
from tests.native_libs import ensure_native_libs
from tests.test_torch_mmss import JaxMMSSDraws, jax_params, mmss_batch, narrow_statics, seeded_tree

REPO = Path(__file__).resolve().parents[1]
MMSS_CONFIG = str(REPO / "configs/coco_cap_det/mmss.yaml")
MMSS = "MMSS-GCNN"
OPTS = ["TPU.COMPUTE_DTYPE", "float32"]
MMSS_KEYS = ("images", "image_sizes", "input_ids", "attention_mask", "special_tokens_mask")


def jax_mmss_cfg(opts=()):
    cfg = jax_cfg()
    cfg.merge_from_file(MMSS_CONFIG)
    cfg.merge_from_list(OPTS + list(opts))
    return cfg


def mmss_trainer(seed=3, res2_out_channels=16):
    s = narrow_statics()
    s = s._replace(backbone=s.backbone._replace(res2_out_channels=res2_out_channels))
    trainer = Trainer(MMSS_CONFIG, OPTS, device="cpu", seed=seed, model=torch_mmss.MMSSGridModel(s))
    tree = seeded_tree(trainer.model)
    trainer.load_flax_params(tree)
    return trainer, tree


def jax_batch(batch):
    return {k: jnp.asarray(batch[k]) for k in MMSS_KEYS}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _norm_without(grads, skip):
    leaves = jax.tree_util.tree_flatten_with_path(grads)[0]
    return float(np.sqrt(sum(float(jnp.sum(g.astype(jnp.float32) ** 2)) for p, g in leaves
                             if not skip("/".join(str(getattr(k, "key", k)) for k in p)))))


def test_trainer_steps_match_jax_train_step():
    """Two ``Trainer.step`` calls against two steps of the jitted JAX
    ``build_train_step`` with ``make_optimizer``: the losses and info,
    ``grad_norm`` as JAX logs it, each trainable parameter's update, the
    frozen BERT and the BN buffers bit for bit."""
    trainer, tree = mmss_trainer()
    cfg = jax_mmss_cfg()
    model = jax_mmss.MMSSGridModel(narrow_statics("jax"))
    params = jax_params(tree)
    tx, labels = jax_opt.make_optimizer(cfg, params["params"], jax_opt.frozen_prefixes_from_cfg(cfg, MMSS))
    state = jax_train.create_train_state(params, tx, jax.random.PRNGKey(0))
    step = jax.jit(jax_train.build_train_step(model, tx, MMSS))
    grad_fn = jax.jit(jax.grad(jax_train.build_loss_fn(model, MMSS), has_aux=True))
    bert = {n: p.detach().clone() for n, p in trainer.model.named_parameters() if n.startswith("language_backbone.")}
    buffers = {n: b.clone() for n, b in trainer.model.named_buffers()}
    assert bert and all(p.requires_grad for n, p in trainer.model.named_parameters())
    assert {n for n, lab in trainer.optimizer.labels.items() if lab == "frozen"} == set(bert)
    for it in range(2):
        batch = mmss_batch(seed=1 + it)
        rng = jax.random.fold_in(state.rng, state.step)
        grads, _ = grad_fn(state.params, jax_batch(batch), rng)
        with JaxMMSSDraws() as rec:
            state, metrics = step(state, jax_batch(batch))
            jax.block_until_ready(state.params)
        prev = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        got = trainer.step(batch, rec.draws())
        assert set(got) == set(metrics)
        for k, v in metrics.items():
            if k == "grad_norm":
                continue
            np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-7, err_msg=k)
        # the logged norm: JAX's counts every gradient, the frozen BERT's
        # too; the port lacks only the frozen-BN leaves
        norm = float(got["grad_norm"])
        without_bn = _norm_without(grads["params"], lambda p: "frozen_bn" in p)
        trainable_only = _norm_without(grads["params"], lambda p: "frozen_bn" in p or p.startswith("language_backbone"))
        assert abs(norm / without_bn - 1) < 1e-5
        assert without_bn - trainable_only > 100 * abs(norm - without_bn)  # BERT's share is in it
        assert abs(norm / float(metrics["grad_norm"]) - 1) < 5e-3
        assert trainable_only > 5.0  # the clip is active
        ref = bridge.state_dict_from_flax(trainer.model, jax.tree_util.tree_map(np.asarray, state.params["params"]))
        for name, p in trainer.model.named_parameters():
            if name in bert:
                assert torch.equal(p.detach(), bert[name]), name
                assert p.grad is None
                continue
            up = (p.detach() - prev[name]).numpy()
            want = ref[name].numpy() - prev[name].numpy()
            # an ulp of the weight per element on top: an update at the
            # weight's rounding (seq_relationship's, weight decay alone)
            ulp = float(np.linalg.norm(np.spacing(prev[name].numpy())))
            err = float(np.linalg.norm(up.astype(np.float64) - want))
            assert err <= 1e-3 * float(np.linalg.norm(want)) + ulp, (it, name, err)
    for n, b in trainer.model.named_buffers():
        assert torch.equal(b, buffers[n]), n


def test_mmss_val_loss_step_matches_jax():
    """``Trainer.val_loss`` against ``build_val_loss_step`` on JAX's
    replayed draws; on its own fixed draws it is deterministic and
    leaves the model untouched."""
    trainer, tree = mmss_trainer()
    model = jax_mmss.MMSSGridModel(narrow_statics("jax"))
    val = jax.jit(jax_train.build_val_loss_step(model, MMSS))
    batch = mmss_batch(seed=5)
    with JaxMMSSDraws() as rec:
        want = val(jax_params(tree), jax_batch(batch))
        jax.block_until_ready(want)
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    b = trainer.device_batch(batch)
    got = trainer.val_loss(b, rec.draws())
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-7, err_msg=k)
    a, c = trainer.val_loss(b), trainer.val_loss(b)
    assert all(torch.equal(a[k], c[k]) for k in a) and not a["val_total_loss"].requires_grad
    for n, p in trainer.model.named_parameters():
        assert torch.equal(p.detach(), before[n]) and p.grad is None, n


def test_teacher_val_loss_step_matches_jax():
    setup = teacher_tests.make_setup("float32")
    trainer = setup["trainer"]
    val = jax.jit(jax_train.build_val_loss_step(setup["model"], "GeneralizedRCNN"))
    batch = teacher_tests.tiny_batch("three_gt", seed=4)
    with teacher_tests.JaxDraws() as rec:
        want = val(setup["params"], teacher_tests.jax_batch(batch))
        jax.block_until_ready(want)
    got = trainer.val_loss(trainer.device_batch(batch), rec.draws())
    assert set(got) == set(want) == set(teacher_tests.LOSSES) | {"val_total_loss"}
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-5, atol=1e-7, err_msg=k)


def test_registry_builds_mmss_from_its_config():
    cfg = torch_cfg()
    cfg.merge_from_file(MMSS_CONFIG)
    cfg.merge_from_list(["MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
                         "MODEL.RESNETS.WIDTH_PER_GROUP", 4])
    model = build_detection_model(cfg)
    s = model.statics
    assert isinstance(model, torch_mmss.MMSSGridModel)
    assert s == torch_mmss.mmss_statics_from_cfg(cfg)
    assert s.backbone.conv_body == "R-50-C5" and s.tie_vl and s.spatial_dropout == 100
    assert (s.bert_layers, s.l_dim, s.vocab_size) == (12, 768, 30522)
    assert (s.transformer.num_layers, s.transformer.num_heads, s.transformer.intermediate_size) == (6, 8, 768)
    assert s.grounding.temperature == 10.0 and s.grounding.loss_type == "cross_entropy"
    assert model.backbone.out_channels == 128 and hasattr(model.backbone.body, "layer4")
    # the same statics as the JAX package's reading of the config
    jcfg = jax_mmss_cfg(["MODEL.RESNETS.STEM_OUT_CHANNELS", 8, "MODEL.RESNETS.RES2_OUT_CHANNELS", 16,
                         "MODEL.RESNETS.WIDTH_PER_GROUP", 4])
    js = jax_mmss.mmss_statics_from_cfg(jcfg)
    assert tuple(js.grounding) == tuple(s.grounding) and tuple(js.transformer) == tuple(s.transformer)
    assert js._replace(backbone=None, grounding=None, transformer=None) == tuple(
        s._replace(backbone=None, grounding=None, transformer=None))


def write_val_captions(root: Path) -> None:
    """``coco/annotations/captions_val2017.json`` over the synthetic
    tree's val images, with captions of its class names (the tree's
    generator writes the train captions only)."""
    coco = root / "coco"
    blob = json.loads((coco / "zero-shot/instances_val2017_all_2.json").read_text())
    names = [c["name"] for c in blob["categories"]]
    anns = [{"id": 20_000_000 + 2 * i + k, "image_id": im["id"],
             "caption": f"a {names[(i + k) % len(names)]} next to a {names[(i + 2 * k + 1) % len(names)]}"}
            for i, im in enumerate(blob["images"]) for k in range(2)]
    (coco / "annotations/captions_val2017.json").write_text(json.dumps({"images": blob["images"],
                                                                         "annotations": anns}))


@pytest.fixture(scope="module", autouse=True)
def native_libs():
    """Both packages' native image and mask libraries, loaded before
    the first comparison (``tests/native_libs.py``)."""
    ensure_native_libs()


@pytest.fixture(scope="module")
def captions_tree(tmp_path_factory):
    out = tmp_path_factory.mktemp("synth_captions")
    subprocess.run([sys.executable, str(REPO / "tools/synth_coco.py"), "--out", str(out), "--train", "5",
                    "--val", "4", "--seen", "3", "--unseen", "2"], check=True, capture_output=True, timeout=300)
    write_val_captions(out)
    return out


def _same(a, b, what):
    assert set(a) == set(b), what
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f"{what} {k}")
        else:
            assert x == y, (what, k)


def test_captions_dataset_samples_and_batches_equal_jax(captions_tree, monkeypatch):
    import random

    from cvpr22_cross_modal_pseudo_labeling_tpu.data.datasets import coco_captions as jax_captions_mod
    from cvpr22_cross_modal_pseudo_labeling_torch.data.datasets import coco_captions as captions_mod

    # the train loader's flips come from visit_rng, seeded from a visit
    # counter of each package, which earlier tests in the process advance
    # apart: both datasets get the same per-index generator instead
    for mod in (jax_captions_mod, captions_mod):
        monkeypatch.setattr(mod, "visit_rng", lambda index: random.Random(1000 + index))
    monkeypatch.setenv("CMPL_TPU_DATA_DIR", str(captions_tree))
    # the JAX catalog reads the variable once, when it is imported
    monkeypatch.setattr(jax_catalog, "DATA_DIR", str(captions_tree))
    coco = captions_tree / "coco"
    for split in ("train2017", "val2017"):
        args = dict(ann_file=str(coco / f"annotations/captions_{split}.json"), root=str(coco / split))
        port, ref = COCOCaptionsDataset(**args), JaxCaptions(**args)
        assert len(port) == len(ref) > 0 and port.ids == ref.ids
        for i in range(len(ref)):
            _same(port[i], ref[i], f"{split} sample {i}")
            assert port.get_img_info(i) == ref.get_img_info(i)
        assert any(ref[i]["caption"] for i in range(len(ref)))
    opts = ["SOLVER.IMS_PER_BATCH", 2, "TEST.IMS_PER_BATCH", 2, "SOLVER.MAX_ITER", 2,
            "INPUT.MIN_SIZE_TRAIN", (64,), "INPUT.MAX_SIZE_TRAIN", 96, "INPUT.MIN_SIZE_TEST", 64,
            "INPUT.MAX_SIZE_TEST", 96, "TPU.IMAGE_BUCKETS", ((96, 96),), "TPU.MAX_CAP_TOKENS", 16,
            "DATALOADER.NUM_WORKERS", 1]
    pcfg = torch_cfg()
    pcfg.merge_from_file(MMSS_CONFIG)
    pcfg.merge_from_list(opts)
    jcfg = jax_mmss_cfg(opts)
    for is_train in (True, False):
        got, want = make_data_loader(pcfg, is_train=is_train), jax_loader(jcfg, is_train=is_train)
        got, want = (got[0], want[0]) if is_train else (got[0][0], want[0][0])
        n = 0
        for (gb, gi), (wb, wi) in zip(got, want):
            assert gi == wi
            _same(gb, wb, f"batch {n}")
            assert gb["input_ids"].shape == (2, 16) and set(MMSS_KEYS) <= set(gb)
            n += 1
        assert n == 2
        device_batch(gb, "cpu", MMSS)  # the step reads every key it needs


def test_mmss_checkpoint_imports_into_the_teacher_as_jax_does(tmp_path):
    """An MMSS port checkpoint, read back through its layouts, imported
    into the teacher's tree with ``LOAD_EMB_PRED_FROM_MMSS_HEAD``, equals
    JAX's ``import_flax_params`` on the same flax tree: the same leaves
    matched and missed, the same values; ``v2l_projection`` lands on
    ``emb_pred`` and the C5 ``layer4`` on the RoI extractor.  Both trunks
    have res2 256 here, so that the C5 stage has the RoI head's 2048
    outputs."""
    trainer, tree = mmss_trainer(res2_out_channels=256)
    torch_ckpt.save_checkpoint(str(tmp_path), torch_ckpt.checkpoint_state(trainer, 3), 3)
    torch_ckpt.flush_pending_checkpoint()
    blob = torch_ckpt.load_checkpoint(torch_ckpt.latest_checkpoint(str(tmp_path)))
    assert blob["meta_arch"] == MMSS and blob["iteration"] == 3
    src = bridge.flax_tree_from_checkpoint(blob)
    teacher = Trainer(teacher_tests.TEACHER, teacher_tests.TRAIN_OPTS + [
        "MODEL.ROI_BOX_HEAD.EMB_DIM", 64, "MODEL.RESNETS.RES2_OUT_CHANNELS", 256], device="cpu")
    target = bridge.seeded_flax_params(teacher.model, 1)
    kw = dict(load_emb_pred_from_mmss_head=True, default_mmss_head="GroundingHead")
    got, got_report = torch_ckpt.import_flax_params(target, src, **kw)
    want, want_report = jax_ckpt.import_flax_params(target, tree, **kw)
    assert got_report == want_report
    assert got_report["matched"] > 150 and not got_report["unfilled_targets"] == []
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, want))[0])
    assert flat_got.keys() == flat_want.keys()
    for k in flat_want:
        np.testing.assert_array_equal(flat_got[k], flat_want[k], err_msg=str(k))
    np.testing.assert_array_equal(got["box_predictor"]["emb_pred"]["kernel"], tree["v2l_projection"]["kernel"])
    layer4 = tree["backbone"]["body"]["layer4"]
    for path, value in jax.tree_util.tree_flatten_with_path(layer4)[0]:
        node = got["roi_extractor"]["layer4"]
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, value)
    assert len(jax.tree_util.tree_leaves(layer4)) == 50  # 3 blocks and the downsample, convs and BN
    teacher.load_flax_params(got)  # the imported tree loads strictly


def test_jax_in_training_eval_cannot_serve_mmss():
    """The fault the port avoids: JAX's in-training eval
    (``tools/train_net.py``'s ``eval_fn``) calls ``inference``, whose
    ``compute_on_dataset`` applies the model with ``class_embeddings=``
    (``tpu/engine/inference.py:49-58``); ``MMSSGridModel.__call__`` takes
    no such argument, so ``mmss.yaml``'s first ``TEST_PERIOD`` raises."""
    model = jax_mmss.MMSSGridModel(narrow_statics("jax"))
    port = torch_mmss.MMSSGridModel(narrow_statics())
    params = jax_params(seeded_tree(port))
    batch = mmss_batch()
    with pytest.raises(TypeError, match="class_embeddings"):
        jax_compute_on_dataset(model, params, [(batch, [0, 1, 2])], dataset=None, class_embeddings=None)
