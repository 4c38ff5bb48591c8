"""Training entry point of the port (the counterpart of
``tools/train_net.py``):

    python -m cvpr22_cross_modal_pseudo_labeling_torch.tools.train_net \\
        --config-file X.yaml [--skip-test] [--device cuda|cpu] [--seed N] KEY VALUE ...

or on k cards of one host, one process a card:

    torchrun --nproc_per_node k -m cvpr22_cross_modal_pseudo_labeling_torch.tools.train_net \\
        --config-file X.yaml [--dist-backend nccl|gloo] KEY VALUE ...

It trains the model the config names (MMSS pretraining ``MMSS-GCNN``;
``GeneralizedRCNN``, the teacher or a class-specific supervised
detector, the RPN-only detector (``MODEL.RPN_ONLY``; its test scores the
proposals' recall), RetinaNet (``MODEL.RETINANET_ON``), or one of its
baseline skeletons ``SBBaseline``, ``OMP`` and ``BA_RPN``; the student ``STGeneralizedRCNN`` or one of its baselines
``SoftTeacher`` and ``UnbiasedTeacher``) on ``DATASETS.TRAIN`` with a ``Trainer`` on ``--device`` (``cuda``
unless the CPU is asked for; it raises without a card), through
``engine/trainer.py::do_train``, and then evaluates a detector on
``DATASETS.TEST`` unless ``--skip-test`` or ``TEST.DO_EVAL False``
(MMSS has no detection test: it needs one of the two).  The datasets
are found under ``CMPL_TPU_DATA_DIR``.  In JAX's order:

* an ``OUTPUT_DIR/last_checkpoint`` with ``MODEL.LOAD_TRAINER_STATE``
  resumes: the loader starts at its iteration, and the checkpoint
  restores the model, the optimizer and the generator; under
  ``DATALOADER.USE_GRAIN`` with a saved ``loader_state.json``
  (``loader_state_{rank}.json`` on the other ranks) the grain stream is
  built from its start and positioned by that state instead, mid-epoch;
* otherwise the weights are drawn from ``--seed``
  (``bridge.seeded_flax_params``), then ``MODEL.WEIGHT`` (a port
  checkpoint or its ``OUTPUT_DIR``, the ``.npz`` dump of a JAX-trained
  checkpoint, a reference ``.pth`` or a Caffe2 ``.pkl``) and
  ``MODEL.LANGUAGE_WEIGHT`` are imported, and the
  student-teacher model's student starts as a copy of its teacher unless
  ``MODEL.RESUME``;
* the student-teacher model's LVIS class-name table comes from its BERT
  table (under ``MODEL.LANGUAGE_BACKBONE.FT_EMB`` the tokenized names
  ship instead, and each step rebuilds the table from the live word
  table); under ``MODEL.EXEMPLARS_ENABLED`` the ``Trainer`` holds the
  exemplar table, the dataset classes' LVIS slots ship with the class
  table, and a resume restores the table; checkpoints are written every
  ``SOLVER.CHECKPOINT_PERIOD`` and at the end;
* every ``SOLVER.TEST_PERIOD`` a detector is evaluated on each of
  ``DATASETS.TEST``, and unless ``SOLVER.SKIP_VAL_LOSS`` the
  validation-loss pass (``Trainer.val_loss``) runs over 8 batches of
  ``DATASETS.TEST[0]`` and logs ``iter N val_loss X``.  MMSS runs the
  pass only: JAX's in-training eval calls detection inference on it,
  which ``MMSSGridModel`` cannot serve (ROADMAP.md section C).

Under torchrun (``WORLD_SIZE`` > 1) each process joins the group over
``--dist-backend`` (``parallel/dist.py::init_from_env``; nccl by default,
gloo when asked for, also for ranks that share a card) and trains on
``cuda:LOCAL_RANK`` (or the CPU with ``--device cpu``) as JAX's processes
do on their hosts: each rank loads ``SOLVER.IMS_PER_BATCH / world``
images a step and ``TEST.IMS_PER_BATCH / world`` an eval batch, its
stripe of the test sets, the step reduces over the global batch
(``engine/train_step.py``), rank 0 writes the checkpoints, the labels,
the metrics and the predictions, and the validation-loss pass sums the
ranks' shares over the batches every rank has (a short tail batch may
leave one rank fewer images than another).  Every family trains on
ranks, MMSS pretraining included.
"""

import argparse
import itertools
import os
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..parallel.dist import BACKENDS

MMSS = "MMSS-GCNN"
# batches of DATASETS.TEST[0] in one validation-loss pass
VAL_LOSS_BATCHES = 8


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Trains, then tests; returns ``train``'s record with the test
    metrics under ``"test"`` (``{}`` when skipped)."""
    p = argparse.ArgumentParser(description="open-vocabulary detection training (PyTorch port)")
    p.add_argument("--config-file", default="", metavar="FILE")
    p.add_argument("--skip-test", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights and draws")
    p.add_argument("--dist-backend", default="nccl", choices=BACKENDS,
                   help="the process group's backend under torchrun (WORLD_SIZE > 1)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None, help="config overrides: KEY VALUE pairs")
    args = p.parse_args(argv)
    device = launch_device(args.device, args.dist_backend)

    from ..config import get_default_cfg
    from ..parallel.dist import rank
    from ..utils.env_info import collect_env_info
    from ..utils.logger import setup_logger

    cfg = get_default_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(list(args.opts or []))
    cfg.freeze()
    test = not args.skip_test and cfg.TEST.DO_EVAL
    if test and cfg.MODEL.META_ARCHITECTURE == MMSS and cfg.DATASETS.TEST:
        raise ValueError("MMSS-GCNN pretraining has no detection test: pass --skip-test or TEST.DO_EVAL False")
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    logger = setup_logger(save_dir=cfg.OUTPUT_DIR, rank=rank())
    logger.info("environment:\n%s", collect_env_info())
    logger.info("config:\n%s", cfg)
    record = train(cfg, logger, device, args.seed)
    record["test"] = {}
    if test:
        record["test"] = run_test(cfg, record["trainer"], logger)
    return record


def launch_device(device: str, backend: str) -> str:
    """The device of this process: ``device`` in one process; under
    torchrun (``WORLD_SIZE`` > 1) the rank's card, or the CPU for
    ``device="cpu"``, once the process group is up.  Raises without a
    card unless the CPU is asked for."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from ..parallel.dist import init_from_env

        return str(init_from_env(backend, torch.device(device).type))
    return device


def _summary(metrics):
    """The metrics of a log line: no per-class AP (COCO's ``AP50_class_``,
    VOC's ``AP_class_``)."""
    return {k: round(v, 4) for k, v in metrics.items() if isinstance(v, float) and "_class_" not in k}


def train(cfg, logger, device: str = "cuda", seed: int = 0) -> Dict:
    """Builds, restores or imports, and trains.  Returns a dict: the
    ``trainer``, the ``start_iter``, the in-training ``evals``
    (iteration -> dataset -> metrics), the ``val_losses`` (iteration ->
    mean ``val_total_loss``) and the set-up's ``timing`` in seconds
    (``weights_s``, ``restore_s``, ``lvis_table_s``)."""
    from .. import bridge
    from ..data import make_data_loader
    from ..data.collate import build_tokenizer
    from ..data.parser import load_lvis_categories, lvis_ids_for_class_names, normalize_class_names
    from ..engine.checkpoint import (
        checkpoint_step,
        import_external_weights,
        import_language_table,
        latest_checkpoint,
        load_checkpoint,
        populate_student_from_teacher,
        restore_trainer,
    )
    from ..engine.inference import Predictor, check_eval_options, inference, iou_types
    from ..engine.train_step import Trainer
    from ..engine.trainer import (
        compute_class_name_embeddings,
        do_train,
        loader_state_path,
        restore_loader_state,
        tokenize_class_names,
    )
    from ..models.detector import ST_FAMILY
    from ..parallel.dist import barrier, gather_objects, is_primary, rank, world_size
    from ..utils.env_info import save_labels
    from ..utils.model_zoo import resolve_weight_path

    meta_arch = cfg.MODEL.META_ARCHITECTURE
    timing = {}
    shard = dict(is_distributed=world_size() > 1, rank=rank(), num_replicas=world_size())

    # resume discovery before the loader is built: the save's name
    # encodes its iteration, where the sampler starts (reference
    # data/build.py:115 + trainer.py:94); every rank reads the tag once
    # a previous run's rank 0 has published it
    barrier()
    last = latest_checkpoint(cfg.OUTPUT_DIR)
    resuming = bool(last and cfg.MODEL.LOAD_TRAINER_STATE)
    start_iter = checkpoint_step(last) if resuming else 0
    # a resumed grain stream is positioned by its saved state, so it is
    # not also sliced at the iteration (that would skip twice)
    use_stream_state = bool(
        cfg.DATALOADER.USE_GRAIN and start_iter > 0 and os.path.exists(loader_state_path(cfg.OUTPUT_DIR))
    )
    loader, dataset = make_data_loader(cfg, is_train=True, start_iter=0 if use_stream_state else start_iter,
                                       **shard)
    trainer = Trainer(cfg, device=device, seed=seed)
    if trainer.exemplars is not None:
        logger.info("exemplar table initialized: %d slots x %d dims", *trainer.exemplars["embs"].shape)

    if not resuming:
        # on a resume the restore below supplies every weight, so
        # MODEL.WEIGHT is neither resolved nor read (reference
        # utils/checkpoint.py:55-63)
        t = time.perf_counter()
        tree = bridge.seeded_flax_params(trainer.model, seed)
        tree, msg = import_external_weights(tree, resolve_weight_path(cfg.MODEL.WEIGHT), cfg)
        if msg:
            logger.info("%s", msg)
        if cfg.MODEL.LANGUAGE_WEIGHT:
            lw = resolve_weight_path(cfg.MODEL.LANGUAGE_WEIGHT)
            tree, report = import_language_table(tree, lw)
            logger.info("language table: imported %d leaves from %s", report["matched"], lw)
        if meta_arch in ST_FAMILY and not cfg.MODEL.RESUME:
            # prepare_model (reference st_generalized_rcnn.py:191-199):
            # the student starts as a copy of the teacher's RoI heads
            tree, n_copied = populate_student_from_teacher(tree)
            logger.info("prepare_model: copied %d teacher leaves into the student", n_copied)
        trainer.load_flax_params(tree)
        timing["weights_s"] = time.perf_counter() - t

    if hasattr(dataset, "class_names") and is_primary():
        save_labels(dataset.class_names, cfg.OUTPUT_DIR)

    if resuming:
        t = time.perf_counter()
        restored_iter = restore_trainer(trainer, load_checkpoint(last), last)
        timing["restore_s"] = time.perf_counter() - t
        if restored_iter != start_iter:
            logger.warning(
                "checkpoint path says iteration %d but contents say %d; using %d (loader was sized for %d)",
                start_iter, restored_iter, restored_iter, start_iter,
            )
            start_iter = restored_iter
        logger.info("resumed from %s at iteration %d", last, start_iter)
        if use_stream_state and restore_loader_state(cfg.OUTPUT_DIR, loader):
            logger.info("data stream resumed from %s", os.path.basename(loader_state_path(cfg.OUTPUT_DIR)))

    # MMSS reads no class table, nor does a class-specific detector, whose
    # datasets (VOC, Cityscapes) may have none
    tables = {} if meta_arch == MMSS else {"class_embeddings": getattr(dataset, "class_emb_mtx", None)}
    if meta_arch in ST_FAMILY:
        names = normalize_class_names([c["name"] for c in load_lvis_categories()])
        if cfg.MODEL.LANGUAGE_BACKBONE.FT_EMB:
            # the word table trains: each step rebuilds the LVIS table
            # from the tokenized names, and a resume computes nothing
            tables["lvis_name_ids"], tables["lvis_name_mask"] = tokenize_class_names(names, build_tokenizer(cfg))
            logger.info("LVIS class names tokenized for the in-step table: %d x %d", *tables["lvis_name_ids"].shape)
        else:
            # the LVIS class-name table from the (frozen) BERT table:
            # after a restore it equals the fresh run's
            t = time.perf_counter()
            tables["lvis_class_embeddings"] = compute_class_name_embeddings(
                trainer.model, names, build_tokenizer(cfg))
            timing["lvis_table_s"] = time.perf_counter() - t
            logger.info(
                "LVIS class-name table: %d x %d in %.3f s",
                *tables["lvis_class_embeddings"].shape, timing["lvis_table_s"],
            )
        if trainer.exemplars is not None and getattr(dataset, "class_names", None):
            # the detection branch mixes exemplars into the dataset's
            # classes by name (-1: no LVIS noun)
            tables["class_lvis_ids"] = np.asarray(lvis_ids_for_class_names(dataset.class_names), np.int64)
    trainer.set_class_tables(**tables)

    evals: Dict[int, Dict[str, Dict[str, float]]] = {}
    val_losses: Dict[int, float] = {}
    eval_fn = None
    detect = meta_arch != MMSS
    val_loss = not cfg.SOLVER.SKIP_VAL_LOSS
    if cfg.DATASETS.TEST and cfg.SOLVER.TEST_PERIOD > 0 and (detect or val_loss):
        if detect:
            check_eval_options(cfg)
        val_loaders, val_datasets = make_data_loader(cfg, is_train=False, **shard)
        val_classes = getattr(val_datasets[0], "class_names", None)
        if val_loss and val_classes is not None and val_classes != getattr(dataset, "class_names", None):
            # the pass reads the training class table; JAX's gather past
            # its end gives a NaN loss
            raise ValueError(
                f"the validation-loss pass runs {cfg.DATASETS.TEST[0]} against the training class table, "
                "whose classes differ; put a dataset with the training classes first in DATASETS.TEST "
                "or set SOLVER.SKIP_VAL_LOSS True"
            )

        def eval_fn(trainer, iteration):
            if detect:
                # the trainer's own model, in eval mode for the pass
                predictor = Predictor.from_model(cfg, trainer.model)
                try:
                    for name, loader_t, ds in zip(cfg.DATASETS.TEST, val_loaders, val_datasets):
                        metrics = inference(
                            predictor, loader_t, ds, iou_types=iou_types(cfg),
                            expected_results=cfg.TEST.EXPECTED_RESULTS,
                            expected_results_sigma_tol=cfg.TEST.EXPECTED_RESULTS_SIGMA_TOL,
                        )
                        logger.info("iter %d eval[%s]: %s", iteration, name, _summary(metrics))
                        evals.setdefault(iteration, {})[name] = metrics
                finally:
                    trainer.model.train()
            if val_loss:
                # the batches every rank has: each reduces over the ranks
                n = min(gather_objects(min(VAL_LOSS_BATCHES, len(val_loaders[0]))))
                totals = [
                    trainer.val_loss(trainer.device_batch(batch))["val_total_loss"]
                    for batch, _ in itertools.islice(iter(val_loaders[0]), n)
                ]
                if totals:
                    val_losses[iteration] = float(np.mean(torch.stack(totals).cpu().numpy()))
                    logger.info("iter %d val_loss %.4f", iteration, val_losses[iteration])

    do_train(trainer.train_step, trainer, loader, cfg, eval_fn=eval_fn, output_dir=cfg.OUTPUT_DIR,
             start_iter=start_iter)
    return {"trainer": trainer, "start_iter": start_iter, "evals": evals, "val_losses": val_losses,
            "timing": timing}


def run_test(cfg, trainer, logger) -> Dict[str, Dict[str, float]]:
    """The trained model on each of ``DATASETS.TEST``; writes
    ``predictions_{name}.json`` into ``OUTPUT_DIR`` and returns each
    dataset's metrics."""
    from ..data import make_data_loader
    from ..engine.inference import Predictor, check_eval_options, inference, iou_types
    from ..parallel.dist import rank, world_size

    if not cfg.DATASETS.TEST:
        return {}
    check_eval_options(cfg)
    predictor = Predictor.from_model(cfg, trainer.model)
    loaders, datasets = make_data_loader(cfg, is_train=False, is_distributed=world_size() > 1, rank=rank(),
                                         num_replicas=world_size())
    out = {}
    for name, loader, dataset in zip(cfg.DATASETS.TEST, loaders, datasets):
        metrics = inference(
            predictor, loader, dataset, iou_types=iou_types(cfg),
            expected_results=cfg.TEST.EXPECTED_RESULTS,
            expected_results_sigma_tol=cfg.TEST.EXPECTED_RESULTS_SIGMA_TOL,
            output_file=os.path.join(cfg.OUTPUT_DIR, f"predictions_{name}.json"),
        )
        logger.info("eval[%s]: %s", name, _summary(metrics))
        out[name] = metrics
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
