"""Evaluation entry point of the port (the counterpart of
``tools/test_net.py``):

    python -m cvpr22_cross_modal_pseudo_labeling_torch.tools.test_net \\
        --config-file X.yaml [--device cuda|cpu] [--seed N] KEY VALUE ...

or on k cards, one process a card, as ``train_net`` is launched
(``torchrun --nproc_per_node k -m ...test_net ... [--dist-backend
nccl|gloo]``): each rank evaluates its stripe of each test set, and rank 0
gathers the results, writes the files and evaluates (``tools/test_net.py``
:56-70's per-process shards).

For each of the config's ``DATASETS.TEST`` it runs the port's loader, a
``Predictor`` on ``--device`` (``cuda`` unless the CPU is asked for; it
raises without a card) for any detector of the ``GeneralizedRCNN`` and
``STGeneralizedRCNN`` families (RetinaNet included), and the port's
evaluator (the COCO protocol, VOC's ``bbox/mAP`` and ``bbox/mAP_07metric``
on a VOC dataset, or the proposals' ``box_proposal/AR_*@1000`` for an
RPN-only model, whose ``predictions_{name}.json`` holds the proposals), and writes ``predictions_{name}.json`` and
``metrics_{name}.json`` into ``OUTPUT_DIR``.  The datasets are found under ``CMPL_TPU_DATA_DIR``.
With ``TEST.BBOX_AUG.ENABLED`` the detections come from the test-time
augmentation (``engine/inference.py::compute_on_dataset_bbox_aug``),
box-only, as in ``tools/test_net.py``.

The weights (``engine/checkpoint.py::load_eval_weights``, which
``tools/export_serving.py`` shares): a port checkpoint (``--ckpt``, or
the save ``OUTPUT_DIR/last_checkpoint`` names) gives the model's weights
and buffers, and one of another meta-architecture raises; other weights
``--ckpt`` names, or ``MODEL.WEIGHT`` without it, are imported into
weights drawn from ``--seed`` (``import_external_weights``: the ``.npz``
dump of a JAX-trained checkpoint, a ``.pth``, a ``.pkl``, and through
``MODEL.WEIGHT`` a port checkpoint of another stage); otherwise the
drawn weights serve.  An orbax checkpoint of the JAX package raises
with the two commands that make it a port checkpoint
(``tools/orbax_to_npz.py`` where jax runs, then this package's
``tools/import_jax_checkpoint.py``).
"""

import argparse
import json
import os
import sys
from typing import Dict, Optional, Sequence

from ..parallel.dist import BACKENDS
from .train_net import launch_device


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, float]]:
    """Runs the evaluation; returns each test dataset's metrics dict
    (``engine/inference.py::inference``)."""
    p = argparse.ArgumentParser(description="open-vocabulary detection eval (PyTorch port)")
    p.add_argument("--config-file", default="", metavar="FILE")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint to evaluate (default: OUTPUT_DIR/last_checkpoint), or weights "
                   "MODEL.WEIGHT would import")
    p.add_argument("--dist-backend", default="nccl", choices=BACKENDS,
                   help="the process group's backend under torchrun (WORLD_SIZE > 1)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = p.parse_args(argv)

    from ..data import make_data_loader
    from ..engine.checkpoint import load_eval_weights
    from ..engine.inference import Predictor, bbox_aug_options, check_eval_options, inference, iou_types, load_cfg
    from ..parallel.dist import barrier, is_primary, rank, world_size
    from ..utils.logger import get_logger, setup_logger

    # torchrun's rank, before the group is up
    setup_logger(rank=int(os.environ.get("RANK", "0")))
    logger = get_logger("test_net")
    opts = args.opts or []
    cfg = load_cfg(args.config_file, opts)
    if not cfg.DATASETS.TEST:
        # the reference loops over an empty cfg.DATASETS.TEST (test_net.py:95-113)
        logger.info("DATASETS.TEST is empty; nothing to evaluate")
        return {}
    device = launch_device(args.device, args.dist_backend)
    setup_logger(save_dir=cfg.OUTPUT_DIR, rank=rank())
    check_eval_options(cfg)
    barrier()  # a training run's rank 0 has published the tag
    predictor = Predictor(args.config_file, opts, device=device)
    logger.info("%s", load_eval_weights(predictor, cfg, args.ckpt, args.seed))
    loaders, datasets = make_data_loader(cfg, is_train=False, is_distributed=world_size() > 1, rank=rank(),
                                         num_replicas=world_size())
    out = {}
    for name, loader, dataset in zip(cfg.DATASETS.TEST, loaders, datasets):
        metrics = inference(
            predictor,
            loader,
            dataset,
            iou_types=iou_types(cfg),
            expected_results=cfg.TEST.EXPECTED_RESULTS,
            expected_results_sigma_tol=cfg.TEST.EXPECTED_RESULTS_SIGMA_TOL,
            output_file=os.path.join(cfg.OUTPUT_DIR, f"predictions_{name}.json"),
            bbox_aug=bbox_aug_options(cfg),
        )
        logger.info(
            "eval[%s]: %s",
            name,
            {k: round(v, 4) for k, v in metrics.items()
             if isinstance(v, float) and "_class_" not in k},
        )
        if is_primary():
            with open(os.path.join(cfg.OUTPUT_DIR, f"metrics_{name}.json"), "w") as f:
                json.dump(
                    {k: float(v) for k, v in metrics.items() if isinstance(v, (int, float))},
                    f, indent=1, sort_keys=True,
                )
        out[name] = metrics
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
