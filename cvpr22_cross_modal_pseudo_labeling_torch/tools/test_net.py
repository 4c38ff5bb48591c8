"""Evaluation entry point of the port (the counterpart of
``tools/test_net.py``):

    python -m cvpr22_cross_modal_pseudo_labeling_torch.tools.test_net \\
        --config-file X.yaml [--device cuda|cpu] [--seed N] KEY VALUE ...

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

The weights, as in ``tools/test_net.py``: a port checkpoint (``--ckpt``,
or the save ``OUTPUT_DIR/last_checkpoint`` names) gives the model's
weights and buffers; otherwise ``MODEL.WEIGHT``, resolved only then, is
imported into weights drawn from ``--seed`` (``bridge.seeded_flax_params``;
``engine/checkpoint.py::import_external_weights``); otherwise the drawn
weights serve.  An orbax checkpoint of the JAX package raises
(ROADMAP.md queue A item 9).
"""

import argparse
import json
import os
import sys
from typing import Dict, Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, float]]:
    """Runs the evaluation; returns each test dataset's metrics dict
    (``engine/inference.py::inference``)."""
    p = argparse.ArgumentParser(description="open-vocabulary detection eval (PyTorch port)")
    p.add_argument("--config-file", default="", metavar="FILE")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint to evaluate (default: OUTPUT_DIR/last_checkpoint)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = p.parse_args(argv)

    from .. import bridge
    from ..data import make_data_loader
    from ..engine.checkpoint import (
        import_external_weights,
        is_port_checkpoint,
        latest_checkpoint,
        load_checkpoint,
    )
    from ..engine.inference import Predictor, bbox_aug_options, check_eval_options, inference, iou_types, load_cfg
    from ..utils.logger import get_logger, setup_logger
    from ..utils.model_zoo import resolve_weight_path

    setup_logger()
    logger = get_logger("test_net")
    opts = args.opts or []
    cfg = load_cfg(args.config_file, opts)
    if not cfg.DATASETS.TEST:
        # the reference loops over an empty cfg.DATASETS.TEST (test_net.py:95-113)
        logger.info("DATASETS.TEST is empty; nothing to evaluate")
        return {}
    setup_logger(save_dir=cfg.OUTPUT_DIR)
    check_eval_options(cfg)
    ckpt = args.ckpt or latest_checkpoint(cfg.OUTPUT_DIR)
    blob = load_checkpoint(ckpt) if ckpt else None
    if blob is not None and not is_port_checkpoint(blob):
        raise ValueError(f"{ckpt} is no checkpoint of the port; import other weights through MODEL.WEIGHT")
    if blob is not None and blob["meta_arch"] != cfg.MODEL.META_ARCHITECTURE:
        raise RuntimeError(f"{ckpt} holds a {blob['meta_arch']} model, not {cfg.MODEL.META_ARCHITECTURE}")

    predictor = Predictor(args.config_file, opts, device=args.device)
    if blob is not None:
        predictor.model.load_state_dict(blob["trainer"]["model"], strict=True)
        logger.info("loaded checkpoint %s (iteration %d) on %s", ckpt, blob["iteration"], predictor.device)
    else:
        tree = bridge.seeded_flax_params(predictor.model, args.seed)
        tree, msg = import_external_weights(tree, resolve_weight_path(cfg.MODEL.WEIGHT), cfg)
        predictor.load_flax_params(tree)
        logger.info("%s", msg or f"random weights from seed {args.seed} on {predictor.device}")
    loaders, datasets = make_data_loader(cfg, is_train=False)
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
        with open(os.path.join(cfg.OUTPUT_DIR, f"metrics_{name}.json"), "w") as f:
            json.dump(
                {k: float(v) for k, v in metrics.items() if isinstance(v, (int, float))},
                f, indent=1, sort_keys=True,
            )
        out[name] = metrics
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
