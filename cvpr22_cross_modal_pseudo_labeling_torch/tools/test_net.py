"""Evaluation entry point of the port (the counterpart of
``tools/test_net.py``):

    python -m cvpr22_cross_modal_pseudo_labeling_torch.tools.test_net \\
        --config-file X.yaml [--device cuda|cpu] [--seed N] KEY VALUE ...

For each of the config's ``DATASETS.TEST`` it runs the port's loader, a
``Predictor`` on ``--device`` (``cuda`` unless the CPU is asked for; it
raises without a card) and the port's COCO evaluator, and writes
``predictions_{name}.json`` and ``metrics_{name}.json`` into
``OUTPUT_DIR``.  The datasets are found under ``CMPL_TPU_DATA_DIR``.

The weights are drawn from ``--seed`` (``bridge.seeded_flax_params``):
checkpoints are not ported yet, so ``--ckpt``, an ``OUTPUT_DIR/
last_checkpoint`` or a ``MODEL.WEIGHT`` raises (ROADMAP.md queue A item
3) rather than being ignored.
"""

import argparse
import json
import logging
import os
import sys
from typing import Dict, Optional, Sequence

CHECKPOINTS_NOT_PORTED = "checkpoints are not ported yet (ROADMAP.md queue A item 3)"


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, float]]:
    """Runs the evaluation; returns each test dataset's metrics dict
    (``engine/inference.py::inference``)."""
    p = argparse.ArgumentParser(description="open-vocabulary detection eval (PyTorch port)")
    p.add_argument("--config-file", default="", metavar="FILE")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    p.add_argument("--ckpt", default=None, help="not ported yet: raises")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = p.parse_args(argv)

    from .. import bridge
    from ..data import make_data_loader
    from ..engine.inference import Predictor, check_eval_options, inference, load_cfg

    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    logger = logging.getLogger("cmpl_torch.test_net")
    opts = args.opts or []
    cfg = load_cfg(args.config_file, opts)
    if not cfg.DATASETS.TEST:
        # the reference loops over an empty cfg.DATASETS.TEST (test_net.py:95-113)
        logger.info("DATASETS.TEST is empty; nothing to evaluate")
        return {}
    if args.ckpt:
        raise NotImplementedError(f"--ckpt {args.ckpt}: {CHECKPOINTS_NOT_PORTED}")
    last = os.path.join(cfg.OUTPUT_DIR, "last_checkpoint")
    if os.path.exists(last):
        raise NotImplementedError(f"{last} exists: {CHECKPOINTS_NOT_PORTED}")
    if cfg.MODEL.WEIGHT:
        raise NotImplementedError(f"MODEL.WEIGHT {cfg.MODEL.WEIGHT}: {CHECKPOINTS_NOT_PORTED}")
    check_eval_options(cfg)

    predictor = Predictor(args.config_file, opts, device=args.device)
    predictor.load_flax_params(bridge.seeded_flax_params(predictor.model, args.seed))
    logger.info("random weights from seed %d on %s", args.seed, predictor.device)
    loaders, datasets = make_data_loader(cfg, is_train=False)
    iou_types = ("bbox",) + (("segm",) if cfg.MODEL.MASK_ON else ())
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    out = {}
    for name, loader, dataset in zip(cfg.DATASETS.TEST, loaders, datasets):
        metrics = inference(
            predictor,
            loader,
            dataset,
            iou_types=iou_types,
            expected_results=cfg.TEST.EXPECTED_RESULTS,
            expected_results_sigma_tol=cfg.TEST.EXPECTED_RESULTS_SIGMA_TOL,
            output_file=os.path.join(cfg.OUTPUT_DIR, f"predictions_{name}.json"),
        )
        logger.info(
            "eval[%s]: %s",
            name,
            {k: round(v, 4) for k, v in metrics.items()
             if isinstance(v, float) and "AP50_class" not in k},
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
