"""Exports the eval forward as a self-contained serving artifact (the
counterpart of ``tools/export_serving.py``):

    python -m cvpr22_cross_modal_pseudo_labeling_torch.tools.export_serving \\
        --config-file X.yaml [--ckpt CKPT] [--out model.pt2] [--batch 1] \\
        [--height 800] [--width 1344] [--device cuda|cpu] [--seed N] \\
        KEY VALUE ...

JAX's tool serializes the jitted eval program with ``jax.export``; this
one exports ``engine/inference.py::ServingModule`` (``Predictor``'s
forward, with the class table of the config's first test dataset held as
a buffer) with ``torch.export.export`` under ``torch.no_grad()`` at one
fixed input shape, ``[batch, height, width, 3]`` uint8 images (as the
port's loader gives them; normalized in the program) and ``[batch, 2]``
int32 sizes, and writes it with ``torch.export.save`` (a ``.pt2``).  The weights and
the class table are in the artifact.  The graph calls the port's kernels
as the custom ops ``cmpl::nms`` and ``cmpl::roi_align`` (and
``cmpl::roi_align_levels`` for R-50-FPN), whose fake implementations
let the trace run without a card.  A manifest JSON next to it
(``OUT.json``) holds JAX's fields (``input_shape``, ``platforms``: the
device type the program was traced on, ``num_classes``,
``meta_architecture``, ``bytes``) and ``input_dtype``.

The weights, as ``test_net`` reads them
(``engine/checkpoint.py::load_eval_weights``): ``--ckpt`` names a port
checkpoint (default: the one ``OUTPUT_DIR/last_checkpoint`` names), or
weights ``MODEL.WEIGHT`` would import (the ``.npz`` dump of a JAX-trained
checkpoint, a ``.pth`` or a ``.pkl``), imported into weights drawn from
``--seed``; without it ``MODEL.WEIGHT`` is imported, or the drawn
weights serve.  The class table is
``class_emb_mtx`` of ``DATASETS.TEST[0]``, found under
``CMPL_TPU_DATA_DIR`` (a class-specific detector's dataset has none).

The serving side, :func:`load_and_run`, imports only this package's
``ops`` (which registers the custom ops; the kernels are built by
``nvcc`` at their first launch on the card) and no model code.
"""

import argparse
import json
import os
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def test_class_table(cfg) -> Optional[np.ndarray]:
    """``class_emb_mtx`` of the config's first test dataset (None when it
    has none), as JAX's tool takes it."""
    from ..data.build import build_dataset
    from ..data.transforms import build_transforms

    dataset = build_dataset(cfg, cfg.DATASETS.TEST[:1], build_transforms(cfg, False), False)[0]
    table = getattr(dataset, "class_emb_mtx", None)
    return None if table is None else np.asarray(table, np.float32)


def export_model(model, class_embeddings: Optional[np.ndarray], meta_architecture: str, batch: int, height: int,
                 width: int, out_path: str) -> Dict:
    """Exports ``ServingModule(model, class_embeddings)`` on the model's
    device at ``[batch, height, width, 3]`` and writes the artifact and its
    manifest; returns the manifest."""
    from ..engine.inference import ServingModule

    device = next(model.parameters()).device
    table = None if class_embeddings is None else torch.as_tensor(class_embeddings, dtype=torch.float32).to(device)
    module = ServingModule(model.eval(), table)
    images = torch.zeros((batch, height, width, 3), dtype=torch.uint8, device=device)
    sizes = torch.tensor([[height, width]] * batch, dtype=torch.int32, device=device)
    with torch.no_grad():
        exported = torch.export.export(module, (images, sizes))
    torch.export.save(exported, out_path)
    manifest = {
        "input_shape": [batch, height, width, 3],
        "input_dtype": "uint8",
        "platforms": [device.type],
        "num_classes": 0 if class_embeddings is None else int(np.asarray(class_embeddings).shape[0]),
        "meta_architecture": meta_architecture,
        "bytes": os.path.getsize(out_path),
    }
    with open(out_path + ".json", "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def load_exported(path: str):
    """The exported program of ``path``, with the port's custom ops
    registered (no model code is imported)."""
    from ..ops import nms, roi_align  # noqa: F401  (registers cmpl::*)

    return torch.export.load(path)


def load_and_run(path: str, images, image_sizes) -> Dict[str, torch.Tensor]:
    """Serving side: the artifact's outputs on ``images`` ``[B, H, W, 3]``
    and ``image_sizes`` ``[B, 2]`` (numpy or tensors, moved to the device
    the artifact was exported on), without model code."""
    program = load_exported(path)
    with open(path + ".json") as f:
        manifest = json.load(f)
    device = torch.device(manifest["platforms"][0])
    images = torch.as_tensor(images).to(device)
    image_sizes = torch.as_tensor(image_sizes).to(device, torch.int32)
    with torch.no_grad():
        return program.module()(images, image_sizes)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    """Builds, loads and exports the model; returns the manifest."""
    p = argparse.ArgumentParser(description="serving export (PyTorch port)")
    p.add_argument("--config-file", required=True, metavar="FILE")
    p.add_argument("--ckpt", default="", help="port checkpoint (default: OUTPUT_DIR/last_checkpoint), or "
                   "weights MODEL.WEIGHT would import")
    p.add_argument("--out", default="model.pt2")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--width", type=int, default=1344)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    args = p.parse_args(argv)

    from ..engine.checkpoint import load_eval_weights
    from ..engine.inference import Predictor

    predictor = Predictor(args.config_file, args.opts or [], device=args.device)
    cfg = predictor.cfg
    print(load_eval_weights(predictor, cfg, args.ckpt, args.seed))
    table = test_class_table(cfg)
    manifest = export_model(predictor.model, table, cfg.MODEL.META_ARCHITECTURE, args.batch, args.height,
                            args.width, args.out)
    print(json.dumps(manifest))
    return manifest


if __name__ == "__main__":
    main(sys.argv[1:])
