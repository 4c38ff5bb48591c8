"""Caffe2/Detectron .pkl weight import (ImageNet R-50/R-101 backbones).

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/engine/
c2_loading.py`` (numpy; the result is a flax-layout tree, which
``bridge.load_flax_params`` loads).  Re-design of reference utils/c2_model_loading.py:205 (+checkpoint.py:147-149):
translates Detectron blob names (``res2_0_branch2a_w``,
``res_conv1_bn_s``...) into the torch-style dotted names our suffix
matcher understands, then reuses engine/checkpoint.import_torch_state_dict.
Detectron BN is a fused affine (scale ``_s`` / bias ``_b``); it maps onto
FrozenBatchNorm as weight/bias with mean=0, var=1.
"""

import pickle
import re
from typing import Dict

import numpy as np


def load_c2_pickle(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    if "blobs" in data:
        data = data["blobs"]
    return {
        k: np.asarray(v)
        for k, v in data.items()
        if not k.endswith("_momentum")
    }


def translate_c2_names(
    blobs: Dict[str, np.ndarray]
) -> Dict[str, np.ndarray]:
    """Caffe2 blob names -> torch-style names (c2_model_loading.py
    _rename_weights_for_resnet semantics)."""
    out: Dict[str, np.ndarray] = {}
    for name, v in blobs.items():
        new = None
        if name == "conv1_w":
            new = "backbone.body.stem.conv1.weight"
        elif name in ("res_conv1_bn_s", "conv1_bn_s"):
            new = "backbone.body.stem.bn1.weight"
        elif name in ("res_conv1_bn_b", "conv1_bn_b"):
            new = "backbone.body.stem.bn1.bias"
        else:
            m = re.match(
                r"res(\d+)_(\d+)_branch([12])([abc]?)(?:_bn)?_([wbs])$",
                name,
            )
            if m:
                stage, block, branch, sub, kind = m.groups()
                layer = int(stage) - 1
                prefix = f"backbone.body.layer{layer}.{block}"
                if branch == "1":
                    mod = "downsample.0" if kind == "w" else "downsample.1"
                else:
                    conv_idx = {"a": 1, "b": 2, "c": 3}[sub]
                    is_bn = "_bn_" in name
                    mod = f"bn{conv_idx}" if is_bn else f"conv{conv_idx}"
                leaf = {
                    "w": "weight",
                    "s": "weight",
                    "b": "bias",
                }[kind]
                # disambiguate: plain conv blobs are `..._w`; bn blobs
                # are `..._bn_s` / `..._bn_b`
                if "_bn_" in name:
                    mod = (
                        "downsample.1" if branch == "1" else f"bn{conv_idx}"
                    )
                new = f"{prefix}.{mod}.{leaf}"
        if new is None:
            continue
        out[new] = v
        # Detectron's fused BN has no running stats: synthesize identity
        if new.endswith(("bn1.weight", "bn2.weight", "bn3.weight")) or (
            "downsample.1" in new and new.endswith("weight")
        ):
            base = new[: -len(".weight")]
            out.setdefault(
                base + ".running_mean", np.zeros_like(v)
            )
            out.setdefault(base + ".running_var", np.ones_like(v))
    return out


def import_c2_imagenet_weights(params, pkl_path: str):
    """Loads a Detectron ImageNet .pkl into the flax param tree.
    Returns (new_params, report)."""
    from .checkpoint import import_torch_state_dict

    blobs = load_c2_pickle(pkl_path)
    sd = translate_c2_names(blobs)
    return import_torch_state_dict(params, sd)
