"""Weight bridge between the JAX package's flax parameter trees and the
port's ``state_dict``.

The port names its modules after the flax scopes, so a flax leaf path
``backbone/body/layer1/block0/conv1/kernel`` maps to the port key
``backbone.body.layer1.block0.conv1.weight``.  The leaf name and the type
of the owning port module decide the layout change:

* ``Conv`` kernel ``[kh, kw, in, out]`` -> ``Conv2d`` weight
  ``[out, in, kh, kw]``;
* ``ConvTranspose`` kernel ``[kh, kw, in, out]`` -> ``ConvTranspose2d``
  weight ``[in, out, kh, kw]`` with both spatial axes flipped (torch's
  transposed conv is the gradient of conv, flax reads the kernel
  unflipped; the JAX checkpoint importer documents the same flip);
* ``Dense`` kernel ``[in, out]`` -> ``Linear`` weight ``[out, in]``;
* ``DenseGeneral`` (BERT's attention): the ``query``/``key``/``value``
  kernel ``[in, H, D]`` -> ``Linear`` weight ``[H * D, in]`` and its bias
  ``[H, D]`` -> ``[H * D]`` (layouts ``dense_heads_out:H`` and
  ``heads:H``); the ``output`` kernel ``[H, D, out]`` -> ``[out, H * D]``
  (``dense_heads_in:H``).  The layout names the head count, so a
  checkpoint's tree is rebuilt without its model;
* ``LayerNorm`` ``scale`` -> ``LayerNorm`` ``weight`` (``ln_scale``);
* ``frozen_bn_{weight,bias,mean,var}`` -> the ``FrozenBatchNorm``
  buffers ``weight``, ``bias``, ``running_mean``, ``running_var``;
* anything else (``bias``, ``word_embeddings``, ``lambda_exemplar``,
  ``mlm_bias``) as it is.

Every flax leaf lands on exactly one port key and every port key is
filled; an unmatched leaf, a missing key or a wrong shape raises.

Each port key's layout (``conv``, ``conv_transpose``, ``dense``,
``dense_heads_out:H``, ``dense_heads_in:H``, ``heads:H``, ``ln_scale``,
``bn`` or ``plain``; :func:`port_layouts`) comes from the type of its
module.
A checkpoint stores the layouts beside its ``state_dict``, so that
:func:`flax_tree_from_checkpoint` gives its flax-layout tree without
building its model (the weight importers of ``engine/checkpoint.py`` run
on flax-layout trees).
"""

from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from .models.layers import Linear
from .models.resnet import FrozenBatchNorm

_BN_LEAVES = {
    "frozen_bn_weight": "weight",
    "frozen_bn_bias": "bias",
    "frozen_bn_mean": "running_mean",
    "frozen_bn_var": "running_var",
}
_FLAX_BN_LEAVES = {v: k for k, v in _BN_LEAVES.items()}
_KERNEL_LAYOUTS = ("conv", "conv_transpose", "dense", "dense_heads_out", "dense_heads_in")


def _flatten(tree, path=()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


def _unwrap(tree):
    if set(tree) == {"params"}:
        return tree["params"]
    return tree


def _port_key(modules: Dict[str, nn.Module], path: Tuple[str, ...]):
    """(port key, layout change) for one flax leaf."""
    owner_name = ".".join(path[:-1])
    if owner_name not in modules:
        raise KeyError(f"flax leaf {'/'.join(path)} has no port module {owner_name!r}")
    owner = modules[owner_name]
    leaf = path[-1]
    prefix = owner_name + "." if owner_name else ""
    if isinstance(owner, FrozenBatchNorm):
        if leaf not in _BN_LEAVES:
            raise KeyError(f"flax leaf {'/'.join(path)} is not a frozen-BN leaf")
        return prefix + _BN_LEAVES[leaf], "bn"
    if isinstance(owner, nn.LayerNorm) and leaf == "scale":
        return prefix + "weight", "ln_scale"
    heads_out = getattr(owner, "heads_out", 0) if isinstance(owner, Linear) else 0
    heads_in = getattr(owner, "heads_in", 0) if isinstance(owner, Linear) else 0
    if leaf == "kernel":
        if isinstance(owner, nn.ConvTranspose2d):
            return prefix + "weight", "conv_transpose"
        if isinstance(owner, nn.Conv2d):
            return prefix + "weight", "conv"
        if heads_out:
            return prefix + "weight", f"dense_heads_out:{heads_out}"
        if heads_in:
            return prefix + "weight", f"dense_heads_in:{heads_in}"
        if isinstance(owner, nn.Linear):
            return prefix + "weight", "dense"
        raise KeyError(f"flax kernel {'/'.join(path)} on a {type(owner).__name__}")
    if leaf == "bias" and heads_out:
        return prefix + leaf, f"heads:{heads_out}"
    return prefix + leaf, "plain"


def _split(kind: str):
    """(layout, head count) of a layout name such as ``heads:8``."""
    name, _, heads = kind.partition(":")
    return name, int(heads) if heads else 0


def _to_port(value: np.ndarray, kind: str) -> np.ndarray:
    kind, heads = _split(kind)
    if kind == "conv":
        return value.transpose(3, 2, 0, 1)
    if kind == "conv_transpose":
        return value.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    if kind == "dense":
        return value.T
    if kind == "dense_heads_out":  # [in, H, D] -> [H * D, in]
        return value.reshape(value.shape[0], -1).T
    if kind == "dense_heads_in":  # [H, D, out] -> [out, H * D]
        return value.reshape(-1, value.shape[-1]).T
    if kind == "heads":  # [H, D] -> [H * D]
        return value.reshape(-1)
    return value


def _to_flax(value: np.ndarray, kind: str) -> np.ndarray:
    kind, heads = _split(kind)
    if kind == "conv":
        return value.transpose(2, 3, 1, 0)
    if kind == "conv_transpose":
        return value[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
    if kind == "dense":
        return value.T
    if kind == "dense_heads_out":
        return value.T.reshape(value.shape[1], heads, -1)
    if kind == "dense_heads_in":
        return value.T.reshape(heads, -1, value.shape[0])
    if kind == "heads":
        return value.reshape(heads, -1)
    return value


def state_dict_from_flax(model: nn.Module, tree) -> Dict[str, torch.Tensor]:
    """The port ``state_dict`` of a flax param tree (nested dict of
    arrays, optionally under a top-level ``"params"`` key)."""
    modules = dict(model.named_modules())
    expected = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(_unwrap(tree)).items():
        key, kind = _port_key(modules, path)
        if key not in expected:
            raise KeyError(f"flax leaf {'/'.join(path)} maps to unknown port key {key}")
        if key in out:
            raise KeyError(f"two flax leaves map to port key {key}")
        arr = np.array(_to_port(np.asarray(value), kind), order="C")  # a writable copy
        if tuple(arr.shape) != tuple(expected[key].shape):
            raise ValueError(
                f"{'/'.join(path)} {tuple(np.shape(value))} -> {key} {arr.shape}, "
                f"port expects {tuple(expected[key].shape)}"
            )
        out[key] = torch.from_numpy(arr).to(expected[key].dtype)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"flax tree leaves {len(missing)} port keys unset: {missing[:5]}")
    return out


def load_flax_params(model: nn.Module, tree) -> None:
    """Loads a flax param tree into ``model`` (strict both ways)."""
    model.load_state_dict(state_dict_from_flax(model, tree), strict=True)


def _flax_path(modules: Dict[str, nn.Module], key: str):
    """(flax leaf path, layout) of one port key."""
    owner_name, _, leaf = key.rpartition(".")
    owner = modules[owner_name]
    if isinstance(owner, FrozenBatchNorm):
        flax_leaf = _FLAX_BN_LEAVES[leaf]
    elif leaf == "weight" and isinstance(owner, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
        flax_leaf = "kernel"
    elif leaf == "weight" and isinstance(owner, nn.LayerNorm):
        flax_leaf = "scale"
    else:
        flax_leaf = leaf
    path = tuple(owner_name.split(".")) + (flax_leaf,) if owner_name else (flax_leaf,)
    return path, _port_key(modules, path)[1]


def port_layouts(model: nn.Module) -> Dict[str, str]:
    """Each key of ``model.state_dict()`` and its layout (the module
    docstring lists them)."""
    modules = dict(model.named_modules())
    return {key: _flax_path(modules, key)[1] for key in model.state_dict()}


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def flax_from_state_dict(model: nn.Module) -> Dict[str, Any]:
    """The inverse of :func:`state_dict_from_flax`: ``model``'s
    weights as a nested dict of float32 numpy arrays in the flax
    layout."""
    modules = dict(model.named_modules())
    tree: Dict[str, Any] = {}
    for key, value in model.state_dict().items():
        path, kind = _flax_path(modules, key)
        _set(tree, path, np.ascontiguousarray(_to_flax(value.detach().cpu().numpy(), kind)))
    return tree


def flax_tree_from_state_dict(state_dict: Dict[str, torch.Tensor], layouts: Dict[str, str]) -> Dict[str, Any]:
    """The flax-layout tree of a port ``state_dict`` whose layouts are
    known (see :func:`port_layouts`), without its model."""
    if set(state_dict) != set(layouts):
        raise KeyError("the state_dict and its layouts name different keys")
    tree: Dict[str, Any] = {}
    for key, value in state_dict.items():
        kind = layouts[key]
        name, heads = _split(kind)
        owner_name, _, leaf = key.rpartition(".")
        if name in ("dense_heads_out", "dense_heads_in", "heads") and heads < 1:
            raise KeyError(f"{key}: layout {kind!r} lacks its head count")
        if name == "bn":
            leaf = _FLAX_BN_LEAVES[leaf]
        elif name in _KERNEL_LAYOUTS + ("ln_scale",):
            if leaf != "weight":
                raise KeyError(f"{key}: a {kind} layout on a leaf other than weight")
            leaf = "scale" if name == "ln_scale" else "kernel"
        elif name not in ("plain", "heads"):
            raise KeyError(f"{key}: unknown layout {kind!r}")
        path = tuple(owner_name.split(".")) + (leaf,) if owner_name else (leaf,)
        _set(tree, path, np.ascontiguousarray(_to_flax(value.detach().cpu().numpy(), kind)))
    return tree


def flax_tree_from_checkpoint(ckpt: Dict[str, Any]) -> Dict[str, Any]:
    """The flax-layout tree of the model in a port checkpoint
    (``engine/checkpoint.py``: its ``trainer`` state's ``model`` and its
    ``layouts``)."""
    return flax_tree_from_state_dict(ckpt["trainer"]["model"], ckpt["layouts"])


def seeded_flax_params(model: nn.Module, seed: int, emb_pred_std: float = 0.01):
    """A flax-layout param tree for ``model`` drawn with numpy from
    ``seed`` (no pretrained weights ship with the repo).  Convs draw
    He-normal kernels (the FPN's, which no ReLU follows, 1 / fan_in
    variance), heads the JAX initializers' scales (RPN and the
    class-specific ``cls_score`` 0.01, box regression and the mask
    uncertainty's ``uncertain_pred`` 0.001, ``emb_pred``
    ``emb_pred_std``; the stem 1/64 of He, as pixels enter at O(100)),
    frozen BN a near-identity affine, biases small noise.  The BERT and
    transformer-head kernels and every embedding table draw BERT's N(0,
    0.02), LayerNorm scales a near-identity.  The RetinaNet head's towers
    draw the FPN's 1 / fan_in variance (JAX's normal(0.01) would shrink
    every score to the prior), its ``cls_logits`` the head's normal(0.01)
    and keeps its prior bias: the scores spread around ``PRIOR_PROB``."""
    rng = np.random.default_rng(seed)
    tree = flax_from_state_dict(model)

    def draw(path, value):
        leaf, shape = path[-1], value.shape
        name = "/".join(path)
        if path[-3:] == ("head", "cls_logits", "bias"):
            return value  # RetinaNetHead's prior bias
        if leaf == "kernel":
            if "language_backbone" in path or "transformer_head" in path:
                return rng.standard_normal(shape, np.float32) * np.float32(0.02)
            if "rpn_head" in path:
                std = 0.01
            elif "bbox_pred" in path:
                std = 0.001
            elif "cls_score" in path:
                std = 0.01
            elif "emb_pred" in path:
                std = emb_pred_std
            elif "uncertain_pred" in path:
                # the log-variance head: sigma = exp(logit / 2), so a
                # He-scale draw makes sigma span orders of magnitude
                std = 0.001
            elif "head" in path and path[-2].startswith(("cls_tower", "bbox_tower")):
                # the RetinaNet towers: the FPN's variance, so that four
                # of them bring the levels' O(10) features down to O(1)
                std = float(np.sqrt(1.0 / np.prod(shape[:-1])))
            elif "head" in path and path[-2] == "cls_logits":
                std = 0.01  # RetinaNetHead's own init
            elif "fpn" in path:
                # no ReLU follows the FPN's convs: the reference's
                # kaiming_uniform(a=1) variance, 1 / fan_in (JAX's
                # lecun_normal too), keeps the levels at the trunk's scale
                std = float(np.sqrt(1.0 / np.prod(shape[:-1])))
            else:
                std = float(np.sqrt(2.0 / np.prod(shape[:-1])))
                if "stem" in path:
                    # pixels enter at O(100): keep the trunk's
                    # activations O(1)
                    std /= 64.0
            return rng.standard_normal(shape, np.float32) * np.float32(std)
        if leaf == "frozen_bn_weight":
            return rng.uniform(0.5, 1.0, shape).astype(np.float32)
        if leaf == "frozen_bn_var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if leaf in ("frozen_bn_bias", "frozen_bn_mean", "bias"):
            return rng.standard_normal(shape, np.float32) * np.float32(0.1)
        if leaf in ("word_embeddings", "position_embeddings", "token_type_embeddings", "mlm_bias"):
            return rng.standard_normal(shape, np.float32) * np.float32(0.02)
        if leaf == "scale":
            return rng.uniform(0.9, 1.1, shape).astype(np.float32)
        if leaf == "lambda_exemplar":
            return np.zeros(shape, np.float32)
        raise KeyError(f"no draw rule for {name}")

    def walk(node, path):
        return {
            k: walk(v, path + (k,)) if isinstance(v, dict) else draw(path + (k,), v)
            for k, v in node.items()
        }

    return walk(tree, ())
