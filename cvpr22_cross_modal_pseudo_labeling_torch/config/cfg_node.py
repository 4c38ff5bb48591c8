"""Minimal yacs-compatible configuration node.

The port's own copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/config/
cfg_node.py`` (the port imports nothing from the JAX package).

The reference uses yacs (`maskrcnn_benchmark/config/__init__.py`); yacs is
not available here so we provide a small, compatible subset: attribute
access, ``merge_from_file`` (YAML), ``merge_from_list``, ``freeze`` /
``defrost``, ``clone``, and ``dump``.  The goal is that the reference's
experiment YAMLs (configs/coco_cap_det/*.yaml) load unchanged.
"""

from __future__ import annotations

import copy
import io
from typing import Any, Dict, List

import yaml

_VALID_TYPES = (tuple, list, str, int, float, bool, type(None))


class CfgNode(dict):
    """A dict with attribute access and yacs-style merge semantics."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: Dict[str, Any] | None = None):
        init_dict = {} if init_dict is None else init_dict
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        for k, v in init_dict.items():
            if isinstance(v, dict):
                v = CfgNode(v)
            dict.__setitem__(self, k, v)

    # -- attribute access ------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config key not found: {name}")

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(
                f"Attempted to set {name} to {value}, but CfgNode is immutable"
            )
        self[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(
                f"Attempted to set {name} to {value}, but CfgNode is immutable"
            )
        dict.__setitem__(self, name, value)

    # -- mutability ------------------------------------------------------
    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode.IMMUTABLE)

    def _set_immutable(self, flag: bool) -> None:
        object.__setattr__(self, CfgNode.IMMUTABLE, flag)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(flag)

    # -- merging ---------------------------------------------------------
    def clone(self) -> "CfgNode":
        frozen = self.is_frozen()
        self._set_immutable(False)
        out = copy.deepcopy(self)
        self._set_immutable(frozen)
        out._set_immutable(False)
        return out

    def merge_from_file(self, path: str) -> None:
        with open(path, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded is None:
            return
        self._merge_dict(loaded)

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        self._merge_dict(other)

    def merge_from_list(self, opts: List[Any]) -> None:
        assert len(opts) % 2 == 0, f"Override list has odd length: {opts}"
        for full_key, v in zip(opts[0::2], opts[1::2]):
            keys = full_key.split(".")
            node = self
            for k in keys[:-1]:
                assert k in node, f"Non-existent key: {full_key}"
                node = node[k]
            leaf = keys[-1]
            assert leaf in node, f"Non-existent key: {full_key}"
            old = node[leaf]
            node[leaf] = _decode_and_check(v, old, full_key)

    def _merge_dict(self, d: Dict[str, Any]) -> None:
        for k, v in d.items():
            if k not in self:
                # Permissive like yacs with new_allowed: accept unknown keys
                # so forward-compatible configs load.
                if isinstance(v, dict):
                    self[k] = CfgNode(v)
                else:
                    self[k] = _coerce(v)
                continue
            old = self[k]
            if isinstance(old, CfgNode) and isinstance(v, dict):
                old._merge_dict(v)
            else:
                self[k] = _decode_and_check(v, old, k)

    # -- io --------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, CfgNode) else v
        return out

    def dump(self) -> str:
        def _plain(v):
            if isinstance(v, CfgNode):
                return {k: _plain(x) for k, x in v.items()}
            if isinstance(v, tuple):
                return list(v)
            return v

        stream = io.StringIO()
        yaml.safe_dump(_plain(self), stream, default_flow_style=None)
        return stream.getvalue()

    def __str__(self) -> str:
        return self.dump()

    def __repr__(self) -> str:
        return f"CfgNode({dict.__repr__(self)})"


def _coerce(v: Any) -> Any:
    if isinstance(v, dict):
        return CfgNode(v)
    if isinstance(v, list):
        return tuple(v)
    return v


def _decode_and_check(new: Any, old: Any, key: str) -> Any:
    # yacs decodes string reprs of python literals from the command line.
    if isinstance(new, str) and not isinstance(old, str):
        try:
            import ast

            new = ast.literal_eval(new)
        except (ValueError, SyntaxError):
            pass
    if isinstance(new, list):
        new = tuple(new)
    if isinstance(old, tuple) and isinstance(new, tuple):
        return new
    if old is None or new is None:
        return new
    if isinstance(old, bool) and isinstance(new, bool):
        return new
    if isinstance(old, (int, float)) and isinstance(new, (int, float)):
        return type(old)(new) if isinstance(old, float) else new
    if type(old) is not type(new) and not isinstance(old, CfgNode):
        raise ValueError(
            f"Type mismatch for key {key}: {type(old).__name__} vs "
            f"{type(new).__name__} ({old!r} vs {new!r})"
        )
    return new
