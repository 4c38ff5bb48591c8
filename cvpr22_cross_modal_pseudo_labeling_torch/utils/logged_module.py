"""Opt-in per-tensor debug statistics.

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/utils/
logged_module.py`` (reference utils/logged_module.py:16-38,
LoggedModule): ``tensor_stats`` (min, max, mean, std and the count of
non-finite values), ``log_stats`` printing them, and ``check_finite``,
which raises on NaN or Inf anywhere in a nested dict, list or tuple of
tensors or arrays (the reference's _log_raise_nan and the MMSS forward's
NaN guard, mmss_gcnn.py:116-120).  ``log_stats`` reads the device once,
so call it only where a host sync is wanted.
"""

from typing import Dict

import numpy as np
import torch


def tensor_stats(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """0-d float32 tensors on ``x``'s device (``std`` is the population
    deviation, as ``jnp.std``)."""
    xf = x.detach().to(torch.float32)
    return {
        "min": xf.min(),
        "max": xf.max(),
        "mean": xf.mean(),
        "std": xf.std(correction=0),
        "nans": (~torch.isfinite(xf)).sum(),
    }


def log_stats(name: str, x: torch.Tensor, enabled: bool = True):
    """Prints ``x``'s statistics (one copy to the host)."""
    if not enabled:
        return
    keys = ("min", "max", "mean", "std", "nans")
    stats = tensor_stats(x)
    s = dict(zip(keys, torch.stack([stats[k].to(torch.float32) for k in keys]).cpu().tolist()))
    print(f"[{name}] min={s['min']:.4g} max={s['max']:.4g} mean={s['mean']:.4g} std={s['std']:.4g} "
          f"nans={int(s['nans'])}")


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def check_finite(tree, message: str = "non-finite value detected"):
    """Raises ValueError naming the first leaf of ``tree`` that holds a
    NaN or an Inf."""
    for path, leaf in _leaves(tree):
        arr = leaf.detach().to(torch.float32).cpu().numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        if not np.all(np.isfinite(arr)):
            raise ValueError(f"{message}: {path}")
