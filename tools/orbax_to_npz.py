#!/usr/bin/env python
"""Dump an orbax checkpoint of the JAX package into one ``.npz``:

    python tools/orbax_to_npz.py <orbax dir | OUTPUT_DIR with last_checkpoint> --out dump.npz

An orbax checkpoint (``engine/checkpoint.py::save_checkpoint``: OCDBT, a
manifest, B-tree nodes and compressed data files) is read only through
orbax and tensorstore.  This tool runs where jax runs: it restores the
raw tree as ``engine/checkpoint.py::load_checkpoint(path)`` does (no
target, so every layout restores: a train state ``{"state": TrainState,
"iteration"}`` of any optimizer chain, or an eval dump ``{"params":
...}``) and writes each array leaf under the "/"-joined path of its keys
(list and tuple positions as their index), with ``np.asarray`` of the
leaf.  Empty nodes (optax's ``MaskedNode`` and ``EmptyState``, which
restore as ``None``) hold no array and are left out.  Nothing is
interpreted: which array is a parameter, a momentum trace or a schedule
count is the reader's business (the port's
``engine/jax_checkpoint.py``).

Every array is of a dtype numpy reads alone: a bfloat16 (or other
``ml_dtypes``) leaf is widened to float32 (integers to int32), a typed
PRNG key is unwrapped with ``jax.random.key_data``.  Reserved keys under
``__dump__/`` record that (``widened``, ``widened_from``, ``key_data``:
the leaves' keys and their original dtypes), the checkpoint's path
(``source``) and, for a train state, its ``iteration``.  The file is
written with ``allow_pickle=False``, so a reader needs numpy only.

With an ``OUTPUT_DIR``, the checkpoint its ``last_checkpoint`` tag names
is dumped, found as ``engine/checkpoint.py::latest_checkpoint`` finds it
(the tag holds an absolute path).
"""

import argparse
import os
import sys
from typing import Any, Dict, Iterator, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

RESERVED = "__dump__/"


def resolve(path: str) -> str:
    """The orbax checkpoint ``path`` names: the one an ``OUTPUT_DIR``'s
    ``last_checkpoint`` tag names, or ``path`` itself."""
    from cvpr22_cross_modal_pseudo_labeling_tpu.engine.checkpoint import latest_checkpoint

    if not os.path.isdir(path):
        raise FileNotFoundError(f"{path}: no such directory")
    if os.path.exists(os.path.join(path, "last_checkpoint")):
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"{path}/last_checkpoint names a checkpoint that does not exist")
        return found
    return path


def leaves(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(the "/"-joined path, leaf) of every leaf that is not ``None``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (str(i),))
    elif tree is not None:
        yield "/".join(path), tree


def to_numpy(leaf, key: str, record: Dict[str, list]) -> np.ndarray:
    """``np.asarray(leaf)`` in a dtype numpy reads alone."""
    import jax

    if isinstance(leaf, jax.Array) and jax.dtypes.issubdtype(leaf.dtype, jax.dtypes.prng_key):
        leaf = jax.random.key_data(leaf)
        record["key_data"].append(key)
    arr = np.asarray(leaf)
    if arr.dtype.isbuiltin != 1 or arr.dtype.kind not in "biufcU":
        wide = np.int32 if jax.numpy.issubdtype(arr.dtype, jax.numpy.integer) else np.float32
        record["widened"].append(key)
        record["widened_from"].append(str(arr.dtype))
        arr = arr.astype(wide)
    return arr


def dump(path: str, out: str) -> Dict[str, Any]:
    """Writes the dump of the checkpoint ``path`` names to ``out``;
    returns what it wrote (source, iteration, arrays, bytes)."""
    from cvpr22_cross_modal_pseudo_labeling_tpu.engine.checkpoint import load_checkpoint

    source = os.path.abspath(resolve(path))
    raw = load_checkpoint(source)
    record = {"widened": [], "widened_from": [], "key_data": []}
    flat = {}
    for key, leaf in leaves(raw):
        if key.startswith(RESERVED):
            raise ValueError(f"{source}: leaf {key} uses the dump's reserved prefix {RESERVED}")
        flat[key] = to_numpy(leaf, key, record)
    flat[RESERVED + "source"] = np.asarray(source)
    if isinstance(raw, dict) and "iteration" in raw:
        flat[RESERVED + "iteration"] = np.asarray(int(raw["iteration"]), np.int64)
    for name, keys in record.items():
        flat[RESERVED + name] = np.asarray(keys, dtype=str)
    tmp = out + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, out)
    return {"source": source, "iteration": int(flat.get(RESERVED + "iteration", -1)),
            "arrays": sum(not k.startswith(RESERVED) for k in flat), "bytes": os.path.getsize(out),
            "widened": record["widened"], "key_data": record["key_data"]}


def main(argv=None) -> Dict[str, Any]:
    p = argparse.ArgumentParser(description="dump an orbax checkpoint of the JAX package to one .npz")
    p.add_argument("checkpoint", help="an orbax checkpoint directory, or an OUTPUT_DIR with last_checkpoint")
    p.add_argument("--out", required=True, help="the .npz to write")
    args = p.parse_args(argv)
    # a dump is host work: keep jax off any accelerator
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    info = dump(args.checkpoint, args.out)
    print(f"orbax_to_npz: {info['arrays']} arrays of {info['source']} (iteration {info['iteration']}) "
          f"-> {args.out}, {info['bytes']} bytes; widened {len(info['widened'])}, "
          f"key data {len(info['key_data'])}", flush=True)
    return info


if __name__ == "__main__":
    main(sys.argv[1:])
