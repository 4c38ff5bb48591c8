"""Checkpoints trained with the JAX package, as weights and as a
resumable trainer state.

An orbax checkpoint of the JAX package (``tpu/engine/trainer.py``:
``{"state": TrainState, "iteration"}``; an eval dump ``{"params": ...}``)
is OCDBT with compressed chunks, which only orbax and tensorstore read.
``tools/orbax_to_npz.py`` runs where jax runs and writes its raw tree to
one ``.npz``: every leaf under the "/"-joined path of its keys, with no
meaning attached.  This module gives the arrays their meaning, with
numpy and torch alone:

* :func:`read_dump` reads the flat arrays; :func:`params_tree` gives the
  flax-layout parameter tree, unwrapped as ``extract_params_tree`` does
  (a train state's ``state/params/params/...`` or an eval dump's
  ``params/...``).  ``MODEL.WEIGHT`` and ``MODEL.LANGUAGE_WEIGHT`` import
  it as they import a port checkpoint's tree (``engine/checkpoint.py``).
* :func:`load_into_trainer` loads a dump into a ``Trainer``.  The
  parameters go through ``bridge.load_flax_params``.  The optimizer state
  is the one ``make_optimizer`` builds (``tpu/engine/optimizer.py:81``):
  ``multi_transform`` over the labels, each an ``add_decayed_weights``
  (left out at weight decay 0), ``trace`` and ``scale_by_schedule``
  chain; the uncertain labels wrapped by ``_freeze_after`` as ``{inner,
  count}``; the ``multi_transform`` at index 2 of an outer chain under
  ``CLIP_GRAD_NORM_AT``; everything inside ``MultiSteps`` under
  ``GRADIENT_ACCUMULATION_STEPS``.  Those indices move with the config,
  so the leaves are found by name: every ``.../trace/<parameter path>``
  becomes that port parameter's ``momentum_buffer`` in its layout
  (``bridge._port_key`` / ``_to_port``), every ``count`` (the
  schedules', ``_freeze_after``'s) and ``MultiSteps``' ``gradient_step``
  must agree and becomes ``Optimizer.updates``, ``MultiSteps``'
  ``mini_step`` and ``acc_grads`` become the accumulation's micro-step and
  running mean, and ``state/extra`` becomes the exemplar table
  (``Trainer.exemplars``).

JAX's ``rng`` key does not carry: the port draws from a
``torch.Generator`` seeded by ``--seed``, another generator.  The grain
loader's stream state (``loader_state.json`` beside the checkpoint, and
``loader_state_{rank}.json`` for the other processes) is grain's dict
``{"next_index": k}``, which the port's grain loader reads as it is:
``import_loader_states`` copies it beside the port checkpoint, where
``train_net`` under ``DATALOADER.USE_GRAIN`` resumes the stream from it.
"""

import json
import os
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import bridge
from .checkpoint import _flatten_params, _unflatten, extract_params_tree

RESERVED = "__dump__/"
EXEMPLAR_KEYS = ("embs", "quality", "valid")


def read_dump(path: str) -> Dict[str, np.ndarray]:
    """The arrays of a dump of ``tools/orbax_to_npz.py``, by key."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"JAX dump {path}: no such file")
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _root(flat: Dict[str, np.ndarray]) -> str:
    """The key prefix of the train state's fields: ``state/`` for the
    JAX package's ``{"state": TrainState, "iteration"}``."""
    return "state/" if any(k.startswith("state/") for k in flat) else ""


def params_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The flax-layout parameter tree of a dump (a train state or an
    eval dump)."""
    tree = _unflatten({tuple(k.split("/")): v for k, v in flat.items() if not k.startswith(RESERVED)})
    return extract_params_tree(tree)


def _after(parts, name: str) -> Optional[str]:
    """The "/"-joined path after the first ``name`` in ``parts``."""
    return "/".join(parts[parts.index(name) + 1:]) if name in parts else None


def optimizer_leaves(flat: Dict[str, np.ndarray]):
    """The optimizer state's leaves by name: (traces, counts, mini_step,
    acc_grads).  ``traces`` and ``acc_grads`` map a parameter's flax path
    to (dump key, array), ``counts`` a dump key to its value.  A leaf of
    another optimizer (Adam's moments, ...) raises."""
    prefix = _root(flat) + "opt_state/"
    traces, counts, acc, micro, unknown = {}, {}, {}, None, []
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        acc_path, trace_path = _after(parts, "acc_grads"), _after(parts, "trace")
        if acc_path is not None:
            acc[acc_path] = (key, value)
        elif trace_path is not None:
            if trace_path in traces:
                raise ValueError(f"two momentum traces of {trace_path}: {traces[trace_path][0]} and {key}")
            traces[trace_path] = (key, value)
        elif parts[-1] in ("count", "gradient_step"):
            counts[key] = int(value)
        elif parts[-1] == "mini_step":
            micro = int(value)
        else:
            unknown.append(key)
    if unknown:
        raise ValueError(
            f"optimizer state leaves that are no part of make_optimizer's chain: {unknown[:5]}"
            + (f" and {len(unknown) - 5} more" if len(unknown) > 5 else "")
        )
    return traces, counts, micro, acc


def _names(keys, n: int = 5) -> str:
    keys = sorted(keys)
    return ", ".join(keys[:n]) + (f" and {len(keys) - n} more" if len(keys) > n else "")


def _check_params(trainer, got: Dict[Tuple[str, ...], Any], expected: Dict[Tuple[str, ...], Any],
                  train_state: bool, source: str) -> list:
    """Raises when the dump's parameters do not fit the trainer's model;
    returns the model's leaves the dump leaves unfilled."""
    foreign = ["/".join(p) for p in got if p not in expected]
    if foreign:
        raise RuntimeError(
            f"{source} does not hold a {trainer.meta_arch} model of this config: {len(foreign)} leaves it lacks "
            f"({_names(foreign)}); its top-level modules are {sorted({p[0] for p in got})}, this model's "
            f"{sorted({p[0] for p in expected})}"
        )
    bad = [f"{'/'.join(p)} {tuple(np.shape(v))} (this model: {tuple(np.shape(expected[p]))})"
           for p, v in got.items() if tuple(np.shape(v)) != tuple(np.shape(expected[p]))]
    if bad:
        raise RuntimeError(f"{source}: leaves of another shape than this {trainer.meta_arch} model's: {_names(bad)}")
    unfilled = ["/".join(p) for p in expected if p not in got]
    if unfilled and train_state:
        raise RuntimeError(f"{source}: the train state leaves {len(unfilled)} parameters unfilled: {_names(unfilled)}")
    return unfilled


def _to_port(value: np.ndarray, kind: str, like: torch.Tensor) -> torch.Tensor:
    arr = np.array(bridge._to_port(np.asarray(value), kind), order="C")
    return torch.from_numpy(arr).to(like.device, like.dtype)


def optimizer_state(trainer, flat: Dict[str, np.ndarray], source: str = "the dump") -> Dict[str, Any]:
    """The trainer's ``Optimizer.state_dict()`` form of a train state's
    optimizer leaves: momentum and accumulated gradients by port
    parameter name, in the port's layouts; ``updates`` and ``micro``."""
    opt = trainer.optimizer
    modules = dict(trainer.model.named_modules())
    by_name = dict(zip(opt.names, opt.params))
    traces, counts, micro, acc = optimizer_leaves(flat)

    def port_param(path: str):
        try:
            name, kind = bridge._port_key(modules, tuple(path.split("/")))
        except KeyError:
            return None, None
        return (name, kind) if name in by_name else (None, None)

    momentum, orphans = {}, []
    for path, (key, value) in traces.items():
        name, kind = port_param(path)
        if name is None:
            orphans.append(key)
            continue
        momentum[name] = _to_port(value, kind, by_name[name])
    if orphans:
        raise RuntimeError(f"{source}: momentum traces with no trainable port parameter: {_names(orphans)}")
    untraced = [n for n in opt.names if n not in momentum]
    if untraced:
        raise RuntimeError(
            f"{source}: trainable port parameters without a momentum trace: {_names(untraced)} "
            f"(flax paths {_names('/'.join(bridge._flax_path(modules, n)[0]) for n in untraced)})"
        )
    if not counts:
        raise RuntimeError(f"{source}: an optimizer state without a schedule count")
    if len(set(counts.values())) != 1:
        raise RuntimeError(f"{source}: the optimizer's counts disagree: "
                           + ", ".join(f"{k} = {v}" for k, v in sorted(counts.items())))
    updates = next(iter(counts.values()))
    accumulated = {}
    if micro is None:
        if opt.accumulate > 1:
            raise RuntimeError(f"{source}: this trainer accumulates {opt.accumulate} micro-steps "
                               "(SOLVER.GRADIENT_ACCUMULATION_STEPS), the dump's optimizer does not")
        micro = 0
    elif opt.accumulate == 1:
        raise RuntimeError(f"{source}: the dump's optimizer accumulates gradients (MultiSteps), this trainer "
                           "does not (SOLVER.GRADIENT_ACCUMULATION_STEPS 1)")
    elif micro > 0:
        # MultiSteps' running mean; the frozen parameters' entries feed
        # only a zeroed update and are not carried
        for name in opt.names:
            path, kind = bridge._flax_path(modules, name)
            entry = acc.get("/".join(path))
            if entry is None:
                raise RuntimeError(f"{source}: no accumulated gradient of {'/'.join(path)} at mini_step {micro}")
            accumulated[name] = _to_port(entry[1], kind, by_name[name])
    return {"momentum": momentum, "updates": updates, "micro": micro, "acc": accumulated}


def exemplar_table(trainer, flat: Dict[str, np.ndarray], source: str = "the dump"):
    """The exemplar table of a train state's ``extra``, on the trainer's
    device, or None when neither holds one."""
    prefix = _root(flat) + "extra/"
    keys = {k[len(prefix):] for k in flat if k.startswith(prefix)}
    if trainer.exemplars is None:
        if keys:
            raise RuntimeError(f"{source} holds an exemplar table ({prefix}{sorted(keys)}); this trainer has none "
                               "(MODEL.EXEMPLARS_ENABLED)")
        return None
    if keys != set(EXEMPLAR_KEYS):
        raise RuntimeError(f"{source}: the exemplar table needs {prefix}{{{','.join(EXEMPLAR_KEYS)}}}, "
                           f"the dump holds {sorted(keys)} (MODEL.EXEMPLARS_ENABLED)")
    table = {}
    for k, mine in trainer.exemplars.items():
        value = flat[prefix + k]
        if tuple(value.shape) != tuple(mine.shape):
            raise RuntimeError(f"{source}: {prefix}{k} is {tuple(value.shape)}, this trainer's table "
                               f"{tuple(mine.shape)}")
        table[k] = torch.from_numpy(np.array(value)).to(mine.device, mine.dtype)
    return table


def load_into_trainer(trainer, flat: Dict[str, np.ndarray], log: Callable[[str], None] = print,
                      source: Optional[str] = None) -> int:
    """Loads a dump into ``trainer``; returns its iteration.

    A train state (with ``opt_state``) restores the parameters, the
    optimizer (momentum, ``updates``, the accumulation) and the exemplar
    table; it must fill every parameter, trace every trainable one and
    trace nothing else.  A bare parameter tree loads as weights only: the
    optimizer and the table stay fresh, the iteration is 0, and a leaf it
    lacks (JAX's eval init makes only what the eval forward reads) keeps
    the trainer's current value, listed in the log.  Raises, naming the
    leaves, on a leaf of another model or shape, an unfilled parameter of
    a train state and an unmatched trace."""
    source = source or str(flat.get(RESERVED + "source", "the dump"))
    train_state = any(k.startswith(_root(flat) + "opt_state/") for k in flat)
    expected = _flatten_params(bridge.flax_from_state_dict(trainer.model))
    got = _flatten_params(params_tree(flat))
    unfilled = _check_params(trainer, got, expected, train_state, source)
    state = optimizer_state(trainer, flat, source) if train_state else None
    table = exemplar_table(trainer, flat, source) if train_state else None
    trainer.load_flax_params(_unflatten({**expected, **got}))
    if not train_state:
        log(f"{source}: weights only ({len(got)} leaves; no optimizer state): the optimizer starts fresh at "
            f"iteration 0" + (f"; {len(unfilled)} leaves it lacks keep their values (import_jax_checkpoint's "
                              f"--seed draw): {_names(unfilled, 10)}" if unfilled else ""))
        return 0
    trainer.optimizer.load_state_dict(state)
    if table is not None:
        trainer.exemplars = table
    iteration = int(flat.get(RESERVED + "iteration", 0))
    log(f"{source}: {len(got)} parameters, {len(state['momentum'])} momentum buffers, updates {state['updates']}, "
        f"micro-step {state['micro']}" + (", the exemplar table" if table is not None else "")
        + f", iteration {iteration}")
    rng = flat.get(_root(flat) + "rng")
    log("not carried: JAX's rng key " + ("" if rng is None else f"{np.asarray(rng).tolist()} ")
        + "(the port draws from a torch.Generator seeded by --seed)")
    return iteration


LOADER_STATE = re.compile(r"loader_state(_\d+)?\.json")


def import_loader_states(src: str, out: str, log: Callable[[str], None] = print) -> List[str]:
    """Copies a JAX run's grain stream states into ``out``: ``src`` is a
    ``loader_state*.json`` file (written under its own name, or as rank
    0's ``loader_state.json`` if it has another) or the run's
    ``OUTPUT_DIR``, whose every ``loader_state*.json`` is copied.  Each
    must be grain's ``{"next_index": k}``.  Returns the paths written."""
    if os.path.isdir(src):
        names = sorted(n for n in os.listdir(src) if LOADER_STATE.fullmatch(n))
        if not names:
            raise FileNotFoundError(f"{src}: no loader_state*.json (was the JAX run's DATALOADER.USE_GRAIN on?)")
        pairs = [(os.path.join(src, n), n) for n in names]
    else:
        name = os.path.basename(src)
        pairs = [(src, name if LOADER_STATE.fullmatch(name) else "loader_state.json")]
    os.makedirs(out, exist_ok=True)
    written = []
    for path, name in pairs:
        with open(path) as f:
            state = json.load(f)
        if not isinstance(state, dict) or not isinstance(state.get("next_index"), int):
            raise ValueError(f"{path}: not a grain stream state ({{'next_index': k}}): {state!r}")
        dst = os.path.join(out, name)
        with open(dst, "w") as f:
            json.dump(state, f)
        log(f"grain stream state {state} from {path} -> {dst}")
        written.append(dst)
    return written
