"""Profiling: ``torch.profiler`` traces, FLOP counts and MFU.

The port's counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/
utils/profiler.py`` (the reference has only a wall-clock timer and
max-memory logs, utils/timer.py:8-44, engine/trainer.py:150-171):

* ``trace(logdir)``: a context manager around ``torch.profiler.profile``
  (the CPU, and CUDA when a card is there) that writes a Chrome trace,
  ``logdir/trace.json``;
* ``profile_steps(step_fn, batch, n_steps)``: one warm-up step, then
  ``n_steps`` under ``trace``;
* ``step_flops(fn, *args)``: the FLOPs of one call, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` (the counterpart of
  ``compiled_step_flops``, XLA's cost analysis);
* ``device_peak_flops()`` and ``mfu_metrics``: the achieved rate over
  the card's published peak;
* ``device_memory_stats()``: each card's allocator figures.
"""

import contextlib
import os
import tempfile
from typing import Callable, Dict, Optional

import torch

# NVIDIA's published dense peaks (no sparsity) of the H100 SXM at its
# 700 W limit, by torch.cuda.get_device_name: NVIDIA H100 Tensor Core GPU
# data sheet, "H100 SXM" column.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {
        "bfloat16": 989e12,
        "float16": 989e12,
        "tf32": 495e12,
        "float32": 67e12,
        "float8": 1979e12,
    },
}


def device_peak_flops(device=None, dtype: str = "bfloat16") -> float:
    """The published peak FLOP/s of ``device``'s card (default: the
    current card) for ``dtype``; raises for a card the table lacks."""
    name = torch.cuda.get_device_name(device)
    if name not in PEAK_FLOPS:
        raise KeyError(f"no published peak for {name!r}; the table holds {sorted(PEAK_FLOPS)}")
    return PEAK_FLOPS[name][dtype]


@contextlib.contextmanager
def trace(logdir: str):
    """Profiles the block (with CUDA activity when a card is there) and
    writes ``logdir/trace.json``; yields the profiler."""
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def profile_steps(step_fn: Callable, batch, n_steps: int = 3, logdir: Optional[str] = None):
    """Runs ``step_fn(batch)`` once outside the trace, then ``n_steps``
    times under ``trace(logdir)``; returns (the last metrics, logdir,
    the profiler)."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "cmpl_torch_trace")
    metrics = step_fn(batch)
    _sync()
    with trace(logdir) as prof:
        for _ in range(n_steps):
            metrics = step_fn(batch)
        _sync()
    return metrics, logdir, prof


def step_flops(fn: Callable, *args, **kwargs) -> float:
    """The FLOPs of ``fn(*args, **kwargs)`` as ``FlopCounterMode`` counts
    them (matmuls and convolutions, forward and backward: two a
    multiply-add).  Runs ``fn`` once."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def mfu_metrics(flops_per_step: float, sec_per_step: float, device=None,
                dtype: str = "bfloat16") -> Dict[str, float]:
    """``{tflops_per_sec, mfu_pct}``: the achieved FLOP rate and its share
    of the card's published ``dtype`` peak."""
    achieved = flops_per_step / sec_per_step
    return {
        "tflops_per_sec": round(achieved / 1e12, 2),
        "mfu_pct": round(100.0 * achieved / device_peak_flops(device, dtype), 2),
    }


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """In-use, peak and reserved MiB of each local card, from
    ``torch.cuda.memory_stats``; empty without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use_mb": stats.get("allocated_bytes.all.current", 0) / 2**20,
            "peak_bytes_mb": stats.get("allocated_bytes.all.peak", 0) / 2**20,
            "reserved_mb": stats.get("reserved_bytes.all.current", 0) / 2**20,
            "bytes_limit_mb": torch.cuda.get_device_properties(i).total_memory / 2**20,
        }
    return out
