"""What the per-layer metric files under ``benchmark/metrics/`` read from
a traced run.  Each function returns None when the run holds nothing to
read (no launch of the kernel, no traced step), and the harness then
leaves the metric out of the line.
"""

from typing import Dict, Optional

from work import flops, kernels

BF16_PEAK_FLOPS = 989e12  # one H100 SXM, dense bf16 (NVIDIA's data sheet)


def idle_share(run: Dict) -> Optional[float]:
    """Percent of the traced window in which no kernel, copy or set ran on
    the card."""
    t = run.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(run: Dict, config: Dict, train: bool) -> Optional[float]:
    """The model FLOPs of the traced window's steps (``work/flops.py``,
    from the configuration's shapes) over the window and the bf16 peak,
    in percent."""
    t = run.get("trace")
    if not t or not run.get("traced_steps"):
        return None
    total = sum(sum(flops.step_flops(config, hw, train).values()) for hw in run["window_buckets"])
    return 100.0 * total / t["window_s"] / BF16_PEAK_FLOPS


def roofline(run: Dict, kernel: str) -> Optional[float]:
    """Percent of its bound that ``kernel``'s launches reached: the sum of
    each launch's bound time over the device time of the op's kernels
    in the traced window."""
    work = run.get("launch_work", {}).get(kernel) or []
    device_s = run.get("trace", {}).get("op_device_s", {}).get(kernel) or []
    if not work or not sum(device_s):
        return None
    return 100.0 * sum(kernels.bound_s(b, o) for b, o in work) / sum(device_s)


def host_syncs(run: Dict) -> Optional[float]:
    """Synchronizing CUDA calls a step (or a served batch) in the traced
    window."""
    if not run.get("traced_steps") or run.get("syncs") is None:
        return None
    return run["syncs"] / run["traced_steps"]
