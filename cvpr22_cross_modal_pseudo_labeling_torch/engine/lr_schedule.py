"""WarmupMultiStepLR.

Counterpart of ``cvpr22_cross_modal_pseudo_labeling_tpu/engine/
lr_schedule.py::warmup_multistep_schedule`` (:13): linear (or constant)
warmup from ``warmup_factor`` over ``warmup_iters`` updates, then a
``gamma`` decay at each milestone.  The arithmetic is float32, in the
JAX function's order, so both give the same learning rate.
"""

from typing import Callable, Sequence

import numpy as np

_F32 = np.float32


def warmup_multistep_schedule(
    base_lr: float,
    steps: Sequence[int],
    gamma: float = 0.1,
    warmup_factor: float = 1.0 / 3,
    warmup_iters: int = 500,
    warmup_method: str = "linear",
) -> Callable[[int], float]:
    """Returns ``schedule(count) -> lr`` for the ``count``-th update."""
    if warmup_method not in ("linear", "constant"):
        raise ValueError(warmup_method)
    milestones = sorted(steps)

    def schedule(count: int) -> float:
        if count >= warmup_iters:
            wf = _F32(1.0)
        elif warmup_method == "linear":
            alpha = min(_F32(count) / _F32(max(warmup_iters, 1)), _F32(1.0))
            wf = _F32(warmup_factor) * (_F32(1.0) - alpha) + alpha
        else:
            wf = _F32(warmup_factor)
        decay = _F32(gamma) ** _F32(sum(count >= m for m in milestones))
        return float(_F32(base_lr) * wf * decay)

    return schedule
