"""Windowed metric meters and timers.

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/utils/
metric_logger.py`` (reference utils/metric_logger.py:8-66, utils/
timer.py:8-44): numbers in, medians, window and global averages out.
"""

import time
from collections import defaultdict, deque
from typing import Dict


class SmoothedValue:
    def __init__(self, window_size: int = 20):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        self.deque.append(value)
        self.total += value
        self.count += 1

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {m.median:.4f} ({m.global_avg:.4f})"
            for name, m in self.meters.items()
        )


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self.total_time = 0.0
        self.calls = 0
        self.diff = 0.0  # last tic->toc interval
        self._start = None

    def tic(self):
        self._start = time.perf_counter()

    def toc(self):
        if self._start is not None:
            self.diff = time.perf_counter() - self._start
            self.total_time += self.diff
            self.calls += 1
            self._start = None

    @property
    def average_time(self) -> float:
        return self.total_time / max(self.calls, 1)
