"""The benchmark's CPU tests: the harness, its generator, its counts and
its reference at narrow widths.  Tests marked ``cuda`` need the card and
skip without one."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (BENCH, BENCH / "tests", BENCH.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
# TensorBoard would import TensorFlow on the loop's first write
sys.modules.setdefault("tensorflow", None)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
