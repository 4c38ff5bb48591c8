"""Two torch threads for the heaviest port test files.

Tier-1 runs six xdist workers on eight cores, and each worker's torch
takes a thread a core: a file's convolutions then wait on one another's
threads, and a file runs many times slower than it does alone.
:func:`two_torch_threads`, imported into a test module, caps torch's
intra-op threads at 2 while the module's tests run and restores the old
count after them, as ``tests/test_torch_ddp.py``'s ranks set 2 threads.
"""

import pytest
import torch

THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(old)
