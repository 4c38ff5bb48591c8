"""Per-visit augmentation RNG.

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/data/
rng.py``.

The reference draws augmentation decisions from the global ``random``
module (reference maskrcnn_benchmark/data/transforms/transforms.py:37,
70, 81), so every visit of an image gets fresh randomness.  A fixed
per-index seed would freeze each image's flip coin and multi-scale
choice for the entire run, collapsing augmentation diversity.

``visit_rng`` hands each dataset ``__getitem__`` call an independent
``random.Random`` seeded from (index, pid, visit counter): fresh per
visit like the reference, but free of cross-thread state on the shared
global RNG (the prefetch pool calls ``__getitem__`` from many threads).
``next()`` on ``itertools.count`` is a single C-level call, atomic
under the GIL.
"""

import itertools
import os
import random

_visits = itertools.count()


def visit_rng(index: int) -> random.Random:
    """A fresh, thread-independent RNG for one dataset visit."""
    seed = hash((int(index), os.getpid(), next(_visits))) & 0xFFFFFFFF
    return random.Random(seed)
