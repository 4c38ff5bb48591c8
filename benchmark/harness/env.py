"""Where a run keeps its caches, and what it may not load.

Every build and kernel cache the program or PyTorch writes goes to a
fixed directory inside the checkout (``build/``, which git ignores), so
that only a checkout's first run of a cell builds and compiles: the
port's nvcc libraries in ``build/kernels/`` (the port fixes that path
itself), Triton, PyTorch extensions, Inductor and the CUDA driver's JIT
cache under ``build/benchmark_cache/``.  Call :func:`set_caches` before
torch is imported.
"""

import os
import sys
from pathlib import Path
from typing import List

ROOT = Path(__file__).resolve().parents[2]
CACHE = ROOT / "build" / "benchmark_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "cvpr22_cross_modal_pseudo_labeling_tpu")


def set_caches() -> None:
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    # libraries that would load JAX or TensorFlow by themselves
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"
    # TensorBoard's first event write imports TensorFlow when it is
    # installed, which takes most of a minute: the loop's JSONL suffices
    sys.modules.setdefault("tensorflow", None)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name is a forbidden one,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN and sys.modules.get(name) is not None})
