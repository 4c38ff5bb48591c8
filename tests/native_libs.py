"""Both packages' native host libraries, loaded before a comparison.

The JAX package's loader (``cvpr22_cross_modal_pseudo_labeling_tpu/
utils/native_loader.py``) has g++ write ``native/lib*.so`` in place, with
no temporary name and no lock between processes.  When several test
processes start on a checkout without the libraries (``*.so`` is not
committed), one of them can find the file while another's g++ is still
writing it: its ``CDLL`` fails, the loader remembers that it tried, and
for the rest of that process the JAX side resizes with PIL (and computes
RLE IoUs with numpy) while the port, whose loader renames a finished
build into ``build/native/``, runs natively.  The two sides then differ
by one grey level in some pixels of every resized image.

:func:`ensure_native_libs` puts both sides on the same path: when the
port's library loads and the JAX package's did not, it waits for the
JAX file to stop changing (another process's g++ finishing), clears the
JAX loader's memory of its failed try and loads it again, for up to
``WAIT_S`` seconds, and fails the calling test with a message if it
never loads.  The JAX package is not changed.
"""

import os
import time

import pytest

WAIT_S = 120.0
POLL_S = 0.5


def _pairs():
    from cvpr22_cross_modal_pseudo_labeling_torch.utils import native as torch_native
    from cvpr22_cross_modal_pseudo_labeling_torch.utils import native_image as torch_image
    from cvpr22_cross_modal_pseudo_labeling_tpu.utils import native as jax_native
    from cvpr22_cross_modal_pseudo_labeling_tpu.utils import native_image as jax_image

    return ((jax_image._loader, torch_image._loader), (jax_native._loader, torch_native._loader))


def _signature(path):
    try:
        st = os.stat(path)
    except OSError:
        return None
    return st.st_size, st.st_mtime_ns


def load_jax_library(loader, wait_s: float = WAIT_S):
    """``loader.get()`` of a JAX ``NativeLib`` whose first try failed,
    once the library file has stopped changing (or, if it is missing,
    after the loader builds it itself); None after ``wait_s``."""
    deadline = time.monotonic() + wait_s
    last = _signature(loader.lib_path)
    while time.monotonic() < deadline:
        time.sleep(POLL_S)
        now = _signature(loader.lib_path)
        if now is None or now == last:
            loader._tried, loader._lib = False, None
            lib = loader.get()
            if lib is not None:
                return lib
        last = now
    return None


def ensure_native_libs(wait_s: float = WAIT_S) -> None:
    """Both packages on the same path for the image ops and the mask
    ops: both native, or both on their fallbacks (no toolchain)."""
    for jax_loader, port_loader in _pairs():
        port = port_loader.get()
        jax_lib = jax_loader.get()
        name = os.path.basename(jax_loader.lib_path)
        if port is None:
            if jax_lib is not None:
                pytest.fail(f"{name}: the JAX package loads its native library and the port cannot build its own")
            continue
        if jax_lib is None and os.path.exists(jax_loader.src):
            if load_jax_library(jax_loader, wait_s) is None:
                pytest.fail(
                    f"{name}: the JAX package's native library did not load within {wait_s:.0f} s "
                    f"({jax_loader.lib_path}); the port's did, so the two would be compared on different paths"
                )
