"""Build-and-load scaffolding for the native host libraries.

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/utils/
native_loader.py``: g++ builds the repo's ``native/*.cpp`` sources on
first use, rebuilds when a source is newer than its library, and loads
the library with ctypes.  The port builds into ``build/native/`` (which
``.gitignore`` covers) and never into ``native/``, where the JAX
package keeps its own libraries.  A library is written under a
temporary name and renamed into place, so two processes that build at
once never load a half-written file; within a process the first
``get()`` holds a lock, so the loader's threads wait for the build
rather than fall back while it runs.
"""

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Callable, Optional, Sequence

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE_DIR = os.path.join(_REPO, "native")
BUILD_DIR = os.path.join(_REPO, "build", "native")


class NativeLib:
    """Lazily builds (g++) and loads one shared library; ``get()``
    returns the CDLL with argtypes registered, or None when the source,
    toolchain, or a link dependency is unavailable (callers fall back
    to their numpy/PIL paths)."""

    def __init__(
        self,
        src_name: str,
        lib_name: str,
        extra_flags: Sequence[str] = (),
        register: Optional[Callable[[ctypes.CDLL], None]] = None,
    ):
        self.src = os.path.join(SOURCE_DIR, src_name)
        self.lib_path = os.path.join(BUILD_DIR, lib_name)
        self.extra_flags = list(extra_flags)
        self.register = register
        self._lib: Optional[ctypes.CDLL] = None
        self._tried = False
        self._lock = threading.Lock()

    def _build(self) -> bool:
        out_dir = os.path.dirname(self.lib_path)
        os.makedirs(out_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".so.tmp")
        os.close(fd)
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, self.src, *self.extra_flags],
                check=True,
                capture_output=True,
                timeout=120,
            )
            os.replace(tmp, self.lib_path)
            return True
        except (OSError, subprocess.SubprocessError):
            return False
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def get(self) -> Optional[ctypes.CDLL]:
        with self._lock:
            if not self._tried:
                self._lib = self._load()
                self._tried = True
        return self._lib

    def _load(self) -> Optional[ctypes.CDLL]:
        stale = not os.path.exists(self.lib_path) or (
            os.path.exists(self.src)
            and os.path.getmtime(self.src) > os.path.getmtime(self.lib_path)
        )
        if stale and (not os.path.exists(self.src) or not self._build()):
            return None
        try:
            lib = ctypes.CDLL(self.lib_path)
        except OSError:
            return None
        if self.register is not None:
            self.register(lib)
        return lib
