"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into a shared library
with a plain C interface and loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds).  One library may serve several
:class:`Kernel` counters: the RoIAlign forward and backward share
``csrc/roi_align.cu`` and count their launches apart.  Libraries live
in ``build/kernels/`` at the root of the checkout, named by the hash of
their source: a changed source is rebuilt on its next use, an unchanged
one is loaded as it is.
A failed build raises; nothing falls back to the plain versions.

Every C entry point takes its pointers and the CUDA stream as
``void*``, launches on that stream without synchronising, and returns
``cudaGetLastError()``; :meth:`Kernel.call` raises if that is not 0.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class Kernel:
    """C entry points of one CUDA source file, and the count of launches
    made through them.

    ``entry_points`` maps each C function to its ``ctypes`` argument
    types; ``source`` names the file under ``csrc/`` (default: ``name``).
    ``on_launch``, when set, is called after every launch with the
    wrapper's inputs and outputs (a harness uses it to hold each launch
    against the plain version); it is None in normal use.
    """

    def __init__(self, name: str, entry_points: Dict[str, Sequence], source: Optional[str] = None):
        self.name = name
        self.source = CSRC / f"{source or name}.cu"
        self.entry_points = dict(entry_points)
        self.launches = 0
        self.on_launch: Optional[Callable] = None
        self._lib = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        digest = hashlib.sha256(
            self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source.stem}-{digest}.so"

    def start_build(self):
        """Starts ``nvcc`` for this source unless its library exists;
        returns ``(process, temporary output)``, or None when there is
        nothing to build."""
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        return proc, tmp

    def finish_build(self, build) -> None:
        if build is None:
            return
        proc, tmp = build
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed on {self.source} (exit {proc.returncode}):\n{log}"
            )
        # atomic publish: a concurrent builder of the same source wins
        # or loses the race with an identical file
        self.log_path().write_text(log)
        os.replace(tmp, self.library_path())

    def log_path(self) -> Path:
        return self.library_path().with_suffix(".log")

    def resource_usage(self) -> List[str]:
        """What ``ptxas -v`` said of each kernel of the library: the
        entry, its registers, shared memory and spills (empty when the
        library was built without its log)."""
        path = self.log_path()
        if not path.exists():
            return []
        keys = ("Compiling entry", "registers", "spill")
        return [
            " ".join(line.split()) for line in path.read_text().splitlines()
            if any(k in line for k in keys)
        ]

    def lib(self):
        with self._lock:
            if self._lib is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(str(self.library_path()))
                for fn, argtypes in self.entry_points.items():
                    f = getattr(lib, fn)
                    f.argtypes = list(argtypes)
                    f.restype = ctypes.c_int
                self._lib = lib
            return self._lib

    def call(self, fn: str, *args) -> None:
        """Calls one C entry point on the current stream and raises on a
        launch error."""
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(self.lib(), fn)(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.name}:{fn} launch failed with CUDA error {err}"
            )


VP = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
F32 = ctypes.c_float

NMS = Kernel(
    "nms",
    {
        # boxes, valid, labels, label_bytes, order, scratch, scratch_words,
        # stop_hint, out_idx, out_valid, B, N, max_outputs, iou_threshold,
        # stream
        "nms_forward": (
            VP, VP, VP, I32, VP, VP, I64, VP, VP, VP, I32, I32, I32, F32, VP,
        ),
    },
)
ROI_ALIGN = Kernel(
    "roi_align",
    {
        # features, rois, out, B, H, W, C, S, P, Q, spatial_scale,
        # sampling_ratio, max_samples, bin_stride, bf16, stream
        "roi_align_forward": (
            VP, VP, VP, I32, I32, I32, I32, I32, I32, I32, F32,
            I32, I32, I32, I32, VP,
        ),
    },
)
ROI_ALIGN_BACKWARD = Kernel(
    "roi_align_backward",
    {
        # grad, rois, workspace, workspace_bytes, out, B, H, W, C, S, P, Q,
        # spatial_scale, sampling_ratio, max_samples, bin_stride, tile_h,
        # tile_w, slab, slabs_per_cta, bf16, stream
        "roi_align_backward": (
            VP, VP, VP, I64, VP, I32, I32, I32, I32, I32, I32, I32, F32,
            I32, I32, I32, I32, I32, I32, I32, I32, VP,
        ),
    },
    source="roi_align",
)
ALL = (NMS, ROI_ALIGN, ROI_ALIGN_BACKWARD)


def build_all() -> None:
    """Builds every library that is missing, one ``nvcc`` per source, all
    started together, then loads them."""
    by_source = {k.source: k for k in ALL}
    procs = [(k, k.start_build()) for k in by_source.values()]
    errors = []
    for k, p in procs:
        try:
            k.finish_build(p)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in ALL:
        k.lib()


def reset_launches() -> None:
    for k in ALL:
        k.launches = 0
