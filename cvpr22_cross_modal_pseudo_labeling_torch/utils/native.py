"""ctypes loader for the native mask ops (native/maskops.cpp).

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/utils/
native.py``, binding only the run-merge IoU matrix the evaluator calls.
Compiles the shared library on first use (g++, into ``build/native/``);
every entry point has a numpy fallback in utils/rle.py, so the port
works without a toolchain: the native path accelerates eval-time RLE
IoU (run-merge, no mask materialization).
"""

import ctypes
from typing import Optional, Sequence

import numpy as np

from .native_loader import NativeLib


def _register(lib: ctypes.CDLL) -> None:
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.rle_iou_matrix.restype = None
    lib.rle_iou_matrix.argtypes = [
        i64p, i64p, i64p, ctypes.c_int64, i64p, i64p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
    ]


_loader = NativeLib("maskops.cpp", "libmaskops.so", register=_register)


def get_lib() -> Optional[ctypes.CDLL]:
    return _loader.get()


def _as_i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int64)


def native_rle_iou_matrix(
    dts: Sequence[dict], gts: Sequence[dict], iscrowd: Sequence[bool]
) -> Optional[np.ndarray]:
    """Run-merge IoU matrix via the native lib; None if unavailable."""
    lib = get_lib()
    if lib is None or not dts or not gts:
        return None
    from .rle import decompress_counts

    def runs_of(r):
        c = r["counts"]
        if isinstance(c, (str, bytes)):
            c = decompress_counts(c)
        return _as_i64(c)

    d_runs = [runs_of(d) for d in dts]
    g_runs = [runs_of(g) for g in gts]
    all_runs = np.concatenate(d_runs + g_runs) if d_runs + g_runs else _as_i64([])
    offs = np.cumsum([0] + [len(r) for r in (d_runs + g_runs)])[:-1]
    d_off = _as_i64(offs[: len(d_runs)])
    g_off = _as_i64(offs[len(d_runs) :])
    d_len = _as_i64([len(r) for r in d_runs])
    g_len = _as_i64([len(r) for r in g_runs])
    crowd = np.ascontiguousarray(
        [1 if c else 0 for c in iscrowd], np.int32
    )
    out = np.zeros((len(dts), len(gts)), np.float64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.rle_iou_matrix(
        all_runs.ctypes.data_as(i64p),
        d_off.ctypes.data_as(i64p),
        d_len.ctypes.data_as(i64p),
        len(dts),
        g_off.ctypes.data_as(i64p),
        g_len.ctypes.data_as(i64p),
        len(gts),
        crowd.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out

