"""Image decode and resize for the host data pipeline.

The port's copy of ``cvpr22_cross_modal_pseudo_labeling_tpu/utils/
native_image.py``: the native JPEG decode and triangle-filter resize
(``native/imageops.cpp``, built into ``build/native/``), with PIL as the
fallback when the library or libjpeg is unavailable.
"""

import ctypes
from typing import Optional, Tuple

import numpy as np

from .native_loader import NativeLib


def _register(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.jpeg_dims.restype = ctypes.c_int
    lib.jpeg_dims.argtypes = [u8p, ctypes.c_int64, ip, ip]
    lib.decode_jpeg.restype = ctypes.c_int
    lib.decode_jpeg.argtypes = [u8p, ctypes.c_int64, u8p, ip, ip]
    lib.resize_bilinear_u8.restype = None
    lib.resize_bilinear_u8.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int,
        ctypes.c_int,
    ]


_loader = NativeLib(
    "imageops.cpp", "libimageops.so", extra_flags=("-ljpeg",),
    register=_register,
)


def get_lib() -> Optional[ctypes.CDLL]:
    return _loader.get()


def decode_jpeg_native(data: bytes) -> Optional[np.ndarray]:
    """Decodes JPEG bytes to an RGB uint8 [H, W, 3] array, or None."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    if lib.jpeg_dims(
        buf.ctypes.data_as(u8p), len(data), ctypes.byref(w),
        ctypes.byref(h),
    ) != 0:
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    ww, hh = ctypes.c_int(w.value), ctypes.c_int(h.value)
    rc = lib.decode_jpeg(
        buf.ctypes.data_as(u8p), len(data),
        out.ctypes.data_as(u8p), ctypes.byref(ww), ctypes.byref(hh),
    )
    if rc != 0:
        return None
    return out


def resize_bilinear_native(
    image: np.ndarray, out_hw: Tuple[int, int]
) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(image, np.uint8)
    dh, dw = out_hw
    dst = np.empty((dh, dw, 3), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.resize_bilinear_u8(
        src.ctypes.data_as(u8p), src.shape[0], src.shape[1],
        dst.ctypes.data_as(u8p), dh, dw,
    )
    return dst


def load_image_rgb(path: str) -> np.ndarray:
    """Loads an image as uint8 RGB; native JPEG path with PIL fallback
    (non-JPEG formats always go through PIL).

    uint8 end-to-end: the transform chain (Resize/flip/jitter) operates
    on uint8 and Normalize does the single float conversion — decode ->
    float round-trips cost two full-image passes per step otherwise."""
    if path.lower().endswith((".jpg", ".jpeg")):
        try:
            with open(path, "rb") as f:
                data = f.read()
            arr = decode_jpeg_native(data)
            if arr is not None:
                return arr
        except OSError:
            pass
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8)
