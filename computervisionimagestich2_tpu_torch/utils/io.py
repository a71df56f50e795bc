"""Image load/save (the port's counterpart of
``computervisionimagestich2_tpu.utils.io``): the native C++ codec
(``native/codec.py``) when it builds, as in the JAX package, else the numpy
BMP codec of ``bmp.py``. Both read and write the same pixels. The choice is
made once per process, on the first image, and logged then
(``obs.log_codec``).
"""
from __future__ import annotations

import os
import threading

import numpy as np

from . import bmp, obs

_lock = threading.Lock()
_CODEC = None


def codec():
    """The codec module this process takes (``native.codec`` or ``bmp``;
    chosen, and logged, on the first call)."""
    global _CODEC
    with _lock:
        if _CODEC is None:
            from ..native import codec as native

            if native.available():
                _CODEC = native
                obs.log_codec("native", library=native.library_path())
            else:
                _CODEC = bmp
                obs.log_codec("numpy",
                              native_unavailable=native.unavailable_reason())
        return _CODEC


def load_image(path: str) -> np.ndarray:
    """Load an image file as RGB uint8 [H, W, 3]."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".bmp":
        return codec().read_bmp(path)
    raise ValueError(f"unsupported image format: {ext}")


def save_image(path: str, img: np.ndarray) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".bmp":
        codec().write_bmp(path, np.ascontiguousarray(img))
        return
    raise ValueError(f"unsupported image format: {ext}")
