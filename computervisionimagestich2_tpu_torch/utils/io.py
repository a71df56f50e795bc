"""Image load/save (the port's counterpart of
``computervisionimagestich2_tpu.utils.io``), on the numpy BMP codec of
``bmp.py``. The JAX package also tries its optional native C++ codec
first; both codecs read and write the same pixels.
"""
from __future__ import annotations

import os

import numpy as np

from . import bmp


def load_image(path: str) -> np.ndarray:
    """Load an image file as RGB uint8 [H, W, 3]."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".bmp":
        return bmp.read_bmp(path)
    raise ValueError(f"unsupported image format: {ext}")


def save_image(path: str, img: np.ndarray) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".bmp":
        bmp.write_bmp(path, img)
        return
    raise ValueError(f"unsupported image format: {ext}")
