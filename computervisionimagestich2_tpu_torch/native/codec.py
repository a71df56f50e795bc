"""ctypes binding for the native BMP codec (``codec.cpp``): the port's copy
of ``computervisionimagestich2_tpu.native.codec``, with its signatures and
errors (``ValueError`` on a file that is not a BMP and on a failed batch).

The library is built with g++ at first use, never at import, from the
port's own ``codec.cpp`` into ``build/torch_native/<source hash>/`` at the
root of the checkout (listed in ``.gitignore``), never beside the source.
Where there is no toolchain, ``available()`` is False and ``utils.io``
takes the numpy codec, which reads and writes the same pixels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "codec.cpp"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None
_tried = False
_error = ""


def library_path() -> Path:
    """Where the library of this source and these flags lives:
    ``build/torch_native/<hash>/`` at the root of the checkout."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return (Path(__file__).resolve().parents[2] / "build" / "torch_native"
            / h.hexdigest()[:16] / "libcodec.so")


def _build() -> Path:
    """Compile the library unless it exists; in a temporary directory,
    renamed into place, so a concurrent process never loads a partial
    file."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        lib = os.path.join(tmp, "libcodec.so")
        subprocess.run(["g++", *CXX_FLAGS, "-o", lib, str(SRC)], check=True,
                       capture_output=True, timeout=120)
        os.replace(lib, out)
    return out


def _load():
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.SubprocessError) as e:
            _error = f"{type(e).__name__}: {e}"
            return None
        lib.bmp_probe.restype = ctypes.c_int
        lib.bmp_probe.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int)]
        lib.bmp_decode.restype = ctypes.c_int
        lib.bmp_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.c_void_p]
        lib.bmp_encode_size.restype = ctypes.c_size_t
        lib.bmp_encode_size.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.bmp_encode.restype = ctypes.c_size_t
        lib.bmp_encode.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p]
        lib.bmp_load_batch.restype = ctypes.c_int
        lib.bmp_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads (built on the first call)."""
    return _load() is not None


def unavailable_reason() -> str:
    """Why ``available()`` is False ("" while it is True or untried)."""
    return _error


def _library():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_error}")
    return lib


def read_bmp(path: str) -> np.ndarray:
    lib = _library()
    with open(path, "rb") as f:
        data = f.read()
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.bmp_probe(data, len(data), ctypes.byref(w), ctypes.byref(h)) != 0:
        raise ValueError(f"not a BMP file: {path}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.bmp_decode(data, len(data), out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"BMP decode failed ({rc}): {path}")
    return out


def write_bmp(path: str, img: np.ndarray) -> None:
    lib = _library()
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an [H, W, 3] or [H, W] image, got "
                         f"{img.shape}")
    h, w = img.shape[:2]
    buf = np.empty(lib.bmp_encode_size(w, h), np.uint8)
    n = lib.bmp_encode(img.ctypes.data_as(ctypes.c_void_p), w, h,
                       buf.ctypes.data_as(ctypes.c_void_p))
    with open(path, "wb") as f:
        f.write(buf[:n].tobytes())


def load_batch(paths: list[str], n_threads: int = 0) -> np.ndarray:
    """Decode a uniform batch of BMPs concurrently -> [N, H, W, 3] uint8."""
    lib = _library()
    first = read_bmp(paths[0])
    h, w = first.shape[:2]
    out = np.empty((len(paths), h, w, 3), np.uint8)
    arr = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
    bad = lib.bmp_load_batch(arr, len(paths),
                             out.ctypes.data_as(ctypes.c_void_p), w, h,
                             n_threads)
    if bad:
        raise ValueError(f"{bad} file(s) failed to load in batch")
    return out
