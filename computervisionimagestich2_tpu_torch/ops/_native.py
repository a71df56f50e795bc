"""Build, load and call the hand-written CUDA kernels (``csrc/*.cu``).

The kernels expose a plain C interface (``csrc/api.h``): each function
launches on the stream it is given and returns the launch's
``cudaError_t``. They are compiled with ``nvcc`` for ``sm_90a`` at first
use — never at import — one ``nvcc`` per source, all started together, and
linked into one shared library under ``build/torch_kernels/`` at the root
of the checkout, keyed by a hash of the sources and flags, and loaded with
``ctypes``.

``--fmad=false`` keeps every float multiply and add separately rounded, as
PyTorch's elementwise ops and XLA compute them: the warp truncates
coefficients to integer pixel indices and the SIFT walks decide window
membership with ``floor`` and ``<``, so a contracted multiply-add would
move pixels.

``LAUNCHES`` counts kernel launches by name; each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that it went
through the kernels (``reset_launch_counts`` / ``launch_counts``). B6
counts its two branches apart: ``warp_image`` (bilinear) and
``warp_image_projective``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("detect.cu", "sift_walks.cu", "l1_2nn.cu", "pair_counts.cu",
           "warp.cu")
HEADERS = ("api.h", "l1.cuh", "l1_tile.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC")

LAUNCHES = {"detect_compact": 0, "sift_orientation_hist": 0,
            "sift_descriptors": 0, "l1_two_nearest_bidir": 0,
            "pair_match_counts": 0, "warp_image": 0,
            "warp_image_projective": 0, "l1_two_nearest": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class WarpParams(ctypes.Structure):
    """``CvsWarpParams`` of ``csrc/api.h``, passed to B6 by value."""

    _fields_ = [("c", _F * 9), ("ox", _F), ("oy", _F), ("model", _I)]


_SIGNATURES = {
    # (n_oct, dog pointers (host), dims (host), gate, coords, valid, n_total,
    #  status, status_len, stream)
    "cvs_detect_compact": (_I, _P, _P, _F, _P, _P, _P, _P, _I, _P),
    # (mod, ang, h, w, x, y, sigma, n_valid, n, radius, hist, stream)
    "cvs_orientation_hist": (_P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P),
    # (mod, ang, h, w, x, y, sigma, angle, n_valid, n, radius, magnif,
    #  window_size, desc, stream)
    "cvs_descriptors": (_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _F, _F,
                        _P, _P),
    # (qry, ref, qry_valid, ref_valid, nb, na, part_d, part_i, d1, d2, i1,
    #  stream)
    "cvs_l1_two_nearest": (_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P),
    # (qry, ref, qry_valid, ref_valid, nb, na, part_d, part_i, d1q, d2q,
    #  i1q, d1r, d2r, i1r, stream)
    "cvs_l1_two_nearest_bidir": (_P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                                 _P, _P, _P, _P),
    # (desc, valid, n_images, cap, pairs, n_pairs, ratio, chunk, live,
    #  tile_start, part, out, stream)
    "cvs_pair_match_counts": (_P, _P, _I, _I, _P, _I, _F, _I, _P, _P, _P, _P,
                              _P),
    # (src, src_h, src_w, channels, params by value, h_out, w_out, out,
    #  stream)
    "cvs_warp_image": (_P, _I, _I, _I, WarpParams, _I, _I, _P, _P),
}

_LIB = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def build_dir() -> Path:
    """``build/torch_kernels`` at the root of the checkout (listed in
    ``.gitignore``)."""
    return Path(__file__).resolve().parents[2] / "build" / "torch_kernels"


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the CUDA kernels")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update((CSRC / name).read_bytes())
    return build_dir() / h.hexdigest()[:16] / "libcvs_kernels.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.
    Returns its path. The build works in a temporary directory and renames
    the library into place, so a concurrent process never loads a partial
    file."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [os.path.join(tmp, src + ".o") for src in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", obj,
             str(CSRC / src)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for src, obj in zip(SOURCES, objs)]
        errors = []
        for src, proc in zip(SOURCES, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src} ({proc.returncode}):\n{err}")
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        os.replace(lib, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def launch(name: str, device: torch.device, *args) -> None:
    """Call kernel launcher ``name`` on ``device``, the card that holds the
    tensors it is given, and on that card's current stream (appended as
    the last argument); raise if the launch reported an error. The
    launchers address the current CUDA device, so the call runs under
    ``torch.cuda.device(device)``: a tensor on a second card would
    otherwise be handed to the first card's stream."""
    fn = getattr(library(), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               shape: tuple | None = None, align: int = 4) -> None:
    """Validate a tensor handed to a kernel: CUDA, dtype, shape (None
    entries match anything), contiguity and pointer alignment."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and (t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape))):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: pointer not {align}-byte aligned")
