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
``warp_image_projective``, each over both of its entries (parameters by
value, or in device memory).

``separable_blur`` is B8's wrapper, here because it serves one private
caller (``ops/gaussian.py::_conv1d_axis``, which takes it for every CUDA
tensor; the plain shift-and-add beside it for CPU tensors).
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("detect.cu", "sift_walks.cu", "l1_2nn.cu", "pair_counts.cu",
           "warp.cu", "blur.cu")
HEADERS = ("api.h", "l1.cuh", "l1_tile.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC")

LAUNCHES = {"detect_compact": 0, "sift_orientation_hist": 0,
            "sift_descriptors": 0, "l1_two_nearest_bidir": 0,
            "pair_match_counts": 0, "warp_image": 0,
            "warp_image_projective": 0, "l1_two_nearest": 0,
            "separable_blur": 0}
# B8's largest radius, (taps - 1) / 2 (the scale space takes 5 to 19, the
# blend 8)
MAX_BLUR_RADIUS = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
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
    # (src, src_h, src_w, channels, params (11 floats on the card), model,
    #  h_out, w_out, out, stream)
    "cvs_warp_image_dev": (_P, _I, _I, _I, _P, _I, _I, _I, _P, _P),
    # (x, outer, length, inner, stride_outer, stride_length, taps, n_taps,
    #  bf16, out, stream)
    "cvs_separable_blur": (_P, _L, _I, _I, _L, _L, _P, _I, _I, _P, _P),
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


def separable_blur(x: torch.Tensor, taps: torch.Tensor,
                   axis: int) -> torch.Tensor:
    """Kernel B8: one pass of the separable Gaussian along ``axis`` of a
    CUDA tensor, out = sum_j taps[j] * xpad[j : j + L] with edge
    replication, in tap order and with each product and sum rounded to
    x's dtype: the bits of ``ops/gaussian.py::_shift_and_add``. ``x``:
    float32 or bfloat16, its dimensions before ``axis`` mergeable into one
    and those after it contiguous (a decimated view is fine); ``taps``: an
    odd number of them, the radius at most ``MAX_BLUR_RADIUS``, in x's
    dtype on x's device (the device constant ``_conv1d_axis`` keeps).
    Returns a new contiguous tensor of x's shape."""
    k = taps.shape[0] if taps.dim() == 1 else 0
    if k % 2 == 0 or (k - 1) // 2 > MAX_BLUR_RADIUS:
        raise ValueError(f"separable_blur: expected an odd number of taps "
                         f"with radius <= {MAX_BLUR_RADIUS}, got "
                         f"{tuple(taps.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"separable_blur: expected a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"separable_blur: expected float32 or bfloat16, got "
                        f"{x.dtype}")
    check_cuda("separable_blur.taps", taps, x.dtype, (k,), align=2)
    if taps.device != x.device:
        raise ValueError(f"separable_blur: taps on {taps.device}, x on "
                         f"{x.device}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if out.numel() >= 2 ** 31:
        raise ValueError(f"separable_blur: expected fewer than 2^31 values, "
                         f"got shape {tuple(x.shape)}")
    view = blur_view(x, axis)
    LAUNCHES["separable_blur"] += 1
    launch("cvs_separable_blur", x.device, view.data_ptr(), view.shape[0],
           view.shape[1], view.shape[2], view.stride(0), view.stride(1),
           taps.data_ptr(), k, int(x.dtype == torch.bfloat16), out.data_ptr())
    return out


def blur_view(x: torch.Tensor, axis: int) -> torch.Tensor:
    """``x`` viewed as [outer, length, inner] along ``axis``, as B8 reads
    it: element (o, l, i) at o * stride(0) + l * stride(1) + i. No copy:
    raises ValueError if the dimensions before ``axis`` do not merge into
    one or those after it are not contiguous."""
    axis %= x.dim()
    outer = math.prod(x.shape[:axis])
    inner = math.prod(x.shape[axis + 1:])
    try:
        view = x.view(outer, x.shape[axis], inner)
    except RuntimeError:
        view = None
    if view is None or (inner > 1 and view.stride(2) != 1):
        raise ValueError(f"separable_blur: shape {tuple(x.shape)} with "
                         f"strides {x.stride()} does not view as [outer, "
                         f"length, contiguous inner] along axis {axis}")
    return view
