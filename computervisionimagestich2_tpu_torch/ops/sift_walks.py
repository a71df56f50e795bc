"""Per-keypoint SIFT walks: the dispatching wrappers of kernels B2 and B3
(``csrc/sift_walks.cu``), the port of ``computervisionimagestich2_tpu.ops.
pallas_sift`` (``orientation_hist_pallas``, ``descriptors_pallas``).

A CPU tensor goes to the plain PyTorch version (``sift_kernels.
orientation_hist`` / ``sift_kernels.descriptors``); a CUDA tensor launches
the kernel or raises. Keypoint lists are valid-prefix compacted and the
live count ``n_valid`` stays on the device, so no launch waits for the host.
"""
from __future__ import annotations

import torch

from . import _native
from . import sift_kernels as sk

orientation_hist_plain = sk.orientation_hist
descriptors_plain = sk.descriptors


def _check_walk_inputs(name: str, mod, ang, lists, n_valid):
    _native.check_cuda(f"{name}.mod", mod, torch.float32, (None, None))
    _native.check_cuda(f"{name}.ang", ang, torch.float32, tuple(mod.shape))
    n = lists[0].shape[0]
    for i, t in enumerate(lists):
        _native.check_cuda(f"{name}.list{i}", t, torch.float32, (n,))
    _native.check_cuda(f"{name}.n_valid", n_valid, torch.int32, (1,))


def orientation_hist(mod: torch.Tensor, ang: torch.Tensor, x: torch.Tensor,
                     y: torch.Tensor, sigma: torch.Tensor,
                     n_valid: torch.Tensor, radius: int, n_bins: int = 36):
    """Raw [N, 36] orientation histograms and the in-image test ``ok``
    (see ``sift_kernels.orientation_hist``). Kernel B2 on CUDA tensors."""
    if mod.device.type == "cpu":
        return orientation_hist_plain(mod, ang, x, y, sigma, n_valid, radius,
                                      n_bins)
    if n_bins != 36:
        raise ValueError("kernel B2 is built for 36 orientation bins")
    _check_walk_inputs("orientation_hist", mod, ang, (x, y, sigma), n_valid)
    h, w = mod.shape
    n = x.shape[0]
    hist = torch.empty((n, n_bins), dtype=torch.float32, device=mod.device)
    _native.LAUNCHES["sift_orientation_hist"] += 1
    _native.launch("cvs_orientation_hist", mod.data_ptr(), ang.data_ptr(),
                   h, w, x.data_ptr(), y.data_ptr(), sigma.data_ptr(),
                   n_valid.data_ptr(), n, radius, hist.data_ptr())
    xi = torch.floor(x + 0.5)
    yi = torch.floor(y + 0.5)
    ok = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
    return hist, ok


def descriptors(mod: torch.Tensor, ang: torch.Tensor, x: torch.Tensor,
                y: torch.Tensor, sigma: torch.Tensor, angle: torch.Tensor,
                n_valid: torch.Tensor, radius: int, magnif: float = 3.0,
                window_size: float = 2.0, nbp: int = 4, nbo: int = 8):
    """[N, 128] normalised SIFT descriptors and ``ok`` (see
    ``sift_kernels.descriptors``). Kernel B3 on CUDA tensors."""
    if mod.device.type == "cpu":
        return descriptors_plain(mod, ang, x, y, sigma, angle, n_valid,
                                 radius, magnif, window_size, nbp, nbo)
    if (nbp, nbo) != (4, 8):
        raise ValueError("kernel B3 is built for 4x4 spatial x 8 "
                         "orientation bins")
    _check_walk_inputs("descriptors", mod, ang, (x, y, sigma, angle), n_valid)
    h, w = mod.shape
    n = x.shape[0]
    desc = torch.empty((n, 128), dtype=torch.float32, device=mod.device)
    _native.LAUNCHES["sift_descriptors"] += 1
    _native.launch("cvs_descriptors", mod.data_ptr(), ang.data_ptr(), h, w,
                   x.data_ptr(), y.data_ptr(), sigma.data_ptr(),
                   angle.data_ptr(), n_valid.data_ptr(), n, radius,
                   float(magnif), float(window_size), desc.data_ptr())
    xi = torch.floor(x + 0.5)
    yi = torch.floor(y + 0.5)
    ok = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h - 1)
          & (torch.arange(n, device=x.device) < n_valid[0]))
    return desc, ok
