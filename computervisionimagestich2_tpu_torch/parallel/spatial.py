"""Row-sharded image kernels (counterpart of
``computervisionimagestich2_tpu.parallel.spatial``).

The reference's unbounded dimension is the growing canvas
(ImageProcess.cpp:215-219). A row-sharded blur keeps each stripe on its own
mesh device and exchanges only the filter halo with its row neighbours
(``mesh.py``: one controller, the halo a slice of the neighbouring stripe).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.gaussian import _conv1d_axis, gauss_taps
from .mesh import Mesh, shard_rows, to_device


def _halo_blur_local(blocks: list[torch.Tensor],
                     taps: np.ndarray) -> list[torch.Tensor]:
    """Blur each row stripe [H_local, W] with a halo exchange between
    neighbouring stripes: W first (no exchange), then H over r rows from
    the stripe above and below; the end stripes replicate their own edge
    row instead of the wrapped halo (VL_PAD_BY_CONTINUITY)."""
    r = (taps.shape[0] - 1) // 2
    n = len(blocks)
    outs = [_conv1d_axis(b, taps, -1) for b in blocks]
    blurred = []
    for i, out in enumerate(outs):
        above = (out[:1].expand(r, -1) if i == 0
                 else to_device(outs[i - 1][-r:], out.device))
        below = (out[-1:].expand(r, -1) if i == n - 1
                 else to_device(outs[i + 1][:r], out.device))
        ext = torch.cat([above, out, below], dim=0)   # [H_local + 2r, W]
        blurred.append(_conv1d_axis(ext, taps, 0)[r:-r])
    return blurred


def sharded_gaussian_blur(img: torch.Tensor, sigma: float, mesh: Mesh,
                          axis_name: str = "sp") -> list[torch.Tensor]:
    """Gaussian blur of [H, W] with rows sharded over ``axis_name``: the
    stripes of the result, stripe i on the axis's device i (concatenate
    with ``mesh.gather_rows``). H must be divisible by the axis size and
    each stripe must be >= the filter radius. Equal to
    ``ops.gaussian.gaussian_blur``."""
    n = mesh.shape[axis_name]
    taps = gauss_taps(sigma)
    r = (taps.shape[0] - 1) // 2
    if img.shape[0] % n != 0 or img.shape[0] // n < r:
        raise ValueError(
            f"H={img.shape[0]} not shardable over {n} devices with radius {r}")
    stripes = shard_rows(img, mesh.axis_devices(axis_name))
    return _halo_blur_local(stripes, taps)
