"""Separable Gaussian smoothing (counterpart of
``computervisionimagestich2_tpu.ops.gaussian``).

VLFeat's taps (vl/sift.c:124-141): W = max(ceil(4 sigma), 1),
taps[j] = exp(-0.5 ((j - W) / sigma)^2), normalised; padding by continuity
(edge replication, VL_PAD_BY_CONTINUITY).

The 1-D passes are the same shift-and-add as the JAX package, summing the
taps in the same order, so float results match. ``conv2d`` is avoided on
purpose: cuDNN would bring TF32 and another summation order, and the blurs
decide strict DoG extrema downstream.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def gauss_taps(sigma: float) -> np.ndarray:
    """VLFeat's normalized Gaussian taps (vl/sift.c:124-141)."""
    w = max(math.ceil(4.0 * sigma), 1)
    j = np.arange(2 * w + 1, dtype=np.float32)
    d = (j - w) / np.float32(sigma)
    taps = np.exp(-0.5 * d * d).astype(np.float32)
    return taps / taps.sum()


def _conv1d_axis(x: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """Correlate along ``axis`` with edge-replicate padding: out =
    sum_j taps[j] * xpad[j : j + L] in tap order. Taps are rounded to
    x's dtype first (as the reference casts them), so a bfloat16 blur
    multiplies by bfloat16 taps."""
    k = taps.shape[0]
    r = (k - 1) // 2
    axis = axis % x.dim()
    length = x.shape[axis]
    idx = torch.arange(-r, length + r, device=x.device).clamp_(0, length - 1)
    xp = x.index_select(axis, idx)
    taps_t = torch.as_tensor(taps).to(device=x.device, dtype=x.dtype)
    out = None
    for j in range(k):
        term = taps_t[j] * xp.narrow(axis, j, length)
        out = term if out is None else out + term
    return out


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur with VLFeat tap/padding semantics, W then H.
    img: [..., H, W] float32 (leading dims batched)."""
    taps = gauss_taps(sigma)
    out = _conv1d_axis(img, taps, -1)
    return _conv1d_axis(out, taps, -2)
