"""Resizes with CImg / VLFeat semantics (counterpart of
``computervisionimagestich2_tpu.ops.resize``).

``cimg_resize`` is CImg get_resize(..., interpolation=3) per dimension: an
overlap-weighted moving average when shrinking (CImg.h:29539-29556) and
origin-aligned linear interpolation when enlarging (CImg.h:29618-29654).
The weights are precomputed on the host per shape pair and applied as the
same banded shifted-slice sums as the JAX package (same term order).
``vlfeat_downsample`` is VLFeat's stride-2^d point decimation
(copy_and_downsample, vl/sift.c:178-194) and ``vlfeat_upsample_rows`` its
midpoint row doubling (copy_and_upsample_rows, vl/sift.c:81-101), which
builds the first octave when ``sift.o_min < 0``.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..core.programs import const


@lru_cache(maxsize=None)
def _resize_weights(n_src: int, n_dst: int) -> np.ndarray:
    """CImg per-dimension resize weights: [n_dst, n_src], rows sum to 1."""
    w = np.zeros((n_dst, n_src), dtype=np.float32)
    if n_dst == n_src:
        np.fill_diagonal(w, 1.0)
    elif n_dst < n_src:
        # mode 2: overlap-weighted moving average on the n_src*n_dst grid
        for t in range(n_dst):
            lo, hi = t * n_src, (t + 1) * n_src
            s0, s1 = lo // n_dst, (hi - 1) // n_dst
            for s in range(s0, s1 + 1):
                ov = min(hi, (s + 1) * n_dst) - max(lo, s * n_dst)
                w[t, s] = ov / n_src
    else:
        # mode 3 enlarge: origin-aligned linear interpolation
        fx = n_src / n_dst
        for t in range(n_dst):
            pos = min(t * fx, n_src - 1.0)
            i = int(pos)
            a = pos - i
            w[t, i] += 1.0 - a
            w[t, min(i + 1, n_src - 1)] += a
    return w


@lru_cache(maxsize=None)
def _banded_weights(n_src: int, n_dst: int):
    """The resize map in banded form: (idx0 [n_dst], w [n_dst, B]) with
    out[t] = sum_b w[t, b] * src[idx0[t] + b]."""
    dense = _resize_weights(n_src, n_dst)
    band = max(int((dense != 0).sum(axis=1).max()), 1)
    idx0 = np.zeros(n_dst, np.int64)
    w = np.zeros((n_dst, band), np.float32)
    for t in range(n_dst):
        nz = np.nonzero(dense[t])[0]
        first = int(nz[0]) if len(nz) else 0
        first = min(first, n_src - band)
        idx0[t] = first
        w[t] = dense[t, first:first + band]
    return idx0, w


def _weights_col(w: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Per-output-position weights shaped [1, n, 1, ...] to broadcast over
    axis 1 of ``like``, in like's dtype (a device constant, ``const``)."""
    t = const(w, like.dtype, like.device)
    return t.reshape((1, -1) + (1,) * (like.dim() - 2))


def _pad_axis1(img: torch.Tensor, before: int, after: int) -> torch.Tensor:
    shape = list(img.shape)
    parts = []
    if before:
        shape[1] = before
        parts.append(img.new_zeros(shape))
    parts.append(img)
    if after:
        shape[1] = after
        parts.append(img.new_zeros(shape))
    return torch.cat(parts, dim=1)


def _shrink_half_axis1(img: torch.Tensor, n_dst: int) -> torch.Tensor:
    """n_dst == n_src // 2: idx0[t] == 2t, so the banded sum becomes
    strided slices."""
    n_src = img.shape[1]
    idx0, w = _banded_weights(n_src, n_dst)
    assert (idx0 == 2 * np.arange(n_dst)).all()
    band = w.shape[1]
    padded = _pad_axis1(img, 0, band)
    out = None
    for b in range(band):
        term = padded[:, b: b + 2 * n_dst: 2] * _weights_col(w[:, b], img)
        out = term if out is None else out + term
    return out


@lru_cache(maxsize=None)
def _enlarge2_weights(n_src: int, n_dst: int) -> tuple[np.ndarray, ...]:
    """``_enlarge2_axis1``'s weights: for the even and the odd output
    columns, w [n_half, 3] with out[t] = sum_b w[t, b] * src[t - 1 + b]."""
    dense = _resize_weights(n_src, n_dst)
    n_half = (n_dst + 1) // 2
    out = []
    for p in (0, 1):
        rows = dense[p::2]
        w = np.zeros((n_half, 3), np.float32)
        for t in range(rows.shape[0]):
            for b in range(3):
                j = t - 1 + b
                if 0 <= j < n_src:
                    w[t, b] = rows[t, j]
        w.setflags(write=False)
        out.append(w)
    return tuple(out)


def _enlarge2_axis1(img: torch.Tensor, n_dst: int) -> torch.Tensor:
    """n_src == n_dst // 2 (the Laplacian expand): even/odd output columns
    each read src[t-1+b] for b in 0..2."""
    n_src = img.shape[1]
    padded = _pad_axis1(img, 1, 2)          # src index i -> padded i+1
    halves = []
    n_half = (n_dst + 1) // 2
    for w in _enlarge2_weights(n_src, n_dst):
        out_p = None
        for b in range(3):
            term = padded[:, b: b + n_half] * _weights_col(w[:, b], img)
            out_p = term if out_p is None else out_p + term
        halves.append(out_p)
    inter = torch.stack(halves, dim=2)       # [H, n_half, 2, ...]
    inter = inter.reshape((img.shape[0], 2 * n_half) + tuple(img.shape[2:]))
    return inter[:, :n_dst]


def _resize_axis1(img: torch.Tensor, n_dst: int) -> torch.Tensor:
    """Resize axis 1 of [H, W, ...] with CImg semantics."""
    n_src = img.shape[1]
    if n_src == n_dst:
        return img
    if n_dst == n_src // 2:
        return _shrink_half_axis1(img, n_dst)
    if n_src == n_dst // 2:
        return _enlarge2_axis1(img, n_dst)
    # generic ratio (not used by the blend pyramid)
    idx0, w = _banded_weights(n_src, n_dst)
    idx0 = const(idx0, torch.int64, img.device)
    out = None
    for b in range(w.shape[1]):
        term = img.index_select(1, idx0 + b) * _weights_col(w[:, b], img)
        out = term if out is None else out + term
    return out


def cimg_resize(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """CImg get_resize(out_w, out_h, 1, C, 3) on an [H, W] or [H, W, C]
    tensor: x first, then y (CImg order)."""
    out = _resize_axis1(img, out_w)
    return _resize_axis1(out.transpose(0, 1), out_h).transpose(0, 1)


def vlfeat_downsample(img: torch.Tensor, d: int = 1) -> torch.Tensor:
    """Stride-2^d point decimation (copy_and_downsample, vl/sift.c:178-194).
    img: [..., H, W]; rows step over [0, H), columns over [0, W-(d-1))."""
    step = 1 << d
    w = img.shape[-1]
    n_out = (w - step) // step + 1
    return img[..., ::step, : step * n_out: step]


def vlfeat_upsample_rows(img: torch.Tensor) -> torch.Tensor:
    """One application of copy_and_upsample_rows (vl/sift.c:81-101): each
    row doubles in length with midpoint interpolation (the last sample
    repeats), and the result is transposed. img: [..., H, W] -> [..., 2W,
    H]; two calls double an image."""
    nxt = torch.cat([img[..., :, 1:], img[..., :, -1:]], dim=-1)
    up = torch.stack([img, 0.5 * (img + nxt)], dim=-1)
    return up.reshape(img.shape[:-1] + (2 * img.shape[-1],)).transpose(-1, -2)
