"""Separable Gaussian smoothing (counterpart of
``computervisionimagestich2_tpu.ops.gaussian``).

VLFeat's taps (vl/sift.c:124-141): W = max(ceil(4 sigma), 1),
taps[j] = exp(-0.5 ((j - W) / sigma)^2), normalised; padding by continuity
(edge replication, VL_PAD_BY_CONTINUITY).

The 1-D passes are the same shift-and-add as the JAX package, summing the
taps in the same order, so float results match: on a CPU tensor as
``_shift_and_add``, on a CUDA tensor as kernel B8 (``csrc/blur.cu``), one
launch a pass, with the same bits. ``conv2d`` is avoided on purpose: cuDNN
would bring TF32 and another summation order, and the blurs decide strict
DoG extrema downstream.

``vanvliet_blur`` is CImg's recursive Van Vliet Gaussian with Triggs
boundaries (get_blur(sigma, true, true), CImg.h:34887-34933, 35045-35116),
the blend's parity blur (``blend.blur_impl="vanvliet"``). Its two IIR
passes per axis run as a log-depth doubling scan over the axis (about
log2(n) rounds of 3x3 products on every row at once), not a loop over
pixels; the JAX package runs an associative scan, which groups the same
products another way, so the two agree to float32 rounding.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..core.programs import const
from . import _native


@lru_cache(maxsize=None)
def gauss_taps(sigma: float) -> np.ndarray:
    """VLFeat's normalized Gaussian taps (vl/sift.c:124-141), cached per
    sigma as a read-only array."""
    w = max(math.ceil(4.0 * sigma), 1)
    j = np.arange(2 * w + 1, dtype=np.float32)
    d = (j - w) / np.float32(sigma)
    taps = np.exp(-0.5 * d * d).astype(np.float32)
    taps = taps / taps.sum()
    taps.setflags(write=False)
    return taps


@lru_cache(maxsize=None)
def _replicate_index(r: int, length: int) -> np.ndarray:
    """Source index of each position of an axis of ``length`` padded by
    ``r`` on both sides with its edge values."""
    idx = np.clip(np.arange(-r, length + r), 0, length - 1)
    idx.setflags(write=False)
    return idx


def _conv1d_axis(x: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """Correlate along ``axis`` with edge-replicate padding: out =
    sum_j taps[j] * xpad[j : j + L] in tap order. Taps are rounded to
    x's dtype first (as the reference casts them), so a bfloat16 blur
    multiplies by bfloat16 taps; they are a device constant (``const``).
    Kernel B8 (``_native.separable_blur``, one launch) on a CUDA tensor;
    ``_shift_and_add`` on a CPU tensor."""
    taps_t = const(taps, x.dtype, x.device)
    if x.device.type == "cpu":
        return _shift_and_add(x, taps_t, axis)
    return _native.separable_blur(x, taps_t, axis)


def _shift_and_add(x: torch.Tensor, taps_t: torch.Tensor,
                   axis: int) -> torch.Tensor:
    """The plain version of ``_conv1d_axis`` (``taps_t``: the taps as a
    tensor of x's dtype on x's device): an edge-replicated copy of x
    (``index_select`` with a device-constant index), then one multiply and
    one add over the whole tensor a tap."""
    k = taps_t.shape[0]
    r = (k - 1) // 2
    axis = axis % x.dim()
    length = x.shape[axis]
    idx = const(_replicate_index(r, length), torch.int64, x.device)
    xp = x.index_select(axis, idx)
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


# ------------------------------------------------------- Van Vliet (CImg)
def _vanvliet_coefs(sigma: float):
    """CImg's Van Vliet coefficients (CImg.h:35053-35065, doubles):
    (B, f1, f2, f3) of v[n] = x[n] + f1 v[n-1] + f2 v[n-2] + f3 v[n-3]."""
    nsigma = max(float(sigma), 0.5)
    m0, m1, m2 = 1.16680, 1.10783, 1.40586
    m1sq, m2sq = m1 * m1, m2 * m2
    q = (-0.2568 + 0.5784 * nsigma + 0.0561 * nsigma * nsigma
         if nsigma < 3.556 else 2.5091 + 0.9804 * (nsigma - 3.556))
    qsq = q * q
    scale = (m0 + q) * (m1sq + m2sq + 2 * m1 * q + qsq)
    b1 = -q * (2 * m0 * m1 + m1sq + m2sq + (2 * m0 + 4 * m1) * q
               + 3 * qsq) / scale
    b2 = qsq * (m0 + 2 * m1 + 3 * q) / scale
    b3 = -qsq * q / scale
    big_b = (m0 * (m1sq + m2sq)) / scale
    return np.float64(big_b), np.float64(-b1), np.float64(-b2), np.float64(-b3)


def _triggs_matrix(f1, f2, f3) -> np.ndarray:
    """B. Triggs' right-boundary matrix (CImg.h:34893-34902), [9]."""
    a1, a2, a3 = f1, f2, f3
    scale_m = 1.0 / ((1.0 + a1 - a2 + a3) * (1.0 - a1 - a2 - a3)
                     * (1.0 + a2 + (a1 - a3) * a3))
    m = np.empty(9)
    m[0] = scale_m * (-a3 * a1 + 1.0 - a3 * a3 - a2)
    m[1] = scale_m * (a3 + a1) * (a2 + a3 * a1)
    m[2] = scale_m * a3 * (a1 + a3 * a2)
    m[3] = scale_m * (a1 + a3 * a2)
    m[4] = -scale_m * (a2 - 1.0) * (a2 + a3 * a1)
    m[5] = -scale_m * a3 * (a3 * a1 + a3 * a3 + a2 - 1.0)
    m[6] = scale_m * (a3 * a1 + a2 + a1 * a1 - a2 * a2)
    m[7] = scale_m * (a1 * a2 + a3 * a2 * a2 - a1 * a3 * a3
                      - a3 * a3 * a3 - a3 * a2 + a3)
    m[8] = scale_m * a3 * (a1 + a3 * a2)
    return m


def _affine_scan_batched(x_terms: torch.Tensor, a_mat: np.ndarray,
                         s_init: torch.Tensor) -> torch.Tensor:
    """s[n] = A s[n-1] + e0 x[n] for x [..., N] and s[-1] = s_init
    [..., 3]; returns s[n][0] for every n, [..., N].

    A doubling (Hillis-Steele) scan: element i holds the affine map
    (P_i, q_i) that takes the state before its window to the state at i;
    round d composes each element with the one d places before it, so
    ceil(log2 N) rounds cover the axis. P_i depends on the position only,
    so it is kept once, [N, 3, 3], and q for every row, [..., N, 3]."""
    n = x_terms.shape[-1]
    dev, dt = x_terms.device, x_terms.dtype
    a = const(np.asarray(a_mat, np.float32), dt, dev)
    p = a.expand(n, 3, 3).clone()
    q = torch.zeros(x_terms.shape + (3,), device=dev, dtype=dt)
    q[..., 0] = x_terms
    # fold the initial state into the first element: q0 = e0 x0 + A s_init
    q[..., 0, :] = q[..., 0, :] + (a * s_init[..., None, :]).sum(-1)
    d = 1
    while d < n:
        # (P, q)[i] <- (P[i] P[i-d], P[i] q[i-d] + q[i]) for i >= d
        pi, prev = p[d:], q[..., :-d, :]
        q_new = (pi[:, :, 0] * prev[..., 0:1] + pi[:, :, 1] * prev[..., 1:2]
                 + pi[:, :, 2] * prev[..., 2:3]) + q[..., d:, :]
        p = torch.cat([p[:d], (pi[..., None] * p[:-d, None]).sum(-2)])
        q = torch.cat([q[..., :d, :], q_new], dim=-2)
        d *= 2
    return q[..., 0]


def vanvliet_blur_axis(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """CImg vanvliet(sigma, order=0, Neumann boundary) along the last axis
    (CImg.h:34887-34933, 35045-35093): forward IIR, Triggs right-boundary
    correction, backward IIR. Agrees with CImg's double-precision loop to
    float32 tolerance. sigma < 0.5 returns x."""
    if float(sigma) < 0.5:
        return x
    big_b, f1, f2, f3 = _vanvliet_coefs(sigma)
    m = [float(np.float32(v)) for v in _triggs_matrix(f1, f2, f3)]
    sum_sq = float(np.float32(big_b * big_b))
    a_mat = np.array([[f1, f2, f3], [1, 0, 0], [0, 1, 0]], np.float32)
    n = x.shape[-1]

    # forward: v[n] = x[n] + f1 v[n-1] + ...; v[<0] = x[0] / B
    v_init = (x[..., :1] / float(np.float32(big_b))).expand(
        x.shape[:-1] + (3,))
    v = _affine_scan_batched(x, a_mat, v_init)

    # Triggs boundary at the right edge (CImg.h:34913-34921): the states
    # after the forward pass are v[n-k] for k <= n, else the Neumann init
    # x[0] / B (CImg.h:34910)
    denom = float(np.float32(1.0 - f1 - f2 - f3))
    uplus = x[..., -1] / denom
    vplus = uplus / denom
    unp, unp1, unp2 = (
        (v[..., n - k] if k <= n else v_init[..., 0]) - uplus
        for k in (1, 2, 3))
    y_last, y_n, y_n1 = (
        (m[r] * unp + m[r + 1] * unp1 + m[r + 2] * unp2 + vplus) * sum_sq
        for r in (0, 3, 6))

    # backward: y[m] = B^2 v[m] + f1 y[m+1] + f2 y[m+2] + f3 y[m+3]
    if n == 1:
        # the backward loop runs n - 1 = 0 times (CImg.h:34922-34931)
        return y_last[..., None]
    rev = torch.flip(v[..., :-1] * sum_sq, dims=(-1,))
    y_rev = _affine_scan_batched(rev, a_mat,
                                 torch.stack([y_last, y_n, y_n1], dim=-1))
    return torch.cat([torch.flip(y_rev, dims=(-1,)), y_last[..., None]],
                     dim=-1)


def vanvliet_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """CImg get_blur(sigma, true, true): Van Vliet along x, then y,
    skipping size-1 axes like blur()'s guards (CImg.h:35113-35116).
    img: [..., H, W]."""
    out = img
    if img.shape[-1] > 1:
        out = vanvliet_blur_axis(out, sigma)
    if img.shape[-2] > 1:
        out = vanvliet_blur_axis(out.transpose(-1, -2),
                                 sigma).transpose(-1, -2)
    return out
