"""Warp-model solvers (counterpart of
``computervisionimagestich2_tpu.ops.solve``).

The reference solves A h = b with rows [x, y, x*y, 1] for x' and y' — a
4x4 LU for a minimal sample (getHomographyMat, ImageProcess.cpp:439-462)
and a least-squares refit on the inliers (getInlinerHomography,
ImageProcess.cpp:500-529). Here coordinates are normalised (shift/scale)
before an unrolled 4x4 Cholesky solve of the normal equations, with one
refinement step, and mapped back exactly; all leading dims are batched, so
one call solves every RANSAC hypothesis.

``solve_projective`` fits the 3x3 homography of ``warp_model="projective"``
(normalised DLT in inhomogeneous form) with an unrolled n x n Cholesky
that sums in the JAX package's order, term by term: that order decides
which 4-point hypotheses score at the 4 px threshold.
"""
from __future__ import annotations

import torch


def _design_rows(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[..., N, 4] rows [x, y, x*y, 1] (ImageProcess.cpp:446-449)."""
    return torch.stack([x, y, x * y, torch.ones_like(x)], dim=-1)


def _denormalize(coeffs_n: torch.Tensor, cx, cy, s) -> torch.Tensor:
    """Map coefficients fitted on x~ = (x - cx) / s, y~ = (y - cy) / s back
    to raw-coordinate coefficients, exactly. coeffs_n: [..., 2, 4]
    (channels x', y'); cx, cy, s: [...]."""
    cx, cy, s = cx[..., None], cy[..., None], s[..., None]
    a = coeffs_n[..., 0]
    b = coeffs_n[..., 1]
    c = coeffs_n[..., 2]
    d = coeffs_n[..., 3]
    s2 = s * s
    w_x = a / s - c * cy / s2
    w_y = b / s - c * cx / s2
    w_xy = c / s2
    w_1 = d - a * cx / s - b * cy / s + c * cx * cy / s2
    return torch.stack([w_x, w_y, w_xy, w_1], dim=-1)


def _solve4_spd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unrolled 4x4 Cholesky solve of a @ x = b. a: [..., 4, 4] SPD,
    b: [..., 4, K]. Returns [..., 4, K]."""
    eps = 1e-30
    l11 = torch.sqrt(torch.clamp(a[..., 0, 0], min=eps))
    l21 = a[..., 1, 0] / l11
    l31 = a[..., 2, 0] / l11
    l41 = a[..., 3, 0] / l11
    l22 = torch.sqrt(torch.clamp(a[..., 1, 1] - l21 * l21, min=eps))
    l32 = (a[..., 2, 1] - l31 * l21) / l22
    l42 = (a[..., 3, 1] - l41 * l21) / l22
    l33 = torch.sqrt(torch.clamp(a[..., 2, 2] - l31 * l31 - l32 * l32,
                                 min=eps))
    l43 = (a[..., 3, 2] - l41 * l31 - l42 * l32) / l33
    l44 = torch.sqrt(torch.clamp(
        a[..., 3, 3] - l41 * l41 - l42 * l42 - l43 * l43, min=eps))
    u = lambda t: t[..., None]  # noqa: E731 — broadcast over K
    # forward substitution L y = b
    y1 = b[..., 0, :] / u(l11)
    y2 = (b[..., 1, :] - u(l21) * y1) / u(l22)
    y3 = (b[..., 2, :] - u(l31) * y1 - u(l32) * y2) / u(l33)
    y4 = (b[..., 3, :] - u(l41) * y1 - u(l42) * y2 - u(l43) * y3) / u(l44)
    # back substitution L^T x = y
    x4 = y4 / u(l44)
    x3 = (y3 - u(l43) * x4) / u(l33)
    x2 = (y2 - u(l32) * x3 - u(l42) * x4) / u(l22)
    x1 = (y1 - u(l21) * x2 - u(l31) * x3 - u(l41) * x4) / u(l11)
    return torch.stack([x1, x2, x3, x4], dim=-2)


def solve_warp(src_xy: torch.Tensor, dst_xy: torch.Tensor,
               weights: torch.Tensor | None = None,
               init: torch.Tensor | None = None) -> torch.Tensor:
    """Fit the 8-coefficient bilinear warp mapping src -> dst.

    src_xy, dst_xy: [..., N, 2]; weights: optional [..., N] mask/weights
    (the RANSAC inlier set); init: optional [..., 8] warm start — the model
    is linear in its coefficients, so fitting the residual of ``init``
    keeps every f32 intermediate at O(threshold) pixels. Returns [..., 8]
    [w11, w12, w13, w21, w22, w23, w31, w32]."""
    x, y = src_xy[..., 0], src_xy[..., 1]
    if weights is None:
        weights = torch.ones_like(x)
    wsum = torch.clamp(torch.sum(weights, dim=-1), min=1.0)
    cx = torch.sum(weights * x, dim=-1) / wsum
    cy = torch.sum(weights * y, dim=-1) / wsum
    spread = torch.sum(weights * (torch.abs(x - cx[..., None])
                                  + torch.abs(y - cy[..., None])),
                       dim=-1) / wsum
    s = torch.clamp(spread, min=1e-3)

    if init is not None:
        ini = init.reshape(init.shape[:-1] + (2, 4))
        i = lambda r, c: ini[..., r, c, None]  # noqa: E731
        pred = torch.stack([
            i(0, 0) * x + i(0, 1) * y + i(0, 2) * x * y + i(0, 3),
            i(1, 0) * x + i(1, 1) * y + i(1, 2) * x * y + i(1, 3),
        ], dim=-1)
        dst_xy = dst_xy - pred
    # center the targets: the constant column absorbs the centroid exactly
    cu = torch.sum(weights * dst_xy[..., 0], dim=-1) / wsum
    cv = torch.sum(weights * dst_xy[..., 1], dim=-1) / wsum
    duv = torch.stack([cu, cv], dim=-1)
    dst_c = dst_xy - duv[..., None, :]

    xn = (x - cx[..., None]) / s[..., None]
    yn = (y - cy[..., None]) / s[..., None]
    a_mat = _design_rows(xn, yn)                        # [..., N, 4]
    aw = a_mat * weights[..., None]
    awt = aw.transpose(-1, -2)
    ata = awt @ a_mat                                   # [..., 4, 4]
    atb = awt @ dst_c                                   # [..., 4, 2]
    # Tikhonov epsilon keeps degenerate samples (duplicate points) finite
    ata = ata + 1e-6 * torch.eye(4, dtype=ata.dtype, device=ata.device)
    sol = _solve4_spd(ata, atb)
    # one step of iterative refinement against the original residual
    r = dst_c - a_mat @ sol
    sol = sol + _solve4_spd(ata, awt @ r)
    sol = torch.cat([sol[..., :3, :], sol[..., 3:, :] + duv[..., None, :]],
                    dim=-2)
    coeffs = _denormalize(sol.transpose(-1, -2), cx, cy, s)  # [..., 2, 4]
    flat = coeffs.reshape(coeffs.shape[:-2] + (8,))
    return flat + init if init is not None else flat


def _cholesky(a: torch.Tensor) -> list:
    """Lower Cholesky factor of SPD a [..., n, n] as a nested list of
    [...] tensors, unrolled in the JAX package's ``_solve_spd`` order:
    each dot product accumulates from 0 in increasing k, and the pivot is
    clamped at 1e-30."""
    n = a.shape[-1]
    eps = 1e-30
    zero = torch.zeros_like(a[..., 0, 0])
    l = [[None] * n for _ in range(n)]
    for i in range(n):
        acc = zero
        for k in range(i):
            acc = acc + l[i][k] * l[i][k]
        l[i][i] = torch.sqrt(torch.clamp(a[..., i, i] - acc, min=eps))
        for j in range(i + 1, n):
            acc = zero
            for k in range(i):
                acc = acc + l[j][k] * l[i][k]
            l[j][i] = (a[..., j, i] - acc) / l[i][i]
    return l


def _cho_solve(l: list, b: torch.Tensor) -> torch.Tensor:
    """Solve L L^T x = b for b [..., n, K] with the factor of
    ``_cholesky``: forward then back substitution, in the order of the
    JAX package's ``_solve_spd``. Returns [..., n, K]."""
    n = len(l)
    zero = torch.zeros_like(b[..., 0, :])
    y = [None] * n
    for i in range(n):
        acc = zero
        for k in range(i):
            acc = acc + l[i][k][..., None] * y[k]
        y[i] = (b[..., i, :] - acc) / l[i][i][..., None]
    x = [None] * n
    for i in reversed(range(n)):
        acc = zero
        for k in range(i + 1, n):
            acc = acc + l[k][i][..., None] * x[k]
        x[i] = (y[i] - acc) / l[i][i][..., None]
    return torch.stack(x, dim=-2)


def _solve_spd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unrolled Cholesky solve of a @ x = b (JAX ``ops/solve.py::
    _solve_spd``, batched over leading dims). a: [..., n, n] SPD,
    b: [..., n, K]."""
    return _cho_solve(_cholesky(a), b)


def solve_projective(src_xy: torch.Tensor, dst_xy: torch.Tensor,
                     weights: torch.Tensor | None = None) -> torch.Tensor:
    """Fit a projective homography (normalised DLT, inhomogeneous form)
    mapping src -> dst: x' = (h0 x + h1 y + h2) / (h6 x + h7 y + 1),
    y' = (h3 x + h4 y + h5) / (h6 x + h7 y + 1), by least squares on the
    linearised equations after the same centring and scaling as
    ``solve_warp``, with a 1e-6 ridge and two steps of iterative
    refinement.

    src_xy, dst_xy: [..., N, 2]; weights: optional [..., N] (the RANSAC
    inlier set). Returns [..., 9], the row-major homography with
    h[8] = 1. The system is factored once and the factor reused by the
    refinement steps (the JAX package factors it again each time, to the
    same bits)."""
    x, y = src_xy[..., 0], src_xy[..., 1]
    u, v = dst_xy[..., 0], dst_xy[..., 1]
    if weights is None:
        weights = torch.ones_like(x)
    wsum = torch.clamp(torch.sum(weights, dim=-1), min=1.0)

    def mean(t):
        return torch.sum(weights * t, dim=-1) / wsum

    cx, cy, cu, cv = mean(x), mean(y), mean(u), mean(v)
    e = lambda t: t[..., None]  # noqa: E731 — broadcast over N
    s = torch.clamp(mean(torch.abs(x - e(cx)) + torch.abs(y - e(cy))),
                    min=1e-3)
    t = torch.clamp(mean(torch.abs(u - e(cu)) + torch.abs(v - e(cv))),
                    min=1e-3)
    xn, yn = (x - e(cx)) / e(s), (y - e(cy)) / e(s)
    un, vn = (u - e(cu)) / e(t), (v - e(cv)) / e(t)

    zero = torch.zeros_like(xn)
    one = torch.ones_like(xn)
    # rows [x y 1 0 0 0 -u*x -u*y] h = u and [0 0 0 x y 1 -v*x -v*y] h = v
    a_u = torch.stack([xn, yn, one, zero, zero, zero, -un * xn, -un * yn],
                      dim=-1)
    a_v = torch.stack([zero, zero, zero, xn, yn, one, -vn * xn, -vn * yn],
                      dim=-1)
    a_mat = torch.cat([a_u, a_v], dim=-2)                 # [..., 2N, 8]
    rhs = torch.cat([un, vn], dim=-1)[..., None]          # [..., 2N, 1]
    w2 = torch.cat([weights, weights], dim=-1)
    awt = (a_mat * w2[..., None]).transpose(-1, -2)       # [..., 8, 2N]
    ata = awt @ a_mat + 1e-6 * torch.eye(8, dtype=a_mat.dtype,
                                         device=a_mat.device)
    factor = _cholesky(ata)
    hn = _cho_solve(factor, awt @ rhs)                    # [..., 8, 1]
    # iterative refinement against the original residual
    for _ in range(2):
        hn = hn + _cho_solve(factor, awt @ (rhs - a_mat @ hn))

    # denormalise: H = T_dst^-1 @ Hn @ T_src, with T_src: p -> (p - c) / s
    # and T_dst^-1: q -> q t + c_dst
    h_n = torch.cat([hn[..., 0], torch.ones_like(hn[..., 0, :])],
                    dim=-1).reshape(hn.shape[:-2] + (3, 3))
    z, o = torch.zeros_like(s), torch.ones_like(s)
    t_src = torch.stack([1 / s, z, -cx / s, z, 1 / s, -cy / s, z, z, o],
                        dim=-1).reshape(s.shape + (3, 3))
    t_dst_inv = torch.stack([t, z, cu, z, t, cv, z, z, o],
                            dim=-1).reshape(s.shape + (3, 3))
    h_full = t_dst_inv @ h_n @ t_src
    h_full = h_full / h_full[..., 2:3, 2:3]
    return h_full.reshape(h_full.shape[:-2] + (9,))
