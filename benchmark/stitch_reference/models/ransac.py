"""RANSAC warp estimation (counterpart of
``computervisionimagestich2_tpu.models.ransac``).

ImageProcess::RANSAC (ImageProcess.cpp:395-436) with all K hypotheses as
one batch: K 4-point solves, one [K, N] reprojection / inlier count
(threshold 4 px over all pairs), the best hypothesis, a warm-started
least-squares refit on its inliers (ImageProcess.cpp:500-529), and
``lo_iters`` rounds of local optimisation. ``model="projective"`` solves
homographies instead (``solve_projective``) and refits them cold on the
inliers, as the JAX package does. The draws come from the ported threefry
(ops/rng.py), so hypotheses equal the JAX package's. Everything stays on
the device; nothing synchronises with the host.
"""
from __future__ import annotations

import torch

from ..core.types import MatchPairs
from ..ops import rng
from ..ops.solve import solve_projective, solve_warp
from ..ops.warp import warp_points


def ransac_warp(pairs: MatchPairs, key: torch.Tensor,
                n_hypotheses: int = 128, threshold: float = 4.0,
                n_sample: int = 4, model: str = "bilinear",
                lo_iters: int = 0, corner_xy: torch.Tensor | None = None,
                corner_span: float | None = None):
    """Returns (coeffs [8] bilinear or [9] projective, inlier_mask [N],
    n_inliers scalar).

    PRECONDITION: ``pairs.valid`` is prefix-compacted (the matcher's
    output is); samples are uniform ints over the live prefix.

    ``corner_xy`` ([4, 2], optional): degenerate-model gate — hypotheses
    that map these points (the incoming image's corners) further than
    ``corner_span`` outside the valid pairs' dst bounding box score zero,
    and a refit that fails the same test falls back to the best
    hypothesis."""
    solve_fn = solve_warp if model == "bilinear" else solve_projective
    dev = pairs.src_xy.device
    valid_f = pairs.valid.float()
    n_valid = torch.clamp(valid_f.sum(), min=1.0)
    u = rng.uniform(key, (n_hypotheses, n_sample), dev)
    sample_idx = torch.minimum((u * n_valid).int(),
                               (n_valid - 1.0).int()).long()
    src_s = pairs.src_xy[sample_idx]                      # [K, 4, 2]
    dst_s = pairs.dst_xy[sample_idx]
    coeffs_k = solve_fn(src_s, dst_s)                     # [K, 8 or 9]

    x = pairs.src_xy[:, 0]
    y = pairs.src_xy[:, 1]
    ck = coeffs_k.T[:, :, None]                           # [8 or 9, K, 1]
    xw, yw = warp_points(ck, x[None, :], y[None, :], model)
    dx = xw - pairs.dst_xy[:, 0][None, :]
    dy = yw - pairs.dst_xy[:, 1][None, :]
    dist = torch.sqrt(dx * dx + dy * dy)                  # [K, N]
    inliers = (dist < threshold) & pairs.valid[None, :]
    counts = inliers.sum(dim=1, dtype=torch.int32)        # [K]

    if corner_xy is not None:
        big = 3e38
        dxv = pairs.dst_xy[:, 0]
        dyv = pairs.dst_xy[:, 1]
        lo_x = torch.where(pairs.valid, dxv, big).min() - corner_span
        lo_y = torch.where(pairs.valid, dyv, big).min() - corner_span
        hi_x = torch.where(pairs.valid, dxv, -big).max() + corner_span
        hi_y = torch.where(pairs.valid, dyv, -big).max() + corner_span
        cxw, cyw = warp_points(ck, corner_xy[None, :, 0],
                               corner_xy[None, :, 1], model)   # [K, 4]
        sane = torch.all((cxw >= lo_x) & (cxw <= hi_x)
                         & (cyw >= lo_y) & (cyw <= hi_y), dim=1)
        inliers = inliers & sane[:, None]
        counts = torch.where(sane, counts, 0)

    # the first maximum, gathered on the device: indexing with a 0-dim
    # tensor would read it on the host
    best = torch.argmax(counts).reshape(1)

    def at_best(t):
        return t.index_select(0, best)[0]

    best_mask = at_best(inliers)

    def refit(mask, init):
        if model == "bilinear":
            # warm-started residual refit: keeps the f32 normal equations
            # at O(threshold) pixels
            return solve_warp(pairs.src_xy, pairs.dst_xy, mask.float(),
                              init=init)
        return solve_projective(pairs.src_xy, pairs.dst_xy, mask.float())

    def score(coeffs):
        xw2, yw2 = warp_points(coeffs, x, y, model)
        ex = xw2 - pairs.dst_xy[:, 0]
        ey = yw2 - pairs.dst_xy[:, 1]
        return (torch.sqrt(ex * ex + ey * ey) < threshold) & pairs.valid

    coeffs = refit(best_mask, at_best(coeffs_k))
    mask, count = best_mask, at_best(counts)
    for _ in range(lo_iters):
        mask2 = score(coeffs)
        count2 = mask2.sum(dtype=torch.int32)
        grow = count2 > count
        coeffs2 = refit(mask2, coeffs)
        coeffs = torch.where(grow, coeffs2, coeffs)
        mask = torch.where(grow, mask2, mask)
        count = torch.maximum(count2, count)

    if corner_xy is not None:
        fxw, fyw = warp_points(coeffs, corner_xy[:, 0], corner_xy[:, 1], model)
        f_ok = torch.all((fxw >= lo_x) & (fxw <= hi_x)
                         & (fyw >= lo_y) & (fyw <= hi_y)
                         & torch.isfinite(fxw) & torch.isfinite(fyw))
        coeffs = torch.where(f_ok, coeffs, at_best(coeffs_k))
        mask = torch.where(f_ok, mask, at_best(inliers))
        count = torch.where(f_ok, count, at_best(counts))
    return coeffs, mask, count


