"""SIFT stages (counterpart of ``computervisionimagestich2_tpu.ops.sift_kernels``).

- ``extrema_mask`` / ``compact_mask`` <- the 26-neighbour scan
  (vl_sift_detect, sift.c:539-603) and the scan-order candidate list; the
  contract of the fused detect kernel B1, here in plain PyTorch.
- ``refine_keypoints`` <- the Newton refine (sift.c:612-757) as dense
  stencil fields plus a 5-step position chase.
- ``polar_gradient``   <- update_gradient (sift.c:791-876).
- ``orientation_hist`` <- the raw 36-bin histogram of
  vl_sift_calc_keypoint_orientations (sift.c:904-1036): the plain version
  of kernel B2; ``orientation_peaks`` smooths and picks the angles.
- ``descriptors``      <- vl_sift_calc_keypoint_descriptor
  (sift.c:1268-1438) with the normalise / clamp 0.2 / renormalise tail:
  the plain version of kernel B3.

Float expressions keep the JAX package's operation order, and divisions by
constants go through ``fp.div`` (correctly rounded, like XLA).
"""
from __future__ import annotations

import math

import torch

from .compaction import compact_indices
from .fp import div

TWO_PI = 2.0 * math.pi
EPSILON_F = 1.19209290e-07  # VL_EPSILON_F
EPSILON_D = 2.220446049250313e-16  # VL_EPSILON_D


def jmod(x: torch.Tensor, y: float) -> torch.Tensor:
    """``jnp.mod`` for a positive float divisor: C fmod (exact), then
    negative remainders shifted up. (``torch.remainder`` computes
    x - floor(x / y) * y, which rounds.)"""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & (r < 0), r + y, r)


# ----------------------------------------------------------------- detection
def dog_stack(octave: torch.Tensor) -> torch.Tensor:
    """DoG from a GSS octave [L, H, W]: dog[s] = oct[s+1] - oct[s]."""
    return octave[1:] - octave[:-1]


def _shifted(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """a shifted by (dy, dx) over its last two dims, zero-filled."""
    h, w = a.shape[-2], a.shape[-1]
    padded = torch.nn.functional.pad(a, (1, 1, 1, 1))
    return padded[..., 1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]


def extrema_mask(dog: torch.Tensor, peak_thresh: float) -> torch.Tensor:
    """Strict 26-neighbour extremum mask (sift.c:539-603).

    dog: [S, H, W] (S >= 3). Returns bool [S-2, H, W]: True at interior
    points that are strict maxima (v >= 0.8 tp) or strict minima
    (v <= -0.8 tp) of their 26-neighbourhood. Slice s is dog level s+1."""
    v = dog[1:-1]
    h, w = dog.shape[1], dog.shape[2]
    gate = 0.8 * peak_thresh

    def pools(f):
        p3x = f(f(_shifted(dog, 0, -1), dog), _shifted(dog, 0, 1))
        p3xy = f(f(_shifted(p3x, -1, 0), p3x), _shifted(p3x, 1, 0))
        p3x_c = p3x[1:-1]
        inplane = f(f(_shifted(p3x_c, -1, 0), _shifted(p3x_c, 1, 0)),
                    f(_shifted(v, 0, -1), _shifted(v, 0, 1)))
        return f(f(inplane, p3xy[:-2]), p3xy[2:])

    is_max = (v >= gate) & (v > pools(torch.maximum))
    is_min = (v <= -gate) & (v < pools(torch.minimum))
    mask = is_max | is_min
    interior = torch.zeros((h, w), dtype=torch.bool, device=dog.device)
    interior[1:h - 1, 1:w - 1] = True
    return mask & interior


def compact_mask(mask: torch.Tensor, capacity: int):
    """Flatten a bool mask into coordinate lists with a static capacity.
    Returns (coords [capacity, ndim] int64, valid [capacity] bool) in
    C-scan order (s, then y, then x — the reference's append order)."""
    idx, valid = compact_indices(mask, capacity)
    # torch.unravel_index would upload the shape: divide by it instead
    dims = []
    for size in reversed(mask.shape):
        dims.append(idx % size)
        idx = idx // size
    return torch.stack(dims[::-1], dim=-1), valid


def _refine_fields(dog: torch.Tensor, w: int, h: int, peak_thresh: float,
                   edge_thresh: float, s_min: int, s_max: int, xper: float,
                   sigma0: float, n_levels: int):
    """Dense refinement fields over the interior of the DoG volume
    [S-2, H-2, W-2]: the gradient/Hessian stencils, the 3x3 solve, the
    +-1 relocation code, and every acceptance quantity (sift.c:612-757)."""
    d_lvl, hh, ww = dog.shape

    def sl(ds, dy, dx):
        return dog[1 + ds: d_lvl - 1 + ds, 1 + dy: hh - 1 + dy,
                   1 + dx: ww - 1 + dx]

    c = sl(0, 0, 0)
    xp1, xm1 = sl(0, 0, 1), sl(0, 0, -1)
    yp1, ym1 = sl(0, 1, 0), sl(0, -1, 0)
    sp1, sm1 = sl(1, 0, 0), sl(-1, 0, 0)

    dx_ = 0.5 * (xp1 - xm1)
    dy_ = 0.5 * (yp1 - ym1)
    ds_ = 0.5 * (sp1 - sm1)
    dxx = xp1 + xm1 - 2 * c
    dyy = yp1 + ym1 - 2 * c
    dss = sp1 + sm1 - 2 * c
    dxy = 0.25 * (sl(0, 1, 1) + sl(0, -1, -1) - sl(0, 1, -1) - sl(0, -1, 1))
    dxs = 0.25 * (sl(1, 0, 1) + sl(-1, 0, -1) - sl(1, 0, -1) - sl(-1, 0, 1))
    dys = 0.25 * (sl(1, 1, 0) + sl(-1, -1, 0) - sl(1, -1, 0) - sl(-1, 1, 0))

    # dense 3x3 adjugate solve: A b = -[dx, dy, ds]
    co_a = dyy * dss - dys * dys
    co_b = dys * dxs - dxy * dss
    co_c = dxy * dys - dyy * dxs
    det = dxx * co_a + dxy * co_b + dxs * co_c
    safe = torch.abs(det) > 1e-18
    one = torch.ones_like(det)
    inv_det = torch.where(safe, one / torch.where(safe, det, one), 0.0)
    r0, r1, r2 = -dx_, -dy_, -ds_
    b0 = (co_a * r0 + (dxs * dys - dxy * dss) * r1
          + (dxy * dys - dxs * dyy) * r2) * inv_det
    b1 = (co_b * r0 + (dxx * dss - dxs * dxs) * r1
          + (dxs * dxy - dxx * dys) * r2) * inv_det
    b2 = (co_c * r0 + (dxy * dxs - dxx * dys) * r1
          + (dxx * dyy - dxy * dxy) * r2) * inv_det

    n_s, fh, fw = c.shape
    dev = dog.device
    ys = torch.arange(1, fh + 1, device=dev, dtype=torch.int32)[None, :, None]
    xs = torch.arange(1, fw + 1, device=dev, dtype=torch.int32)[None, None, :]
    ss = torch.arange(n_s, device=dev, dtype=torch.int32)[:, None, None]
    step_x = (((b0 > 0.6) & (xs < w - 2)).int()
              - ((b0 < -0.6) & (xs > 1)).int())
    step_y = (((b1 > 0.6) & (ys < h - 2)).int()
              - ((b1 < -0.6) & (ys > 1)).int())
    step_code = (step_y + 1) * 3 + (step_x + 1)

    val = c + 0.5 * (dx_ * b0 + dy_ * b1 + ds_ * b2)
    den = dxx * dyy - dxy * dxy
    tr = dxx + dyy
    score = tr * tr / torch.where(den == 0, 1e-30, den)
    xn = xs.float() + b0
    yn = ys.float() + b1
    sn = (ss + 1 + s_min).float() + b2
    te = edge_thresh
    ok = ((torch.abs(val) > peak_thresh)
          & (score < (te + 1.0) * (te + 1.0) / te) & (score >= 0)
          & (torch.abs(b0) < 1.5) & (torch.abs(b1) < 1.5)
          & (torch.abs(b2) < 1.5)
          & (xn >= 0) & (xn <= w - 1) & (yn >= 0) & (yn <= h - 1)
          & (sn >= s_min) & (sn <= s_max))
    sigma = sigma0 * torch.pow(2.0, div(sn, float(n_levels))) * xper
    return step_code, ok, xn * xper, yn * xper, sigma, torch.abs(val)


def refine_keypoints(dog: torch.Tensor, coords: torch.Tensor,
                     valid: torch.Tensor, w: int, h: int, peak_thresh: float,
                     edge_thresh: float, s_min: int, s_max: int, xper: float,
                     sigma0: float, n_levels: int):
    """Candidate refinement. coords: [N, 3] (mask slice s, y, x) from
    compact_mask(extrema_mask(...)); mask slice s is dog level s+1.
    Returns (ok, x, y, sigma, level, response) of length N, x/y/sigma in
    input-image units (xper-scaled), response = |DoG| at the refined point."""
    step_code, okf, xf, yf, sigmaf, respf = _refine_fields(
        dog, w, h, peak_thresh, edge_thresh, s_min, s_max, xper, sigma0,
        n_levels)
    _, hh, ww = dog.shape
    hh2, ww2 = hh - 2, ww - 2
    sc_flat = step_code.reshape(-1)
    s_dog = coords[:, 0] + 1
    # dead slots start at an interior point; steps are bounds-clamped, so
    # every chase index stays inside the fields (outputs of dead slots are
    # masked by `valid`)
    y = torch.where(valid, coords[:, 1], 1)
    x = torch.where(valid, coords[:, 2], 1)
    base = coords[:, 0] * (hh2 * ww2)
    for _ in range(5):
        code = sc_flat[base + (y - 1) * ww2 + (x - 1)].long()
        x = x + code % 3 - 1
        y = y + code // 3 - 1
    flat = base + (y - 1) * ww2 + (x - 1)
    ok = okf.reshape(-1)[flat] & valid
    lvl = s_dog + s_min
    return (ok, xf.reshape(-1)[flat], yf.reshape(-1)[flat],
            sigmaf.reshape(-1)[flat], lvl, respf.reshape(-1)[flat])


# ------------------------------------------------------------------ gradient
def polar_gradient(levels: torch.Tensor) -> torch.Tensor:
    """Polar gradient field (update_gradient, sift.c:791-876).

    levels: [L, H, W]. Returns [L, 2, H, W]: (modulus, angle in [0, 2pi)).
    Central differences inside, one-sided at the borders."""
    _, h, w = levels.shape
    dev = levels.device
    cols = torch.arange(w, device=dev)
    rows = torch.arange(h, device=dev)
    xp = levels.index_select(2, (cols + 1).clamp(max=w - 1))
    xm = levels.index_select(2, (cols - 1).clamp(min=0))
    yp = levels.index_select(1, (rows + 1).clamp(max=h - 1))
    ym = levels.index_select(1, (rows - 1).clamp(min=0))
    fx = torch.where((cols == 0) | (cols == w - 1), 1.0, 0.5)[None, None, :]
    fy = torch.where((rows == 0) | (rows == h - 1), 1.0, 0.5)[None, :, None]
    gx = fx * (xp - xm)
    gy = fy * (yp - ym)
    mod = torch.sqrt(gx * gx + gy * gy)
    ang = jmod(torch.atan2(gy, gx) + TWO_PI, TWO_PI)
    return torch.stack([mod, ang], dim=1)


# --------------------------------------------------------------- orientation
def ori_patch_radius(sigma0: float, n_levels: int, s_max: int,
                     is_level: int | None = None) -> int:
    """Static bound for the orientation window radius floor(4.5 sigma)
    (sift.c:934) of keypoints at integer level ``is_level`` (|b_s| < 1.5);
    None = octave-wide worst case."""
    top = (s_max - 2) if is_level is None else is_level
    sn_max = min(float(s_max), top + 1.5)
    sigma_max = sigma0 * 2.0 ** (sn_max / n_levels)
    return max(int(math.floor(3.0 * 1.5 * sigma_max)), 1)


def _window(plane_h: int, plane_w: int, xi: torch.Tensor, yi: torch.Tensor,
            radius: int):
    """Integer window coordinates around (xi, yi): img_x [n, 1, P],
    img_y [n, P, 1], their in-image mask [n, P, P], and offsets [P]."""
    dev = xi.device
    offs = torch.arange(-radius, radius + 1, device=dev)
    img_x = xi[:, None, None] + offs[None, None, :]
    img_y = yi[:, None, None] + offs[None, :, None]
    inimg = ((img_x >= 0) & (img_x <= plane_w - 1)
             & (img_y >= 0) & (img_y <= plane_h - 1))
    return img_x, img_y, inimg, offs.float()


def orientation_hist(mod: torch.Tensor, ang: torch.Tensor, x: torch.Tensor,
                     y: torch.Tensor, sigma: torch.Tensor,
                     n_valid: torch.Tensor, radius: int, n_bins: int = 36,
                     winf: float = 1.5, chunk: int = 256):
    """Raw [N, n_bins] orientation histograms — the plain version of
    kernel B2 (contract of ``pallas_sift.orientation_hist_pallas``).

    mod, ang: [H, W] gradient planes of one level; x, y, sigma: [N]
    octave-local keypoint lists, valid-prefix compacted; n_valid: [1] live
    count. Returns (hist, ok): ok is the in-image test of the rounded
    keypoint; rows that are not ok or past n_valid are zero."""
    h, w = mod.shape
    n = x.shape[0]
    dev = x.device
    xi = torch.floor(x + 0.5).long()
    yi = torch.floor(y + 0.5).long()
    ok = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
    live = ok & (torch.arange(n, device=dev) < n_valid[0])
    xi_c = xi.clamp(0, w - 1)
    yi_c = yi.clamp(0, h - 1)
    hist = torch.zeros((n, n_bins), dtype=torch.float32, device=dev)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        img_x, img_y, inimg, offs = _window(h, w, xi_c[s:e], yi_c[s:e], radius)
        gx, gy = img_x.clamp(0, w - 1), img_y.clamp(0, h - 1)
        m = mod[gy, gx]
        a = ang[gy, gx]
        xc = x[s:e, None, None]
        yc = y[s:e, None, None]
        dx = (xi_c[s:e].float()[:, None, None] + offs[None, None, :]) - xc
        dy = (yi_c[s:e].float()[:, None, None] + offs[None, :, None]) - yc
        r2 = dx * dx + dy * dy
        sigmaw = winf * sigma[s:e, None, None]
        wr = torch.clamp(torch.floor(3.0 * sigmaw), min=1.0)
        sel = ((torch.abs(offs)[None, None, :] <= wr)
               & (torch.abs(offs)[None, :, None] <= wr) & inimg
               & (r2 < wr * wr + 0.6) & live[s:e, None, None])
        wgt = torch.exp(-r2 / (2.0 * (sigmaw * sigmaw)))
        mw = torch.where(sel, m * wgt, 0.0).reshape(e - s, -1)
        fbin = div(n_bins * a, TWO_PI).reshape(e - s, -1)
        b0 = torch.floor(fbin - 0.5)
        rbin = fbin - b0 - 0.5
        i1 = (b0.long() + n_bins) % n_bins
        i2 = (b0.long() + 1 + n_bins) % n_bins
        hc = hist[s:e]
        hc.scatter_add_(1, i1, mw * (1.0 - rbin))
        hc.scatter_add_(1, i2, mw * rbin)
    return hist, ok


def orientation_peaks(hist: torch.Tensor, ok: torch.Tensor, n_bins: int = 36,
                      max_angles: int = 4):
    """Histogram smoothing + peak extraction (sift.c:1000-1032).

    hist: [N, n_bins] raw histograms, ok: [N] acceptance. Six rounds of
    circular [1, 1, 1] / 3 smoothing in VLFeat's summation order, peaks
    above 0.8 of the maximum, quadratic interpolation, the first
    ``max_angles`` peaks in bin order. Returns (angles [N, max_angles],
    valid [N, max_angles])."""
    hs = hist
    for _ in range(6):
        hs = div(torch.roll(hs, 1, 1) + hs + torch.roll(hs, -1, 1), 3.0)
    hm = torch.roll(hs, 1, 1)     # hm[j] = hs[j - 1]
    hp = torch.roll(hs, -1, 1)    # hp[j] = hs[j + 1]
    hmax = hs.max(dim=1, keepdim=True).values
    is_peak = (hs > 0.8 * hmax) & (hs > hm) & (hs > hp)
    di = -0.5 * (hp - hm) / torch.where(is_peak, hp + hm - 2 * hs, 1.0)
    bins = torch.arange(n_bins, device=hist.device, dtype=torch.float32)
    th = div(TWO_PI * (bins[None, :] + di + 0.5), float(n_bins))
    rank = torch.cumsum(is_peak.int(), dim=1)
    keep = is_peak & (rank <= max_angles) & ok[:, None]
    order = torch.where(keep, rank - 1, max_angles + 1)
    angles, avalid = [], []
    for a in range(max_angles):
        sel = order == a
        angles.append(torch.where(sel, th, 0.0).sum(dim=1))
        avalid.append(sel.any(dim=1))
    return torch.stack(angles, dim=1), torch.stack(avalid, dim=1)


# ---------------------------------------------------------------- descriptor
def desc_patch_radius(sigma0: float, n_levels: int, s_max: int,
                      magnif: float = 3.0, nbp: int = 4,
                      is_level: int | None = None) -> int:
    """Static bound for the descriptor window radius
    floor(sqrt(2) * SBP * (NBP+1)/2 + 0.5) (sift.c:1310-1311)."""
    top = (s_max - 2) if is_level is None else is_level
    sn_max = min(float(s_max), top + 1.5)
    sigma_max = sigma0 * 2.0 ** (sn_max / n_levels)
    sbp = magnif * sigma_max
    return int(math.floor(math.sqrt(2.0) * sbp * (nbp + 1) / 2.0 + 0.5))


def descriptors(mod: torch.Tensor, ang: torch.Tensor, x: torch.Tensor,
                y: torch.Tensor, sigma: torch.Tensor, angle: torch.Tensor,
                n_valid: torch.Tensor, radius: int, magnif: float = 3.0,
                window_size: float = 2.0, nbp: int = 4, nbo: int = 8,
                chunk: int = 64):
    """SIFT descriptors — the plain version of kernel B3 (contract of
    ``sift_kernels.descriptors`` / ``pallas_sift.descriptors_pallas``).

    mod, ang: [H, W] gradient planes of one level; x, y, sigma, angle: [N]
    octave-local keypoint x angle lists, valid-prefix compacted; n_valid:
    [1]. Trilinear split into nbp x nbp x nbo bins under a Gaussian window,
    then normalise / clamp 0.2 / renormalise. Returns (desc [N, 128],
    ok [N]); rows not ok or past n_valid are zero."""
    h, w = mod.shape
    n = x.shape[0]
    dev = x.device
    nb = nbp * nbp * nbo
    xi = torch.floor(x + 0.5).long()
    yi = torch.floor(y + 0.5).long()
    # guard (sift.c:1321-1329): note the descriptor requires yi < h-1
    ok = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h - 1)
          & (torch.arange(n, device=dev) < n_valid[0]))
    xi_c = xi.clamp(0, w - 1)
    yi_c = yi.clamp(0, h - 1)
    centers = (torch.arange(nbp, device=dev, dtype=torch.float32)
               - nbp // 2 + 0.5)
    tbins = torch.arange(nbo, device=dev, dtype=torch.float32)
    out = torch.zeros((n, nb), dtype=torch.float32, device=dev)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        c = e - s
        img_x, img_y, _, offs = _window(h, w, xi_c[s:e], yi_c[s:e], radius)
        gx, gy = img_x.clamp(0, w - 1), img_y.clamp(0, h - 1)
        m = mod[gy, gx]
        a = ang[gy, gx]
        a0 = angle[s:e, None, None]
        st0 = torch.sin(a0)
        ct0 = torch.cos(a0)
        sbp = magnif * sigma[s:e, None, None] + EPSILON_D
        wr = torch.floor(div(math.sqrt(2.0) * sbp * (nbp + 1), 2.0) + 0.5)
        xf = xi_c[s:e].float()[:, None, None]
        yf = yi_c[s:e].float()[:, None, None]
        dxi = offs[None, None, :]
        dyi = offs[None, :, None]
        # pixel loop bounds (sift.c:1352-1357)
        sel = ((dxi >= torch.maximum(-wr, 1.0 - xf))
               & (dxi <= torch.minimum(wr, w - xf - 2.0))
               & (dyi >= torch.maximum(-wr, 1.0 - yf))
               & (dyi <= torch.minimum(wr, h - yf - 2.0)))
        theta = jmod(a - a0, TWO_PI)
        dx = xf + dxi - x[s:e, None, None]
        dy = yf + dyi - y[s:e, None, None]
        nx = (ct0 * dx + st0 * dy) / sbp
        ny = (-st0 * dx + ct0 * dy) / sbp
        nt = div(nbo * theta, TWO_PI)
        win = torch.exp(div(-(nx * nx + ny * ny),
                            2.0 * window_size * window_size))
        base = torch.where(sel, win * m, 0.0).reshape(c, -1)
        wx = torch.clamp(1.0 - torch.abs(nx.reshape(c, -1, 1) - centers),
                         min=0.0)
        wy = torch.clamp(1.0 - torch.abs(ny.reshape(c, -1, 1) - centers),
                         min=0.0)
        dt = torch.abs(nt.reshape(c, -1, 1) - tbins)
        dt = torch.minimum(dt, nbo - dt)
        wt = torch.clamp(1.0 - dt, min=0.0)
        z = (base[..., None] * wy)[..., :, None] * wx[..., None, :]
        d = torch.bmm(z.reshape(c, -1, nbp * nbp).transpose(1, 2), wt)
        out[s:e] = d.reshape(c, nb)
    norm1 = torch.sqrt(torch.sum(out * out, dim=1, keepdim=True)) + EPSILON_F
    d = torch.clamp(out / norm1, max=0.2)
    norm2 = torch.sqrt(torch.sum(d * d, dim=1, keepdim=True)) + EPSILON_F
    return torch.where(ok[:, None], d / norm2, 0.0), ok
