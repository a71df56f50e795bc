"""Row-sharded composite and multi-band blend (counterpart of
``computervisionimagestich2_tpu.parallel.blend``).

The SAME pyramid blend as ``models.blender.blend_two_images``, with the
canvas rows sharded over a mesh axis: each stripe lives on its device
(``mesh.py``: a list of stripes, one controller), and the only traffic
between stripes is the filter / resize halo taken from the row neighbours.

Per pyramid level the H-direction ops need neighbour rows:

  blur      radius-r taps        -> r rows from above and below (the end
                                    stripes replicate their own border,
                                    VL_PAD_BY_CONTINUITY)
  shrink/2  band-B CImg average  -> B rows from below (global zero pad)
  enlarge x2 3-tap CImg lerp     -> 1 row above, 2 below (global zero pad)

W-direction ops touch only local columns. Levels stay sharded while a
stripe can host a single-hop halo (stripe >= blur radius) and the halved
height still splits evenly (H % 2n == 0); the small deep tail is gathered
once per distinct device and finished there with the single-device
``blend_stacked``. The stitch edge's composite (``sharded_composite``)
needs no halo: each stripe inverse-warps (kernel B6 on CUDA) and copies
its own rows of the replicated sources, its row offset folded into the
offsets.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..models.blender import (blend_stacked, half_plane_mask, n_levels,
                              resolve_dtype)
from ..ops.gaussian import _conv1d_axis, gauss_taps
from ..ops.resize import _banded_weights, _resize_axis1, _resize_weights
from ..ops.warp import _host_coeffs, shift_image, warp_image
from .mesh import Mesh, shard_rows, to_device


def _halo_above(xs: list[torch.Tensor], k: int,
                zero_edge: bool) -> list[torch.Tensor]:
    """For each stripe, k halo rows from the stripe above (moved to its
    device); the top stripe sees zeros (resize out-of-range) or its own
    replicated edge (blur continuity)."""
    out = []
    for i, x in enumerate(xs):
        if i > 0:
            out.append(to_device(xs[i - 1][-k:], x.device))
        elif zero_edge:
            out.append(x.new_zeros((k,) + tuple(x.shape[1:])))
        else:
            out.append(x[:1].expand((k,) + tuple(x.shape[1:])))
    return out


def _halo_below(xs: list[torch.Tensor], k: int,
                zero_edge: bool) -> list[torch.Tensor]:
    """As ``_halo_above``, from the stripe below; the bottom stripe sees
    zeros or its own last row."""
    n = len(xs)
    out = []
    for i, x in enumerate(xs):
        if i < n - 1:
            out.append(to_device(xs[i + 1][:k], x.device))
        elif zero_edge:
            out.append(x.new_zeros((k,) + tuple(x.shape[1:])))
        else:
            out.append(x[-1:].expand((k,) + tuple(x.shape[1:])))
    return out


def _halo_blur(xs: list[torch.Tensor], taps: np.ndarray) -> list[torch.Tensor]:
    """Separable FIR blur of stripes [H_loc, W, C]: W pass local, H pass
    over a 2r-row halo, the taps in x's dtype summed term by term in tap
    order: the values of ``models.blender._blur_hwc``."""
    r = (taps.shape[0] - 1) // 2
    xw = [_conv1d_axis(x, taps, 1) for x in xs]
    above = _halo_above(xw, r, zero_edge=False)
    below = _halo_below(xw, r, zero_edge=False)
    out = []
    for x, up, down in zip(xw, above, below):
        ext = torch.cat([up, x, down], dim=0)
        t = torch.as_tensor(taps).to(device=x.device, dtype=x.dtype)
        h_loc = x.shape[0]
        acc = None
        for j in range(taps.shape[0]):
            term = t[j] * ext[j:j + h_loc]
            acc = term if acc is None else acc + term
        out.append(acc)
    return out


def _halo_shrink_rows(xs: list[torch.Tensor],
                      w_stripes: list[torch.Tensor]) -> list[torch.Tensor]:
    """CImg half-shrink along the rows of stripes [2m, W, C] -> [m, W, C].

    w_stripes: each stripe's rows of the global banded shrink weights
    (ops.resize._banded_weights, idx0[t] == 2t for exact halving). The
    bottom stripe's out-of-range taps read zeros, the global zero pad of
    ops.resize._shrink_half_axis1."""
    band = w_stripes[0].shape[1]
    below = _halo_below(xs, band, zero_edge=True)
    out = []
    for x, down, w in zip(xs, below, w_stripes):
        ext = torch.cat([x, down], dim=0)
        m = x.shape[0] // 2
        acc = None
        for b in range(band):
            wk = w[:, b].reshape((m,) + (1,) * (x.dim() - 1))
            term = ext[b: b + 2 * m: 2] * wk
            acc = term if acc is None else acc + term
        out.append(acc)
    return out


def _enlarge2_parity_weights(n_src: int):
    """Per-parity banded weights for the x2 CImg enlarge (n_dst = 2*n_src):
    output row 2t+p reads source rows t-1..t+1 with weights from
    ops.resize._resize_weights; out-of-range taps are zero."""
    dense = _resize_weights(n_src, 2 * n_src)
    ws = []
    for p in (0, 1):
        rows = dense[p::2]
        w = np.zeros((n_src, 3), np.float32)
        for t in range(n_src):
            for b in range(3):
                j = t - 1 + b
                if 0 <= j < n_src:
                    w[t, b] = rows[t, j]
        ws.append(w)
    return ws


def _enlarge_rows_from_ext(ext: torch.Tensor, w0: torch.Tensor,
                           w1: torch.Tensor) -> torch.Tensor:
    """x2 row enlarge given the pre-extended source ext [m+3, W, C] (1
    pad/halo row above, m stripe rows, 2 below) and the stripe's
    per-parity weights [m, 3]. Returns [2m, W, C]."""
    m = w0.shape[0]
    halves = []
    for w in (w0, w1):
        acc = None
        for b in range(3):
            wk = w[:, b].reshape((m,) + (1,) * (ext.dim() - 1))
            term = ext[b:b + m] * wk
            acc = term if acc is None else acc + term
        halves.append(acc)
    inter = torch.stack(halves, dim=1)
    return inter.reshape((2 * m,) + tuple(ext.shape[1:]))


def _halo_enlarge_rows(xs: list[torch.Tensor], w0s, w1s) -> list[torch.Tensor]:
    """x2 row enlarge of sharded stripes: 1 halo row above, 2 below."""
    above = _halo_above(xs, 1, zero_edge=True)
    below = _halo_below(xs, 2, zero_edge=True)
    return [_enlarge_rows_from_ext(torch.cat([up, x, down], dim=0), w0, w1)
            for x, up, down, w0, w1 in zip(xs, above, below, w0s, w1s)]


def _stripe_ext_of_replicated(full: torch.Tensor,
                              n: int) -> list[torch.Tensor]:
    """The [m+3, W, C] extended source of each of n stripes' enlarge, cut
    out of a replicated [H, W, C] level (the sharded / replicated pyramid
    boundary): global zero pad (1, 2), then each stripe's window (views of
    one padded copy)."""
    m = full.shape[0] // n
    zeros = full.new_zeros((3,) + tuple(full.shape[1:]))
    padded = torch.cat([zeros[:1], full, zeros[1:]], dim=0)
    return [padded[idx * m: idx * m + m + 3] for idx in range(n)]


def plan_shard_levels(h: int, levels: int, n: int, blur_sigma: float) -> int:
    """How many leading pyramid levels can run row-sharded over n devices:
    a stripe must host a single-hop blur halo (H/n >= radius) and the
    halved height must still split evenly (H % 2n == 0)."""
    r = (gauss_taps(blur_sigma).shape[0] - 1) // 2
    L, cur = 0, h
    while L < levels - 1 and cur % (2 * n) == 0 and cur // n >= max(r, 2):
        L += 1
        cur //= 2
    return L


def _stripes(x, devices) -> list[torch.Tensor]:
    """A row-sharded array as its stripes: a list of stripes as given, or
    a whole [H, ...] tensor split over ``devices``."""
    if isinstance(x, torch.Tensor):
        return shard_rows(x, devices)
    xs = list(x)
    if len(xs) != len(devices) or len({s.shape for s in xs}) != 1:
        raise ValueError(f"expected {len(devices)} stripes of one shape, got "
                         f"{[tuple(s.shape) for s in xs]}")
    return [to_device(s, d) for s, d in zip(xs, devices)]


def sharded_composite(src_img: torch.Tensor, result_img: torch.Tensor,
                      backward_coeffs, min_x: float, min_y: float,
                      canvas_hw: tuple[int, int], mesh: Mesh,
                      axis_name: str = "sp", model: str = "bilinear"):
    """Row-sharded stitch-edge composite (``compose.composite`` over the
    mesh).

    Returns (a, b), each a list of [H/n, W, 3] stripes, stripe i on the
    axis's device i: a = src_img inverse-warped through backward_coeffs
    (kernel B6 per stripe on CUDA), b = the previous result shifted by the
    truncated offsets (ImageProcess.cpp:218-224). Both are backward maps
    of replicated sources, so each stripe is computed alone with its row
    offset folded into offset_y: in float32, min_y + idx * m, as the JAX
    body adds it (``parallel/blend.py:187`` there). Feed the outputs to
    ``sharded_blend_two_images``."""
    h, w = canvas_hw
    n = mesh.shape[axis_name]
    if h % n:
        raise ValueError(f"canvas H={h} not divisible by {n} devices")
    m = h // n
    coeffs = _host_coeffs(backward_coeffs, model)
    oy = np.float32(min_y)
    a, b, src, res = [], [], {}, {}
    for idx, dev in enumerate(mesh.axis_devices(axis_name)):
        row0 = idx * m
        if dev not in src:  # the replicated sources, once per device
            src[dev] = to_device(src_img, dev)
            res[dev] = to_device(result_img, dev)
        a.append(warp_image(src[dev], coeffs, min_x, oy + np.float32(row0),
                            (m, w), model))
        b.append(shift_image(res[dev], int(min_x), int(min_y) + row0, (m, w)))
    return a, b


def sharded_composite_and_blend(src_img: torch.Tensor,
                                result_img: torch.Tensor, backward_coeffs,
                                min_x: float, min_y: float,
                                canvas_hw: tuple[int, int], mesh: Mesh,
                                axis_name: str = "sp",
                                model: str = "bilinear",
                                level_mode: str = "max",
                                blur_sigma: float = 2.0,
                                content_h: int | None = None,
                                dtype: str = "f32") -> list[torch.Tensor]:
    """One stitch edge, composite + multi-band blend, with the canvas rows
    sharded end to end (``sharded_composite``, then
    ``sharded_blend_two_images``). Returns the blended stripes; equals
    ``compose.composite`` + ``blend_two_images`` to f32 round-off."""
    a, b = sharded_composite(src_img, result_img, backward_coeffs,
                             min_x, min_y, canvas_hw, mesh, axis_name, model)
    return sharded_blend_two_images(a, b, mesh, axis_name, level_mode,
                                    blur_sigma, content_h, dtype)


def sharded_blend_two_images(a, b, mesh: Mesh, axis_name: str = "sp",
                             level_mode: str = "max",
                             blur_sigma: float = 2.0,
                             content_h: int | None = None,
                             dtype: str = "f32") -> list[torch.Tensor]:
    """``blend_two_images`` with canvas rows sharded over
    ``mesh[axis_name]``.

    a, b: [H, W, 3] float32 u8-valued canvases, as whole tensors or as
    lists of stripes (``sharded_composite``'s outputs). The leading
    ``plan_shard_levels`` pyramid levels run as stripes with halo
    exchanges; the deep tail is gathered once per distinct device and
    finished there (``blend_stacked``). Returns the blended float32
    stripes, stripe i on the axis's device i; equal to the single-device
    blend to f32 round-off. Raises if H does not admit even sharding.
    ``dtype="bf16"`` runs the stripes, halos and the gathered tail in
    bfloat16. ``"auto"`` resolves against the default 1.5 Mpx, not a
    configured ``bf16_auto_area``, as in the JAX package."""
    devices = mesh.axis_devices(axis_name)
    n = len(devices)
    first = a if isinstance(a, torch.Tensor) else a[0]
    h = int(first.shape[0]) * (1 if isinstance(a, torch.Tensor) else len(a))
    w = int(first.shape[1])
    dtype = resolve_dtype(dtype, h, w)
    if dtype not in ("f32", "bf16"):
        raise ValueError(f"unknown blend dtype {dtype!r}")
    levels = n_levels(h, w, level_mode)
    L = plan_shard_levels(h, levels, n, blur_sigma)
    if L == 0:
        raise ValueError(
            f"H={h} not row-shardable over {n} devices "
            f"(needs H % {2 * n} == 0 and H//{n} >= blur radius)")
    a_s, b_s = _stripes(a, devices), _stripes(b, devices)
    m = h // n

    # the seam mask's row comes from the stripe that holds the mid row
    mid = (h if content_h is None else int(content_h)) // 2
    k, r = divmod(mid, m)
    mask_row = half_plane_mask(a_s[k][r:r + 1], b_s[k][r:r + 1])[0]
    stacked = [torch.cat([x, y, to_device(mask_row, x.device).expand(m, w)
                          [..., None]], dim=-1)
               for x, y in zip(a_s, b_s)]
    ws_, shr, enl = _blend_program(mesh, axis_name, h, w, levels, L,
                                   blur_sigma)
    taps = gauss_taps(blur_sigma)
    if dtype == "bf16":
        # reduced-precision stripes: the weight tables are cast alongside,
        # so promotion does not pull the chain back to f32
        bf = torch.bfloat16
        stacked = [s.to(bf) for s in stacked]
        shr = [[x.to(bf) for x in lvl] for lvl in shr]
        enl = [([x.to(bf) for x in w0s], [x.to(bf) for x in w1s])
               for w0s, w1s in enl]
    sdt = stacked[0].dtype

    # sharded downsweep: blur (H halo) -> W halve (local) -> H halve
    # (halo), the op order of blend_stacked's cimg_resize(_blur_hwc())
    s_loc = [stacked]
    for i in range(L):
        blurred = _halo_blur(s_loc[-1], taps)
        wsh = [_resize_axis1(x, ws_[i + 1]) for x in blurred]
        s_loc.append(_halo_shrink_rows(wsh, shr[i]))

    # replicated deep tail: level L gathered once per distinct device, the
    # levels L..levels-1 by the single-device blend_stacked
    full_l, tail = {}, {}
    for dev in dict.fromkeys(devices):
        full_l[dev] = torch.cat([to_device(x, dev) for x in s_loc[L]])
        tail[dev] = blend_stacked(full_l[dev], levels - L,
                                  blur_sigma=blur_sigma, dtype=dtype,
                                  blur_impl="fir").to(sdt)

    # sharded upsweep: laplacian + masked lerp + reconstruct per level
    expand = None
    for i in range(L - 1, -1, -1):
        w0s, w1s = enl[i]
        if i == L - 1:
            ext6 = {d: _stripe_ext_of_replicated(
                _resize_axis1(f[..., :6], ws_[i]), n)
                for d, f in full_l.items()}
            extx = {d: _stripe_ext_of_replicated(
                _resize_axis1(t, ws_[i]), n) for d, t in tail.items()}
            up6 = [_enlarge_rows_from_ext(ext6[d][j], w0s[j], w1s[j])
                   for j, d in enumerate(devices)]
            upx = [_enlarge_rows_from_ext(extx[d][j], w0s[j], w1s[j])
                   for j, d in enumerate(devices)]
        else:
            up6 = _halo_enlarge_rows(
                [_resize_axis1(s[..., :6], ws_[i]) for s in s_loc[i + 1]],
                w0s, w1s)
            upx = _halo_enlarge_rows(
                [_resize_axis1(e, ws_[i]) for e in expand], w0s, w1s)
        expand = []
        for s, u6, ux in zip(s_loc[i], up6, upx):
            lap = s[..., :6] - u6
            msk = s[..., 6:7]
            blended = lap[..., :3] * msk + lap[..., 3:6] * (1.0 - msk)
            expand.append(torch.clamp(blended + ux, 0.0, 255.0))
    return [e.float() for e in expand]


@lru_cache(maxsize=64)
def _blend_program(mesh: Mesh, axis_name: str, h: int, w: int, levels: int,
                   L: int, blur_sigma: float):
    """The level widths and per-stripe weight tables of a sharded blend,
    keyed on the static geometry (the JAX package caches its jitted SPMD
    program and these operands on the same key): the widths of every
    level; per sharded level, each stripe's rows of the banded shrink
    weights [H_{i+1} / n, B] and of the two parity enlarge weights
    [H_{i+1} / n, 3], float32, on the stripe's device. Level i sharded
    requires H_i % 2n == 0, so every table splits evenly."""
    devices = mesh.axis_devices(axis_name)
    hs, ws_ = [h], [w]
    for _ in range(1, levels):
        hs.append(max(hs[-1] // 2, 1))
        ws_.append(max(ws_[-1] // 2, 1))
    shrink, enlarge = [], []
    for i in range(L):
        idx0, wmat = _banded_weights(hs[i], hs[i + 1])
        assert (idx0 == 2 * np.arange(hs[i + 1])).all()
        shrink.append(tuple(shard_rows(torch.from_numpy(wmat), devices)))
        w0, w1 = _enlarge2_parity_weights(hs[i + 1])
        enlarge.append((tuple(shard_rows(torch.from_numpy(w0), devices)),
                        tuple(shard_rows(torch.from_numpy(w1), devices))))
    return tuple(ws_), tuple(shrink), tuple(enlarge)
