"""Multi-band (Laplacian pyramid) blending (counterpart of
``computervisionimagestich2_tpu.models.blender``).

blendTwoImages (ImageProcess.cpp:648-773): a vertical half-plane seam mask
from the mid-row overlap centroid, Gaussian pyramids (blur sigma 2 + CImg
half resize; the blur is the FIR Gaussian, or CImg's own recursive Van
Vliet filter with ``blur_impl="vanvliet"``) of the stacked [a | b | mask]
canvas, per-level
Laplacian masked lerp, and top-down reconstruction clamped to [0, 255].

The JAX package's default area gates are ported because they change the
output: bfloat16 pyramids above ``bf16_auto_area`` pixels, and above
``seam_auto_area`` pixels a seam-band blend of a 4*band-wide window with
rgb gain compensation.
"""
from __future__ import annotations

import math

import torch

from ..ops.gaussian import _conv1d_axis, gauss_taps, vanvliet_blur
from ..ops.resize import cimg_resize

AUTO_BF16_AREA = 1_500_000


def _blur_hwc(img: torch.Tensor, sigma: float,
              impl: str = "fir") -> torch.Tensor:
    """Blur [H, W, C] along W then H: the FIR Gaussian (the gaussian_blur
    order), or with ``impl="vanvliet"`` CImg's recursive Van Vliet filter
    (get_blur(2, true, true), ImageProcess.cpp:709)."""
    if impl == "vanvliet":
        return vanvliet_blur(img.movedim(-1, 0), sigma).movedim(0, -1)
    if impl != "fir":
        raise ValueError(f"unknown blur_impl {impl!r}")
    taps = gauss_taps(sigma)
    return _conv1d_axis(_conv1d_axis(img, taps, 1), taps, 0)


def n_levels(h: int, w: int, mode: str = "max") -> int:
    ext = max(w, h) if mode == "max" else min(w, h)
    return int(math.floor(math.log2(ext)))


def resolve_dtype(dtype: str, h: int, w: int,
                  area_threshold: int = AUTO_BF16_AREA) -> str:
    """The "auto" blend-precision policy: bf16 above ``area_threshold``
    pixels, f32 otherwise."""
    if dtype != "auto":
        return dtype
    return "bf16" if h * w > area_threshold else "f32"


def half_plane_mask(a: torch.Tensor, b: torch.Tensor,
                    content_h: int | torch.Tensor | None = None
                    ) -> torch.Tensor:
    """Vertical half-plane seam mask from the mid-row overlap centroid
    (ImageProcess.cpp:650-698). Returns [H, W] float32 {0, 1}: 1 where
    canvas ``a`` wins at pyramid level 0.

    ``content_h``: the content's rows on a padded canvas, whose mid row
    the seam reads; an int, or a tensor of one value on the canvases'
    device (the plan's content height, truncated there): its mid row is
    then picked with ``index_select``, clamped into the canvas as the JAX
    package's traced index is, and nothing is read back."""
    h, w = a.shape[0], a.shape[1]
    if isinstance(content_h, torch.Tensor):
        mid = (content_h.reshape(1).to(torch.int64) // 2).clamp(0, h - 1)
        row_a = a.index_select(0, mid)[0, :, 0]
        row_b = b.index_select(0, mid)[0, :, 0]
    else:
        mid = (h if content_h is None else content_h) // 2
        row_a = a[mid, :, 0]
        row_b = b[mid, :, 0]
    xs = torch.arange(w, device=a.device, dtype=torch.float32)
    a_nz = row_a != 0
    both_nz = a_nz & (row_b != 0)
    width_a = torch.clamp(a_nz.float().sum(), min=1.0)
    width_ov = torch.clamp(both_nz.float().sum(), min=1.0)
    ratio = torch.where(a_nz, xs, 0.0).sum() / width_a
    overlap_ratio = torch.where(both_nz, xs, 0.0).sum() / width_ov
    left_mask = (xs < overlap_ratio).float()
    right_mask = (xs >= torch.trunc(overlap_ratio + 1.0)).float()
    mask_row = torch.where(ratio < overlap_ratio, left_mask, right_mask)
    return mask_row[None, :].expand(h, w)


def blend_stacked(s0: torch.Tensor, levels: int, blur_sigma: float = 2.0,
                  blur_impl: str = "fir", dtype: str = "f32") -> torch.Tensor:
    """Pyramid blend of a stacked [H, W, 7] canvas (a | b | mask):
    downsweep (blur + halve), per-level Laplacian masked lerp, top-down
    reconstruction with clamping. dtype="bf16" runs the chain in bfloat16,
    with the FIR blur only (as in the JAX package)."""
    if dtype == "bf16":
        if blur_impl != "fir":
            raise ValueError("dtype='bf16' supports blur_impl='fir' only")
        s0 = s0.to(torch.bfloat16)
    elif dtype != "f32":
        raise ValueError(f"unknown blend dtype {dtype!r}")
    s_pyr = [s0]
    for _ in range(1, levels):
        hp = max(s_pyr[-1].shape[0] // 2, 1)
        wp = max(s_pyr[-1].shape[1] // 2, 1)
        s_pyr.append(cimg_resize(_blur_hwc(s_pyr[-1], blur_sigma, blur_impl),
                                 hp, wp))

    blend_pyr = []
    for i in range(levels):
        ab = s_pyr[i][..., :6]
        if i < levels - 1:
            ab = ab - cimg_resize(s_pyr[i + 1][..., :6], ab.shape[0],
                                  ab.shape[1])
        m = s_pyr[i][..., 6:7]
        blend_pyr.append(ab[..., :3] * m + ab[..., 3:6] * (1.0 - m))

    expand = blend_pyr[-1]
    for i in range(levels - 2, -1, -1):
        expand = cimg_resize(expand, blend_pyr[i].shape[0],
                             blend_pyr[i].shape[1])
        expand = torch.clamp(blend_pyr[i] + expand, 0.0, 255.0)
    return expand.float()


def seam_auto_engaged(bcfg, h: int, w: int) -> bool:
    """Does the area-gated automatic seam-band policy apply to an h x w
    blend canvas under this BlendConfig?"""
    return bool(bcfg.seam_band == 0 and bcfg.seam_auto_area
                and h * w > bcfg.seam_auto_area)


def apply_composite_gain(a: torch.Tensor, b: torch.Tensor, bcfg,
                         h: int, w: int) -> torch.Tensor:
    """Gain-compensate the incoming canvas ``a`` toward ``b`` when asked
    for, and always (per channel) when the seam-auto policy engages: a
    narrow seam band cannot hide exposure steps the full pyramid smears."""
    auto = seam_auto_engaged(bcfg, h, w)
    if not (bcfg.gain_compensation or auto):
        return a
    from .gain import gain_compensate

    return gain_compensate(
        a, b, bcfg.gain_mode if bcfg.gain_compensation else "rgb")


def blend_two_images(a: torch.Tensor, b: torch.Tensor,
                     level_mode: str = "max", blur_sigma: float = 2.0,
                     content_h: int | torch.Tensor | None = None,
                     dtype: str = "f32",
                     blur_impl: str = "fir") -> torch.Tensor:
    """Blend canvas a (the new warped image) over b (the previous result).
    Returns the blended float canvas (the caller truncates to u8)."""
    h, w = a.shape[0], a.shape[1]
    dtype = resolve_dtype(dtype, h, w)
    levels = n_levels(h, w, level_mode)
    mask0 = half_plane_mask(a, b, content_h)
    s0 = torch.cat([a, b, mask0[..., None]], dim=-1)
    return blend_stacked(s0, levels, blur_sigma, blur_impl, dtype)


def blend_seam_band(a: torch.Tensor, b: torch.Tensor, band: int,
                    level_mode: str = "max", blur_sigma: float = 2.0,
                    content_h: int | torch.Tensor | None = None,
                    dtype: str = "f32",
                    blur_impl: str = "fir") -> torch.Tensor:
    """Seam-band multi-band blend: pyramid-blend only a [H, 4*band] window
    centred on the half-plane seam and copy a / b elsewhere; only the
    central 2*band columns of the window are pasted back. The canvas is
    at least 4*band wide (``blend_plan`` gives a narrower one the full
    blend).

    The window's start column stays on the device (JAX's
    ``dynamic_slice_in_dim`` / ``dynamic_update_slice_in_dim``): the
    window is gathered with ``index_select`` and its centre pasted back
    with ``index_copy_``, so nothing is read back."""
    h, w = a.shape[0], a.shape[1]
    wb = 4 * band
    dtype = resolve_dtype(dtype, h, wb)
    mask0 = half_plane_mask(a, b, content_h)
    # seam column: the half-plane row has one transition; count the prefix
    # equal to its first value (either side's mask)
    mask_row = mask0[0]
    t = (mask_row == mask_row[0]).sum()
    s = torch.clamp(t - wb // 2, 0, w - wb)
    cols = torch.arange(wb, device=a.device) + s
    stacked = torch.cat([a, b, mask0[..., None]], dim=-1)
    win = stacked.index_select(1, cols)
    levels = max(1, min(n_levels(h, wb, level_mode),
                        int(math.log2(max(band // 8, 2)))))
    blended_win = blend_stacked(win, levels, blur_sigma, blur_impl, dtype)
    out = torch.where(mask0[..., None] == 1.0, a, b)
    return out.index_copy_(1, cols[band:3 * band],
                           blended_win[:, band:3 * band])


def blend_plan(bcfg, h: int, w: int) -> tuple[int, str]:
    """What ``blend_edge`` runs on an h x w canvas under this BlendConfig:
    (band, dtype), band 0 for the full-canvas pyramid, else the seam-band
    window of ``blend_seam_band`` (explicit ``seam_band`` or the area
    gate), with the "auto" precision policy resolved against
    ``bf16_auto_area``. A canvas narrower than the window takes the full
    blend at the window's precision."""
    thr = bcfg.bf16_auto_area
    band = bcfg.seam_band
    if band == 0 and seam_auto_engaged(bcfg, h, w):
        band = bcfg.seam_auto_band
    if band == 0:
        return 0, resolve_dtype(bcfg.dtype, h, w, thr)
    dt = resolve_dtype(bcfg.dtype, h, min(4 * band, w), thr)
    # the window keeps the full-canvas policy's choice, so the gate
    # cannot flip a big canvas back to f32
    if (bcfg.seam_band == 0 and bcfg.dtype == "auto"
            and resolve_dtype("auto", h, w, thr) == "bf16"):
        dt = "bf16"
    return (band if 4 * band <= w else 0), dt


def blend_mode(bcfg, h: int, w: int) -> str:
    """The blend ``blend_edge`` runs on an h x w canvas, by name: "band"
    (the seam-band window) or the full canvas in "f32" or "bf16"."""
    band, dtype = blend_plan(bcfg, h, w)
    return "band" if band else dtype


def blend_edge(a: torch.Tensor, b: torch.Tensor, bcfg,
               content_h: int | torch.Tensor | None = None) -> torch.Tensor:
    """Config-driven blend: the reference's full-canvas pyramid, or the
    seam-band window, as ``blend_plan`` resolves them. The gates read the
    canvas's shape; ``content_h`` (``half_plane_mask``) only moves the
    seam row."""
    band, dt = blend_plan(bcfg, int(a.shape[0]), int(a.shape[1]))
    if band > 0:
        return blend_seam_band(a, b, band, bcfg.level_mode, bcfg.blur_sigma,
                               content_h, dt, bcfg.blur_impl)
    return blend_two_images(a, b, bcfg.level_mode, bcfg.blur_sigma,
                            content_h, dt, bcfg.blur_impl)
