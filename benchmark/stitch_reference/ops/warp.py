"""Warp / sampling ops (counterpart of ``computervisionimagestich2_tpu.ops.warp``).

- ``gather_pixels``       img[yi, xi] on integer indices
- ``bilinear_sample``     <- Projection::bilinearInterpolation (Projection.cpp:3-18)
- ``cylindrical_project`` <- Projection::imageProjection (Projection.cpp:20-73),
  with the semantics of the JAX package's gather oracle
  ``_cylindrical_project_gather`` (the banded MXU form exists for the TPU)
- ``warp_xy`` / ``warp_points`` <- getX/YAfterWarping (ImageProcess.cpp:465-471)
- ``projective_xy``       the 3x3 homography of ``warp_model="projective"``
- ``warp_image``          <- warpingImageByHomography (ImageProcess.cpp:596-606):
  kernel B6 (``csrc/warp.cu``) on a CUDA tensor, ``warp_image_plain`` on a
  CPU tensor, for both warp models; the model and offsets as host floats
  (by value) or as device tensors (read by the kernel from device memory)
- ``shift_image``         <- movingImageByOffset (ImageProcess.cpp:608-620),
  with Python-int offsets or device ones (JAX's traced offsets)

Images are [H, W, C] float32 (values 0..255). Coefficients are the
reference's 8-coefficient bilinear warp [w11, w12, w13, w21, w22, w23, w31,
w32]: x' = w11 x + w12 y + w13 x y + w21, y' = w22 x + w23 y + w31 x y + w32;
or, with ``model="projective"``, a row-major 3x3 homography as 9 floats.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from .fp import rdiv


def gather_pixels(img: torch.Tensor, xi: torch.Tensor,
                  yi: torch.Tensor) -> torch.Tensor:
    """img[yi, xi] for integer index tensors. img: [H, W, C] or [H, W]."""
    return img[yi, xi]


def bilinear_sample(img: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample with the reference's corner/clamp semantics:
    x_floor = floor(x), x_ceil = min(ceil(x), W-1) (same for y). Returns
    [..., C], un-truncated."""
    h, w = img.shape[0], img.shape[1]
    xf = torch.floor(x)
    yf = torch.floor(y)
    xc = torch.clamp(torch.ceil(x), max=w - 1)
    yc = torch.clamp(torch.ceil(y), max=h - 1)
    a = (x - xf)[..., None]
    b = (y - yf)[..., None]
    xf_i = xf.long().clamp(0, w - 1)
    yf_i = yf.long().clamp(0, h - 1)
    xc_i = xc.long().clamp(0, w - 1)
    yc_i = yc.long().clamp(0, h - 1)
    p00 = img[yf_i, xf_i]
    p10 = img[yf_i, xc_i]
    p11 = img[yc_i, xc_i]
    p01 = img[yc_i, xf_i]
    return ((1 - a) * (1 - b) * p00 + a * (1 - b) * p10
            + a * b * p11 + (1 - a) * b * p01)


def trunc_u8(x: torch.Tensor) -> torch.Tensor:
    """C-style float -> unsigned char: truncation toward zero, clamped."""
    return torch.clamp(torch.trunc(x), 0.0, 255.0)


def cylindrical_project(img: torch.Tensor,
                        angle_deg: float = 15.0) -> torch.Tensor:
    """Cylindrical projection, backward map (Projection.cpp:20-73),
    including the integer-division centers and the landscape axis swap.
    img: [H, W, C] float32; returns the same shape, zero outside the
    source, truncated to the u8 grid."""
    src_h, src_w = img.shape[0], img.shape[1]
    flag = src_w > src_h  # landscape -> swapped axes (Projection.cpp:24)
    width = src_h if flag else src_w
    height = src_w if flag else src_h
    half_w = width // 2
    half_h = height // 2
    r = (width / 2.0) / math.tan(angle_deg * math.pi / 180.0)

    ys = torch.arange(src_h, device=img.device, dtype=torch.int32)[:, None]
    xs = torch.arange(src_w, device=img.device, dtype=torch.int32)[None, :]
    ys, xs = torch.broadcast_tensors(ys, xs)
    if flag:
        dst_x = (ys - half_w).float()
        dst_y = (xs - half_h).float()
    else:
        dst_x = (xs - half_w).float()
        dst_y = (ys - half_h).float()
    k = rdiv(r, torch.sqrt(r * r + dst_x * dst_x))
    sx = dst_x / k + half_w
    sy = dst_y / k + half_h
    if flag:
        valid = (sx >= 0) & (sx < src_h) & (sy >= 0) & (sy < src_w)
        sample_x, sample_y = sy, sx
    else:
        valid = (sx >= 0) & (sx < src_w) & (sy >= 0) & (sy < src_h)
        sample_x, sample_y = sx, sy
    out = trunc_u8(bilinear_sample(img, sample_x, sample_y))
    return torch.where(valid[..., None], out, 0.0)


def warp_xy(coeffs: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Apply the 8-coefficient bilinear warp; returns (x', y')."""
    c = coeffs
    xw = c[0] * x + c[1] * y + c[2] * x * y + c[3]
    yw = c[4] * x + c[5] * y + c[6] * x * y + c[7]
    return xw, yw


def projective_xy(coeffs: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Apply a row-major 3x3 homography stored as 9 coefficients (the
    JAX package's ``projective_xy``): a denominator within 1e-12 of 0
    becomes 1e-12."""
    c = coeffs
    den = c[6] * x + c[7] * y + c[8]
    den = torch.where(torch.abs(den) < 1e-12, 1e-12, den)
    return ((c[0] * x + c[1] * y + c[2]) / den,
            (c[3] * x + c[4] * y + c[5]) / den)


N_COEFFS = {"bilinear": 8, "projective": 9}


def warp_points(coeffs: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                model: str = "bilinear"):
    """Model-dispatching point warp: 'bilinear' (8 coefficients, the
    reference) or 'projective' (9). ``coeffs`` may carry trailing batch
    dims ([8, K, 1] warps every point under K hypotheses)."""
    if model == "bilinear":
        return warp_xy(coeffs, x, y)
    if model == "projective":
        return projective_xy(coeffs, x, y)
    raise ValueError(f"unknown warp model {model!r}")


def warp_image_plain(src: torch.Tensor, coeffs: torch.Tensor,
                     offset_x: float, offset_y: float,
                     out_shape: tuple[int, int],
                     model: str = "bilinear") -> torch.Tensor:
    """Plain PyTorch version of kernel B6: for each canvas pixel (x, y),
    (nx, ny) = trunc(warp(x + ox, y + oy)) under ``model``; copy
    src[ny, nx] where in bounds, else 0."""
    h, w = out_shape
    src_h, src_w = src.shape[0], src.shape[1]
    dev = src.device
    ys = torch.arange(h, device=dev, dtype=torch.float32)[:, None].expand(h, w)
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, :].expand(h, w)
    ox, oy = (_as_tensor(o, dev).to(torch.float32)
              for o in (offset_x, offset_y))
    xw, yw = warp_points(coeffs, xs + ox, ys + oy, model)
    tx = torch.trunc(xw)
    ty = torch.trunc(yw)
    # float-domain bounds: the int test for finite values, False for NaN
    valid = (tx >= 0) & (tx < src_w) & (ty >= 0) & (ty < src_h)
    nx = torch.where(valid, tx, 0.0).long()
    ny = torch.where(valid, ty, 0.0).long()
    return torch.where(valid[..., None], src[ny, nx], 0.0)


def _host_coeffs(coeffs: torch.Tensor | Sequence[float],
                 model: str) -> np.ndarray:
    """The model's coefficients as a float32 numpy vector: a tensor
    (float32, on any device) is read back once; host floats are rounded to
    float32, the type the model is evaluated in."""
    if isinstance(coeffs, torch.Tensor):
        if coeffs.dtype != torch.float32:
            raise TypeError(f"warp_image.coeffs: expected torch.float32, got "
                            f"{coeffs.dtype}")
        coeffs = coeffs.detach().cpu().numpy()
    c = np.asarray(coeffs, dtype=np.float32)
    if c.shape != (N_COEFFS[model],):
        raise ValueError(f"warp_image.coeffs: {model} takes "
                         f"{N_COEFFS[model]} coefficients, got shape "
                         f"{c.shape}")
    return c


def warp_image(src: torch.Tensor, coeffs: torch.Tensor | Sequence[float],
               offset_x, offset_y, out_shape: tuple[int, int],
               model: str = "bilinear") -> torch.Tensor:
    """Inverse-warp src [H, W, C] float32 onto a fresh [h, w, C] canvas.

    Kernel B6 on a CUDA tensor; ``warp_image_plain`` on a CPU tensor.
    ``coeffs``: the backward model (8 floats for ``model="bilinear"``, 9
    for "projective"), as host floats or as a float32 tensor. The offsets
    (the plan's canvas minima): host floats, or float32 tensors of one
    value with the model a tensor too. On the card, when the model and
    both offsets are tensors there (the programs hand over the plan's
    rows), the kernel reads them from device memory and nothing is read
    back; with host offsets they travel by value, and a model given as a
    tensor is read back once."""
    if model not in N_COEFFS:
        raise ValueError(f"unknown warp model {model!r}")
    if not isinstance(coeffs, torch.Tensor):
        coeffs = torch.from_numpy(_host_coeffs(coeffs, model))
    return warp_image_plain(src, coeffs.to(src.device), offset_x, offset_y,
                            out_shape, model)


def _as_tensor(v, device) -> torch.Tensor:
    """A one-value offset as a 0-dim tensor on ``device``: a tensor as it
    is (moved if it lies elsewhere), a host number uploaded."""
    if isinstance(v, torch.Tensor):
        return v.reshape(()).to(device=device)
    return torch.tensor(v, device=device)


def _shift_index(offset: torch.Tensor, n_out: int, n_src: int,
                 device) -> tuple[torch.Tensor, torch.Tensor]:
    """Along one axis: the source index of each of ``n_out`` outputs, at
    the device offset truncated toward zero (``int()``, JAX's ``astype``),
    clamped into the source, and whether it lay inside it."""
    idx = (torch.arange(n_out, device=device)
           + offset.to(torch.int32).to(torch.int64))
    inside = (idx >= 0) & (idx < n_src)
    return idx.clamp(0, n_src - 1), inside


def shift_image(src: torch.Tensor, offset_x, offset_y,
                out_shape: tuple[int, int]) -> torch.Tensor:
    """Offset copy without interpolation: out[y, x] = src[y + oy, x + ox]
    where in bounds, else 0 (movingImageByOffset; integer offsets are the
    truncated canvas minima, ImageProcess.cpp:224).

    The offsets are Python ints (the copy is a slice), or tensors of one
    value on the source's device, truncated there (the canvas minima as
    the plan holds them): then the rows and columns are gathered with
    ``index_select`` and the outside masked, as the JAX package's dynamic
    slice does, with nothing read back."""
    h, w = out_shape
    if isinstance(offset_x, torch.Tensor) or isinstance(offset_y,
                                                        torch.Tensor):
        rows, rin = _shift_index(_as_tensor(offset_y, src.device), h,
                                 src.shape[0], src.device)
        cols, cin = _shift_index(_as_tensor(offset_x, src.device), w,
                                 src.shape[1], src.device)
        out = src.index_select(0, rows).index_select(1, cols)
        inside = (rin[:, None] & cin[None, :]).reshape(
            (h, w) + (1,) * (src.dim() - 2))
        return out.masked_fill(~inside, 0)
    src_h, src_w = src.shape[0], src.shape[1]
    out = src.new_zeros((h, w) + tuple(src.shape[2:]))
    oy, ox = int(offset_y), int(offset_x)
    y0, y1 = max(0, -oy), min(h, src_h - oy)
    x0, x1 = max(0, -ox), min(w, src_w - ox)
    if y1 > y0 and x1 > x0:
        out[y0:y1, x0:x1] = src[y0 + oy:y1 + oy, x0 + ox:x1 + ox]
    return out
