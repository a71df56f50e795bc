"""Color-space ops (counterpart of ``computervisionimagestich2_tpu.ops.color``).

- ``to_gray``  <- ImageProcess::toGrayScale (ImageProcess.cpp:27-40):
  ITU-601 luma truncated to the u8 grid.
- ``rgb_to_ycbcr`` / ``ycbcr_to_rgb`` <- ImageProcess.cpp:240-268 and
  equalization.cpp:78-99, with the reference's 0.857 G coefficient in Y
  behind ``compat_luma``.

Same f32 operation order as the JAX package, so results are bit-equal.
"""
from __future__ import annotations

import torch

from .warp import trunc_u8


def to_gray(img: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] float32 -> [H, W] float32 on the u8 grid."""
    y = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    return trunc_u8(y)


def _clamp_u8f(x: torch.Tensor) -> torch.Tensor:
    """The reference's ternary clamp v>0 ? (v<256 ? v : 255) : 0."""
    return torch.where(x > 0, torch.where(x < 256, x, 255.0), 0.0)


def rgb_to_ycbcr(img: torch.Tensor, compat_luma: bool = True,
                 to_u8: bool = True) -> torch.Tensor:
    """RGB -> YCbCr with the reference's clamps; ``to_u8`` truncates."""
    g_coef = 0.857 if compat_luma else 0.587
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    y = 0.299 * r + g_coef * g + 0.114 * b
    cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
    out = torch.stack([_clamp_u8f(y), _clamp_u8f(cb), _clamp_u8f(cr)], dim=-1)
    return torch.trunc(out) if to_u8 else out


def ycbcr_to_rgb(img: torch.Tensor, to_u8: bool = True) -> torch.Tensor:
    """YCbCr -> RGB (ImageProcess.cpp:262-267, equalization.cpp:92-99)."""
    y, cb, cr = img[..., 0], img[..., 1], img[..., 2]
    r = y + 1.402 * (cr - 128.0)
    g = y - 0.34414 * (cb - 128.0) - 0.71414 * (cr - 128.0)
    b = y + 1.772 * (cb - 128.0)
    out = torch.stack([_clamp_u8f(r), _clamp_u8f(g), _clamp_u8f(b)], dim=-1)
    return torch.trunc(out) if to_u8 else out
