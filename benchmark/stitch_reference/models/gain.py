"""Gain compensation (counterpart of
``computervisionimagestich2_tpu.models.gain``).

Scales the incoming warped canvas so its overlap mean matches the existing
canvas: one scalar gain from ITU-601 luma means ("luma"), or one gain per
channel ("rgb"). The seam-band blend forces "rgb" on above its area gate
(models/blender.py::apply_composite_gain).
"""
from __future__ import annotations

import torch


def gain_compensate(a: torch.Tensor, b: torch.Tensor,
                    mode: str = "luma") -> torch.Tensor:
    """Scale canvas a [H, W, 3] (0..255, zeros = empty) so its mean over
    the overlap (both lumas > 0) matches b's; the gain is clamped to
    [0.5, 2]. Returns the adjusted a."""
    if mode not in ("luma", "rgb"):
        raise ValueError(f"unknown gain mode {mode!r}")
    luma_a = 0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2]
    luma_b = 0.299 * b[..., 0] + 0.587 * b[..., 1] + 0.114 * b[..., 2]
    overlap = (luma_a > 0) & (luma_b > 0)
    n = torch.clamp(overlap.float().sum(), min=1.0)
    if mode == "rgb":
        mean_a = torch.where(overlap[..., None], a, 0.0).sum(dim=(0, 1)) / n
        mean_b = torch.where(overlap[..., None], b, 0.0).sum(dim=(0, 1)) / n
    else:
        mean_a = torch.where(overlap, luma_a, 0.0).sum() / n
        mean_b = torch.where(overlap, luma_b, 0.0).sum() / n
    gain = torch.where((mean_a > 1.0) & (mean_b > 1.0),
                       mean_b / torch.clamp(mean_a, min=1e-3), 1.0)
    gain = torch.clamp(gain, 0.5, 2.0)
    return torch.clamp(a * gain, 0.0, 255.0)
