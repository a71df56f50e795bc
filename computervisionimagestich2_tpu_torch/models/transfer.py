"""Reinhard color transfer (counterpart of
``computervisionimagestich2_tpu.models.transfer``).

class transfer (transfer.cpp): RGB -> LMS -> log10 -> l-alpha-beta,
per-channel mean / std matched to a template image, then back. Plain
elementwise tensor work and two global reductions per image.
"""
from __future__ import annotations

import math

import torch

_SQRT3 = math.sqrt(3.0)
_SQRT6 = math.sqrt(6.0)
_SQRT2 = math.sqrt(2.0)


def rgb_to_lab(img: torch.Tensor) -> torch.Tensor:
    """RGBtoLab (transfer.cpp:175-198). img: [..., 3] float32."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    l = 0.3811 * r + 0.5783 * g + 0.0402 * b
    m = 0.1967 * r + 0.7244 * g + 0.0782 * b
    s = 0.0241 * r + 0.1288 * g + 0.8444 * b
    l = torch.log10(torch.where(l == 0, 1.0, l))
    m = torch.log10(torch.where(m == 0, 1.0, m))
    s = torch.log10(torch.where(s == 0, 1.0, s))
    pa, pb, pc = 1.0 / _SQRT3, 1.0 / _SQRT6, 1.0 / _SQRT2
    big_l = pa * (l + m + s)
    alpha = pb * l + pb * m - 2.0 * pb * s
    beta = pc * l - pc * m
    return torch.stack([big_l, alpha, beta], dim=-1)


def lab_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """LabToRGB (transfer.cpp:200-226), including its [0, 255] clamps."""
    big_l, alpha, beta = img[..., 0], img[..., 1], img[..., 2]
    pa, pb, pc = _SQRT3 / 3.0, _SQRT6 / 6.0, _SQRT2 / 2.0
    l = torch.pow(10.0, pa * big_l + pb * alpha + pc * beta)
    m = torch.pow(10.0, pa * big_l + pb * alpha - pc * beta)
    s = torch.pow(10.0, pa * big_l - 2.0 * pb * alpha)
    r = 4.4679 * l - 3.5873 * m + 0.1193 * s
    g = -1.2186 * l + 2.3809 * m - 0.1624 * s
    b = 0.0497 * l - 0.2439 * m + 1.2045 * s
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)


def color_transfer(src: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
    """transfer(src, template) -> output (transfer.cpp:4-13, 125-173).

    src, template: [H, W, 3] float32 RGB (0..255); shapes may differ.
    Returns the color-matched image, float32."""
    lab_src = rgb_to_lab(src)
    lab_tpl = rgb_to_lab(template)
    mean_s = lab_src.mean(dim=(0, 1))
    mean_t = lab_tpl.mean(dim=(0, 1))
    std_s = torch.sqrt(((lab_src - mean_s) ** 2).mean(dim=(0, 1)))
    std_t = torch.sqrt(((lab_tpl - mean_t) ** 2).mean(dim=(0, 1)))
    return lab_to_rgb((lab_src - mean_s) * std_t / std_s + mean_t)
