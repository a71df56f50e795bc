"""Histogram equalization (counterpart of
``computervisionimagestich2_tpu.models.equalization``).

Color mode, the one the pipeline uses (equalization.cpp:74-131): RGB ->
YCbCr with the 0.857 luma quirk, equalize Y through a 256-entry LUT from
the CDF (equalization.cpp:57-65), -> RGB with clamps. The pipeline tail
(ImageProcess.cpp:237-268) then mixes the equalized and original luma
19 : 1. Plain histogram counts (a ``scatter_add_`` of ones, a row of
bins per image row) and a LUT gather; the JAX package's radix-16 one-hot
contractions exist for the TPU.
"""
from __future__ import annotations

import torch

from ..core.programs import program
from ..ops.color import rgb_to_ycbcr, ycbcr_to_rgb


def _histogram(channel_u8: torch.Tensor) -> torch.Tensor:
    """The 256-bin int64 histogram of a u8-valued channel [H, W], as ones
    added at each value into one row of bins per image row, then summed
    over the rows. ``torch.bincount`` reads its input's largest value on
    the host, which a CUDA graph cannot hold; one row of bins for the
    whole image would queue the card's atomic adds on 256 addresses. The
    counts are integers, so the order of the adds changes nothing."""
    idx = channel_u8.reshape(channel_u8.shape[0], -1).long()
    bins = torch.zeros((idx.shape[0], 256), dtype=torch.int64,
                       device=idx.device)
    return bins.scatter_add_(1, idx, torch.ones_like(idx)).sum(0)


def _equalize_lut(channel_u8: torch.Tensor) -> torch.Tensor:
    """LUT from a u8-valued channel: mapped[i] = round(255 * cdf[i])."""
    n = channel_u8.numel()
    hist = _histogram(channel_u8)
    cdf = torch.cumsum(hist.float() / n, 0)
    return torch.round(255.0 * cdf)


def equalize_color(img: torch.Tensor, compat_luma: bool = True) -> torch.Tensor:
    """Color-mode equalization. img: [H, W, 3] float32 u8-valued RGB.
    Returns the equalized RGB image on the u8 grid."""
    ycbcr = rgb_to_ycbcr(img, compat_luma=compat_luma, to_u8=True)
    y = ycbcr[..., 0]
    lut = _equalize_lut(y)
    # index clamp mirrors equalization.cpp:128 (y is already in [0, 255])
    y_eq = lut[y.clamp(0, 255).long()]
    out = torch.stack([y_eq, ycbcr[..., 1], ycbcr[..., 2]], dim=-1)
    return ycbcr_to_rgb(out, to_u8=True)


@program("equalize_and_mix")
def equalize_and_mix(result: torch.Tensor, compat_luma: bool = True,
                     mix_weight: float = 19.0 / 20.0) -> torch.Tensor:
    """The pipeline tail: equalize a copy, convert both to YCbCr (float,
    clamped), mix luma mix_weight : (1 - mix_weight), convert back to RGB
    on the u8 grid. A program (JAX ``equalization.py:99``): on the card
    one CUDA graph per canvas shape and settings."""
    eq = equalize_color(result, compat_luma)
    ycc_res = rgb_to_ycbcr(result, compat_luma=compat_luma, to_u8=False)
    ycc_eq = rgb_to_ycbcr(eq, compat_luma=compat_luma, to_u8=False)
    y_mix = ycc_res[..., 0] * mix_weight + ycc_eq[..., 0] * (1.0 - mix_weight)
    mixed = torch.stack([y_mix, ycc_res[..., 1], ycc_res[..., 2]], dim=-1)
    return ycbcr_to_rgb(mixed, to_u8=True)
