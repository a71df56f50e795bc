"""Explicit device resolution.

Every entry point takes a ``device`` argument; there is no global device
and no silent fallback: asking for ``cuda`` where no GPU is visible raises.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``torch.device(device)``, raising if it is a CUDA device and
    no GPU is available.

    Also pins float32 matmuls and convolutions to full precision. The
    Gaussian blurs feed strict DoG-extremum comparisons and the RANSAC
    solves feed integer warp truncations; TF32 keeps about three decimal
    digits, which moves both. (PyTorch's default already disables TF32 for
    matmuls but enables it for cuDNN convolutions.)
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {str(device)!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
