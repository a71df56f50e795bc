"""Correctly rounded division by a Python scalar.

PyTorch does not divide by Python scalars the way XLA does:
``float / Tensor`` runs ``Tensor.reciprocal() * float``, and on CUDA
``Tensor / float`` multiplies by the reciprocal of the scalar. Both round
twice. Where the reference divides by a constant, these helpers divide by
a 0-dim tensor on the operand's device, which takes the ordinary
correctly rounded division on every device. The divisor is uploaded once
per value, dtype and device (``core/programs.py::const``).
"""
from __future__ import annotations

import torch

from ..core.programs import const


def div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s, correctly rounded in x's dtype."""
    return x / const(s, x.dtype, x.device)


def rdiv(s: float, x: torch.Tensor) -> torch.Tensor:
    """s / x, correctly rounded in x's dtype."""
    return torch.full_like(x, s) / x
