"""Core data types (counterpart of ``computervisionimagestich2_tpu.core.types``).

Fixed-capacity, index-aligned tensors with validity masks: descriptors and
coordinates share one row index, and valid rows form a prefix.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Features(NamedTuple):
    """SIFT features of one image, padded to a static capacity.

    desc:  [CAP, 128] float32 — L2-normalized descriptors.
    xy:    [CAP, 2]  float32 — keypoint (x, y) in image coords.
    scale: [CAP]     float32 — keypoint sigma.
    valid: [CAP]     bool.
    """

    desc: torch.Tensor
    xy: torch.Tensor
    scale: torch.Tensor
    valid: torch.Tensor

    def count(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)


class MatchPairs(NamedTuple):
    """Matched keypoint coordinate pairs, padded to static capacity.

    src_xy, dst_xy: [MAX_M, 2] float32; valid: [MAX_M] bool (a prefix).
    n_raw: int32 scalar tensor, the uncapped ratio-test hit count, so
    overflow() > 0 flags truncation that would otherwise be silent.
    """

    src_xy: torch.Tensor
    dst_xy: torch.Tensor
    valid: torch.Tensor
    n_raw: torch.Tensor | None = None

    def count(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)

    def overflow(self) -> torch.Tensor:
        """Matches dropped by the static capacity (0 when n_raw unknown)."""
        if self.n_raw is None:
            return torch.zeros((), dtype=torch.int32, device=self.valid.device)
        return torch.clamp(self.n_raw - self.valid.shape[0], min=0)

    def swapped(self) -> "MatchPairs":
        """Reverse direction (ImageProcess.cpp:185-198)."""
        return MatchPairs(self.dst_xy, self.src_xy, self.valid, self.n_raw)


