"""Core data types (counterpart of ``computervisionimagestich2_tpu.core.types``).

Fixed-capacity, index-aligned tensors with validity masks: descriptors and
coordinates share one row index, and valid rows form a prefix.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


def features_from_numpy(feats, device: torch.device | str) -> Features:
    """Features from any 4-field (desc, xy, scale, valid) record of arrays —
    e.g. the JAX package's ``Features`` after ``np.asarray`` — on ``device``."""
    desc, xy, scale, valid = (np.asarray(a) for a in feats)
    return Features(
        desc=torch.as_tensor(desc, dtype=torch.float32, device=device),
        xy=torch.as_tensor(xy, dtype=torch.float32, device=device),
        scale=torch.as_tensor(scale, dtype=torch.float32, device=device),
        valid=torch.as_tensor(valid, dtype=torch.bool, device=device))


def features_to_numpy(feats: Features) -> tuple[np.ndarray, ...]:
    """(desc, xy, scale, valid) as numpy arrays on the host."""
    return tuple(t.detach().cpu().numpy() for t in feats)
