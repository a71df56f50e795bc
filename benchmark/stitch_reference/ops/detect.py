"""SIFT detection in plain PyTorch (the benchmark's frozen copy of the
port's ``ops/detect.py``, its CPU path only).

Strict 26-neighbour DoG extrema on interior pixels (vl_sift_detect,
sift.c:539-603), listed in (s, y, x) scan order and truncated at a static
capacity; each image row keeps at most its first ``ROWCAP`` hits in
ascending x, and ``n_total`` stays the uncapped hit count.
"""
from __future__ import annotations

import torch

from . import sift_kernels as sk

ROWCAP = 128  # hits kept per image row (pallas_detect.py:48)
MAX_OCTAVES = 8  # DoG stacks per call


def detect_compact_plain(dog: torch.Tensor, peak_thresh: float,
                         capacity: int):
    """Plain PyTorch version of kernel B1: the dense extrema mask with the
    per-row cap, compacted in scan order. Returns (coords [capacity, 3]
    int64 rows (s, y, x), valid [capacity] bool, n_total int32)."""
    mask = sk.extrema_mask(dog, peak_thresh)
    rank = torch.cumsum(mask, dim=-1) - 1  # hits before x in its row
    coords, valid = sk.compact_mask(mask & (rank < ROWCAP), capacity)
    return coords, valid, mask.sum(dtype=torch.int32)


def detect_compact_octaves(dogs, peak_thresh: float, capacities):
    """``detect_compact_plain`` of every DoG stack in ``dogs`` (the octaves
    of one image, each [S+2, H, W] float32) at its capacity: a list of
    (coords, valid, n_total)."""
    dogs, capacities = list(dogs), [int(c) for c in capacities]
    if len(dogs) != len(capacities) or not 1 <= len(dogs) <= MAX_OCTAVES:
        raise ValueError(f"detect_compact_octaves: {len(dogs)} DoG stacks "
                         f"(1..{MAX_OCTAVES}), {len(capacities)} capacities")
    return [detect_compact_plain(d, peak_thresh, c)
            for d, c in zip(dogs, capacities)]


