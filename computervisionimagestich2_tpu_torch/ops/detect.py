"""Fused SIFT detection: the dispatching wrapper of kernel B1
(``csrc/detect.cu``), the port of ``computervisionimagestich2_tpu.ops.
pallas_detect.detect_compact_pallas``.

Strict 26-neighbour DoG extrema on interior pixels (vl_sift_detect,
sift.c:539-603), listed in (s, y, x) scan order and truncated at a static
capacity. Like the TPU kernel, each image row keeps at most its first
``ROWCAP`` hits in ascending x; ``n_total`` stays the uncapped hit count, so
the caller reports every dropped candidate (``cand_dropped = n_total -
sum(valid)``). Whenever no row holds more than ``ROWCAP`` extrema the result
equals the dense path's ``compact_mask(extrema_mask(dog, tp), capacity)``.

A CPU tensor goes to ``detect_compact_plain``; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from . import _native
from . import sift_kernels as sk

ROWCAP = 128  # hits kept per image row (pallas_detect.py:48)


def detect_compact_plain(dog: torch.Tensor, peak_thresh: float,
                         capacity: int):
    """Plain PyTorch version of kernel B1: the dense extrema mask with the
    per-row cap, compacted in scan order. Returns (coords [capacity, 3]
    int64 rows (s, y, x), valid [capacity] bool, n_total int32)."""
    mask = sk.extrema_mask(dog, peak_thresh)
    rank = torch.cumsum(mask, dim=-1) - 1  # hits before x in its row
    coords, valid = sk.compact_mask(mask & (rank < ROWCAP), capacity)
    return coords, valid, mask.sum(dtype=torch.int32)


def detect_compact(dog: torch.Tensor, peak_thresh: float, capacity: int):
    """Candidate coordinates of the strict DoG extrema of ``dog`` [S+2, H,
    W] float32 (``sift_kernels.dog_stack``), as ``detect_compact_plain``
    returns them. Kernel B1 on CUDA tensors."""
    if dog.device.type == "cpu":
        return detect_compact_plain(dog, peak_thresh, capacity)
    _native.check_cuda("detect_compact.dog", dog, torch.float32,
                       (None, None, None))
    d, h, w = dog.shape
    if d < 3 or h < 1 or capacity < 1:
        raise ValueError(f"detect_compact: needs >= 3 DoG levels, rows and "
                         f"a capacity; got dog {tuple(dog.shape)}, capacity "
                         f"{capacity}")
    rows = (d - 2) * h
    dev = dog.device
    row_lists = torch.empty((rows, ROWCAP), dtype=torch.int32, device=dev)
    row_counts = torch.empty((rows,), dtype=torch.int32, device=dev)
    coords = torch.empty((capacity, 3), dtype=torch.int64, device=dev)
    valid = torch.empty((capacity,), dtype=torch.bool, device=dev)
    n_total = torch.empty((1,), dtype=torch.int32, device=dev)
    # the gate is compared in float32, as the plain version compares it
    gate = 0.8 * peak_thresh
    _native.LAUNCHES["detect_compact"] += 1
    _native.launch("cvs_detect_compact", dog.data_ptr(), d - 2, h, w, gate,
                   capacity, row_lists.data_ptr(), row_counts.data_ptr(),
                   coords.data_ptr(), valid.data_ptr(), n_total.data_ptr())
    return coords, valid, n_total[0]
