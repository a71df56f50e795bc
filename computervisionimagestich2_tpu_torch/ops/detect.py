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

The DoG stacks of an image's octaves depend on its Gaussian levels only,
so ``detect_compact_octaves`` takes them all and the kernel detects them in
one launch. A CPU tensor goes to ``detect_compact_plain``; a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _native
from . import sift_kernels as sk

ROWCAP = 128  # hits kept per image row (pallas_detect.py:48)
MAX_OCTAVES = 8  # DoG stacks per launch of kernel B1 (csrc/detect.cu)
BAND_ROWS = 8    # image rows per block of kernel B1


def detect_compact_plain(dog: torch.Tensor, peak_thresh: float,
                         capacity: int):
    """Plain PyTorch version of kernel B1: the dense extrema mask with the
    per-row cap, compacted in scan order. Returns (coords [capacity, 3]
    int64 rows (s, y, x), valid [capacity] bool, n_total int32)."""
    mask = sk.extrema_mask(dog, peak_thresh)
    rank = torch.cumsum(mask, dim=-1) - 1  # hits before x in its row
    coords, valid = sk.compact_mask(mask & (rank < ROWCAP), capacity)
    return coords, valid, mask.sum(dtype=torch.int32)


def detect_compact_banded_plain(dog: torch.Tensor, peak_thresh: float,
                                capacity: int):
    """Kernel B1's plan in plain PyTorch: per (level, band of ``BAND_ROWS``
    rows) the rows' hits in ascending x, each row capped at ``ROWCAP``; a
    band's first slot is the sum of the capped counts of every band before
    it in scan order (the kernel's prefix scan over its blocks); slots past
    ``capacity`` are dropped, the rest stay zero. Equals
    ``detect_compact_plain`` exactly."""
    mask = sk.extrema_mask(dog, peak_thresh)
    s_out, h, _ = mask.shape
    coords = torch.zeros((capacity, 3), dtype=torch.int64, device=dog.device)
    valid = torch.zeros((capacity,), dtype=torch.bool, device=dog.device)
    base_capped = base_uncapped = 0  # the scan's exclusive prefix
    for s in range(s_out):
        for y0 in range(0, h, BAND_ROWS):
            band = mask[s, y0:y0 + BAND_ROWS]
            row_n = band.sum(dim=1)
            kept = torch.clamp(row_n, max=ROWCAP)
            row_off = torch.cumsum(kept, 0) - kept
            for r in range(band.shape[0]):
                slot0 = base_capped + int(row_off[r])
                xs = torch.nonzero(band[r])[:int(kept[r]), 0]
                xs = xs[:max(0, capacity - slot0)]
                sl = slice(slot0, slot0 + xs.numel())
                coords[sl, 0], coords[sl, 1], coords[sl, 2] = s, y0 + r, xs
                valid[sl] = True
            base_capped += int(kept.sum())
            base_uncapped += int(row_n.sum())
    return coords, valid, torch.tensor(base_uncapped, dtype=torch.int32,
                                       device=dog.device)


def detect_compact_octaves(dogs, peak_thresh: float, capacities):
    """``detect_compact_plain`` of every DoG stack in ``dogs`` (the octaves
    of one image, each [S+2, H, W] float32) at its capacity: a list of
    (coords, valid, n_total). On CUDA tensors kernel B1 detects all of them
    in one launch; at most ``MAX_OCTAVES`` stacks a call."""
    dogs, capacities = list(dogs), [int(c) for c in capacities]
    if len(dogs) != len(capacities) or not 1 <= len(dogs) <= MAX_OCTAVES:
        raise ValueError(f"detect_compact_octaves: {len(dogs)} DoG stacks "
                         f"(1..{MAX_OCTAVES}), {len(capacities)} capacities")
    if dogs[0].device.type == "cpu":
        return [detect_compact_plain(d, peak_thresh, c)
                for d, c in zip(dogs, capacities)]
    for k, (dog, cap) in enumerate(zip(dogs, capacities)):
        _native.check_cuda(f"detect_compact.dog[{k}]", dog, torch.float32,
                           (None, None, None))
        d, h, w = dog.shape
        if d < 3 or h < 1 or not 1 <= w <= 65535 or cap < 1:
            raise ValueError(f"detect_compact: needs >= 3 DoG levels, rows, "
                             f"1..65535 columns and a capacity; got dog "
                             f"{tuple(dog.shape)}, capacity {cap}")
        if dog.device != dogs[0].device:
            raise ValueError("detect_compact: DoG stacks on several devices")
    dev = dogs[0].device
    n = len(dogs)
    dims = [(d.shape[0] - 2, d.shape[1], d.shape[2], c)
            for d, c in zip(dogs, capacities)]
    blocks = sum(s * -(-h // BAND_ROWS) for s, h, _, _ in dims)
    total = sum(capacities)
    coords = torch.empty((total, 3), dtype=torch.int64, device=dev)
    valid = torch.empty((total,), dtype=torch.bool, device=dev)
    n_total = torch.empty((n,), dtype=torch.int32, device=dev)
    # the scan's status words and its ticket; the launcher zeroes them
    status = torch.empty((blocks + 1,), dtype=torch.int64, device=dev)
    # the gate is compared in float32, as the plain version compares it
    gate = 0.8 * peak_thresh
    _native.LAUNCHES["detect_compact"] += 1
    _native.launch(
        "cvs_detect_compact", n,
        (ctypes.c_void_p * n)(*(d.data_ptr() for d in dogs)),
        (ctypes.c_int * (4 * n))(*(v for row in dims for v in row)), gate,
        coords.data_ptr(), valid.data_ptr(), n_total.data_ptr(),
        status.data_ptr(), blocks + 1)
    out, at = [], 0
    for k, cap in enumerate(capacities):
        out.append((coords[at:at + cap], valid[at:at + cap], n_total[k]))
        at += cap
    return out


def detect_compact(dog: torch.Tensor, peak_thresh: float, capacity: int):
    """Candidate coordinates of the strict DoG extrema of ``dog`` [S+2, H,
    W] float32 (``sift_kernels.dog_stack``), as ``detect_compact_plain``
    returns them. Kernel B1 on CUDA tensors."""
    return detect_compact_octaves([dog], peak_thresh, [capacity])[0]
