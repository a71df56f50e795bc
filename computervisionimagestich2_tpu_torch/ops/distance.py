"""Exact L1 2-NN + Lowe ratio test (counterpart of
``computervisionimagestich2_tpu.ops.distance`` on its exact-L1 path).

Replaces the reference's kd-forest ANN matcher (vl/kdtree.c) and the 2-NN
+ ratio wrapper (ImageProcess.cpp:273-351) with an exact search: every live
query x reference L1 distance, top-2 per row, lowest index on ties.

``two_nearest`` is one direction: kernel B4 (``csrc/l1_2nn.cu``) on a CUDA
tensor, ``two_nearest_plain`` on a CPU tensor. ``two_nearest_bidir`` runs
it in both directions (the port of ``two_nearest_l1_bidir_pallas``).
"""
from __future__ import annotations

import torch

from . import _native

BIG = 3.0e38


def two_nearest_plain(qry: torch.Tensor, ref: torch.Tensor,
                      qry_valid: torch.Tensor, ref_valid: torch.Tensor,
                      chunk: int = 128):
    """Plain PyTorch version of kernel B4: for each query row, (d1, d2, i1)
    over the valid reference rows. Invalid references never win; invalid
    queries get d1 = d2 = BIG. A tie at d1 gives d2 = d1."""
    nb = qry.shape[0]
    d1 = torch.full((nb,), BIG, dtype=torch.float32, device=qry.device)
    d2 = torch.full((nb,), BIG, dtype=torch.float32, device=qry.device)
    i1 = torch.zeros((nb,), dtype=torch.int64, device=qry.device)
    if ref.shape[0] == 0:
        return d1, d2, i1
    for s in range(0, nb, chunk):
        e = min(nb, s + chunk)
        d = torch.sum(torch.abs(qry[s:e, None, :] - ref[None, :, :]), dim=-1)
        d = torch.where(ref_valid[None, :], d, BIG)
        j = torch.argmin(d, dim=1)     # first index of the minimum
        d1[s:e] = torch.gather(d, 1, j[:, None])[:, 0]
        d2[s:e] = torch.where(
            torch.arange(d.shape[1], device=d.device)[None, :] == j[:, None],
            BIG, d).min(dim=1).values
        i1[s:e] = j
    d1 = torch.where(qry_valid, d1, BIG)
    d2 = torch.where(qry_valid, d2, BIG)
    return d1, d2, i1


def two_nearest(qry: torch.Tensor, ref: torch.Tensor,
                qry_valid: torch.Tensor, ref_valid: torch.Tensor):
    """For every query descriptor, its 2 nearest reference descriptors by
    L1: (d1, d2, i1). Valid masks must be prefix-compacted (the matcher's
    features always are); on CUDA the kernel bounds its loops by the live
    counts. Kernel B4 on CUDA tensors."""
    if qry.device.type == "cpu":
        return two_nearest_plain(qry, ref, qry_valid, ref_valid)
    _native.check_cuda("two_nearest.qry", qry, torch.float32, (None, 128), 16)
    _native.check_cuda("two_nearest.ref", ref, torch.float32, (None, 128), 16)
    nb = qry.shape[0]
    counts = torch.stack([qry_valid.sum(dtype=torch.int32),
                          ref_valid.sum(dtype=torch.int32)])
    d1 = torch.empty((nb,), dtype=torch.float32, device=qry.device)
    d2 = torch.empty((nb,), dtype=torch.float32, device=qry.device)
    i1 = torch.empty((nb,), dtype=torch.int32, device=qry.device)
    _native.LAUNCHES["l1_two_nearest"] += 1
    _native.launch("cvs_l1_two_nearest", qry.data_ptr(), ref.data_ptr(),
                   counts.data_ptr(), nb, d1.data_ptr(), d2.data_ptr(),
                   i1.data_ptr())
    return d1, d2, i1.long()


def two_nearest_bidir(qry: torch.Tensor, ref: torch.Tensor,
                      qry_valid: torch.Tensor, ref_valid: torch.Tensor):
    """Both 2-NN directions: ((d1q, d2q, i1q), (d1r, d2r, i1r)), the second
    tuple with the roles of qry and ref swapped."""
    return (two_nearest(qry, ref, qry_valid, ref_valid),
            two_nearest(ref, qry, ref_valid, qry_valid))


def ratio_match_bidir(qry: torch.Tensor, ref: torch.Tensor,
                      qry_valid: torch.Tensor, ref_valid: torch.Tensor,
                      ratio: float = 0.5):
    """Lowe ratio test (ImageProcess.cpp:329-331) in both directions.
    Returns (ok_q [NB], i1_q [NB], ok_r [NA], i1_r [NA])."""
    (d1q, d2q, i1q), (d1r, d2r, i1r) = two_nearest_bidir(
        qry, ref, qry_valid, ref_valid)
    okq = ((d1q / d2q) < ratio) & qry_valid & (d2q < BIG)
    okr = ((d1r / d2r) < ratio) & ref_valid & (d2r < BIG)
    return okq, i1q, okr, i1r
