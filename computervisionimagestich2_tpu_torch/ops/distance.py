"""Exact L1 2-NN + Lowe ratio test (counterpart of
``computervisionimagestich2_tpu.ops.distance`` on its exact-L1 path).

Replaces the reference's kd-forest ANN matcher (vl/kdtree.c) and the 2-NN
+ ratio wrapper (ImageProcess.cpp:273-351) with an exact search: every live
query x reference L1 distance, top-2 per row, lowest index on ties.

``two_nearest_bidir`` is kernel B4 of ``csrc/l1_2nn.cu`` (the port of
``two_nearest_l1_bidir_pallas``): both directions from one distance pass
over 64 x 64 tiles, whose per-tile top-2s a second kernel merges
(``merge_top2_plain`` is that merge in plain PyTorch); on a CPU tensor it
is ``two_nearest_plain`` run both ways. ``two_nearest`` is one direction:
kernel B7 (the port of ``two_nearest_l1_pallas``, behind ``ratio_match``
and ``models.matcher.match_features``), the same tile pass with the query
rows' scans and merge only (``two_nearest_tiled_plain`` is that plan in
plain PyTorch), so it gives the bits of B4's query side;
``two_nearest_plain`` on a CPU tensor. ``pair_match_counts`` is kernel B5
(``csrc/pair_counts.cu``, the port of ``pair_match_counts_pallas``): the
ratio-test counts of many image pairs from B4's tile pass run over the live
tiles of every pair, chunked over the pairs within a fixed scratch budget,
with ``pair_match_counts_plain`` beside it and that plan in plain PyTorch as
``pair_match_counts_tiled_plain``.

``MatchConfig``'s other strategies are the JAX package's XLA formulations
in plain PyTorch, on either device: ``method="l2pre"``
(``_l2pre_one_direction``: one f32 matmul of squared-L2 candidates, the
first ``l2pre_m`` per query in (distance, index) order, then an exact-L1
rescore of those only, ``_l1_rescore``) and ``distance="l2"``
(``pairwise_l2sq`` and two min-reductions). ``method="auto"`` is exact L1,
as the JAX package decides off a TPU.
"""
from __future__ import annotations

import torch

from . import _native

BIG = 3.0e38
TILE = 64  # queries and references per tile of kernels B4, B5 and B7


def two_nearest_plain(qry: torch.Tensor, ref: torch.Tensor,
                      qry_valid: torch.Tensor, ref_valid: torch.Tensor,
                      chunk: int = 128):
    """Plain PyTorch version of kernel B7 (and of B4, run both ways): for
    each query row, (d1, d2, i1) over the valid reference rows. Invalid references never win; invalid
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
        d1[s:e], d2[s:e], i1[s:e] = _top2(d, ref_valid[None, :])
    d1 = torch.where(qry_valid, d1, BIG)
    d2 = torch.where(qry_valid, d2, BIG)
    return d1, d2, i1


def _strategy(distance: str, method: str) -> str | None:
    """Which formulation a (distance, method) pair takes: None for exact
    L1 (kernels B4 / B7 on the card), "l2pre" or "l2". The JAX package's
    ``two_nearest`` prefilters only L1, and its "auto" is exact off a
    TPU."""
    if distance == "l1":
        return "l2pre" if method == "l2pre" else None
    if distance == "l2":
        return "l2"
    raise ValueError(f"unknown distance {distance!r}")


def pairwise_l2sq(qry: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Squared-L2 distances [NQ, NR] by the matmul identity, clamped at 0:
    (|q|^2 + |r|^2) - 2 q.r in the JAX package's order. One f32 matmul
    (TF32 stays off, ``device.resolve_device``)."""
    qn = torch.sum(qry * qry, dim=-1, keepdim=True)
    rn = torch.sum(ref * ref, dim=-1, keepdim=True)
    return torch.clamp(qn + rn.T - 2.0 * (qry @ ref.T), min=0.0)


def _top2(d: torch.Tensor, ok: torch.Tensor):
    """(d1, d2, j) of every row of a distance matrix, ``ok`` (broadcast to
    it) marking the columns that may win: the first minimum is the
    nearest, the second distance excludes only that column (a tie at d1
    gives d2 = d1)."""
    d = torch.where(ok, d, BIG)
    j = torch.argmin(d, dim=1)
    d1 = torch.gather(d, 1, j[:, None])[:, 0]
    cols = torch.arange(d.shape[1], device=d.device)[None, :]
    d2 = torch.where(cols == j[:, None], BIG, d).min(dim=1).values
    return d1, d2, j


def _top2_dense(d: torch.Tensor, qry_valid: torch.Tensor,
                ref_valid: torch.Tensor):
    """``_top2`` over the valid references, BIG for invalid queries."""
    d1, d2, i1 = _top2(d, ref_valid[None, :])
    return (torch.where(qry_valid, d1, BIG), torch.where(qry_valid, d2, BIG),
            i1)


def _first_m(d: torch.Tensor, m: int) -> torch.Tensor:
    """Column indices of each row's ``m`` smallest entries in (value,
    index) order: a stable sort, so ties go to the lower index. The JAX
    package's ``approx_min_k`` gives this order on the CPU, where it is
    exact; ``torch.topk`` may break ties otherwise and so change the set."""
    return torch.sort(d, dim=1, stable=True).indices[:, :m]


def _l1_rescore(qry: torch.Tensor, cand_desc: torch.Tensor,
                cand_idx: torch.Tensor, cand_ok: torch.Tensor):
    """Exact L1 top-2 over per-query candidate sets.

    qry [NQ, F]; cand_desc [NQ, M, F]; cand_idx [NQ, M] global reference
    indices; cand_ok [NQ, M] candidate validity. Returns (d1, d2, i1): the
    first minimum in candidate order wins."""
    d = torch.sum(torch.abs(qry[:, None, :] - cand_desc), dim=-1)
    d1, d2, j1 = _top2(d, cand_ok)
    return d1, d2, torch.gather(cand_idx, 1, j1[:, None])[:, 0]


def _l2pre_one_direction(qry: torch.Tensor, ref: torch.Tensor,
                         qry_valid: torch.Tensor, ref_valid: torch.Tensor,
                         m: int):
    """One direction of the L2-prefiltered L1 2-NN (``method="l2pre"``):
    the [NQ, NR] squared-L2 matrix from one f32 matmul, invalid references
    at BIG, the first min(m, NR) candidates of each query in (distance,
    index) order (``_first_m``), then exact L1 over those only
    (``_l1_rescore``). Returns (d1, d2, i1) as ``two_nearest`` does."""
    d2sq = torch.where(ref_valid[None, :], pairwise_l2sq(qry, ref), BIG)
    idx = _first_m(d2sq, min(m, ref.shape[0]))
    d1, d2, i1 = _l1_rescore(qry, ref[idx], idx, ref_valid[idx])
    return torch.where(qry_valid, d1, BIG), torch.where(qry_valid, d2, BIG), i1


def two_nearest(qry: torch.Tensor, ref: torch.Tensor,
                qry_valid: torch.Tensor, ref_valid: torch.Tensor,
                distance: str = "l1", method: str = "auto",
                l2pre_m: int = 32):
    """For every query descriptor, its 2 nearest reference descriptors:
    (d1, d2, i1), as ``two_nearest_plain`` returns them. Any masks are
    honoured; the kernel reads them on the device, so nothing waits for the
    host. Exact L1 is kernel B7 on CUDA tensors; ``method="l2pre"`` and
    ``distance="l2"`` take their plain PyTorch formulations
    (``_strategy``)."""
    other = _strategy(distance, method)
    if other == "l2pre":
        return _l2pre_one_direction(qry, ref, qry_valid, ref_valid, l2pre_m)
    if other == "l2":
        return _top2_dense(pairwise_l2sq(qry, ref), qry_valid, ref_valid)
    if qry.device.type == "cpu":
        return two_nearest_plain(qry, ref, qry_valid, ref_valid)
    _native.check_cuda("two_nearest.qry", qry, torch.float32, (None, 128), 16)
    _native.check_cuda("two_nearest.ref", ref, torch.float32, (None, 128), 16)
    nb, na = qry.shape[0], ref.shape[0]
    _native.check_cuda("two_nearest.qry_valid", qry_valid, torch.bool, (nb,),
                       1)
    _native.check_cuda("two_nearest.ref_valid", ref_valid, torch.bool, (na,),
                       1)
    dev = qry.device
    d1 = torch.empty((nb,), dtype=torch.float32, device=dev)
    d2 = torch.empty((nb,), dtype=torch.float32, device=dev)
    i1 = torch.empty((nb,), dtype=torch.int32, device=dev)
    if nb == 0:
        return d1, d2, i1.long()
    n_part = -(-na // TILE) * nb  # a partial top-2 per query and ref tile
    part_d = torch.empty((2 * n_part,), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_part,), dtype=torch.int32, device=dev)
    _native.LAUNCHES["l1_two_nearest"] += 1
    _native.launch("cvs_l1_two_nearest", dev, qry.data_ptr(), ref.data_ptr(),
                   qry_valid.data_ptr(), ref_valid.data_ptr(), nb, na,
                   part_d.data_ptr(), part_i.data_ptr(), d1.data_ptr(),
                   d2.data_ptr(), i1.data_ptr())
    return d1, d2, i1.long()


def merge_top2_plain(d1: torch.Tensor, d2: torch.Tensor, i1: torch.Tensor,
                     valid: torch.Tensor):
    """Plain PyTorch version of B4's and B7's merge: per-tile partial top-2s
    d1, d2, i1 [T, N] (tile t's rows hold the 2-NN of each row over the
    t-th tile of the other side, i1 as global indices) merged in ascending
    tile order with a strict ``<``, so the lowest index wins and a tie at
    d1 gives d2 = d1. Rows where ``valid`` is false get BIG, BIG, 0."""
    n = d1.shape[1]
    a1 = torch.full((n,), BIG, dtype=torch.float32, device=d1.device)
    a2 = torch.full((n,), BIG, dtype=torch.float32, device=d1.device)
    ai = torch.zeros((n,), dtype=torch.int64, device=d1.device)
    for t in range(d1.shape[0]):
        b1, b2, bi = d1[t], d2[t], i1[t].long()
        win = b1 < a1
        a2 = torch.where(win, torch.minimum(a1, b2), torch.minimum(a2, b1))
        a1 = torch.where(win, b1, a1)
        ai = torch.where(win, bi, ai)
    return (torch.where(valid, a1, BIG), torch.where(valid, a2, BIG),
            torch.where(valid, ai, 0))


def two_nearest_tiled_plain(qry: torch.Tensor, ref: torch.Tensor,
                            qry_valid: torch.Tensor, ref_valid: torch.Tensor):
    """Kernel B7's plan in plain PyTorch: each query's partial top-2 over
    every live 64-reference tile (``two_nearest_plain`` on the slice, i1
    made global), merged in ascending tile order (``merge_top2_plain``).
    Equals ``two_nearest_plain`` exactly."""
    nb = qry.shape[0]
    n_rt = -(-_live_bound(ref_valid) // TILE)
    d1 = torch.empty((n_rt, nb), dtype=torch.float32, device=qry.device)
    d2 = torch.empty((n_rt, nb), dtype=torch.float32, device=qry.device)
    i1 = torch.empty((n_rt, nb), dtype=torch.int64, device=qry.device)
    for t in range(n_rt):
        sl = slice(t * TILE, (t + 1) * TILE)
        d1[t], d2[t], i1[t] = two_nearest_plain(qry, ref[sl], qry_valid,
                                                ref_valid[sl])
        i1[t] += t * TILE
    return merge_top2_plain(d1, d2, i1, qry_valid)


def two_nearest_bidir(qry: torch.Tensor, ref: torch.Tensor,
                      qry_valid: torch.Tensor, ref_valid: torch.Tensor,
                      distance: str = "l1", method: str = "auto",
                      l2pre_m: int = 32):
    """Both 2-NN directions: ((d1q, d2q, i1q), (d1r, d2r, i1r)), the second
    tuple with the roles of qry and ref swapped, as ``two_nearest`` returns
    each. Exact L1 is kernel B4 on CUDA tensors: one distance pass serves
    both directions; any masks are honoured and read on the device. Under
    ``method="l2pre"`` each direction runs its own prefilter; under
    ``distance="l2"`` one squared-L2 matrix serves both."""
    other = _strategy(distance, method)
    if other == "l2pre":
        return (_l2pre_one_direction(qry, ref, qry_valid, ref_valid, l2pre_m),
                _l2pre_one_direction(ref, qry, ref_valid, qry_valid, l2pre_m))
    if other == "l2":
        d = pairwise_l2sq(qry, ref)
        return (_top2_dense(d, qry_valid, ref_valid),
                _top2_dense(d.T, ref_valid, qry_valid))
    if qry.device.type == "cpu":
        return (two_nearest_plain(qry, ref, qry_valid, ref_valid),
                two_nearest_plain(ref, qry, ref_valid, qry_valid))
    name = "two_nearest_bidir"
    _native.check_cuda(f"{name}.qry", qry, torch.float32, (None, 128), 16)
    _native.check_cuda(f"{name}.ref", ref, torch.float32, (None, 128), 16)
    nb, na = qry.shape[0], ref.shape[0]
    _native.check_cuda(f"{name}.qry_valid", qry_valid, torch.bool, (nb,), 1)
    _native.check_cuda(f"{name}.ref_valid", ref_valid, torch.bool, (na,), 1)
    dev = qry.device
    n_part = -(-na // TILE) * nb + -(-nb // TILE) * na
    part_d = torch.empty((2 * n_part,), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_part,), dtype=torch.int32, device=dev)
    out = [torch.empty((n,), dtype=dt, device=dev) for n in (nb, na)
           for dt in (torch.float32, torch.float32, torch.int32)]
    if nb or na:
        _native.LAUNCHES["l1_two_nearest_bidir"] += 1
        _native.launch("cvs_l1_two_nearest_bidir", dev, qry.data_ptr(),
                       ref.data_ptr(), qry_valid.data_ptr(),
                       ref_valid.data_ptr(), nb, na, part_d.data_ptr(),
                       part_i.data_ptr(), *(t.data_ptr() for t in out))
    d1q, d2q, i1q, d1r, d2r, i1r = out
    return (d1q, d2q, i1q.long()), (d1r, d2r, i1r.long())


def _ratio_ok(d1: torch.Tensor, d2: torch.Tensor, valid: torch.Tensor,
              ratio: float) -> torch.Tensor:
    """Lowe ratio test (ImageProcess.cpp:329-331) on a 2-NN result."""
    return ((d1 / d2) < ratio) & valid & (d2 < BIG)


def ratio_match(qry: torch.Tensor, ref: torch.Tensor,
                qry_valid: torch.Tensor, ref_valid: torch.Tensor,
                ratio: float = 0.5, distance: str = "l1",
                method: str = "auto", l2pre_m: int = 32):
    """Lowe ratio test, one direction: keep queries whose nearest / second
    distance ratio is < ratio. Returns (match_mask [NB], nearest_ref_index
    [NB])."""
    d1, d2, i1 = two_nearest(qry, ref, qry_valid, ref_valid,
                             distance=distance, method=method,
                             l2pre_m=l2pre_m)
    return _ratio_ok(d1, d2, qry_valid, ratio), i1


def ratio_match_bidir(qry: torch.Tensor, ref: torch.Tensor,
                      qry_valid: torch.Tensor, ref_valid: torch.Tensor,
                      ratio: float = 0.5, distance: str = "l1",
                      method: str = "auto", l2pre_m: int = 32):
    """Lowe ratio test in both directions.
    Returns (ok_q [NB], i1_q [NB], ok_r [NA], i1_r [NA])."""
    (d1q, d2q, i1q), (d1r, d2r, i1r) = two_nearest_bidir(
        qry, ref, qry_valid, ref_valid, distance=distance, method=method,
        l2pre_m=l2pre_m)
    return (_ratio_ok(d1q, d2q, qry_valid, ratio), i1q,
            _ratio_ok(d1r, d2r, ref_valid, ratio), i1r)


def pair_match_counts_plain(desc3: torch.Tensor, valid2: torch.Tensor,
                            pairs: torch.Tensor, ratio: float = 0.5):
    """Plain PyTorch version of kernel B5: the per-pair loop of the JAX
    scan (models/registration.py:243-254) on ``two_nearest_plain``."""
    out = torch.zeros((pairs.shape[0], 2), dtype=torch.int32,
                      device=desc3.device)
    for p, (i, j) in enumerate(pairs.tolist()):
        for col, (q, r) in enumerate(((j, i), (i, j))):
            d1, d2, _ = two_nearest_plain(desc3[q], desc3[r], valid2[q],
                                          valid2[r])
            out[p, col] = _ratio_ok(d1, d2, valid2[q], ratio).sum()
    return out


PAIR_SCRATCH_BYTES = 256 << 20  # B5's budget for per-tile partials


def pair_chunk(cap: int, n_pairs: int, scratch_bytes: int) -> int:
    """Pairs per chunk of kernel B5: as many as ``scratch_bytes`` hold the
    partials of (4 float planes [ceil(cap / 64), cap] each), at least one."""
    per_pair = 4 * 4 * -(-cap // TILE) * cap
    return max(1, min(n_pairs, scratch_bytes // max(per_pair, 1)))


def _live_bound(mask: torch.Tensor) -> int:
    """One past the last true entry of a 1-d mask (0 if none)."""
    hits = torch.nonzero(mask)
    return int(hits[-1]) + 1 if hits.numel() else 0


def pair_match_counts_tiled_plain(desc3: torch.Tensor, valid2: torch.Tensor,
                                  pairs: torch.Tensor, ratio: float = 0.5,
                                  scratch_bytes: int = PAIR_SCRATCH_BYTES):
    """Kernel B5's plan in plain PyTorch, scratch layout included: the pairs
    in chunks of ``pair_chunk``; per chunk, the live 64 x 64 tiles of every
    pair write their (d1, d2) partials into the chunk's scratch (left as it
    was by the chunk before, NaN at first), then every valid row merges its
    partials over the other side's live tiles (``merge_top2_plain``) and
    the ratio test counts. Equals ``pair_match_counts_plain`` exactly."""
    n, cap = desc3.shape[0], desc3.shape[1]
    n_pairs = pairs.shape[0]
    out = torch.zeros((n_pairs, 2), dtype=torch.int32, device=desc3.device)
    if n_pairs == 0 or cap == 0:
        return out
    chunk = pair_chunk(cap, n_pairs, scratch_bytes)
    n_t = -(-cap // TILE)
    part = torch.full((chunk, 2, 2, n_t, cap), float("nan"),
                      dtype=torch.float32, device=desc3.device)
    tiles = [-(-_live_bound(valid2[m]) // TILE) for m in range(n)]
    plist = pairs.tolist()
    for p0 in range(0, n_pairs, chunk):
        todo = plist[p0:p0 + chunk]
        for s, (i, j) in enumerate(todo):  # the tile pass
            for side, (rows, other) in enumerate(((j, i), (i, j))):
                if tiles[rows] == 0:
                    continue
                for t in range(tiles[other]):
                    sl = slice(t * TILE, (t + 1) * TILE)
                    d1, d2, _ = two_nearest_plain(
                        desc3[rows], desc3[other, sl], valid2[rows],
                        valid2[other, sl])
                    part[s, side, 0, t] = d1
                    part[s, side, 1, t] = d2
        for s, (i, j) in enumerate(todo):  # merge and count
            for side, (rows, other) in enumerate(((j, i), (i, j))):
                k = tiles[other]
                d1, d2, _ = merge_top2_plain(
                    part[s, side, 0, :k], part[s, side, 1, :k],
                    torch.zeros((k, cap), dtype=torch.int64,
                                device=desc3.device), valid2[rows])
                out[p0 + s, side] = _ratio_ok(d1, d2, valid2[rows],
                                              ratio).sum()
    return out


def pair_match_counts(desc3: torch.Tensor, valid2: torch.Tensor,
                      pairs: torch.Tensor, ratio: float = 0.5):
    """Ratio-test match counts of every listed image pair, both directions.

    desc3 [N, CAP, 128] float32, valid2 [N, CAP] bool, pairs [P, 2] int32
    rows (i, j). Returns [P, 2] int32: [:, 0] counts queries = image j
    against references = image i (the reference's getImgPair(i, j) size),
    [:, 1] the reverse. Kernel B5 on CUDA tensors: one distance pass per
    pair for both directions, no host synchronisation, any number of pairs.

    Scratch: the per-tile partials take CAP^2 / 4 bytes per pair; the call
    holds at most ``PAIR_SCRATCH_BYTES`` (256 MiB) of them and walks the
    pairs in chunks of ``pair_chunk`` (three device launches per chunk). The
    budget covers every N at CAP <= 32,768 (45 pairs at CAP 9,728 take 5
    chunks of at most 11); past that a chunk is one pair and takes its CAP^2 / 4
    bytes."""
    if desc3.device.type == "cpu":
        return pair_match_counts_plain(desc3, valid2, pairs, ratio)
    _native.check_cuda("pair_match_counts.desc3", desc3, torch.float32,
                       (None, None, 128), 16)
    n, cap = desc3.shape[0], desc3.shape[1]
    _native.check_cuda("pair_match_counts.valid2", valid2, torch.bool,
                       (n, cap), 1)
    _native.check_cuda("pair_match_counts.pairs", pairs, torch.int32,
                       (None, 2))
    n_pairs = pairs.shape[0]
    dev = desc3.device
    out = torch.zeros((n_pairs, 2), dtype=torch.int32, device=dev)
    if n_pairs == 0 or cap == 0:
        return out
    chunk = pair_chunk(cap, n_pairs, PAIR_SCRATCH_BYTES)
    plan = torch.empty((n + chunk + 1,), dtype=torch.int32, device=dev)
    part = torch.empty((chunk * 4 * -(-cap // TILE) * cap,),
                       dtype=torch.float32, device=dev)
    _native.LAUNCHES["pair_match_counts"] += 1
    _native.launch("cvs_pair_match_counts", dev, desc3.data_ptr(),
                   valid2.data_ptr(), n, cap, pairs.data_ptr(), n_pairs,
                   float(ratio), chunk, plan.data_ptr(),
                   plan[n:].data_ptr(), part.data_ptr(), out.data_ptr())
    return out
