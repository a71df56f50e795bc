"""The work a kernel's inputs need, counted from live rows rather than
capacities (the arithmetic of the port's ``chip_smoke.py::kernel_bound``),
and the least time the card could do it in (``peaks``)."""
from __future__ import annotations

from . import peaks

# per pair of live descriptors: |q - r| and an add per each of the 128
# features (the absolute value folds into the add), 4 top-2 compares
L1_OPS_PER_PAIR = 2 * 128 + 4
DESC_BYTES = 128 * 4


def bound_s(nbytes: float, ops: float) -> float:
    """The larger of the two times at the peak rates."""
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.OPS_PER_S)


def l1_bidir(nq: int, nr: int, cap_q: int, cap_r: int) -> float:
    """B4 on one edge: the live descriptors read once, the masks, both
    directions' (d1, d2, i1) written; every live pair compared once."""
    return bound_s((nq + nr) * DESC_BYTES + cap_q + cap_r
                   + (cap_q + cap_r) * 12, L1_OPS_PER_PAIR * nq * nr)


def pair_counts(live: list[int], cap: int) -> float:
    """B5 on every i < j pair of the images with ``live`` descriptors:
    each live descriptor read once, the masks, the pairs and counts; one
    distance pass serves both directions."""
    pairs = [(i, j) for i in range(len(live)) for j in range(i + 1, len(live))]
    return bound_s(sum(live) * DESC_BYTES + len(live) * cap
                   + len(pairs) * (8 + 8),
                   sum(L1_OPS_PER_PAIR * live[i] * live[j] for i, j in pairs))
