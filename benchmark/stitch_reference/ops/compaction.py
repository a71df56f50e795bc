"""Stream compaction into static-capacity buffers (counterpart of
``computervisionimagestich2_tpu.ops.compaction``).

Indices of the set entries of a mask, in C-scan order, truncated at a
static capacity — the static-shape stand-in for VLFeat's realloc'd
keypoint buffer (vl/sift.c:580-590). The form is a prefix sum plus a
scatter to unique slots, so it needs no host synchronisation and is
deterministic on the GPU.
"""
from __future__ import annotations

import torch


def compact_indices(mask: torch.Tensor, capacity: int):
    """Flat indices of True entries of ``mask`` (any shape), C-scan order.

    Returns (idx [capacity] int64, valid [capacity] bool). Slots past the
    population count hold 0 with valid=False (``nonzero(size=capacity,
    fill_value=0)`` semantics)."""
    flat = mask.reshape(-1)
    n = flat.shape[0]
    pos = torch.cumsum(flat, 0, dtype=torch.int64) - 1
    keep = flat & (pos < capacity)
    # non-kept entries land in a dump slot at index `capacity`
    slot = torch.where(keep, pos, capacity)
    idx = torch.zeros(capacity + 1, dtype=torch.int64, device=mask.device)
    idx.scatter_(0, slot, torch.arange(n, device=mask.device))
    total = flat.sum() if n else torch.zeros((), dtype=torch.int64,
                                             device=mask.device)
    valid = torch.arange(capacity, device=mask.device) < total
    return torch.where(valid, idx[:capacity], 0), valid


def select_strongest(valid: torch.Tensor, strength: torch.Tensor,
                     capacity: int):
    """Indices of the ``capacity`` strongest valid entries, in scan order.

    Keeps the strongest by ``strength`` (> 0 for every valid entry) when
    the capacity binds, then re-sorts the kept set ascending so the output
    is prefix-compacted in scan order. Ties keep the lower index first, as
    ``lax.top_k`` does (a stable sort; ``torch.topk`` is not stable). When
    nothing would drop, equal to ``compact_indices(valid, capacity)``.

    Returns (idx [capacity] int64, valid [capacity] bool)."""
    n = valid.shape[0]
    if capacity >= n:
        return compact_indices(valid, capacity)
    s = torch.where(valid, strength, -1.0)
    order = torch.sort(s, descending=True, stable=True).indices
    top_idx = order[:capacity]
    keep_valid = s[top_idx] > 0.0
    idx = torch.sort(torch.where(keep_valid, top_idx, n)).values
    out_valid = idx < n
    return torch.where(out_valid, idx, 0), out_valid


