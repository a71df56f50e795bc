"""Descriptor matching (counterpart of
``computervisionimagestich2_tpu.models.matcher``).

getImgPair (ImageProcess.cpp:273-351) with an exact search: 2-NN by L1
(or the ``l2pre`` / ``l2`` strategies of ``MatchConfig``), the Lowe ratio
test (< 0.5), and prefix-compacted (A keypoint, B keypoint) coordinate
pairs. Descriptors and coordinates share row indices, so the
reference's descriptor-keyed reverse lookup (ImageProcess.cpp:333-338) is
not needed.
"""
from __future__ import annotations

import torch

from ..core.types import Features, MatchPairs
from ..ops import distance as dist_ops
from ..ops.compaction import compact_indices


def match_features(feats_a: Features, feats_b: Features,
                   ratio: float = 0.5, distance: str = "l1",
                   max_matches: int = 2048, method: str = "auto",
                   l2pre_m: int = 32) -> MatchPairs:
    """Pairs with src = A's keypoint, dst = B's keypoint for each of B's
    descriptors that passes the ratio test against A (the reference's
    ImgPair(left, right) order, ImageProcess.cpp:341): one direction of
    ``match_features_bidir``, whose first result it equals. Exact L1 is
    kernel B7 on CUDA tensors; ``distance`` / ``method`` / ``l2pre_m``
    choose the strategy as in ``ops.distance.two_nearest``."""
    ok, idx_a = dist_ops.ratio_match(feats_b.desc, feats_a.desc,
                                     feats_b.valid, feats_a.valid, ratio,
                                     distance, method, l2pre_m)
    sel, valid = compact_indices(ok, max_matches)
    return MatchPairs(src_xy=feats_a.xy[idx_a[sel]], dst_xy=feats_b.xy[sel],
                      valid=valid, n_raw=ok.sum(dtype=torch.int32))


def match_features_bidir(feats_a: Features, feats_b: Features,
                         ratio: float = 0.5, distance: str = "l1",
                         max_matches: int = 2048, method: str = "auto",
                         l2pre_m: int = 32):
    """Both getImgPair directions. Returns (ab, ba): ab has src = A's
    keypoint and dst = B's keypoint for each of B's descriptors that
    passes the ratio test against A (the reference's ImgPair(left, right)
    order, ImageProcess.cpp:341); ba is the reverse. ``n_raw`` is the
    uncapped hit count."""
    okb, idx_a, oka, idx_b = dist_ops.ratio_match_bidir(
        feats_b.desc, feats_a.desc, feats_b.valid, feats_a.valid, ratio,
        distance, method, l2pre_m)
    sel_b, valid_b = compact_indices(okb, max_matches)
    ab = MatchPairs(src_xy=feats_a.xy[idx_a[sel_b]],
                    dst_xy=feats_b.xy[sel_b], valid=valid_b,
                    n_raw=okb.sum(dtype=torch.int32))
    sel_a, valid_a = compact_indices(oka, max_matches)
    ba = MatchPairs(src_xy=feats_b.xy[idx_b[sel_a]],
                    dst_xy=feats_a.xy[sel_a], valid=valid_a,
                    n_raw=oka.sum(dtype=torch.int32))
    return ab, ba
