"""Per-edge registration and the edge plan (counterpart of
``computervisionimagestich2_tpu.models.registration``).

One stitch edge (ImageProcess.cpp:176-227): bidirectional matching, the
direction swap on the uncapped counts (ImageProcess.cpp:185-198), forward
and backward RANSAC, the canvas bounds, and the feature-coordinate
updates. ``plan_edges`` uploads the stitch order as an int32 [E, 3]
tensor, runs ``plan_rows`` on it and reads the [E, 23] plan back to the
host once (``plan_edges_with_rows`` also keeps the device rows).
``plan_rows`` is the JAX package's ``lax.scan`` over the edges
as a program (``core/programs.py``: one CUDA graph per key on the card):
it indexes the features with the edge tensor on the device and folds the
edge ids into the RANSAC keys there, so its key is the JAX program's
(the features' shapes, the number of edges, ``img_hw``, ``start_hw`` and
``cfg``) and two scenes with other edges of one count replay one graph.
``register_edge`` is a program of its own (the JAX package's jit) for the
callers off the plan, the incremental loop and the stream: its edge id is
a 0-dim device tensor, so its key holds no edge. ``all_pairs_match_counts``
gives graph ordering its [N, N] match counts from one launch of kernel B5
(under exact L1), as a program too.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import StitchConfig
from ..core.programs import const, program
from ..core.types import Features, MatchPairs
from ..ops import distance, rng
from ..ops.warp import warp_points
from .matcher import match_features_bidir
from .ransac import ransac_warp


def _pick(cond: torch.Tensor, a: MatchPairs, b: MatchPairs) -> MatchPairs:
    return MatchPairs(*(torch.where(cond, x, y) for x, y in zip(a, b)))


@program("register_edge")
def register_edge(feats_src: Features, feats_dst: Features,
                  cfg: StitchConfig, edge_id: int | torch.Tensor = 0,
                  img_hw: tuple[int, int] | None = None,
                  pairs_out: list | None = None):
    """Returns (forward, backward, n_matches, overflow): forward maps
    dst-image coords into the src/result frame, backward maps canvas
    coords into dst-image coords, n_matches is the larger direction's
    match count, overflow the matches dropped by the capacity.

    ``edge_id`` decorrelates the RANSAC draws across edges (fold_in); each
    direction folds its own tag. A 0-dim integer tensor on the features'
    device folds there, with the seed's key and the tags as device
    constants; an int folds on the host, with the same bits. ``img_hw``:
    the incoming image's (H, W); when given, the forward RANSAC gates out
    hypotheses that map the image corners more than 4 image diagonals
    outside the matched region. ``pairs_out``: a list that receives the
    forward fit's matches (dst-image xy, src xy, valid) on the host.

    A program (the JAX package's jit, its ``registration.py:26``): on the
    card one CUDA graph per key, the features' shapes, ``cfg`` and
    ``img_hw``. An int ``edge_id`` is a static argument, a key of its
    own, so the callers on the card hand over the tensor: the incremental
    loop a ``const`` of its edge, the stream its device frame counter,
    the plan (into whose graph this one is inlined) its edge row."""
    mcfg = cfg.match
    s2d, d2s = match_features_bidir(feats_src, feats_dst,
                                    mcfg.ratio_threshold, mcfg.distance,
                                    mcfg.max_matches, mcfg.method,
                                    mcfg.l2pre_m)
    n_s2d, n_d2s = s2d.n_raw, d2s.n_raw
    use_s2d = n_s2d > n_d2s
    s2d_final = _pick(use_s2d, s2d, d2s.swapped())
    d2s_final = _pick(use_s2d, s2d.swapped(), d2s)
    if pairs_out is not None:
        pairs_out.append(tuple(t.cpu() for t in (
            d2s_final.src_xy, d2s_final.dst_xy, d2s_final.valid)))

    dev = feats_src.desc.device
    if isinstance(edge_id, torch.Tensor):
        tags = const([0, 1], torch.int64, dev)
        key = rng.fold_in(rng.prng_key_on(cfg.ransac.seed, dev), edge_id)
        key_fwd, key_bwd = rng.fold_in(key, tags[0]), rng.fold_in(key, tags[1])
    else:
        key = rng.fold_in(rng.prng_key(cfg.ransac.seed), edge_id)
        key_fwd = rng.fold_in(key, 0)
        key_bwd = rng.fold_in(key, 1)
    corner_xy = corner_span = None
    if img_hw is not None:
        h_img, w_img = img_hw
        corner_xy = const(
            [[0.0, 0.0], [w_img - 1.0, 0.0], [0.0, h_img - 1.0],
             [w_img - 1.0, h_img - 1.0]], torch.float32, dev)
        corner_span = 4.0 * math.hypot(float(w_img), float(h_img))
    rc = cfg.ransac
    forward, _, _ = ransac_warp(d2s_final, key_fwd, rc.n_hypotheses,
                                rc.threshold, rc.n_sample, cfg.warp_model,
                                rc.lo_iters, corner_xy, corner_span)
    backward, _, _ = ransac_warp(s2d_final, key_bwd, rc.n_hypotheses,
                                 rc.threshold, rc.n_sample, cfg.warp_model,
                                 rc.lo_iters)
    return (forward, backward, torch.maximum(n_s2d, n_d2s),
            s2d_final.overflow())


def update_features_by_warp(feats: Features, coeffs: torch.Tensor,
                            offset_x, offset_y,
                            model: str = "bilinear") -> Features:
    """updateFeaturesByHomography (ImageProcess.cpp:622-631)."""
    xw, yw = warp_points(coeffs, feats.xy[:, 0], feats.xy[:, 1], model)
    return feats._replace(xy=torch.stack([xw - offset_x, yw - offset_y],
                                         dim=-1))


def _canvas_bounds(fwd: torch.Tensor, w_src: int, h_src: int,
                   cur_w, cur_h, model: str):
    """Canvas bounds after warping the source corners
    (getMin/Max*AfterWarping + clamps, ImageProcess.cpp:206-216, 532-594).
    Returns (min_x, min_y, new_w, new_h) as device scalars."""
    dev = fwd.device
    xs = const([0.0, w_src - 1.0, 0.0, w_src - 1.0], torch.float32, dev)
    ys = const([0.0, 0.0, h_src - 1.0, h_src - 1.0], torch.float32, dev)
    xw, yw = warp_points(fwd, xs, ys, model)
    min_x = torch.clamp(xw.min(), max=0.0)
    min_y = torch.clamp(yw.min(), max=0.0)
    max_x = torch.maximum(xw.max(), cur_w)
    max_y = torch.maximum(yw.max(), cur_h)
    return min_x, min_y, torch.ceil(max_x - min_x), torch.ceil(max_y - min_y)


def plan_edges(feats_stacked: Features, edges: list[tuple[int, int, int]],
               img_hw: tuple[int, int], start_hw: tuple[int, int],
               cfg: StitchConfig) -> np.ndarray:
    """Register every stitch edge and return the [E, 23] plan on the host
    (``plan_rows``'s rows). edges: (src, dst, pre) triples in BFS order,
    uploaded as one int32 [E, 3] tensor."""
    return plan_edges_with_rows(feats_stacked, edges, img_hw, start_hw,
                                cfg)[0]


def plan_edges_with_rows(feats_stacked: Features,
                         edges: list[tuple[int, int, int]],
                         img_hw: tuple[int, int], start_hw: tuple[int, int],
                         cfg: StitchConfig) -> tuple[np.ndarray, torch.Tensor]:
    """``plan_edges``, with the plan's rows on the device beside their one
    readback: (plan [E, 23] numpy, the same rows as a tensor on the
    features' device), for callers that hand the rows on to programs."""
    edges_t = torch.as_tensor(np.asarray(edges, dtype=np.int32).reshape(-1, 3),
                              device=feats_stacked.desc.device)
    rows = plan_rows(feats_stacked, edges_t, tuple(img_hw), tuple(start_hw),
                     cfg)
    return rows.cpu().numpy(), rows


@program("plan_edges")
def plan_rows(feats_stacked: Features, edges: torch.Tensor,
              img_hw: tuple[int, int], start_hw: tuple[int, int],
              cfg: StitchConfig, pairs_out: list | None = None
              ) -> torch.Tensor:
    """The edge plan on the device: [E, 23] rows, one per edge of
    ``edges`` (int32 [E, 3] rows (src, dst, pre) in BFS order, on the
    features' device).

    feats_stacked: Features with a leading image axis [N, CAP, ...]. Per
    edge: match, solve both RANSAC directions, compute the canvas bounds,
    then update the feature coordinates — dst by forward + offset, pre by
    the int-truncated offset (ImageProcess.cpp:226-227). The images are
    picked with ``index_select`` and the coordinates written back with
    ``index_copy_`` on the device. Rows: fwd(9), bwd(9) (a bilinear
    model's 8 coefficients and a 0), min_x, min_y, new_w, new_h,
    match-capacity overflow. ``pairs_out``: as ``register_edge``'s, one
    entry an edge."""
    h_img, w_img = img_hw
    dev = feats_stacked.desc.device
    xy_all = feats_stacked.xy.clone()   # updated in place, edge by edge
    cur_w = const(float(start_hw[1]), torch.float32, dev)
    cur_h = const(float(start_hw[0]), torch.float32, dev)
    # a bilinear model's 8 coefficients fill 9 slots; a homography's 9 do
    pad = ([const([0.0], torch.float32, dev)]
           if cfg.warp_model == "bilinear" else [])
    ids = edges.long()
    rows = []
    for e in range(edges.shape[0]):
        src, dst, pre = ids[e, 0:1], ids[e, 1:2], ids[e, 2:3]

        def at_img(i):
            return Features(*(t.index_select(0, i)[0] for t in (
                feats_stacked.desc, xy_all, feats_stacked.scale,
                feats_stacked.valid)))

        f_dst = at_img(dst)
        # (src, dst) is unique per edge -> distinct RANSAC draws per edge
        fwd, bwd, _, ovf = register_edge(at_img(src), f_dst, cfg,
                                         src[0] * 65536 + dst[0], img_hw,
                                         pairs_out)
        min_x, min_y, new_w, new_h = _canvas_bounds(
            fwd, w_img, h_img, cur_w, cur_h, cfg.warp_model)
        xy_dst = update_features_by_warp(f_dst, fwd, min_x, min_y,
                                         cfg.warp_model).xy
        xy_all.index_copy_(0, dst, xy_dst[None])
        xy_pre = xy_all.index_select(0, pre)[0] - torch.stack(
            [torch.trunc(min_x), torch.trunc(min_y)])[None, :]
        xy_all.index_copy_(0, pre, xy_pre[None])
        rows.append(torch.cat([fwd, *pad, bwd, *pad, torch.stack(
            [min_x, min_y, new_w, new_h, ovf.float()])]))
        cur_w, cur_h = new_w, new_h
    return torch.stack(rows)


@program("all_pairs_match_counts")
def all_pairs_match_counts(desc: torch.Tensor, valid: torch.Tensor,
                           cfg: StitchConfig) -> torch.Tensor:
    """Match counts for every ordered image pair (ImageProcess.cpp:117-137).

    desc: [N, CAP, 128] stacked descriptors; valid: [N, CAP]. Returns
    [N, N] int32 on the device with count[i, j] = |getImgPair(i, j)|
    (queries = j's descriptors against i's reference set); the diagonal is
    0. Under exact L1 both directions of every i<j pair come from one call
    of ``distance.pair_match_counts`` (kernel B5 on CUDA tensors). Under
    ``method="l2pre"`` (with ``l2pre_m_counts`` candidates) or
    ``distance="l2"`` each pair runs ``ratio_match_bidir``, as the JAX
    package's scan does (its ``registration.py:243-257``).

    A program (the JAX package's jit, its ``registration.py:189``): on the
    card one CUDA graph per key, the stacked features' shapes and ``cfg``
    (``Stitcher`` trims them to ``live_prefix`` first, outside, as that
    readback sets the key). The pair list is a host constant: the loop of
    the plain PyTorch strategies walks its host copy."""
    n = desc.shape[0]
    out = torch.zeros((n, n), dtype=torch.int32, device=desc.device)
    if n <= 1:
        return out
    mcfg = cfg.match
    pair_list = [(i, j) for i in range(n) for j in range(i + 1, n)]
    pairs = const(pair_list, torch.int32, desc.device)
    if mcfg.distance == "l1" and mcfg.method != "l2pre":
        counts = distance.pair_match_counts(desc, valid, pairs,
                                            mcfg.ratio_threshold)
    else:
        rows = []
        for i, j in pair_list:
            okq, _, okr, _ = distance.ratio_match_bidir(
                desc[j], desc[i], valid[j], valid[i], mcfg.ratio_threshold,
                mcfg.distance, mcfg.method, mcfg.l2pre_m_counts)
            rows.append(torch.stack([okq.sum(dtype=torch.int32),
                                     okr.sum(dtype=torch.int32)]))
        counts = torch.stack(rows)
    i, j = pairs[:, 0].long(), pairs[:, 1].long()
    out[i, j] = counts[:, 0]
    out[j, i] = counts[:, 1]
    return out
