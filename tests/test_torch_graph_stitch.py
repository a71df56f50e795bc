"""The PyTorch port's default path end to end: ``Stitcher`` with
``DEFAULT_CONFIG`` (graph ordering, the fused detect) on the CPU against
the JAX package's ``Stitcher``, on crops handed over in scrambled order.
"""
import dataclasses

import numpy as np

from computervisionimagestich2_tpu.models.stitcher import Stitcher as JStitcher
from computervisionimagestich2_tpu_torch import DEFAULT_CONFIG
from computervisionimagestich2_tpu_torch.models.stitcher import (
    Stitcher as TStitcher)
from test_integration import make_scene

# DEFAULT_CONFIG at the sizes of tests/test_torch_stitch.py, with the
# stitchability threshold lowered as in tests/test_integration.py:66-69
# (small synthetic crops yield fewer matches than real photos)
SMALL_DEFAULT = dataclasses.replace(
    DEFAULT_CONFIG,
    sift=dataclasses.replace(DEFAULT_CONFIG.sift, n_octaves=2,
                             max_keypoints_per_octave=512,
                             max_keypoints=1024),
    match=dataclasses.replace(DEFAULT_CONFIG.match, max_matches=512,
                              pair_threshold=5),
    ransac=dataclasses.replace(DEFAULT_CONFIG.ransac, n_hypotheses=64))


def _record_ordering(stitcher):
    """Keep the adjacency and start image the stitcher discovers."""
    seen = {}
    graph, middle = stitcher._match_graph, stitcher._middle_index

    def match_graph(*args):
        adj = graph(*args)
        seen["adj"] = [row[:] for row in adj]  # bfs_edge_seq consumes adj
        return adj

    def middle_index(adj):
        seen["start"] = middle(adj)
        return seen["start"]

    stitcher._match_graph = match_graph
    stitcher._middle_index = middle_index
    return seen


def test_default_path_matches_jax_stitcher():
    """Three make_scene crops in scrambled order: the discovered adjacency
    (the scene's chain) and start equal JAX's; canvas shape within +-3 px
    and MAD over the common canvas <= 3 u8 levels, as in
    tests/test_torch_stitch.py."""
    scene = make_scene(np.random.default_rng(0), h=160, w=320)
    crops = [scene[:, s:s + 160] for s in (160, 0, 80)]
    st_t = TStitcher(SMALL_DEFAULT, device="cpu")
    st_j = JStitcher(SMALL_DEFAULT)
    seen_t, seen_j = _record_ordering(st_t), _record_ordering(st_j)
    out_t = st_t.stitch(crops)
    out_j = st_j.stitch(crops)
    assert seen_t == seen_j
    # scene order 1 - 2 - 0: the chain, started from its middle
    chain = {(1, 2), (2, 0)}
    edges = {(i, j) for i, row in enumerate(seen_t["adj"])
             for j, a in enumerate(row) if a and i < j}
    assert {tuple(sorted(e)) for e in chain} == edges, seen_t["adj"]
    assert seen_t["start"] == 2
    assert out_t.dtype == np.uint8
    assert abs(out_t.shape[0] - out_j.shape[0]) <= 3
    assert abs(out_t.shape[1] - out_j.shape[1]) <= 3
    assert abs(out_j.shape[1] - scene.shape[1]) <= 16, out_j.shape
    h = min(out_t.shape[0], out_j.shape[0])
    w = min(out_t.shape[1], out_j.shape[1])
    mad = np.abs(out_t[:h, :w].astype(np.int64)
                 - out_j[:h, :w].astype(np.int64)).mean()
    assert mad <= 3.0, mad
    assert st_t.stage_times["ordering"] > 0
