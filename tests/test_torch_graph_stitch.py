"""The PyTorch port's default path end to end: ``Stitcher`` with
``DEFAULT_CONFIG`` (graph ordering, the fused detect) on the CPU against
the JAX package's ``Stitcher``, on crops handed over in scrambled order;
and ``graph_revisit="faithful"`` on a dense match graph, in the planned and
the incremental loop.
"""
import dataclasses

import numpy as np
import pytest
import torch

from computervisionimagestich2_tpu.models.stitcher import Stitcher as JStitcher
from computervisionimagestich2_tpu_torch import DEFAULT_CONFIG
from computervisionimagestich2_tpu_torch.models.stitcher import (
    Stitcher as TStitcher, bfs_edge_seq)
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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """A thread pool per pytest worker oversubscribes the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.mark.parametrize("planned", [True, False],
                         ids=["planned", "incremental"])
def test_faithful_revisit_matches_jax_stitcher(planned):
    """Three crops that all overlap (a triangle in the match graph) under
    ``graph_revisit="faithful"``: the BFS stitches image 0 twice, as the
    reference's unguarded loop does. Same adjacency and start as the JAX
    ``Stitcher``; canvas shape within +-3 px and MAD <= 3 u8 levels, in the
    planned and in the incremental loop."""
    scene = make_scene(np.random.default_rng(0), h=160, w=320)
    crops = [scene[:, s:s + 160] for s in (100, 0, 50)]
    cfg = dataclasses.replace(SMALL_DEFAULT, graph_revisit="faithful",
                              planned=planned)
    st_t = TStitcher(cfg, device="cpu")
    st_j = JStitcher(cfg)
    seen_t, seen_j = _record_ordering(st_t), _record_ordering(st_j)
    out_t = st_t.stitch(crops)
    out_j = st_j.stitch(crops)
    assert seen_t == seen_j
    adj = seen_t["adj"]
    assert sum(map(sum, adj)) // 2 == 3, adj  # more edges than a tree
    seq = bfs_edge_seq([row[:] for row in adj], seen_t["start"], "faithful")
    dsts = [dst for _, dst, _ in seq]
    assert len(seq) == 3 and len(set(dsts)) == 2, seq  # an image revisited
    assert len(bfs_edge_seq([row[:] for row in adj], seen_t["start"])) == 2
    assert out_t.dtype == np.uint8
    assert abs(out_t.shape[0] - out_j.shape[0]) <= 3
    assert abs(out_t.shape[1] - out_j.shape[1]) <= 3
    h = min(out_t.shape[0], out_j.shape[0])
    w = min(out_t.shape[1], out_j.shape[1])
    mad = np.abs(out_t[:h, :w].astype(np.int64)
                 - out_j[:h, :w].astype(np.int64)).mean()
    assert mad <= 3.0, mad
