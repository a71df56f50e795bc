"""PyTorch port vs the JAX package: graph ordering — the all-pairs match
counts (plain version of kernel B5) and the host-side graph rules
(``directed_adjacency``, ``_middle_index``, ``bfs_edge_seq``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervisionimagestich2_tpu.models import registration as jreg
from computervisionimagestich2_tpu.models import stitcher as jst
from computervisionimagestich2_tpu.ops import distance as jdist
from computervisionimagestich2_tpu.ops.pallas_distance import (
    pair_match_counts_pallas)
from computervisionimagestich2_tpu_torch import DEFAULT_CONFIG
from computervisionimagestich2_tpu_torch.core.types import features_from_numpy
from computervisionimagestich2_tpu_torch.models import registration as treg
from computervisionimagestich2_tpu_torch.models import stitcher as tst
from computervisionimagestich2_tpu_torch.ops import distance as tdist
from test_integration import make_scene
from test_torch_kernels import PAIR_CASES, _pair_case, _pair_inputs

T = torch.as_tensor
CFG = dataclasses.replace(
    DEFAULT_CONFIG,
    sift=dataclasses.replace(DEFAULT_CONFIG.sift, n_octaves=2,
                             max_keypoints_per_octave=512,
                             max_keypoints=1024),
    match=dataclasses.replace(DEFAULT_CONFIG.match, max_matches=512))


@pytest.mark.parametrize("asymmetric", [False, True])
def test_pair_match_counts_plain_matches_pallas_and_scan(asymmetric):
    """tests/test_pallas_distance.py:115-136 inputs (lives 200/130/256/77,
    two clustered pairs), and a variant whose two columns differ: exact
    counts in both columns against the Pallas kernel in interpret mode and
    the JAX per-pair scan."""
    desc, valid, pairs = _pair_inputs(asymmetric)
    got = tdist.pair_match_counts(T(desc), T(valid), T(pairs)).numpy()
    pallas = np.asarray(pair_match_counts_pallas(desc, valid, pairs, 0.5,
                                                 interpret=True))
    np.testing.assert_array_equal(got, pallas)
    for p, (i, j) in enumerate(pairs):
        okq, _, okr, _ = jdist.ratio_match_bidir(
            desc[j], desc[i], valid[j], valid[i], 0.5, "l1", pallas="off",
            method="exact")
        assert got[p].tolist() == [int(np.asarray(okq).sum()),
                                   int(np.asarray(okr).sum())], (i, j)
    # the clustered pairs match in both directions
    assert got[0].min() > 30 and got[5].min() > 30
    if asymmetric:  # pair (0, 1): queries = image 1 gain the copies
        assert got[0].tolist() == [60, 40]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """A thread pool per pytest worker oversubscribes the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", PAIR_CASES)
def test_pair_match_counts_tiled_plan_equals_plain(case):
    """Kernel B5's plan in plain PyTorch (per-tile (d1, d2) partials of
    the live 64 x 64 tiles in a chunk's scratch, merge, ratio count) on a
    scratch budget of two pairs, so 3 chunks (5 at 10 pairs): exactly the
    counts of the untiled per-pair loop, on the reference inputs, the
    asymmetric variant, an image with no valid row, holed masks,
    duplicates across a tile edge and five images."""
    desc, valid, pairs = (T(a) for a in _pair_case(case))
    cap = desc.shape[1]
    budget = 2 * 16 * -(-cap // tdist.TILE) * cap
    assert tdist.pair_chunk(cap, len(pairs), budget) == 2
    want = tdist.pair_match_counts_plain(desc, valid, pairs)
    got = tdist.pair_match_counts_tiled_plain(desc, valid, pairs, 0.5, budget)
    assert torch.equal(got, want), (got, want)
    one_chunk = tdist.pair_match_counts_tiled_plain(desc, valid, pairs)
    assert torch.equal(one_chunk, want)
    assert int(want.max()) > 0
    if case == "empty":  # every pair with image 1
        assert (want[[0, 3, 4]] == 0).all()
    if case == "dups":  # the query tied at d1 = d2 = 0 is no match
        assert want[0, 0] == tdist.pair_match_counts_plain(
            *(T(a) for a in _pair_case("reference")))[0, 0] - 1


def test_pair_chunk_budget():
    """The default budget holds 45 pairs at 9,728 slots in 5 chunks of at
    most 11; one pair past the budget is still a chunk; a chunk never exceeds
    the pairs."""
    assert tdist.pair_chunk(9728, 45, tdist.PAIR_SCRATCH_BYTES) == 11
    assert tdist.pair_chunk(2048, 6, tdist.PAIR_SCRATCH_BYTES) == 6
    assert tdist.pair_chunk(40000, 3, tdist.PAIR_SCRATCH_BYTES) == 1
    assert tdist.pair_chunk(0, 3, tdist.PAIR_SCRATCH_BYTES) == 3


@pytest.fixture(scope="module")
def jax_scene_feats():
    """The JAX package's stacked matching features of four make_scene
    crops, neighbours overlapping by half."""
    scene = make_scene(np.random.default_rng(0), h=140, w=300)
    parts = [scene[:, s:s + 120] for s in (0, 60, 120, 180)]
    st = jst.Stitcher(CFG)
    st.prepare(parts)
    return tuple(np.array(a) for a in st._matching_feats())


def test_all_pairs_match_counts_matches_jax(jax_scene_feats):
    """The same features through both packages: equal [N, N] counts, a
    zero diagonal, and neighbouring crops matching best."""
    desc, valid = jax_scene_feats[0], jax_scene_feats[3]
    want = np.asarray(jreg.all_pairs_match_counts(
        jnp.asarray(desc), jnp.asarray(valid), CFG))
    feats = features_from_numpy(jax_scene_feats, "cpu")
    got = treg.all_pairs_match_counts(feats.desc, feats.valid, CFG)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (np.diag(want) == 0).all()
    assert min(want[i, i + 1] for i in range(3)) > want[0, 3]


def test_all_pairs_match_counts_single_image():
    """n == 1 (tests/test_integration.py:114-125): [[0]] without a call."""
    got = treg.all_pairs_match_counts(torch.zeros((1, 128, 128)),
                                      torch.zeros((1, 128), dtype=torch.bool),
                                      CFG)
    assert got.tolist() == [[0]]


@pytest.mark.parametrize("counts,threshold,want", [
    # tests/test_integration.py:127-136: only the passing direction of an
    # asymmetric pair; the i<j pass mirrors without recomputation
    ([[0, 5], [25, 0]], 20, [[False, False], [True, False]]),
    ([[0, 25], [0, 0]], 20, [[False, True], [True, False]]),
])
def test_directed_adjacency_reference_cases(counts, threshold, want):
    assert tst.directed_adjacency(np.array(counts), threshold) == want
    assert jst.directed_adjacency(np.array(counts), threshold) == want


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("revisit", ["skip", "faithful"])
def test_graph_rules_match_jax(seed, revisit):
    """Seeded random count matrices (N 2-6, counts around the threshold):
    identical adjacency, start image and BFS edge sequence."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 7))
    counts = rng.integers(10, 31, (n, n))
    np.fill_diagonal(counts, 0)
    adj_t = tst.directed_adjacency(counts, 20)
    adj_j = jst.directed_adjacency(counts, 20)
    assert adj_t == adj_j
    start_t = tst.Stitcher._middle_index(adj_t)
    assert start_t == jst.Stitcher._middle_index(adj_j)
    seq_t = tst.bfs_edge_seq([r[:] for r in adj_t], start_t, revisit)
    assert seq_t == jst.bfs_edge_seq([r[:] for r in adj_j], start_t, revisit)
