"""``match.method="l2pre"`` and ``match.distance="l2"`` in the port against
the JAX package on the CPU: the L2-prefiltered L1 2-NN (candidates in
(distance, index) order, the exact-L1 rescore), the exact squared-L2
2-NN, the graph counts under both, and a small stitch with l2pre.

On the CPU the JAX package's ``approx_min_k`` is exact, so its candidate
sets are the port's up to ties; how it orders ties is checked on the row
where the port's rule was chosen.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervisionimagestich2_tpu import config as jconfig
from computervisionimagestich2_tpu.models import registration as jreg
from computervisionimagestich2_tpu.models.stitcher import Stitcher as JStitcher
from computervisionimagestich2_tpu.ops import distance as jdist
from computervisionimagestich2_tpu_torch import DEFAULT_CONFIG
from computervisionimagestich2_tpu_torch.models import registration as treg
from computervisionimagestich2_tpu_torch.models.stitcher import (
    Stitcher as TStitcher)
from computervisionimagestich2_tpu_torch.ops import distance as tdist
from test_integration import make_scene
from test_torch_graph_stitch import SMALL_DEFAULT
from test_torch_incremental import _one_torch_thread  # noqa: F401
from test_torch_kernels import _pair_inputs

T = torch.as_tensor
# the row where torch.topk and approx_min_k disagree on the set (m = 4)
TIE_ROW = [3.0, 1.0, 1.0, 2.0, 1.0, 0.5, 0.5]


def _exact_sets_inputs():
    """tests/test_match_ransac.py::test_l2pre_matches_exact_sets: 256
    noisy copies of 384 unit references, 200 and 350 of them valid."""
    rng = np.random.default_rng(0)
    base = np.abs(rng.normal(size=(384, 128))).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    q = np.abs(base[:256] + rng.normal(size=(256, 128)).astype(np.float32)
               * 0.01).astype(np.float32)
    return q, base, np.arange(256) < 200, np.arange(384) < 350


def _validity_inputs():
    """tests/test_match_ransac.py::test_l2pre_respects_validity: the
    queries' exact copies sit among the references, all invalid."""
    rng = np.random.default_rng(0)
    q = np.abs(rng.normal(size=(64, 128))).astype(np.float32)
    r = np.zeros((128, 128), np.float32)
    r[:8] = np.abs(rng.normal(size=(8, 128)))
    r[8:72] = q
    return q, r, np.ones(64, bool), np.arange(128) < 8


def _assert_2nn_close(got, want, valid, rtol=1e-5, atol=0.0):
    """d1 / d2 within the tolerance on the valid rows; i1 equal wherever
    the nearest is clear of the second by more than the tolerance."""
    d1, d2, i1 = (np.asarray(x) for x in got)
    w1, w2, wi = (np.asarray(x) for x in want)
    np.testing.assert_allclose(d1[valid], w1[valid], rtol=rtol, atol=atol)
    np.testing.assert_allclose(d2[valid], w2[valid], rtol=rtol, atol=atol)
    clear = valid & (w2 - w1 > 1e-4 * np.maximum(w1, 1e-6) + 2 * atol)
    np.testing.assert_array_equal(i1[clear], wi[clear])


def test_l2pre_matches_jax_on_the_exact_sets_inputs():
    """Both directions at m = 32: ratio-test masks equal to JAX's l2pre
    and to exact L1, nearest indices equal on the matches, d1 / d2 rtol
    1e-5 against JAX's l2pre."""
    q, r, qv, rv = _exact_sets_inputs()
    args = (T(q), T(r), T(qv), T(rv))
    got = tdist.ratio_match_bidir(*args, 0.5, "l1", "l2pre", 32)
    want = jdist.ratio_match_bidir(q, r, qv, rv, 0.5, "l1", "off", "l2pre",
                                   32)
    exact = tdist.ratio_match_bidir(*args, 0.5, "l1", "exact")
    for k in (0, 2):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(got[k].numpy(), exact[k].numpy())
        ok = got[k].numpy()
        np.testing.assert_array_equal(got[k + 1].numpy()[ok],
                                      np.asarray(want[k + 1])[ok])
    assert int(got[0].sum()) == 200
    tf, tb = tdist.two_nearest_bidir(*args, "l1", "l2pre", 32)
    jf = jdist.two_nearest(q, r, qv, rv, "l1", "off", "l2pre", 32)
    jb = jdist.two_nearest(r, q, rv, qv, "l1", "off", "l2pre", 32)
    _assert_2nn_close(tf, jf, qv)
    _assert_2nn_close(tb, jb, rv)


def test_l2pre_respects_validity_like_jax():
    """m = 16 with the queries' invalid copies among the references: no
    invalid reference wins; d1 / d2 rtol 1e-5 and i1 as JAX's."""
    q, r, qv, rv = _validity_inputs()
    got = tdist.two_nearest(T(q), T(r), T(qv), T(rv), "l1", "l2pre", 16)
    want = jdist.two_nearest(q, r, qv, rv, "l1", "off", "l2pre", 16)
    assert (got[2] < 8).all()
    _assert_2nn_close(got, want, qv)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_candidates_follow_approx_min_k_order_on_a_tie_row():
    """On the tie row with m = 4 the candidates and their order equal
    approx_min_k's on the CPU, [5, 6, 1, 2] (torch.topk picks another set).
    Through the whole prefilter: a zero query against references whose
    squared norms are the row (exact in f32) and whose L1 norms tie at 1
    for all four candidates, so the rescore's first minimum in candidate
    order decides i1 = 5, as in JAX."""
    row = np.asarray([TIE_ROW], np.float32)
    want = np.asarray(jax.lax.approx_min_k(jnp.asarray(row), 4)[1])
    got = tdist._first_m(T(row), 4).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[5, 6, 1, 2]])

    ref = np.zeros((7, 128), np.float32)
    for k, v in enumerate(TIE_ROW):
        if v == 0.5:
            ref[k, :2] = 0.5   # |r|^2 = 0.5, |r|_1 = 1
        else:
            ref[k, :int(v)] = 1.0
    q = np.zeros((1, 128), np.float32)
    ok = np.ones(1, bool), np.ones(7, bool)
    t = tdist.two_nearest(T(q), T(ref), T(ok[0]), T(ok[1]), "l1", "l2pre", 4)
    j = jdist.two_nearest(q, ref, *ok, "l1", "off", "l2pre", 4)
    assert [float(t[0]), float(t[1]), int(t[2])] == [1.0, 1.0, 5]
    assert [float(j[0][0]), float(j[1][0]), int(j[2][0])] == [1.0, 1.0, 5]


def test_candidates_keep_index_order_on_long_ties():
    """Ties at the m-th place go to the lower index in every row length
    (a stable order: the port never relies on torch.topk's tie order)."""
    d = torch.full((3, 40), 0.25)
    d[1, 30] = 0.1
    d[2, ::3] = 0.2  # 14 smaller ties: the first 12 of them
    got = tdist._first_m(d, 12)
    assert got[0].tolist() == list(range(12))
    assert got[1].tolist() == [30] + list(range(11))
    assert got[2].tolist() == list(range(0, 36, 3))


@pytest.mark.parametrize("inputs", ["exact_sets", "validity"])
def test_l2_distance_matches_jax_both_ways(inputs):
    """distance="l2" (squared L2, exact) in both directions: ratio-test
    masks and nearest indices on the matches equal JAX's; d1 / d2 within
    atol 1e-5 x (the largest query plus the largest reference squared
    norm), the matmul identity's cancellation scale."""
    q, r, qv, rv = (_exact_sets_inputs() if inputs == "exact_sets"
                    else _validity_inputs())
    args = (T(q), T(r), T(qv), T(rv))
    got = tdist.ratio_match_bidir(*args, 0.5, "l2")
    want = jdist.ratio_match_bidir(q, r, qv, rv, 0.5, "l2", "off")
    for k in (0, 2):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        ok = got[k].numpy()
        np.testing.assert_array_equal(got[k + 1].numpy()[ok],
                                      np.asarray(want[k + 1])[ok])
    atol = 1e-5 * (float((q * q).sum(1).max()) + float((r * r).sum(1).max()))
    tf, tb = tdist.two_nearest_bidir(*args, "l2")
    for t_dir, j_dir, valid in (
            (tf, jdist.two_nearest(q, r, qv, rv, "l2", "off"), qv),
            (tb, jdist.two_nearest(r, q, rv, qv, "l2", "off"), rv)):
        _assert_2nn_close(t_dir, j_dir, valid, rtol=0.0, atol=atol)
    one = tdist.two_nearest(*args, "l2")
    assert all(torch.equal(a, b) for a, b in zip(one, tf))


@pytest.mark.parametrize("strategy", ["l2pre", "l2"])
def test_all_pairs_match_counts_match_jax(strategy):
    """Graph counts of four feature sets (tests/test_pallas_distance.py's
    pair inputs, plus ten second copies that make one pair asymmetric)
    under l2pre (l2pre_m_counts = 8) and under l2: the [N, N] counts equal
    JAX's scan, and under l2pre they equal exact L1's (B5's plain
    version)."""
    desc, valid, _ = _pair_inputs(asymmetric=True)
    if strategy == "l2pre":
        change = dict(method="l2pre")
    else:
        change = dict(distance="l2")
    cfg = dataclasses.replace(DEFAULT_CONFIG, match=dataclasses.replace(
        DEFAULT_CONFIG.match, **change))
    jcfg = dataclasses.replace(jconfig.DEFAULT_CONFIG, match=dataclasses.replace(
        jconfig.DEFAULT_CONFIG.match, pallas="off", **change))
    got = treg.all_pairs_match_counts(T(desc), T(valid), cfg).numpy()
    want = np.asarray(jreg.all_pairs_match_counts(jnp.asarray(desc),
                                                  jnp.asarray(valid), jcfg))
    np.testing.assert_array_equal(got, want)
    assert got[0, 1] > 20 and got[0, 1] != got[1, 0], got
    if strategy == "l2pre":
        exact = treg.all_pairs_match_counts(T(desc), T(valid), DEFAULT_CONFIG)
        np.testing.assert_array_equal(got, exact.numpy())


def test_l2pre_stitch_matches_jax_stitcher():
    """Three scrambled make_scene crops with match.method="l2pre" in both
    packages: the same discovered chain; canvas shape within +-3 px and
    MAD <= 3 u8 levels (tests/test_torch_stitch.py's gate)."""
    scene = make_scene(np.random.default_rng(0), h=160, w=320)
    crops = [scene[:, s:s + 160] for s in (160, 0, 80)]
    cfg = dataclasses.replace(SMALL_DEFAULT, match=dataclasses.replace(
        SMALL_DEFAULT.match, method="l2pre"))
    out_t = TStitcher(cfg, device="cpu").stitch(crops)
    out_j = JStitcher(cfg).stitch(crops)
    assert abs(out_t.shape[0] - out_j.shape[0]) <= 3, (out_t.shape,
                                                       out_j.shape)
    assert abs(out_t.shape[1] - out_j.shape[1]) <= 3, (out_t.shape,
                                                       out_j.shape)
    assert out_t.shape[1] > 250, out_t.shape  # all three crops stitched
    h = min(out_t.shape[0], out_j.shape[0])
    w = min(out_t.shape[1], out_j.shape[1])
    mad = np.abs(out_t[:h, :w].astype(np.int64)
                 - out_j[:h, :w].astype(np.int64)).mean()
    assert mad <= 3.0, mad
