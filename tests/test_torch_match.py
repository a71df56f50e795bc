"""PyTorch port vs the JAX package: matching (plain version of kernels B4
and B7), the threefry generator, the warp solver, RANSAC and the edge
plan.

The descriptor sets are the JAX package's own SIFT features of
``make_scene`` crops, carried into the port with ``features_from_numpy``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervisionimagestich2_tpu.core.types import Features as JFeatures
from computervisionimagestich2_tpu.models import matcher as jmatcher
from computervisionimagestich2_tpu.models import ransac as jransac
from computervisionimagestich2_tpu.models import registration as jreg
from computervisionimagestich2_tpu.models.stitcher import Stitcher as JStitcher
from computervisionimagestich2_tpu.ops import distance as jdist
from computervisionimagestich2_tpu.ops import solve as jsolve
from computervisionimagestich2_tpu.ops.pallas_distance import (
    two_nearest_l1_bidir_pallas, two_nearest_l1_pallas)
from computervisionimagestich2_tpu_torch import SLICE_CONFIG
from computervisionimagestich2_tpu_torch.core.types import (
    Features, MatchPairs, features_from_numpy, features_to_numpy)
from computervisionimagestich2_tpu_torch.models import matcher as tmatcher
from computervisionimagestich2_tpu_torch.models import ransac as transac
from computervisionimagestich2_tpu_torch.models import registration as treg
from computervisionimagestich2_tpu_torch.ops import distance as tdist
from computervisionimagestich2_tpu_torch.ops import rng as trng
from computervisionimagestich2_tpu_torch.ops import solve as tsolve
from test_integration import make_scene
from test_torch_kernels import ONE_WAY_CASES, _one_way_case

T = torch.as_tensor
CFG = dataclasses.replace(
    SLICE_CONFIG,
    sift=dataclasses.replace(SLICE_CONFIG.sift, n_octaves=2,
                             max_keypoints_per_octave=512,
                             max_keypoints=1024),
    match=dataclasses.replace(SLICE_CONFIG.match, max_matches=512),
    ransac=dataclasses.replace(SLICE_CONFIG.ransac, n_hypotheses=64))


@pytest.fixture(scope="module")
def jax_feats():
    """The JAX package's stacked features of three overlapping crops."""
    scene = make_scene(np.random.default_rng(0), h=160, w=320)
    parts = [scene[:, s:s + 160] for s in (0, 80, 160)]
    st = JStitcher(CFG)
    proj, _ = st.prepare(parts)
    fs = st._matching_feats()
    return tuple(np.array(a) for a in fs), proj[0].shape[:2]


def _feat(stacked, i):
    return tuple(a[i] for a in stacked)


def _jfeat(f):
    return JFeatures(*(jnp.asarray(a) for a in f))


def _close_l1(d1_t, d2_t, i1_t, d1_j, d2_j, i1_j, live):
    """d1/d2 rtol 1e-5 (tests/test_pallas_distance.py:24-25); i1 equal
    wherever the 2-NN gap d2 - d1 exceeds 1e-4 * d1 (ties may break either
    way under another summation order)."""
    d1_j, d2_j, i1_j = (np.asarray(a)[live] for a in (d1_j, d2_j, i1_j))
    np.testing.assert_allclose(d1_t.numpy()[live], d1_j, rtol=1e-5)
    np.testing.assert_allclose(d2_t.numpy()[live], d2_j, rtol=1e-5)
    clear = (d2_j - d1_j) > 1e-4 * d1_j
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(i1_t.numpy()[live][clear], i1_j[clear])


def test_two_nearest_bidir_matches_pallas_and_xla(jax_feats):
    """Plain version of B4 vs two_nearest_l1_bidir_pallas(interpret=True)
    and the XLA two_nearest_bidir(method="exact")."""
    stacked, _ = jax_feats
    desc, valid = stacked[0], stacked[3]
    q, r, qv, rv = desc[1], desc[0], valid[1], valid[0]
    assert qv.sum() > 20 and rv.sum() > 20
    fwd_t, bwd_t = tdist.two_nearest_bidir(T(q), T(r), T(qv), T(rv))
    refs = [two_nearest_l1_bidir_pallas(jnp.asarray(q), jnp.asarray(r),
                                        jnp.asarray(qv), jnp.asarray(rv),
                                        interpret=True),
            jdist.two_nearest_bidir(jnp.asarray(q), jnp.asarray(r),
                                    jnp.asarray(qv), jnp.asarray(rv),
                                    "l1", "off", "exact")]
    for fwd_j, bwd_j in refs:
        _close_l1(*fwd_t, *fwd_j, qv)
        _close_l1(*bwd_t, *bwd_j, rv)
    # dead rows never match
    assert (fwd_t[0].numpy()[~qv] > 1e37).all()


def test_two_nearest_ties_and_dead_refs():
    """Exact ties pick the lowest index and give d2 == d1; dead
    references never win."""
    q = np.zeros((3, 128), np.float32)
    r = np.zeros((5, 128), np.float32)
    r[1] = r[3] = 0.5
    r[0] = 9.0
    q[1] = 0.5
    rv = np.array([False, True, True, True, False])
    d1, d2, i1 = tdist.two_nearest(T(q), T(r), T(np.ones(3, bool)), T(rv))
    jd1, jd2, ji1 = jdist.two_nearest(jnp.asarray(q), jnp.asarray(r),
                                      jnp.ones(3, bool), jnp.asarray(rv),
                                      "l1", "off", "exact")
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ji1))
    np.testing.assert_array_equal(d1.numpy(), np.asarray(jd1))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(jd2))
    assert i1[1] == 1 and d1[1] == d2[1] == 0.0


def _tiled_bidir_plain(q, r, qv, rv, tile=tdist.TILE):
    """Kernel B4's plan in plain PyTorch: per-tile top-2s of each query
    over each 64-wide reference tile and of each reference over each
    64-wide query tile, indices made global, then ``merge_top2_plain``."""
    def side(rows, other, rows_ok, other_ok):
        parts = [tdist.two_nearest_plain(rows, other[s:s + tile], rows_ok,
                                         other_ok[s:s + tile])
                 for s in range(0, other.shape[0], tile)]
        d1, d2, i1 = (torch.stack(x) for x in zip(*parts))
        i1 = i1 + torch.arange(0, other.shape[0], tile)[:, None]
        return tdist.merge_top2_plain(d1, d2, i1, rows_ok)
    return side(q, r, qv, rv), side(r, q, rv, qv)


def _merge_case(case):
    """Seeded inputs for the tiled merge: duplicated descriptors across
    tile edges (exact d1 ties between tiles), small-integer descriptors
    (many exact ties), holed masks on both sides, and live counts that are
    not a multiple of 64."""
    rng = np.random.default_rng({"dups": 1, "ints": 2, "holes": 3}[case])
    nb, na = (150, 200) if case != "holes" else (200, 256)
    if case == "ints":
        q = rng.integers(0, 3, (nb, 128)).astype(np.float32)
        r = rng.integers(0, 3, (na, 128)).astype(np.float32)
    else:
        q = rng.random((nb, 128), dtype=np.float32)
        r = rng.random((na, 128), dtype=np.float32)
    qv, rv = np.ones(nb, bool), np.ones(na, bool)
    if case == "dups":  # the same reference on both sides of tile edges
        r[64] = r[63]
        r[130] = r[10]
        r[199] = r[64]
        q[63] = q[64] = r[63]          # d1 = 0 at 63 and 64, and at 199
        q[100] = r[130]
        q[127] = r[128] = q[128]
    if case == "holes":
        rv[60:70] = False              # across the first tile edge
        rv[173:] = False               # 173 live references
        qv[[0, 63, 64, 65, 127]] = False
        qv[149:] = False               # 149 live queries
        r[61] = q[5]                   # masked exact match never wins
    return q, r, qv, rv


@pytest.mark.parametrize("case", ["dups", "ints", "holes"])
def test_tiled_merge_equals_untiled_plain(case):
    """Per-tile partial top-2s over 64-wide tiles, merged in ascending
    tile order by ``merge_top2_plain``, equal the untiled
    ``two_nearest_plain`` bit for bit in both directions: d1 and d2 on
    every row (BIG on invalid ones), i1 on valid rows."""
    q, r, qv, rv = (T(a) for a in _merge_case(case))
    tiled = _tiled_bidir_plain(q, r, qv, rv)
    untiled = (tdist.two_nearest_plain(q, r, qv, rv),
               tdist.two_nearest_plain(r, q, rv, qv))
    ties = 0
    for (d1t, d2t, i1t), (d1u, d2u, i1u), ok in zip(tiled, untiled,
                                                    (qv, rv)):
        assert torch.equal(d1t, d1u) and torch.equal(d2t, d2u)
        assert torch.equal(i1t[ok], i1u[ok])
        assert (i1t[~ok] == 0).all()
        ties += int(((d1u == d2u) & ok).sum())
    if case in ("dups", "ints"):
        assert ties > 0  # the case does exercise exact ties


@pytest.mark.parametrize("case", ONE_WAY_CASES)
def test_one_way_tiled_plan_equals_plain_and_jax(case):
    """Kernel B7's plan in plain PyTorch (each query's partial top-2 over
    every live 64-reference tile, merged in ascending tile order) equals
    the untiled ``two_nearest_plain`` bit for bit: d1, d2 and i1 on every
    row (BIG, BIG, 0 on invalid queries and when no reference is valid).
    Against the JAX ``two_nearest`` on its exact path: d1 / d2 rtol 1e-5,
    i1 equal on valid queries."""
    qry, ref, qv, rv = _one_way_case(case)
    args = [T(a) for a in (qry, ref, qv, rv)]
    d1t, d2t, i1t = tdist.two_nearest_tiled_plain(*args)
    d1u, d2u, i1u = tdist.two_nearest_plain(*args)
    assert torch.equal(d1t, d1u) and torch.equal(d2t, d2u)
    assert torch.equal(i1t[args[2]], i1u[args[2]])
    assert (i1t[~args[2]] == 0).all()
    assert (d1t[~args[2]] > 1e37).all() and (d2t[~args[2]] > 1e37).all()
    if case == "dups":
        assert int(((d1u == d2u) & args[2]).sum()) > 0  # exact ties at d1
        assert d1t[63] == d2t[63] == 0 and int(i1t[63]) == 63
    if not rv.any():
        assert (d1t > 1e37).all() and (i1t == 0).all()
        return  # no reference to compare on (JAX refuses an empty axis)
    d1j, d2j, i1j = jdist.two_nearest(
        *(jnp.asarray(a) for a in (qry, ref, qv, rv)), "l1", "off", "exact")
    np.testing.assert_allclose(d1t.numpy()[qv], np.asarray(d1j)[qv],
                               rtol=1e-5)
    np.testing.assert_allclose(d2t.numpy()[qv], np.asarray(d2j)[qv],
                               rtol=1e-5)
    # an exact tie at d1 between two references may break either way under
    # another summation order only when their sums differ: these are equal
    # rows, so the lowest index wins in both packages
    np.testing.assert_array_equal(i1t.numpy()[qv], np.asarray(i1j)[qv])
    assert rv[i1t.numpy()[qv]].all()


def test_merge_top2_plain_ties_and_order():
    """Two tiles tied at d1: the earlier tile's index wins and d2 = d1; a
    later, strictly smaller d1 wins and pushes the old d1 into d2; a tile
    of BIG (no valid entry) changes nothing; invalid rows get BIG."""
    big = float(np.float32(tdist.BIG))
    d1 = T(np.array([[5.0, 5.0, 7.0], [5.0, 3.0, big], [big] * 3],
                    np.float32))
    d2 = T(np.array([[9.0, 6.0, 8.0], [6.0, 6.0, big], [big] * 3],
                    np.float32))
    i1 = T(np.array([[3, 3, 1], [70, 80, 0], [0, 0, 0]]))
    ok = T(np.array([True, True, False]))
    m1, m2, mi = tdist.merge_top2_plain(d1, d2, i1, ok)
    assert m1.tolist() == [5.0, 3.0, big]
    assert m2.tolist() == [5.0, 5.0, big]
    assert mi.tolist() == [3, 80, 0]


def test_match_features_bidir_equal(jax_feats):
    """Equal pairs and n_raw in both directions."""
    stacked, _ = jax_feats
    fa, fb = _feat(stacked, 0), _feat(stacked, 1)
    jab, jba = jmatcher.match_features_bidir(
        _jfeat(fa), _jfeat(fb), 0.5, "l1", 512, "off", "exact")
    tab, tba = tmatcher.match_features_bidir(
        features_from_numpy(fa, "cpu"), features_from_numpy(fb, "cpu"),
        0.5, "l1", 512)
    for t, j in ((tab, jab), (tba, jba)):
        assert int(t.n_raw) == int(np.asarray(j.n_raw)) > 10
        np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
        v = t.valid.numpy()
        np.testing.assert_array_equal(t.src_xy.numpy()[v],
                                      np.asarray(j.src_xy)[v])
        np.testing.assert_array_equal(t.dst_xy.numpy()[v],
                                      np.asarray(j.dst_xy)[v])


def _pallas_distance_case(case):
    """The inputs of tests/test_pallas_distance.py:13-60 and the Pallas
    tiling each uses: a hole in the reference mask, invalid queries, and
    live prefixes."""
    rng = np.random.default_rng(0)
    nb, na, f = (128, 256, 64) if case == "invalid_queries" else (256, 512,
                                                                   128)
    qry = rng.normal(size=(nb, f)).astype(np.float32)
    ref = rng.normal(size=(na, f)).astype(np.float32)
    qv, rv = np.ones(nb, bool), np.ones(na, bool)
    tiles = dict(tb=128, ta=128, kc=32)
    if case == "ref_mask_hole":
        rv[100:120] = False
        tiles["ta"] = 256
    elif case == "invalid_queries":
        qv[10:] = False
    else:
        qv, rv = np.arange(nb) < 130, np.arange(na) < 200
    return (qry, ref, qv, rv), tiles


@pytest.mark.parametrize("case", ["ref_mask_hole", "invalid_queries",
                                  "live_prefix"])
def test_two_nearest_matches_one_direction_pallas(case):
    """Plain version of B7 vs two_nearest_l1_pallas(interpret=True): d1/d2
    rtol 1e-5 on valid queries, i1 equal, invalid queries at BIG; masked
    references never win."""
    args, tiles = _pallas_distance_case(case)
    d1t, d2t, i1t = tdist.two_nearest(*(T(a) for a in args))
    d1j, d2j, i1j = two_nearest_l1_pallas(*args, **tiles, interpret=True)
    qv, rv = args[2], args[3]
    np.testing.assert_allclose(d1t.numpy()[qv], np.asarray(d1j)[qv],
                               rtol=1e-5)
    np.testing.assert_allclose(d2t.numpy()[qv], np.asarray(d2j)[qv],
                               rtol=1e-5)
    np.testing.assert_array_equal(i1t.numpy()[qv], np.asarray(i1j)[qv])
    assert (d1t.numpy()[~qv] > 1e37).all() and (d2t.numpy()[~qv] > 1e37).all()
    assert rv[i1t.numpy()[qv]].all()


def test_ratio_match_and_matcher_api_match_jax(jax_feats):
    """B7's callers: ratio_match, match_features, match_count and
    match_config_call against the JAX functions (pallas="off",
    method="exact"): equal masks, indices, pairs and n_raw; and
    match_features under distance="l2"."""
    stacked, _ = jax_feats
    fa, fb = _feat(stacked, 0), _feat(stacked, 1)
    ok_t, i1_t = tdist.ratio_match(T(fb[0]), T(fa[0]), T(fb[3]), T(fa[3]))
    ok_j, i1_j = jdist.ratio_match(fb[0], fa[0], fb[3], fa[3], 0.5, "l1",
                                   "off", "exact")
    ok_j = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    np.testing.assert_array_equal(i1_t.numpy()[ok_j], np.asarray(i1_j)[ok_j])

    ta, tb = features_from_numpy(fa, "cpu"), features_from_numpy(fb, "cpu")
    jp = jmatcher.match_features(_jfeat(fa), _jfeat(fb), 0.5, "l1", 512,
                                 "off", "exact")
    mcfg = dataclasses.replace(CFG.match, max_matches=512)
    for tp in (tmatcher.match_features(ta, tb, 0.5, "l1", 512),
               tmatcher.match_config_call(ta, tb, mcfg)):
        assert int(tp.n_raw) == int(np.asarray(jp.n_raw)) > 10
        np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
        v = tp.valid.numpy()
        np.testing.assert_array_equal(tp.src_xy.numpy()[v],
                                      np.asarray(jp.src_xy)[v])
        np.testing.assert_array_equal(tp.dst_xy.numpy()[v],
                                      np.asarray(jp.dst_xy)[v])
    jn = jmatcher.match_count(_jfeat(fa), _jfeat(fb), 0.5, "l1", "off",
                              "exact")
    assert int(tmatcher.match_count(ta, tb)) == int(np.asarray(jn))
    # distance="l2" is ported: the same pairs as the JAX package's
    tp = tmatcher.match_features(ta, tb, 0.5, "l2", 512)
    jp = jmatcher.match_features(_jfeat(fa), _jfeat(fb), 0.5, "l2", 512,
                                 "off")
    assert int(tp.n_raw) == int(np.asarray(jp.n_raw)) > 10
    v = np.asarray(jp.valid)
    np.testing.assert_array_equal(tp.valid.numpy(), v)
    np.testing.assert_array_equal(tp.src_xy.numpy()[v],
                                  np.asarray(jp.src_xy)[v])


def test_match_features_is_first_direction_of_bidir(jax_feats):
    """match_features(a, b) equals match_features_bidir(a, b)[0], as the
    JAX docstring promises (models/matcher.py:55-57)."""
    stacked, _ = jax_feats
    ta = features_from_numpy(_feat(stacked, 1), "cpu")
    tb = features_from_numpy(_feat(stacked, 2), "cpu")
    one = tmatcher.match_features(ta, tb)
    ab, _ = tmatcher.match_features_bidir(ta, tb)
    for x, y in zip(one, ab):
        assert torch.equal(x, y)


def test_features_numpy_round_trip(jax_feats):
    stacked, _ = jax_feats
    f = features_from_numpy(_feat(stacked, 2), "cpu")
    assert isinstance(f, Features) and f.valid.dtype == torch.bool
    for a, b in zip(features_to_numpy(f), _feat(stacked, 2)):
        np.testing.assert_array_equal(a, b)
    assert int(f.count()) == int(_feat(stacked, 2)[3].sum())


# ------------------------------------------------------------------ rng
@pytest.mark.parametrize("data", [0, 1, 65537, 131072 + 1, 2 ** 32 - 1])
def test_threefry_bit_exact(data):
    """PRNGKey(666666), fold_in on uint32 edge ids, uniform((128, 4)) —
    the calls of registration.py:63-66 and ransac.py:82."""
    jkey = jax.random.PRNGKey(666666)
    tkey = trng.prng_key(666666)
    np.testing.assert_array_equal(tkey.numpy(),
                                  np.asarray(jkey).astype(np.int64))
    jk = jax.random.fold_in(jkey, jnp.asarray(data, jnp.uint32))
    tk = trng.fold_in(tkey, data)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))
    for tag in (0, 1):
        ju = np.asarray(jax.random.uniform(jax.random.fold_in(jk, tag),
                                           (128, 4)))
        tu = trng.uniform(trng.fold_in(tk, tag), (128, 4)).numpy()
        np.testing.assert_array_equal(tu.view(np.uint32), ju.view(np.uint32))


# ------------------------------------------------------- solve, RANSAC
def _pairs(jax_feats):
    stacked, _ = jax_feats
    jab, _ = jmatcher.match_features_bidir(
        _jfeat(_feat(stacked, 0)), _jfeat(_feat(stacked, 1)), 0.5, "l1",
        512, "off", "exact")
    arrs = [np.array(a) for a in jab]
    return jab, MatchPairs(*(T(a) for a in arrs))


def test_solve_warp(jax_feats):
    """Minimal 4-point solves (batched) and the weighted warm-started
    refit: coefficients rtol 1e-4. The 4-point samples take one point per
    quadrant of the matched region: a near-collinear sample is
    ill-conditioned, and any f32 reordering moves its solution."""
    jp, tp = _pairs(jax_feats)
    n = int(tp.valid.sum())
    src, dst = tp.src_xy.numpy()[:n], tp.dst_xy.numpy()[:n]
    right = src[:, 0] > np.median(src[:, 0])
    low = src[:, 1] > np.median(src[:, 1])
    quads = [np.flatnonzero((right == a) & (low == b))
             for a in (False, True) for b in (False, True)]
    rng = np.random.default_rng(3)
    idx = np.stack([[rng.choice(q) for q in quads] for _ in range(16)])
    jc = jax.vmap(jsolve.solve_warp)(jnp.asarray(src[idx]),
                                     jnp.asarray(dst[idx]))
    tc = tsolve.solve_warp(T(src[idx]), T(dst[idx]))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4,
                               atol=1e-5)
    w = (np.arange(n) % 3 != 0).astype(np.float32)
    jr = jsolve.solve_warp(jnp.asarray(src), jnp.asarray(dst),
                           jnp.asarray(w), init=jc[0])
    tr = tsolve.solve_warp(T(src), T(dst), T(w), init=tc[0])
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("gate", [False, True])
def test_ransac_warp(jax_feats, gate):
    """Same MatchPairs and key: coefficients rtol 1e-4, equal inlier
    masks and counts (with and without the corner gate)."""
    jp, tp = _pairs(jax_feats)
    key = jax.random.fold_in(jax.random.PRNGKey(666666), jnp.uint32(1))
    tkey = trng.fold_in(trng.prng_key(666666), 1)
    corner = span = None
    if gate:
        corner = np.array([[0, 0], [159, 0], [0, 159], [159, 159]],
                          np.float32)
        span = 4.0 * np.hypot(160.0, 160.0)
    jc, jm, jn = jransac.ransac_warp(
        jp, key, 64, 4.0, 4, "bilinear", 1,
        None if corner is None else jnp.asarray(corner), span)
    tc, tm, tn = transac.ransac_warp(
        tp, tkey, 64, 4.0, 4, "bilinear", 1,
        None if corner is None else T(corner), span)
    assert int(tn) == int(np.asarray(jn)) > 8
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4,
                               atol=1e-6)


def test_plan_edges_on_jax_features(jax_feats):
    """The whole edge plan fed the JAX package's own features: equal
    canvas dims, min_x / min_y within 0.5 px, coefficients rtol 1e-3."""
    stacked, img_hw = jax_feats
    edges = [(1, 2, 1), (1, 0, 2)]
    jplan = np.asarray(jreg.plan_edges(
        _jfeat(stacked), jnp.asarray(np.asarray(edges, np.int32)), img_hw,
        img_hw, CFG))
    tplan = treg.plan_edges(features_from_numpy(stacked, "cpu"), edges,
                            img_hw, img_hw, CFG)
    assert tplan.shape == jplan.shape == (2, treg.PLAN_ROW)
    np.testing.assert_array_equal(tplan[:, 20:], jplan[:, 20:])
    np.testing.assert_allclose(tplan[:, 18:20], jplan[:, 18:20], atol=0.5)
    np.testing.assert_allclose(tplan[:, :18], jplan[:, :18], rtol=1e-3,
                               atol=1e-5)
    # a sane chain: the canvas grows by about one crop step per edge
    assert 160 <= jplan[-1, 20] <= 360 and jplan[-1, 21] <= 200
