"""The port's ``warp_model="projective"`` against the JAX package on the
CPU: the homography solver, RANSAC's hypotheses and refit, the warp of
both models (the plain version of kernel B6), and a two-crop stitch in the
planned and the incremental loop.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervisionimagestich2_tpu.core.types import MatchPairs as JPairs
from computervisionimagestich2_tpu.models.ransac import ransac_warp as jransac
from computervisionimagestich2_tpu.models.stitcher import Stitcher as JStitcher
from computervisionimagestich2_tpu.ops import solve as jsolve
from computervisionimagestich2_tpu.ops import warp as jwarp
from computervisionimagestich2_tpu_torch.core.types import MatchPairs
from computervisionimagestich2_tpu_torch.models import compose
from computervisionimagestich2_tpu_torch.models.ransac import ransac_warp
from computervisionimagestich2_tpu_torch.models.stitcher import (
    Stitcher as TStitcher)
from computervisionimagestich2_tpu_torch.ops import rng as trng
from computervisionimagestich2_tpu_torch.ops import solve as tsolve
from computervisionimagestich2_tpu_torch.ops import warp as twarp
from test_integration import make_scene
from test_torch_graph_stitch import SMALL_DEFAULT
from test_torch_incremental import _one_torch_thread  # noqa: F401

T = torch.as_tensor
JSOLVE_BATCH = jax.jit(jax.vmap(jsolve.solve_projective))
# the homographies of tests/test_projective.py
H_SOLVE = np.array([1.05, 0.08, 20.0, -0.04, 0.97, 5.0, 1e-4, -5e-5, 1.0])
H_RANSAC = np.array([1.0, 0.03, 50.0, -0.02, 1.02, -8.0, 5e-5, 1e-5, 1.0])


def apply_h(h, x, y):
    den = h[6] * x + h[7] * y + h[8]
    return ((h[0] * x + h[1] * y + h[2]) / den,
            (h[3] * x + h[4] * y + h[5]) / den)


def test_solve_projective_recovers_homography():
    """tests/test_projective.py's case: the port's fit reprojects within
    0.2 px of the true homography and of the JAX package's fit; batched
    4-point solves (one per RANSAC hypothesis) agree with the vmapped JAX
    solver to rtol 1e-3 (f32 sums in another order)."""
    rng = np.random.default_rng(0)
    src = rng.uniform(0, 500, (30, 2)).astype(np.float32)
    u, v = apply_h(H_SOLVE, src[:, 0], src[:, 1])
    dst = np.stack([u, v], -1).astype(np.float32)
    got = tsolve.solve_projective(T(src), T(dst))
    ref = np.asarray(jax.jit(jsolve.solve_projective)(src, dst))
    assert got.shape == (9,) and float(got[8]) == 1.0
    gu, gv = twarp.projective_xy(got, T(src[:, 0]), T(src[:, 1]))
    ju, jv = apply_h(ref, src[:, 0], src[:, 1])
    for g, want, j in ((gu, u, ju), (gv, v, jv)):
        np.testing.assert_allclose(g.numpy(), want, atol=0.2)
        np.testing.assert_allclose(g.numpy(), j, atol=0.2)
    idx = np.stack([rng.permutation(30)[:4] for _ in range(16)])
    jb = np.asarray(JSOLVE_BATCH(src[idx], dst[idx]))
    tb = tsolve.solve_projective(T(src[idx]), T(dst[idx])).numpy()
    np.testing.assert_allclose(tb, jb, rtol=1e-3, atol=1e-7)


def test_solve_spd_equals_jax_bit_for_bit():
    """The unrolled Cholesky solve sums in the JAX package's order, term by
    term: on the same 8 x 8 SPD systems (batched here, one by one there,
    op by op) the solutions are equal to the bit."""
    rng = np.random.default_rng(2)
    m = rng.normal(size=(6, 12, 8)).astype(np.float32)
    a = (np.swapaxes(m, 1, 2) @ m + np.float32(1e-3) * np.eye(8)).astype(
        np.float32)
    b = rng.normal(size=(6, 8, 1)).astype(np.float32)
    got = tsolve._solve_spd(T(a), T(b)).numpy()
    with jax.disable_jit():
        ref = np.stack([np.asarray(jsolve._solve_spd(jnp.asarray(x),
                                                      jnp.asarray(y)))
                        for x, y in zip(a, b)])
    np.testing.assert_array_equal(got, ref)


def _outlier_pairs():
    """tests/test_projective.py's RANSAC case: 60 pairs of which the first
    15 are pushed 60-150 px off, in a capacity of 128."""
    rng = np.random.default_rng(1)
    n, cap = 60, 128
    src = rng.uniform(0, 400, (n, 2)).astype(np.float32)
    u, v = apply_h(H_RANSAC, src[:, 0], src[:, 1])
    dst = np.stack([u, v], -1).astype(np.float32)
    dst[:15] += rng.uniform(60, 150, (15, 2)).astype(np.float32)
    pad = lambda a: np.pad(a, ((0, cap - n), (0, 0)))  # noqa: E731
    valid = np.zeros(cap, bool)
    valid[:n] = True
    return src, u, v, (pad(src), pad(dst), valid)


@pytest.mark.parametrize("lo_iters", [0, 1])
def test_ransac_projective_matches_jax(lo_iters):
    """Same pairs and key: the same final inlier count and mask, and a
    model within 1.0 px of the truth on the inliers. The hypotheses (the
    same 128 threefry draws, solved by both): the same best count, and the
    same best hypothesis, index and count, among those whose count float32
    rounding cannot move. A sample with two points a few px apart is
    ill-conditioned, and its f32 model moves with the summation order (the
    JAX package's jitted and op-by-op solves differ there by 1e-2 in the
    coefficients); a hypothesis is stable where the port's and JAX's
    counts both equal the count under a float64 solve."""
    src, u, v, arrays = _outlier_pairs()
    jkey, tkey = jax.random.PRNGKey(1), trng.prng_key(1)
    jc, jm, jn = jransac(JPairs(*(jnp.asarray(a) for a in arrays)), jkey,
                         model="projective", lo_iters=lo_iters)
    pairs = MatchPairs(*(T(a) for a in arrays))
    tc, tm, tn = ransac_warp(pairs, tkey, model="projective",
                             lo_iters=lo_iters)
    assert int(tn) == int(np.asarray(jn)) >= 42
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    gu, gv = twarp.warp_points(tc, T(src[15:, 0]), T(src[15:, 1]),
                               "projective")
    np.testing.assert_allclose(gu.numpy(), u[15:], atol=1.0)
    np.testing.assert_allclose(gv.numpy(), v[15:], atol=1.0)

    # the hypotheses themselves: the draws of ransac_warp, solved by both
    ju = np.asarray(jax.random.uniform(jkey, (128, 4)))
    np.testing.assert_array_equal(trng.uniform(tkey, (128, 4)).numpy(), ju)
    idx = np.minimum((ju * np.float32(60.0)).astype(np.int32), 59)
    s, d = arrays[0][idx], arrays[1][idx]

    def counts(coeffs):
        xw, yw = apply_h(coeffs.T[:, :, None], src[None, :, 0],
                         src[None, :, 1])
        dx = xw - arrays[1][None, :60, 0]
        dy = yw - arrays[1][None, :60, 1]
        return (np.sqrt(dx * dx + dy * dy) < 4.0).sum(axis=1)

    jk = counts(np.asarray(JSOLVE_BATCH(s, d)))
    tk = counts(tsolve.solve_projective(T(s), T(d)).numpy())
    k64 = counts(tsolve.solve_projective(T(s).double(),
                                         T(d).double()).numpy())
    stable = (jk == k64) & (tk == k64)
    assert (~stable).sum() <= 8, np.flatnonzero(~stable)
    assert tk.max() == jk.max() >= 42
    best_t = int(np.argmax(np.where(stable, tk, -1)))
    best_j = int(np.argmax(np.where(stable, jk, -1)))
    assert best_t == best_j and tk[best_t] == jk[best_j] == jk.max()


# a homography whose horizon (den = 0) crosses the canvas near x = 95
H_HORIZON = np.array([1.0, 0.02, 3.0, 0.01, 1.0, 2.0, -0.0105, 1e-4, 1.0],
                     np.float32)


@pytest.mark.parametrize("model,coeffs,canvas", [
    ("bilinear", [1.01, 0.02, 1e-4, -7.5, -0.015, 0.99, 2e-4, 5.25],
     (80, 90)),
    ("projective", [0.98, 0.03, -4.0, -0.02, 1.01, 6.5, 2e-4, -1e-4, 1.0],
     (81, 93)),
    ("projective", H_HORIZON.tolist(), (70, 130)),
], ids=["bilinear", "projective", "projective_horizon"])
def test_warp_image_plain_matches_jax(model, coeffs, canvas):
    """The plain version of B6 against the JAX package's warp_image op by
    op (jax.disable_jit: jitted XLA:CPU contracts multiply-adds), exact,
    for both models; the horizon case has inf / NaN source coordinates on
    the canvas, which must write 0. Host floats and a tensor give the same
    canvas."""
    rng = np.random.default_rng(14)
    src = rng.integers(0, 256, (60, 50, 3)).astype(np.float32)
    c = np.asarray(coeffs, np.float32)
    with jax.disable_jit():
        ref = np.asarray(jwarp.warp_image(
            jnp.asarray(src), jnp.asarray(c), jnp.float32(-3.5),
            jnp.float32(-7.25), out_shape=canvas, model=model))
    out = twarp.warp_image_plain(T(src), T(c), -3.5, -7.25, canvas, model)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (ref != 0).any() and (ref == 0).any()
    np.testing.assert_array_equal(
        twarp.warp_image(T(src), c.tolist(), -3.5, -7.25, canvas,
                         model).numpy(), ref)
    if model == "projective" and c[6] < -0.01:
        xs = np.arange(canvas[1], dtype=np.float32) - 3.5
        den = c[6] * xs + c[7] * (-7.25) + c[8]
        assert (den > 0).any() and (den < 0).any()  # the horizon crosses


def test_warp_image_refuses_wrong_coefficient_count():
    src = torch.zeros((4, 4, 3))
    with pytest.raises(ValueError, match="9 coefficients"):
        twarp.warp_image(src, [1.0] * 8, 0.0, 0.0, (4, 4), "projective")
    with pytest.raises(ValueError, match="unknown warp model"):
        twarp.warp_image(src, [1.0] * 8, 0.0, 0.0, (4, 4), "affine")


def test_canvas_plan_matches_jax():
    """The host canvas plan of a projective forward model, as in the JAX
    package (compose.canvas_plan)."""
    from computervisionimagestich2_tpu.models import compose as jcompose

    fwd = np.array([1.02, 0.01, 95.0, -0.01, 0.99, -3.0, 1.5e-4, -2e-5, 1.0],
                   np.float32)
    assert compose.canvas_plan(fwd, (160, 160), (160, 200), "projective") \
        == jcompose.canvas_plan(fwd, (160, 160), (160, 200), "projective")


PROJECTIVE = dataclasses.replace(SMALL_DEFAULT, ordering="chain",
                                 warp_model="projective")


@pytest.fixture(scope="module")
def two_crops():
    scene = make_scene(np.random.default_rng(0), h=160, w=320)
    return [scene[:, :160], scene[:, 80:240]]


@pytest.fixture(scope="module")
def jax_projective(two_crops):
    return JStitcher(PROJECTIVE).stitch(two_crops)


@pytest.mark.parametrize("planned", [True, False],
                         ids=["planned", "incremental"])
def test_projective_stitch_matches_jax(two_crops, jax_projective, planned,
                                       capfd):
    """Two crops, chain ordering, projective warps: the port's canvas
    against the JAX package's planned stitch, shape within +-3 px and MAD
    <= 3 u8 levels (tests/test_torch_stitch.py's gate), as wide as the
    scene. No match_overflow is logged: the incremental loop reads the
    overflow from its own slot of the readback, not from h[8]."""
    cfg = dataclasses.replace(PROJECTIVE, planned=planned)
    capfd.readouterr()
    out_t = TStitcher(cfg, device="cpu").stitch(two_crops)
    assert "match_overflow" not in capfd.readouterr().err
    out_j = jax_projective
    assert out_t.dtype == np.uint8
    assert abs(out_t.shape[0] - out_j.shape[0]) <= 3
    assert abs(out_t.shape[1] - out_j.shape[1]) <= 3
    assert 220 <= out_j.shape[1] <= 256, out_j.shape
    h = min(out_t.shape[0], out_j.shape[0])
    w = min(out_t.shape[1], out_j.shape[1])
    mad = np.abs(out_t[:h, :w].astype(np.int64)
                 - out_j[:h, :w].astype(np.int64)).mean()
    assert mad <= 3.0, mad
