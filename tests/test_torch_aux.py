"""The JAX package's small functions in the port, each against its JAX
counterpart on the CPU: ``reprojection_errors`` and ``ransac_config_call``
(models/ransac.py), ``equalize_gray`` (models/equalization.py),
``gather_pixels`` (ops/warp.py), ``log_sift_overflow_async`` and ``trace``
(utils/obs.py), ``pairwise_l1`` (ops/distance.py) and
``solve_warp_batched`` (ops/solve.py).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervisionimagestich2_tpu.config import RansacConfig as JRansac
from computervisionimagestich2_tpu.core.types import MatchPairs as JPairs
from computervisionimagestich2_tpu.models import equalization as jeq
from computervisionimagestich2_tpu.models import ransac as jransac
from computervisionimagestich2_tpu.ops import distance as jdistance
from computervisionimagestich2_tpu.ops import solve as jsolve
from computervisionimagestich2_tpu.ops import warp as jwarp
from computervisionimagestich2_tpu_torch.config import RansacConfig
from computervisionimagestich2_tpu_torch.core.types import MatchPairs
from computervisionimagestich2_tpu_torch.models import equalization as teq
from computervisionimagestich2_tpu_torch.models import ransac as transac
from computervisionimagestich2_tpu_torch.ops import distance as tdistance
from computervisionimagestich2_tpu_torch.ops import solve as tsolve
from computervisionimagestich2_tpu_torch.ops import rng as trng
from computervisionimagestich2_tpu_torch.ops import warp as twarp
from computervisionimagestich2_tpu_torch.utils import obs
from test_torch_incremental import _one_torch_thread  # noqa: F401

T = torch.as_tensor
# a bilinear map near the identity: x' = x + 0.01 y + 1e-4 x y + 40, ...
COEFFS = np.array([1.0, 0.01, 1e-4, 40.0, -0.02, 1.0, 5e-5, -3.0],
                  np.float32)


def _pairs(seed=0, n=160, cap=192, outliers=40):
    """Match pairs under ``COEFFS`` with 0.5 px noise, ``outliers`` of them
    moved far away, valid as a prefix of ``n`` of ``cap`` slots."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(0, 160, (cap, 2)).astype(np.float32)
    x, y = src[:, 0], src[:, 1]
    c = COEFFS
    dst = np.stack([c[0] * x + c[1] * y + c[2] * x * y + c[3],
                    c[4] * x + c[5] * y + c[6] * x * y + c[7]], -1)
    dst += rng.normal(0, 0.5, dst.shape)
    dst[:outliers] += rng.uniform(30, 90, (outliers, 2)) * rng.choice(
        [-1, 1], (outliers, 2))
    dst = dst.astype(np.float32)
    valid = np.arange(cap) < n
    return ((src, dst, valid, np.int32(n)),
            JPairs(*(jnp.asarray(a) for a in (src, dst, valid, np.int32(n)))),
            MatchPairs(*(T(a) for a in (src, dst, valid, np.array(n)))))


def test_reprojection_errors_matches_jax():
    """Per-pair reprojection L2 under a bilinear model, atol 1e-4."""
    _, jp, tp = _pairs()
    got = transac.reprojection_errors(T(COEFFS), tp).numpy()
    want = np.asarray(jransac.reprojection_errors(jnp.asarray(COEFFS), jp))
    assert got.shape == want.shape == (192,)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.median(got[40:160]) < 1.5  # the inliers sit near the model


@pytest.mark.parametrize("salt,key_seed", [(0, None), (7, None), (3, 123)])
def test_ransac_config_call_matches_jax(salt, key_seed):
    """The draws are bit-exact (the port's threefry), so the same salt
    gives the same hypotheses: equal inlier masks and counts, coefficients
    at the RANSAC tolerance of tests/test_torch_match.py (rtol 1e-4; the
    refit sums in another order). In the port the call is ``ransac_warp``
    under ``fold_in(key, salt)``, bit for bit."""
    _, jp, tp = _pairs(seed=salt)
    cfg, jcfg = RansacConfig(n_hypotheses=64), JRansac(n_hypotheses=64)
    jkey = None if key_seed is None else jax.random.PRNGKey(key_seed)
    tkey = None if key_seed is None else trng.prng_key(key_seed)
    tc, tm, tn = transac.ransac_config_call(tp, cfg, tkey, salt)
    jc, jm, jn = jransac.ransac_config_call(jp, jcfg, jkey, salt)
    assert int(tn) == int(np.asarray(jn)) >= 100
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4,
                               atol=1e-6)
    base = trng.prng_key(cfg.seed if key_seed is None else key_seed)
    again = transac.ransac_warp(tp, trng.fold_in(base, salt), 64, 4.0, 4,
                                lo_iters=cfg.lo_iters)
    assert all(torch.equal(a, b) for a, b in zip((tc, tm, tn), again))


@pytest.mark.parametrize("shape", [(48, 64), (37, 91)])
def test_equalize_gray_matches_jax(shape):
    """Gray-mode equalization exactly (the JAX side unjitted: jitted
    XLA:CPU contracts the luma's multiply-adds into FMAs, which moves u8
    truncations; tests/test_torch_ops.py)."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, shape + (3,)).astype(np.float32)
    img[: shape[0] // 3] *= 0.3  # a dark band: a skewed histogram
    got = teq.equalize_gray(T(img)).numpy()
    with jax.disable_jit():
        want = np.asarray(jeq.equalize_gray(jnp.asarray(img)))
    assert got.shape == shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [3, None])
def test_gather_pixels_matches_jax(channels):
    """img[yi, xi] on integer index arrays of any shape, exactly."""
    rng = np.random.default_rng(5)
    shape = (20, 30) + ((channels,) if channels else ())
    img = rng.random(shape).astype(np.float32)
    yi = rng.integers(0, 20, (7, 9)).astype(np.int32)
    xi = rng.integers(0, 30, (7, 9)).astype(np.int32)
    got = twarp.gather_pixels(T(img), T(xi).long(), T(yi).long()).numpy()
    want = np.asarray(jwarp.gather_pixels(jnp.asarray(img), jnp.asarray(xi),
                                          jnp.asarray(yi)))
    np.testing.assert_array_equal(got, want)


def test_log_sift_overflow_async_warns(capfd):
    """The report runs on a daemon thread that the caller can join: one
    warning line per image with drops, in the JAX package's format, and
    none for a healthy image; a tensor is read back on the thread."""
    stats = torch.tensor([[0, 0, 0, 0], [3, 0, 1, 2]], dtype=torch.int32)
    t = obs.log_sift_overflow_async(stats)
    t.join(timeout=30)
    assert not t.is_alive() and t.daemon
    err = capfd.readouterr().err
    assert err.count("WARNING sift_overflow") == 1, err
    assert ("image=1 dropped_candidates=3 dropped_keypoints=0 "
            "dropped_descriptors=1 dropped_final=2") in err, err


def test_trace_is_a_no_op_without_the_variable(monkeypatch, tmp_path):
    monkeypatch.delenv("PANORAMA_TPU_TRACE", raising=False)
    monkeypatch.chdir(tmp_path)
    with obs.trace("features"):
        x = torch.ones(8).sum()
    assert float(x) == 8.0
    assert not any(tmp_path.iterdir())


def test_trace_writes_a_profile(monkeypatch, tmp_path):
    """With PANORAMA_TPU_TRACE set, the block's torch.profiler trace lands
    under <dir>/<label> as a Chrome trace that names the ops it ran."""
    monkeypatch.setenv("PANORAMA_TPU_TRACE", str(tmp_path))
    with obs.trace("stitching"):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    files = list((tmp_path / "stitching").glob("*.json"))
    assert len(files) == 1, list(tmp_path.rglob("*"))
    text = files[0].read_text()
    assert "aten::matmul" in text or "aten::mm" in text


def test_pairwise_l1_matches_jax():
    """All-pairs L1 of 128-d descriptors, rtol 1e-6 (sums of 128 terms in
    another order); two_nearest_plain is built on it."""
    rng = np.random.default_rng(4)
    q = rng.uniform(0, 0.2, (37, 128)).astype(np.float32)
    r = rng.uniform(0, 0.2, (53, 128)).astype(np.float32)
    got = tdistance.pairwise_l1(T(q), T(r)).numpy()
    want = np.asarray(jdistance.pairwise_l1(jnp.asarray(q), jnp.asarray(r)))
    assert got.shape == (37, 53)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_solve_warp_batched_matches_jax(weighted):
    """A batch of bilinear fits over one shared weight vector (the JAX
    vmap's in_axes (0, 0, None)): coefficients rtol 1e-4, atol 1e-5, as
    tests/test_torch_match.py::test_solve_warp holds solve_warp."""
    (src, dst, _, _), _, _ = _pairs(outliers=0)
    src = np.stack([src[:96], src[96:]])
    dst = np.stack([dst[:96], dst[96:]])
    w = (np.arange(96) % 4 != 0).astype(np.float32) if weighted else None
    got = tsolve.solve_warp_batched(
        T(src), T(dst), None if w is None else T(w)).numpy()
    want = np.asarray(jsolve.solve_warp_batched(
        jnp.asarray(src), jnp.asarray(dst), None if w is None
        else jnp.asarray(w)))
    assert got.shape == (2, 8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
