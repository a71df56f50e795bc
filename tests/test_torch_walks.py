"""PyTorch port vs the JAX package: the per-keypoint SIFT walks, the
plain versions of kernels B2 (orientation histograms) and B3
(descriptors), against the Pallas kernels in interpret mode and the XLA
formulation, at the tolerances of tests/test_pallas_sift.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervisionimagestich2_tpu.ops import pallas_sift as ps
from computervisionimagestich2_tpu.ops import sift_kernels as jsk
from computervisionimagestich2_tpu_torch.ops import sift_kernels as tsk
from computervisionimagestich2_tpu_torch.ops import sift_walks
from test_torch_kernels import WALK_EDGE_RADIUS, _walk_edge_inputs

T = torch.as_tensor


@pytest.fixture(scope="module")
def walk_scene():
    """The scene of tests/test_pallas_sift.py."""
    rng = np.random.default_rng(7)
    h, w = 96, 80
    mod = rng.random((h, w), dtype=np.float32)
    ang = (rng.random((h, w)) * 2 * np.pi).astype(np.float32)
    n, nv = 48, 31
    x = (rng.random(n) * (w - 1) * 1.06 - 2).astype(np.float32)
    y = (rng.random(n) * (h - 1) * 1.06 - 2).astype(np.float32)
    sig = (1.2 + rng.random(n) * 2.5).astype(np.float32)
    a0 = (rng.random(n) * 2 * np.pi).astype(np.float32)
    return h, w, mod, ang, n, nv, x, y, sig, a0


def test_orientation_hist_plain_matches_pallas(walk_scene):
    """B2's plain version vs orientation_hist_pallas(interpret=True): raw
    histograms rtol 1e-5, then angles after orientation_peaks atol 1e-5
    and equal validity (tests/test_pallas_sift.py:44-46)."""
    h, w, mod, ang, n, nv, x, y, sig, _ = walk_scene
    r = 17
    jh, jok = ps.orientation_hist_pallas(
        ps.pad_for_patches(jnp.asarray(mod), r),
        ps.pad_for_patches(jnp.asarray(ang), r), jnp.asarray(x),
        jnp.asarray(y), jnp.asarray(sig), jnp.asarray([nv], jnp.int32),
        w, h, r, 36, interpret=True)
    th, tok = sift_walks.orientation_hist(
        T(mod), T(ang), T(x), T(y), T(sig), T(np.array([nv], np.int32)), r)
    jh = np.asarray(jh)
    np.testing.assert_allclose(th.numpy(), jh, rtol=1e-5,
                               atol=1e-5 * jh.max())
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))

    valid = np.arange(n) < nv
    ja, jav = jsk.orientation_peaks(jnp.asarray(jh),
                                    jok & jnp.asarray(valid), 36, 4)
    ta, tav = tsk.orientation_peaks(th, tok & T(valid), 36, 4)
    np.testing.assert_array_equal(tav.numpy(), np.asarray(jav))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    assert tav.any()


@pytest.mark.parametrize("case", ["border", "radius"])
def test_orientation_hist_plain_edge_cases_match_pallas(case):
    """B2's plain version vs orientation_hist_pallas(interpret=True) on
    keypoints at the image border, and with the window radius at, below
    and above the level's static radius (the walk is capped there) and at
    its minimum of 1: raw histograms rtol 1e-5 (atol 1e-5 x max), equal
    ``ok``, zero rows past the live count."""
    mod, ang, x, y, sig, nv = _walk_edge_inputs(case)
    h, w = mod.shape
    r = WALK_EDGE_RADIUS
    jh, jok = ps.orientation_hist_pallas(
        ps.pad_for_patches(jnp.asarray(mod), r),
        ps.pad_for_patches(jnp.asarray(ang), r), jnp.asarray(x),
        jnp.asarray(y), jnp.asarray(sig), jnp.asarray(nv), w, h, r, 36,
        interpret=True)
    th, tok = sift_walks.orientation_hist(T(mod), T(ang), T(x), T(y),
                                          T(sig), T(nv), r)
    jh = np.asarray(jh)
    np.testing.assert_allclose(th.numpy(), jh, rtol=1e-5,
                               atol=1e-5 * jh.max())
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    n = int(nv[0])
    live = tok.numpy()[:n]
    assert (th.numpy()[n:] == 0).all() and (th.numpy()[:n][~live] == 0).all()
    assert (th.numpy()[:n][live].sum(axis=1) > 0).all()
    if case == "border":
        assert 0 < live.sum() < n  # some keypoints round off the image


def test_descriptors_plain_matches_pallas_and_xla(walk_scene):
    """B3's plain version vs descriptors_pallas(interpret=True) and the
    XLA sift_kernels.descriptors: atol 2e-6, equal ok
    (tests/test_pallas_sift.py:64-66)."""
    h, w, mod, ang, n, nv, x, y, sig, a0 = walk_scene
    r = 28
    jd, jok = ps.descriptors_pallas(
        ps.pad_for_patches(jnp.asarray(mod), r),
        ps.pad_for_patches(jnp.asarray(ang), r), jnp.asarray(x),
        jnp.asarray(y), jnp.asarray(sig), jnp.asarray(a0),
        jnp.asarray([nv], jnp.int32), w, h, r, 3.0, 2.0, 4, 8,
        interpret=True)
    grad = jnp.stack([jnp.asarray(mod), jnp.asarray(ang)], axis=-1)[None]
    gp = jnp.pad(grad, ((0, 0), (r, r), (r, r), (0, 0)))
    xd, xok = jsk.descriptors(gp, jnp.zeros(n, jnp.int32), jnp.asarray(x),
                              jnp.asarray(y), jnp.asarray(sig),
                              jnp.asarray(a0), jnp.arange(n) < nv, w, h, r,
                              3.0, 2.0, 4, 8)
    td, tok = sift_walks.descriptors(T(mod), T(ang), T(x), T(y), T(sig),
                                     T(a0), T(np.array([nv], np.int32)), r)
    for ref_d, ref_ok in ((jd, jok), (xd, xok)):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_ok))
        np.testing.assert_allclose(td.numpy(), np.asarray(ref_d), atol=2e-6)
    assert tok.sum() > 10
