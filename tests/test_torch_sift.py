"""PyTorch port vs the JAX package: the SIFT stages.

Detection is compared exactly on the same DoG input, refinement and the
gradient field within f32 rounding, and the whole extractor at the gates
of tests/test_sift.py. The walks (kernels B2 and B3) are in
tests/test_torch_walks.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervisionimagestich2_tpu.config import SiftConfig
from computervisionimagestich2_tpu.models import sift as jsift
from computervisionimagestich2_tpu.ops import color as jcolor
from computervisionimagestich2_tpu.ops import sift_kernels as jsk
from computervisionimagestich2_tpu_torch.models import sift as tsift
from computervisionimagestich2_tpu_torch.ops import sift_kernels as tsk
from test_integration import make_scene

T = torch.as_tensor
CFG = SiftConfig(n_octaves=2, max_keypoints_per_octave=512,
                 max_keypoints=1024)


def _octave(seed=0, h=56, w=72):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h, w))
    for _ in range(3):
        img = (np.roll(img, 1, 0) + img + np.roll(img, -1, 0)) / 3
        img = (np.roll(img, 1, 1) + img + np.roll(img, -1, 1)) / 3
    return np.trunc(img).astype(np.float32)


@pytest.mark.parametrize("tp,cap", [(0.0, 512), (1.0, 512), (0.5, 8)])
def test_extrema_and_compaction_exact(tp, cap):
    """The contract of kernel B1 on one DoG input: identical masks and
    scan-order candidate lists, including capacity truncation."""
    dog = np.random.default_rng(11).normal(size=(4, 45, 61)).astype(
        np.float32) * 2
    jm = jsk.extrema_mask(jnp.asarray(dog), tp)
    tm = tsk.extrema_mask(T(dog), tp)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    jc, jv = jsk.compact_mask(jm, cap)
    tc, tv = tsk.compact_mask(tm, cap)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_refine_keypoints():
    """Same DoG and candidates: identical acceptance, positions within
    f32 rounding (rtol 1e-5)."""
    first, _ = tsift.scale_space_sigmas(CFG)
    oct_t = tsift.build_octave(T(_octave(1)), CFG, first)
    dog = tsk.dog_stack(oct_t)
    h, w = dog.shape[1:]
    coords, valid = tsk.compact_mask(tsk.extrema_mask(dog, 0.0), 512)
    args = (w, h, 0.0, 10.0, CFG.s_min, CFG.s_max, 1.0, CFG.sigma0,
            CFG.n_levels)
    with jax.disable_jit():
        jout = jsk.refine_keypoints(jnp.asarray(dog.numpy()),
                                    jnp.asarray(coords.numpy(), jnp.int32),
                                    jnp.asarray(valid.numpy()), *args)
    tout = tsk.refine_keypoints(dog, coords, valid, *args)
    ok = np.asarray(jout[0])
    assert ok.sum() > 10
    np.testing.assert_array_equal(tout[0].numpy(), ok)
    np.testing.assert_array_equal(tout[4].numpy()[ok], np.asarray(jout[4])[ok])
    for t, j in zip(tout[1:4] + tout[5:], jout[1:4] + jout[5:]):
        np.testing.assert_allclose(t.numpy()[ok], np.asarray(j)[ok],
                                   rtol=1e-5, atol=1e-6)


def test_polar_gradient():
    levels = np.random.default_rng(2).uniform(0, 255, (2, 30, 41)).astype(
        np.float32)
    jg = np.asarray(jsk.polar_gradient(jnp.asarray(levels)))
    tg = tsk.polar_gradient(T(levels)).numpy()
    np.testing.assert_allclose(tg[:, 0], jg[:, 0], rtol=1e-6, atol=1e-4)
    # angles on the circle: atan2 implementations differ by ulps, and a
    # value at the 0 / 2pi seam may land on either side
    d = np.abs(tg[:, 1] - jg[:, 1])
    assert np.minimum(d, 2 * np.pi - d).max() < 1e-5


@pytest.fixture(scope="module")
def scene_gray():
    img = make_scene(np.random.default_rng(0), h=120, w=160)
    return np.array(jcolor.to_gray(jnp.asarray(img, jnp.float32)))


def test_sift_extract_stats_matches_jax(scene_gray):
    """Gates of tests/test_sift.py:43-62: counts within max(2, 5%), >= 90%
    of the JAX keypoints within 0.5 px of a port keypoint, best co-located
    descriptor cosine > 0.999; the overflow telemetry is equal."""
    jf, js = jsift.sift_extract_stats(jnp.asarray(scene_gray), CFG)
    tf, ts = tsift.sift_extract_stats(T(scene_gray), CFG)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    jv, tv = np.asarray(jf.valid), tf.valid.numpy()
    jxy, txy = np.asarray(jf.xy)[jv], tf.xy.numpy()[tv]
    jd, td = np.asarray(jf.desc)[jv], tf.desc.numpy()[tv]
    assert len(jxy) > 20
    assert abs(len(jxy) - len(txy)) <= max(2, 0.05 * len(jxy))
    d = np.linalg.norm(jxy[:, None] - txy[None], axis=-1)
    matched = d.min(axis=1) < 0.5
    assert matched.mean() >= 0.9, matched.mean()
    cos = np.where(d < 0.5, jd @ td.T, -1.0).max(axis=1)[matched]
    assert cos.min() > 0.999, cos.min()


def test_sift_capacity_truncation_matches_jax(scene_gray):
    """With tight capacities every stage truncates: the dropped counts and
    the response-ranked selection agree with the JAX package."""
    cfg = dataclasses.replace(CFG, max_keypoints_per_octave=128,
                              max_keypoints=64)
    jf, js = jsift.sift_extract_stats(jnp.asarray(scene_gray), cfg)
    tf, ts = tsift.sift_extract_stats(T(scene_gray), cfg)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert np.asarray(js)[3] > 0
    assert int(tf.valid.sum()) == int(np.asarray(jf.valid).sum()) == 64
