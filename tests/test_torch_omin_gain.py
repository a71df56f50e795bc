"""The port's upsampled first octave (``sift.o_min=-1``) and scalar luma
gain (``blend.gain_mode="luma"``) against the JAX package on the CPU: the
row upsample exactly, the extractor at the feature gates of
tests/test_torch_sift.py, the gain on the cases of
tests/test_streaming_gain.py, and a stitch with both switched on.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervisionimagestich2_tpu.config import SiftConfig
from computervisionimagestich2_tpu.models import gain as jgain
from computervisionimagestich2_tpu.models import sift as jsift
from computervisionimagestich2_tpu.models.stitcher import Stitcher as JStitcher
from computervisionimagestich2_tpu.ops import resize as jresize
from computervisionimagestich2_tpu_torch.models import gain as tgain
from computervisionimagestich2_tpu_torch.models import sift as tsift
from computervisionimagestich2_tpu_torch.models.stitcher import (
    Stitcher as TStitcher)
from computervisionimagestich2_tpu_torch.ops import resize as tresize
from test_integration import make_scene
from test_sift import make_image
from test_torch_graph_stitch import SMALL_DEFAULT
from test_torch_incremental import _one_torch_thread  # noqa: F401

T = torch.as_tensor


@pytest.mark.parametrize("shape", [(5, 7), (2, 64, 80)])
def test_vlfeat_upsample_rows_exact(shape):
    """One call doubles the rows' length and transposes; two double an
    image. Exact against the JAX package (midpoints of f32 values)."""
    x = np.random.default_rng(3).uniform(0, 255, shape).astype(np.float32)
    one = tresize.vlfeat_upsample_rows(T(x))
    assert one.shape == shape[:-2] + (2 * shape[-1], shape[-2])
    np.testing.assert_array_equal(
        one.numpy(), np.asarray(jresize.vlfeat_upsample_rows(jnp.asarray(x))))
    two = tresize.vlfeat_upsample_rows(one)
    ref = jresize.vlfeat_upsample_rows(
        jresize.vlfeat_upsample_rows(jnp.asarray(x)))
    assert two.shape == shape[:-2] + (2 * shape[-2], 2 * shape[-1])
    np.testing.assert_array_equal(two.numpy(), np.asarray(ref))


def test_sift_omin_negative_matches_jax():
    """The image and configuration of tests/test_sift.py's o_min=-1 test:
    the overflow telemetry is equal; counts within max(2, 5%), >= 90% of
    the JAX keypoints within 0.5 px of a port keypoint, best co-located
    descriptor cosine > 0.999 (tests/test_torch_sift.py's gates); the
    upsampled octave finds keypoints below the o_min=0 scales, in input
    coordinates."""
    img = make_image(7, (64, 80))
    cfg = SiftConfig(n_octaves=3, o_min=-1, max_keypoints_per_octave=512,
                     max_keypoints=1024)
    jf, js = jsift.sift_extract_stats(jnp.asarray(img), cfg)
    tf, ts = tsift.sift_extract_stats(T(img), cfg)
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
    t0 = tsift.sift_extract(T(img), dataclasses.replace(cfg, n_octaves=2,
                                                        o_min=0))
    assert tf.scale.numpy()[tv].min() < 0.75 * t0.scale[t0.valid].min()
    assert txy.min() >= 0 and txy[:, 0].max() < 80 and txy[:, 1].max() < 64


def _step_canvases():
    h, w = 40, 60
    a = np.zeros((h, w, 3), np.float32)
    b = np.zeros((h, w, 3), np.float32)
    a[:, 20:] = 80.0
    b[:, :40] = 160.0
    return a, b


def _tint_canvases():
    h, w = 40, 60
    scale = np.asarray([0.8, 1.1, 0.6], np.float32)
    base = np.random.default_rng(0).uniform(60, 180, (h, w, 3)).astype(
        np.float32)
    a = np.zeros((h, w, 3), np.float32)
    b = np.zeros((h, w, 3), np.float32)
    a[:, 20:] = base[:, 20:] * scale
    b[:, :40] = base[:, :40]
    return a, b


def _clamp_canvases():
    return (np.full((10, 10, 3), 10.0, np.float32),
            np.full((10, 10, 3), 250.0, np.float32))


@pytest.mark.parametrize("case", [_step_canvases, _tint_canvases,
                                  _clamp_canvases],
                         ids=["step", "tint", "clamped"])
@pytest.mark.parametrize("mode", ["luma", "rgb"])
def test_gain_compensate_matches_jax(case, mode):
    """The cases of tests/test_streaming_gain.py:12-46, both modes, atol
    1e-4 against the JAX package; luma is the default of both."""
    a, b = case()
    ref = np.asarray(jgain.gain_compensate(jnp.asarray(a), jnp.asarray(b),
                                           mode))
    got = tgain.gain_compensate(T(a), T(b), mode).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    if mode == "luma":
        np.testing.assert_array_equal(
            tgain.gain_compensate(T(a), T(b)).numpy(), got)


def test_omin_luma_stitch_matches_jax():
    """Two crops with o_min=-1 and explicit luma gain compensation, chain
    ordering: the port's canvas against the JAX package's, shape within
    +-3 px and MAD <= 3 u8 levels (tests/test_torch_stitch.py's gate)."""
    cfg = dataclasses.replace(
        SMALL_DEFAULT, ordering="chain",
        sift=dataclasses.replace(SMALL_DEFAULT.sift, o_min=-1),
        blend=dataclasses.replace(SMALL_DEFAULT.blend,
                                  gain_compensation=True, gain_mode="luma"))
    scene = make_scene(np.random.default_rng(0), h=160, w=320)
    crops = [scene[:, :160], scene[:, 80:240]]
    out_t = TStitcher(cfg, device="cpu").stitch(crops)
    out_j = JStitcher(cfg).stitch(crops)
    assert abs(out_t.shape[0] - out_j.shape[0]) <= 3
    assert abs(out_t.shape[1] - out_j.shape[1]) <= 3
    assert 220 <= out_j.shape[1] <= 256, out_j.shape
    h = min(out_t.shape[0], out_j.shape[0])
    w = min(out_t.shape[1], out_j.shape[1])
    mad = np.abs(out_t[:h, :w].astype(np.int64)
                 - out_j[:h, :w].astype(np.int64)).mean()
    assert mad <= 3.0, mad
