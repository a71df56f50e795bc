"""PyTorch port vs the JAX package: canvas planning, compositing, the
pyramid blend (full canvas and the area-gated seam band with rgb gain),
and the equalization tail.

Blend outputs are compared after u8 truncation: the pyramids sum in
another order, so a value near an integer may truncate either way — max
abs diff <= 1 level, mean <= 0.05.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervisionimagestich2_tpu.config import BlendConfig
from computervisionimagestich2_tpu.models import blender as jblend
from computervisionimagestich2_tpu.models import compose as jcompose
from computervisionimagestich2_tpu.models import equalization as jeq
from computervisionimagestich2_tpu.models import gain as jgain
from computervisionimagestich2_tpu.ops.warp import trunc_u8 as jtrunc
from computervisionimagestich2_tpu_torch.models import blender as tblend
from computervisionimagestich2_tpu_torch.models import compose as tcompose
from computervisionimagestich2_tpu_torch.models import equalization as teq
from computervisionimagestich2_tpu_torch.models import gain as tgain
from computervisionimagestich2_tpu_torch.ops.warp import trunc_u8 as ttrunc
from test_integration import make_scene

T = torch.as_tensor
COEF = np.array([1.003, 0.004, 2e-5, 61.5, -0.002, 0.998, 1e-5, 3.25],
                np.float32)
BWD = np.array([0.997, -0.004, -2e-5, -60.8, 0.002, 1.002, -1e-5, -3.5],
               np.float32)


def _assert_u8_close(got, ref):
    d = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    assert d.max() <= 1, d.max()
    assert d.mean() <= 0.05, d.mean()


@pytest.fixture(scope="module")
def canvases():
    """One stitch step on a make_scene pair: a = the incoming image
    inverse-warped onto the canvas, b = the previous result shifted."""
    scene = make_scene(np.random.default_rng(1), h=120, w=200).astype(
        np.float32)
    src, res = scene[:, 60:], scene[:, :140]
    new_h, new_w, min_x, min_y = tcompose.canvas_plan(COEF, (120, 140),
                                                      (120, 140))
    a, b = tcompose.composite(T(src), T(res), T(BWD), min_x, min_y,
                              (new_h, new_w))
    return src, res, (new_h, new_w, min_x, min_y), a.numpy(), b.numpy()


def test_canvas_plan_and_composite_exact(canvases):
    src, res, plan, a, b = canvases
    assert plan == jcompose.canvas_plan(COEF, (120, 140), (120, 140))
    new_h, new_w, min_x, min_y = plan
    assert 120 <= new_h <= 130 and 195 <= new_w <= 210
    with jax.disable_jit():
        ja, jb = jcompose.composite(jnp.asarray(src), jnp.asarray(res),
                                    jnp.asarray(BWD), min_x, min_y,
                                    (new_h, new_w))
    np.testing.assert_array_equal(a, np.asarray(ja))
    np.testing.assert_array_equal(b, np.asarray(jb))
    assert (a[:, -20:] > 0).any() and (b[:, :20] > 0).any()


def test_half_plane_mask_exact(canvases):
    _, _, _, a, b = canvases
    np.testing.assert_array_equal(
        tblend.half_plane_mask(T(a), T(b)).numpy(),
        np.asarray(jblend.half_plane_mask(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("level_mode,dtype", [("max", "auto"),
                                              ("min", "auto"),
                                              ("max", "bf16")])
def test_blend_edge(canvases, level_mode, dtype):
    """f32 (the "auto" policy below its area gate) and the bf16 pyramid
    that the gate selects above 1.5 Mpx, forced here on a small canvas."""
    _, _, _, a, b = canvases
    bcfg = BlendConfig(level_mode=level_mode, dtype=dtype)
    assert tblend.resolve_dtype(dtype, *a.shape[:2]) == (
        "bf16" if dtype == "bf16" else "f32")
    ref = np.asarray(jtrunc(jblend.blend_edge(jnp.asarray(a),
                                              jnp.asarray(b), bcfg)))
    got = ttrunc(tblend.blend_edge(T(a), T(b), bcfg)).numpy()
    _assert_u8_close(got, ref)


def test_seam_band_gate_with_gain(canvases):
    """The area gates, lowered to this canvas: above seam_auto_area the
    blend takes a 4*band window at the seam, and apply_composite_gain
    engages rgb gain (f32 pyramid: bf16_auto_area is not reached)."""
    _, _, _, a, b = canvases
    h, w = a.shape[:2]
    bcfg = BlendConfig(seam_auto_area=h * w - 1, seam_auto_band=16)
    assert tblend.seam_auto_engaged(bcfg, h, w)
    ja = jblend.apply_composite_gain(jnp.asarray(a), jnp.asarray(b), bcfg,
                                     h, w)
    ta = tblend.apply_composite_gain(T(a), T(b), bcfg, h, w)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-3)
    assert not np.array_equal(np.asarray(ja), a)
    ref = np.asarray(jtrunc(jblend.blend_edge(ja, jnp.asarray(b), bcfg)))
    got = ttrunc(tblend.blend_edge(ta, T(b), bcfg)).numpy()
    _assert_u8_close(got, ref)


def test_gain_compensate_rgb(canvases):
    _, _, _, a, b = canvases
    a2 = np.clip(a * np.float32(1.3), 0, 255)
    ref = np.asarray(jgain.gain_compensate(jnp.asarray(a2), jnp.asarray(b),
                                           "rgb"))
    got = tgain.gain_compensate(T(a2), T(b), "rgb").numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)
    with pytest.raises(ValueError, match="unknown gain mode"):
        tgain.gain_compensate(T(a2), T(b), "hsv")


def test_equalize_and_mix():
    img = make_scene(np.random.default_rng(2), h=90, w=130).astype(
        np.float32)
    img[:10] = 0.0
    ref = np.asarray(jeq.equalize_and_mix(jnp.asarray(img)))
    got = teq.equalize_and_mix(T(img)).numpy()
    _assert_u8_close(got, ref)
    # the ex6 variant against the JAX tail run op by op: jitted XLA:CPU
    # contracts the YCbCr multiply-adds into FMAs, which here moves one
    # luma truncation into another LUT step (3 pixels 2 levels apart)
    with jax.disable_jit():
        ref = np.asarray(jeq.equalize_and_mix(jnp.asarray(img), False,
                                              5 / 6))
    got = teq.equalize_and_mix(T(img), False, 5 / 6).numpy()
    _assert_u8_close(got, ref)


def test_n_levels_and_dtype_policy():
    for hw in ((120, 203), (1, 7), (1080, 5000)):
        for mode in ("max", "min"):
            assert tblend.n_levels(*hw, mode) == jblend.n_levels(*hw, mode)
    cfg = BlendConfig()
    for hw in ((1000, 1400), (1200, 1300), (1500, 1400)):
        assert tblend.resolve_dtype("auto", *hw) == jblend.resolve_dtype(
            "auto", *hw)
        assert (tblend.seam_auto_engaged(cfg, *hw)
                == jblend.seam_auto_engaged(cfg, *hw))
    assert dataclasses.replace(cfg, seam_auto_area=0) is not None
