"""The port's Van Vliet blur (``blend.blur_impl="vanvliet"``) against the
JAX package and against CImg's double-precision loop on the CPU, the
blend built on it, and a stitch with it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervisionimagestich2_tpu.models import blender as jblend
from computervisionimagestich2_tpu.models.stitcher import Stitcher as JStitcher
from computervisionimagestich2_tpu.ops import gaussian as jgauss
from computervisionimagestich2_tpu_torch.models import blender as tblend
from computervisionimagestich2_tpu_torch.models.stitcher import (
    Stitcher as TStitcher)
from computervisionimagestich2_tpu_torch.ops import gaussian as tgauss
from test_integration import make_scene
from test_torch_graph_stitch import SMALL_DEFAULT
from test_torch_incremental import _one_torch_thread  # noqa: F401
from test_vanvliet import cimg_recursive_apply_0

T = torch.as_tensor
FILT = list(jgauss._vanvliet_coefs(2.0))
# the JAX package's blurs, jitted: op by op its associative scan takes
# tens of seconds per call
J_AXIS = jax.jit(jgauss.vanvliet_blur_axis, static_argnums=1)
J_BLUR = jax.jit(jgauss.vanvliet_blur, static_argnums=1)


def test_coefficients_equal_jax():
    for sigma in (0.3, 2.0, 5.0):
        np.testing.assert_array_equal(tgauss._vanvliet_coefs(sigma),
                                      jgauss._vanvliet_coefs(sigma))
    np.testing.assert_array_equal(tgauss._triggs_matrix(*FILT[1:]),
                                  jgauss._triggs_matrix(*FILT[1:]))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 37, 200])
def test_axis_matches_jax_and_cimg(n):
    """Three rows of length n, short axes included (the Triggs states fall
    back to the Neumann init below 4, and n = 1 has no backward pass):
    atol 1e-3 against the JAX package's associative scan and 0.05 against
    CImg's double loop (tests/test_vanvliet.py's tolerance)."""
    x = np.random.default_rng(n).uniform(0, 255, (3, n)).astype(np.float32)
    got = tgauss.vanvliet_blur_axis(T(x), 2.0).numpy()
    ref = np.asarray(J_AXIS(jnp.asarray(x), 2.0))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    cimg = np.stack([cimg_recursive_apply_0(r, FILT) for r in x])
    np.testing.assert_allclose(got, cimg, rtol=0, atol=0.05)


def test_small_sigma_is_identity():
    x = T(np.arange(20, dtype=np.float32))
    assert torch.equal(tgauss.vanvliet_blur_axis(x, 0.3), x)


@pytest.mark.parametrize("shape", [(40, 56), (1, 37), (29, 1), (2, 13, 9)])
def test_blur_2d_matches_jax_and_cimg(shape):
    """x then y, size-1 axes skipped (CImg.h:35113-35116), leading dims
    batched: atol 1e-3 against the JAX package, 0.1 against CImg's loop
    (tests/test_vanvliet.py's 2-D tolerance)."""
    img = np.random.default_rng(4).uniform(0, 255, shape).astype(np.float32)
    got = tgauss.vanvliet_blur(T(img), 2.0).numpy()
    ref = np.asarray(J_BLUR(jnp.asarray(img), 2.0))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    expect = img.reshape((-1,) + shape[-2:]).astype(np.float64)
    for k, plane in enumerate(expect):
        if shape[-1] > 1:
            plane = np.stack([cimg_recursive_apply_0(r, FILT) for r in plane])
        if shape[-2] > 1:
            plane = np.stack([cimg_recursive_apply_0(c, FILT)
                              for c in plane.T]).T
        expect[k] = plane
    np.testing.assert_allclose(got, expect.reshape(shape), rtol=0, atol=0.1)


def test_vanvliet_blend_matches_jax():
    """The wide canvas of tests/test_vanvliet.py (40 x 600, 9 levels, the
    short axis reaching 1): the port's Van Vliet pyramid against the JAX
    package's, within 1e-3 before the u8 truncation and one u8 level after;
    bf16 refuses the recursive blur, as in the JAX package."""
    rng = np.random.default_rng(7)
    h, w = 40, 600
    a = np.zeros((h, w, 3), np.float32)
    b = np.zeros((h, w, 3), np.float32)
    a[:, : w * 2 // 3] = rng.uniform(1, 255, (h, w * 2 // 3, 3))
    b[:, w // 3:] = rng.uniform(1, 255, (h, w - w // 3, 3))
    ref = np.asarray(jblend.blend_two_images(
        jnp.asarray(a), jnp.asarray(b), "max", 2.0, "vanvliet"))
    got = tblend.blend_two_images(T(a), T(b), "max", 2.0,
                                  blur_impl="vanvliet").numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    assert np.abs(np.trunc(got) - np.trunc(ref)).max() <= 1
    with pytest.raises(ValueError, match="bf16"):
        tblend.blend_two_images(T(a), T(b), dtype="bf16",
                                blur_impl="vanvliet")


def test_vanvliet_stitch_matches_jax():
    """Two crops with the Van Vliet blend, chain ordering: the port's
    canvas against the JAX package's, shape within +-3 px and MAD <= 3 u8
    levels (tests/test_torch_stitch.py's gate)."""
    cfg = dataclasses.replace(
        SMALL_DEFAULT, ordering="chain",
        blend=dataclasses.replace(SMALL_DEFAULT.blend, blur_impl="vanvliet"))
    scene = make_scene(np.random.default_rng(0), h=160, w=320)
    crops = [scene[:, :160], scene[:, 80:240]]
    out_t = TStitcher(cfg, device="cpu").stitch(crops)
    out_j = JStitcher(cfg).stitch(crops)
    assert abs(out_t.shape[0] - out_j.shape[0]) <= 3
    assert abs(out_t.shape[1] - out_j.shape[1]) <= 3
    h = min(out_t.shape[0], out_j.shape[0])
    w = min(out_t.shape[1], out_j.shape[1])
    mad = np.abs(out_t[:h, :w].astype(np.int64)
                 - out_j[:h, :w].astype(np.int64)).mean()
    assert mad <= 3.0, mad
