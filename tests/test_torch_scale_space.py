"""PyTorch port vs the JAX package: scale-space ops (Gaussian blur, the
SIFT octave and its DoG, VLFeat decimation, CImg resize).

The JAX side runs op by op under ``jax.disable_jit()``: jitted XLA:CPU
contracts the shift-and-add taps into FMAs, which moves 0..255 values by
an ulp (1.5e-5 above 128), while the port rounds every operation as the
expressions are written.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervisionimagestich2_tpu.models import sift as jsift
from computervisionimagestich2_tpu.ops import gaussian as jgauss
from computervisionimagestich2_tpu.ops import resize as jresize
from computervisionimagestich2_tpu.ops import sift_kernels as jsk
from computervisionimagestich2_tpu_torch.models import sift as tsift
from computervisionimagestich2_tpu_torch.ops import gaussian as tgauss
from computervisionimagestich2_tpu_torch.ops import resize as tresize
from computervisionimagestich2_tpu_torch.ops import sift_kernels as tsk
from test_torch_sift import CFG, _octave

T = torch.as_tensor


@pytest.mark.parametrize("sigma", [1.2263, 2.0])
def test_gaussian_blur(sigma):
    """Same taps, same shift-and-add order: atol 1e-5 on 0..255 values."""
    img = np.random.default_rng(5).uniform(0, 255, (2, 40, 52)).astype(
        np.float32)
    np.testing.assert_array_equal(tgauss.gauss_taps(sigma),
                                  jgauss.gauss_taps(sigma))
    with jax.disable_jit():
        ref = np.asarray(jgauss.gaussian_blur(jnp.asarray(img), sigma))
    out = tgauss.gaussian_blur(T(img), sigma).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_vlfeat_downsample_exact():
    img = np.random.default_rng(6).random((3, 37, 51)).astype(np.float32)
    for d in (1, 2):
        np.testing.assert_array_equal(
            tresize.vlfeat_downsample(T(img), d).numpy(),
            np.asarray(jresize.vlfeat_downsample(jnp.asarray(img), d)))


@pytest.mark.parametrize("shape,out", [((40, 52, 7), (20, 26)),
                                       ((41, 53, 3), (20, 26)),
                                       ((20, 26, 3), (41, 53)),
                                       ((30, 30), (17, 45))])
def test_cimg_resize(shape, out):
    """Same host weights and term order; atol 1e-4 on 0..255 values."""
    img = np.random.default_rng(7).uniform(0, 255, shape).astype(np.float32)
    with jax.disable_jit():
        ref = np.asarray(jresize.cimg_resize(jnp.asarray(img), *out))
    got = tresize.cimg_resize(T(img), *out).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_build_octave_and_dog():
    """Same taps and summation order: atol 1e-5 on 0..255 levels."""
    base = _octave()
    first, _ = tsift.scale_space_sigmas(CFG)
    assert (first, _) == jsift.scale_space_sigmas(CFG)
    with jax.disable_jit():
        joct = jsift.build_octave(jnp.asarray(base), CFG, first)
        jdog = np.asarray(jsk.dog_stack(joct))
    toct = tsift.build_octave(T(base), CFG, first)
    np.testing.assert_allclose(toct.numpy(), np.asarray(joct), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tsk.dog_stack(toct).numpy(), jdog, atol=1e-5,
                               rtol=0)
