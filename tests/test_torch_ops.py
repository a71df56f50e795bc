"""PyTorch port vs the JAX package: pixel ops and compaction. The CUDA
kernels against their plain versions are in tests/test_torch_kernels.py.

The same numpy inputs (fixed seeds) go through the JAX function and its
counterpart in ``computervisionimagestich2_tpu_torch``; the port runs its
plain PyTorch versions on the CPU.

Where a comparison is exact, the JAX side runs op by op under
``jax.disable_jit()``: jitted XLA:CPU fuses ``a * b + c`` into an FMA and
rewrites division by a constant as multiplication by its reciprocal, which
moves a truncation by one level in ~2% of pixels (measured on ``to_gray``),
while the expressions as written, and the port, round every operation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervisionimagestich2_tpu.ops import color as jcolor
from computervisionimagestich2_tpu.ops import compaction as jcomp
from computervisionimagestich2_tpu.ops import warp as jwarp
from computervisionimagestich2_tpu_torch.ops import color as tcolor
from computervisionimagestich2_tpu_torch.ops import compaction as tcomp
from computervisionimagestich2_tpu_torch.ops import warp as twarp

T = torch.as_tensor


def _u8_image(seed, h, w):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3)).astype(np.float32)
    img[: h // 4] = img[: h // 4, :, :1]   # gray rows: luma lands on integers
    return img


# ------------------------------------------------------------- pixel ops
def test_color_conversions_exact():
    img = _u8_image(0, 48, 64)
    with jax.disable_jit():
        jg = np.asarray(jcolor.to_gray(jnp.asarray(img)))
        jy = np.asarray(jcolor.rgb_to_ycbcr(jnp.asarray(img)))
        jyf = np.asarray(jcolor.rgb_to_ycbcr(jnp.asarray(img), False, False))
        jr = np.asarray(jcolor.ycbcr_to_rgb(jnp.asarray(img)))
    np.testing.assert_array_equal(tcolor.to_gray(T(img)).numpy(), jg)
    np.testing.assert_array_equal(tcolor.rgb_to_ycbcr(T(img)).numpy(), jy)
    np.testing.assert_array_equal(
        tcolor.rgb_to_ycbcr(T(img), False, False).numpy(), jyf)
    np.testing.assert_array_equal(tcolor.ycbcr_to_rgb(T(img)).numpy(), jr)


def test_trunc_u8_exact():
    x = np.random.default_rng(1).uniform(-300, 600, 4096).astype(np.float32)
    np.testing.assert_array_equal(twarp.trunc_u8(T(x)).numpy(),
                                  np.asarray(jwarp.trunc_u8(jnp.asarray(x))))


@pytest.mark.parametrize("hw", [(64, 48), (48, 64)])
def test_cylindrical_project_exact(hw):
    """Portrait and the landscape axis swap, against the gather oracle."""
    img = _u8_image(2, *hw)
    with jax.disable_jit():
        ref = np.asarray(jwarp._cylindrical_project_gather(jnp.asarray(img)))
    np.testing.assert_array_equal(
        twarp.cylindrical_project(T(img)).numpy(), ref)


def test_warp_image_exact():
    src = _u8_image(3, 60, 50)
    coef = np.array([1.01, 0.02, 1e-4, -7.5, -0.015, 0.99, 2e-4, 5.25],
                    np.float32)
    with jax.disable_jit():
        ref = np.asarray(jwarp.warp_image(
            jnp.asarray(src), jnp.asarray(coef), jnp.float32(-3.5),
            jnp.float32(-7.25), out_shape=(80, 90)))
    out = twarp.warp_image(T(src), T(coef), -3.5, -7.25, (80, 90))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (ref != 0).any() and (ref == 0).any()


@pytest.mark.parametrize("off", [(0, 0), (-5, 7), (12, -3), (-100, 0)])
def test_shift_image_exact(off):
    src = _u8_image(4, 30, 40)
    ref = np.asarray(jwarp.shift_image(
        jnp.asarray(src), jnp.int32(off[0]), jnp.int32(off[1]),
        out_shape=(45, 50)))
    out = twarp.shift_image(T(src), off[0], off[1], (45, 50))
    np.testing.assert_array_equal(out.numpy(), ref)


# -------------------------------------------------------------- compaction
@pytest.mark.parametrize("density,cap", [(0.05, 64), (0.3, 64), (0.0, 16)])
def test_compact_indices_exact(density, cap):
    mask = np.random.default_rng(8).random((3, 17, 23)) < density
    ji, jv = jcomp.compact_indices(jnp.asarray(mask), cap)
    ti, tv = tcomp.compact_indices(T(mask), cap)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("cap", [40, 200, 400])
def test_select_strongest_exact(cap):
    """Including ties: equal strengths keep the lower index, as lax.top_k."""
    rng = np.random.default_rng(9)
    valid = rng.random(300) < 0.5
    strength = np.round(rng.random(300) * 8).astype(np.float32) + 0.5
    ji, jv = jcomp.select_strongest(jnp.asarray(valid), jnp.asarray(strength),
                                    cap)
    ti, tv = tcomp.select_strongest(T(valid), T(strength), cap)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_compact_values_exact():
    rng = np.random.default_rng(10)
    mask = rng.random((9, 11)) < 0.2
    vals = rng.random((9, 11, 2)).astype(np.float32)
    jout = jcomp.compact_values(jnp.asarray(mask), 32, jnp.asarray(vals))
    tout = tcomp.compact_values(T(mask), 32, T(vals))
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
