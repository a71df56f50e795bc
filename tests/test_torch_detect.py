"""PyTorch port vs the JAX package: the fused detect (plain version of
kernel B1) and the SIFT extractor on its ``detect_impl="pallas"`` branch.

The detect is held exactly against ``detect_compact_pallas`` in interpret
mode, including a binding capacity and a row with more extrema than the
128 a row keeps, and the kernel's plan (bands, capped row lists, a prefix
scan) against the plain version; the extractor, which detects all its
octaves in one call, against the port's dense branch (bit
identical) and against the JAX extractor at the gates of tests/test_sift.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervisionimagestich2_tpu.config import SiftConfig
from computervisionimagestich2_tpu.models import sift as jsift
from computervisionimagestich2_tpu.ops import color as jcolor
from computervisionimagestich2_tpu.ops.pallas_detect import (
    detect_compact_pallas)
from computervisionimagestich2_tpu_torch.models import sift as tsift
from computervisionimagestich2_tpu_torch.ops import detect as tdetect
from test_integration import make_scene
from test_torch_kernels import (_dog_inputs, _octave_dogs,
                                row_overflow_dog)

T = torch.as_tensor
CFG = SiftConfig(n_octaves=2, max_keypoints_per_octave=512,
                 max_keypoints=1024, detect_impl="pallas")


@pytest.mark.parametrize("case", range(5), ids=[
    "64x96", "61x130", "33x40", "capacity8", "row_overflow"])
def test_detect_compact_plain_matches_pallas(case):
    """Exact coords, valid and n_total against the Pallas kernel run in
    interpret mode, on the DoG cases of tests/test_torch_kernels.py."""
    dog, tp, cap = _dog_inputs()[case]
    tc, tv, tn = tdetect.detect_compact_plain(T(dog), tp, cap)
    jc, jv, jn = detect_compact_pallas(jnp.asarray(dog), tp, cap,
                                       interpret=True)
    assert tc.dtype == torch.int64 and tc.shape == (cap, 3)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert int(tn) == int(np.asarray(jn))
    if case == 4:  # the row of 298 extrema
        # only the row's first 128 hits, in ascending x, survive
        assert int(tn) == 298 and int(tv.sum()) == 128
        np.testing.assert_array_equal(tc.numpy()[:128, 2],
                                      np.arange(1, 129))


def _banded_cases():
    """The five DoG cases, and the 298-hit row under a capacity of 100: the
    list ends inside the row's kept hits."""
    return _dog_inputs() + [(row_overflow_dog(), 1.0, 100)]


@pytest.mark.parametrize("case", range(6), ids=[
    "64x96", "61x130", "33x40", "capacity8", "row_overflow",
    "row_overflow_capacity100"])
def test_banded_plan_equals_plain(case):
    """Kernel B1's plan (bands of rows, capped row lists, a prefix scan
    over the bands, truncation at the capacity) in plain PyTorch equals
    ``detect_compact_plain`` exactly: coords, valid and n_total."""
    dog, tp, cap = _banded_cases()[case]
    bc, bv, bn = tdetect.detect_compact_banded_plain(T(dog), tp, cap)
    pc, pv, pn = tdetect.detect_compact_plain(T(dog), tp, cap)
    assert torch.equal(bc, pc) and torch.equal(bv, pv)
    assert int(bn) == int(pn) and bn.dtype == pn.dtype
    if case == 5:
        assert int(pv.sum()) == 100 and int(pn) == 298


def test_detect_compact_octaves_equals_per_octave_calls():
    """All the DoG stacks of one call (widths off the 32-pixel grid, two
    rows, the 298-hit row, a binding capacity, a stack without a hit)
    against one call of the Pallas kernel per stack, in interpret mode,
    exactly; and the wrapper's refusals."""
    dogs, tp, caps = _octave_dogs("edges")
    got = tdetect.detect_compact_octaves([T(d) for d in dogs], tp, caps)
    assert len(got) == len(dogs)
    for (c, v, n), dog, cap in zip(got, dogs, caps):
        jc, jv, jn = detect_compact_pallas(jnp.asarray(dog), tp, cap,
                                           interpret=True)
        assert c.shape == (cap, 3) and v.shape == (cap,)
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        assert int(n) == int(np.asarray(jn))
    assert [int(v.sum()) for _, v, _ in got[3:]] == [8, 128, 0, 0]
    with pytest.raises(ValueError):
        tdetect.detect_compact_octaves([T(dogs[0])], tp, caps[:2])
    with pytest.raises(ValueError):
        tdetect.detect_compact_octaves([], tp, [])
    with pytest.raises(ValueError):  # more stacks than one launch takes
        tdetect.detect_compact_octaves(
            [T(dogs[2])] * (tdetect.MAX_OCTAVES + 1), tp,
            [16] * (tdetect.MAX_OCTAVES + 1))


def test_row_overflow_is_reported_in_cand_dropped():
    """An octave whose DoG holds the 298-hit row: the fused branch drops
    170 candidates at the per-row cap and reports them in stats[0]
    (n_total - sum(valid)); the dense branch keeps all 298."""
    dog = row_overflow_dog()
    assert dog.shape[0] == CFG.n_levels + 2
    # GSS levels whose differences are this DoG (small integers: exact)
    octave = T(np.concatenate([np.zeros((1,) + dog.shape[1:], np.float32),
                               np.cumsum(dog, axis=0)]))
    stats = {}
    for impl in ("pallas", "xla"):
        cfg = dataclasses.replace(CFG, detect_impl=impl)
        cand = tsift.detect_octaves([T(dog)], cfg)[0]
        stats[impl] = tsift._process_octave(octave, cfg, 0, T(dog), cand)[5]
    assert int(stats["pallas"][0]) == 298 - 128
    assert int(stats["xla"][0]) == 0


@pytest.fixture(scope="module")
def scene_gray():
    img = make_scene(np.random.default_rng(0), h=120, w=160)
    return np.array(jcolor.to_gray(jnp.asarray(img, jnp.float32)))


@pytest.fixture(scope="module")
def port_fused(scene_gray):
    return tsift.sift_extract_stats(T(scene_gray), CFG)


def test_fused_branch_equals_dense_branch(scene_gray, port_fused):
    """No row overflows on a real scene, so detect_impl="pallas" and "xla"
    give bit-identical features and telemetry."""
    tf_p, ts_p = port_fused
    tf_x, ts_x = tsift.sift_extract_stats(
        T(scene_gray), dataclasses.replace(CFG, detect_impl="xla"))
    assert int(tf_p.valid.sum()) > 20
    np.testing.assert_array_equal(ts_p.numpy(), ts_x.numpy())
    for a, b in zip(tf_p, tf_x):
        assert torch.equal(a, b)


def test_fused_branch_matches_jax_extractor(scene_gray, port_fused):
    """The port's fused branch against the JAX extractor with Pallas off
    (its CPU path): the gates of tests/test_sift.py:43-62 — counts within
    max(2, 5%), >= 90% of the JAX keypoints within 0.5 px of a port
    keypoint, best co-located descriptor cosine > 0.999 — and equal
    telemetry."""
    jf, js = jsift.sift_extract_stats(
        jnp.asarray(scene_gray), dataclasses.replace(CFG, pallas="off"))
    tf, ts = port_fused
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
