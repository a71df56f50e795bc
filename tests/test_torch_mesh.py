"""The port's mesh mode (``parallel/mesh.py``, ``spatial.py``, ``blend.py``,
``shard_batch``, ``Stitcher(mesh=...)``) against the JAX package's on the
CPU, and against the port's own single-device functions.

The JAX side runs on the virtual 8-device CPU mesh of tests/conftest.py;
the port's on ``make_mesh(8, sp=8, devices=["cpu"] * 8)``, eight stripes
on the one CPU device (a virtual mesh, as ``chip_smoke.py`` builds on one
card). The inputs are those of tests/test_parallel.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervisionimagestich2_tpu import config as jconfig
from computervisionimagestich2_tpu.models.stitcher import Stitcher as JStitcher
from computervisionimagestich2_tpu.parallel import blend as jpblend
from computervisionimagestich2_tpu.parallel import make_mesh as jmake_mesh
from computervisionimagestich2_tpu.parallel import sharded_gaussian_blur as jsgb
from computervisionimagestich2_tpu_torch import config as tconfig
from computervisionimagestich2_tpu_torch.models import compose
from computervisionimagestich2_tpu_torch.models.blender import blend_two_images
from computervisionimagestich2_tpu_torch.models.stitcher import Stitcher
from computervisionimagestich2_tpu_torch.ops.gaussian import gaussian_blur
from computervisionimagestich2_tpu_torch.parallel import (
    batched, blend as pblend, make_mesh, shard_batch, sharded_blend_two_images,
    sharded_composite, sharded_composite_and_blend, sharded_gaussian_blur)
from computervisionimagestich2_tpu_torch.parallel.mesh import gather_rows
from test_integration import make_scene
from test_torch_batched import TINY, _panoramas, _register_scene
from test_torch_incremental import _one_torch_thread  # noqa: F401

T = torch.as_tensor
COEFFS = np.array([1.01, 0.02, 1e-5, -0.01, 0.99, 2e-5, 1e-6, 3.0],
                  np.float32)


def _mesh(n=8, sp=8):
    return make_mesh(n, sp=sp, devices=["cpu"] * n)


def _cat(stripes) -> np.ndarray:
    return gather_rows(stripes, "cpu").numpy()


def _panorama_canvases(h, w, rng):
    """tests/test_parallel.py:46-52: a fills the left 2/3, b the right 2/3,
    zero borders (the seam mask reads the mid row's zero structure)."""
    a = np.zeros((h, w, 3), np.float32)
    b = np.zeros((h, w, 3), np.float32)
    a[8:-8, : 2 * w // 3] = rng.uniform(10, 250, (h - 16, 2 * w // 3, 3))
    b[4:-12, w // 3:] = rng.uniform(10, 250, (h - 16, w - w // 3, 3))
    return a, b


def _edge_inputs():
    """tests/test_parallel.py:73-81: a near-translation stitch edge."""
    rng = np.random.default_rng(0)
    src = rng.uniform(10, 250, (96, 128, 3)).astype(np.float32)
    prev = rng.uniform(10, 250, (96, 108, 3)).astype(np.float32)
    return src, prev, -12.7, -8.3, (128, 160)


# ------------------------------------------------------------------ mesh
def test_make_mesh_shape_and_checks():
    """The (data, sp) grid and JAX's checks; a virtual mesh hashes by its
    devices; with no CUDA device the default mesh raises, never falling
    back to the CPU."""
    mesh = make_mesh(8, sp=4, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 2, "sp": 4}
    assert mesh.axis_devices("sp") == (torch.device("cpu"),) * 4
    assert mesh.axis_devices("data") == (torch.device("cpu"),) * 2
    assert mesh == make_mesh(8, sp=4, devices=["cpu"] * 8)
    assert hash(mesh) == hash(make_mesh(8, sp=4, devices=["cpu"] * 8))
    assert mesh != _mesh()
    assert make_mesh(devices=["cpu"] * 3).shape == {"data": 3, "sp": 1}
    with pytest.raises(ValueError, match="must divide"):
        make_mesh(6, sp=4, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        make_mesh(9, sp=1, devices=["cpu"] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(2, sp=2)


# ------------------------------------------------------------------ blur
def test_sharded_blur_matches_jax_and_single_device():
    """tests/test_parallel.py:31-37: against the JAX package's sharded blur
    and the port's gaussian_blur, atol 1e-4."""
    img = np.random.default_rng(0).normal(size=(128, 64)).astype(np.float32)
    got = _cat(sharded_gaussian_blur(T(img), 2.0, _mesh(), "sp"))
    np.testing.assert_allclose(got, gaussian_blur(T(img), 2.0).numpy(),
                               atol=1e-4)
    jgot = np.asarray(jsgb(jnp.asarray(img), 2.0, jmake_mesh(8, sp=8), "sp"))
    np.testing.assert_allclose(got, jgot, atol=1e-4)


# ------------------------------------------------------------- composite
def test_sharded_composite_matches_single_device_and_jax():
    """tests/test_parallel.py:63-89: the stripes of the sharded composite
    equal compose.composite bit for bit (the row offset is added in
    float32, as the JAX body adds it) and the JAX package's sharded
    stripes exactly (the tolerance tests/test_torch_compose.py applies to
    composite); one stripe per device of the axis."""
    src, prev, min_x, min_y, canvas = _edge_inputs()
    a_s, b_s = sharded_composite(T(src), T(prev), COEFFS, min_x, min_y,
                                 canvas, _mesh())
    assert len(a_s) == len(b_s) == 8
    assert all(s.shape == (16, 160, 3) for s in a_s + b_s)
    a_e, b_e = compose.composite(T(src), T(prev), COEFFS, min_x, min_y,
                                 canvas)
    np.testing.assert_array_equal(_cat(a_s), a_e.numpy())
    np.testing.assert_array_equal(_cat(b_s), b_e.numpy())
    ja, jb = jpblend.sharded_composite(
        jnp.asarray(src), jnp.asarray(prev), jnp.asarray(COEFFS), min_x,
        min_y, canvas, jmake_mesh(8, sp=8))
    np.testing.assert_array_equal(_cat(a_s), np.asarray(ja))
    np.testing.assert_array_equal(_cat(b_s), np.asarray(jb))


def test_sharded_composite_and_blend_matches_single_device():
    """The whole sharded edge against compose.composite +
    blend_two_images, atol 2e-3 (tests/test_parallel.py:91-95)."""
    src, prev, min_x, min_y, canvas = _edge_inputs()
    got = _cat(sharded_composite_and_blend(T(src), T(prev), COEFFS, min_x,
                                           min_y, canvas, _mesh()))
    a_e, b_e = compose.composite(T(src), T(prev), COEFFS, min_x, min_y,
                                 canvas)
    np.testing.assert_allclose(got, blend_two_images(a_e, b_e).numpy(),
                               atol=2e-3)


# ----------------------------------------------------------------- blend
@pytest.mark.parametrize("dtype,hw", [("f32", (256, 192)),
                                      ("bf16", (128, 96))])
def test_sharded_blend_matches_jax_and_single_device(dtype, hw):
    """tests/test_parallel.py:40-60 and :98-120: against the JAX
    package's sharded blend and the port's blend_two_images of the same
    dtype, f32 within atol 2e-3, bf16 max abs < 4.0 (and < 8.0 from the
    f32 blend); >= 2 levels truly sharded at 256 rows."""
    h, w = hw
    a, b = _panorama_canvases(h, w, np.random.default_rng(1))
    if dtype == "f32":
        assert pblend.plan_shard_levels(h, 8, 8, 2.0) >= 2
    got = _cat(sharded_blend_two_images(T(a), T(b), _mesh(), "sp",
                                        dtype=dtype))
    assert got.dtype == np.float32 and got.shape == (h, w, 3)
    single = blend_two_images(T(a), T(b), dtype=dtype).numpy()
    jgot = np.asarray(jpblend.sharded_blend_two_images(
        jnp.asarray(a), jnp.asarray(b), jmake_mesh(8, sp=8), "sp",
        dtype=dtype))
    if dtype == "f32":
        np.testing.assert_allclose(got, single, atol=2e-3)
        np.testing.assert_allclose(got, jgot, atol=2e-3)
    else:
        assert np.abs(got - single).max() < 4.0
        assert np.abs(got - jgot).max() < 4.0
        assert np.abs(got - blend_two_images(T(a), T(b)).numpy()).max() < 8.0


def test_sharded_blend_takes_stripes_and_auto_is_default_area():
    """The blend takes sharded_composite's stripes as well as whole
    canvases; ``dtype="auto"`` resolves against the default 1.5 Mpx (the
    JAX package's sharded blend, which ignores a configured
    bf16_auto_area), so a small canvas blends in f32."""
    a, b = _panorama_canvases(128, 96, np.random.default_rng(2))
    mesh = _mesh()
    whole = _cat(sharded_blend_two_images(T(a), T(b), mesh))
    stripes = _cat(sharded_blend_two_images(list(T(a).chunk(8)),
                                            list(T(b).chunk(8)), mesh))
    auto = _cat(sharded_blend_two_images(T(a), T(b), mesh, dtype="auto"))
    np.testing.assert_array_equal(stripes, whole)
    np.testing.assert_array_equal(auto, whole)


def test_unshardable_inputs_raise():
    """tests/test_parallel.py:151-158 and the blur's and composite's
    checks: 100 rows do not split into 16, a 64-row blur has stripes
    shorter than the radius over 16, a 100-row canvas over 8."""
    a = torch.zeros((100, 64, 3))
    with pytest.raises(ValueError, match="row-shardable"):
        sharded_blend_two_images(a, a, _mesh(), "sp")
    with pytest.raises(ValueError, match="not shardable"):
        sharded_gaussian_blur(torch.zeros((64, 32)), 2.0, _mesh(16, 16))
    with pytest.raises(ValueError, match="not divisible"):
        sharded_composite(a, a, COEFFS, 0.0, 0.0, (100, 64), _mesh())


# --------------------------------------------------------- weight tables
@pytest.mark.parametrize("sigma", [1.0, 2.0, 3.5])
def test_plan_shard_levels_and_enlarge_weights_match_jax(sigma):
    """plan_shard_levels on a grid of heights, level counts and device
    counts, and the per-parity enlarge weights, equal to the JAX
    package's."""
    for h in (16, 64, 96, 100, 128, 256, 384, 1504):
        for levels in (1, 3, 8, 11):
            for n in (1, 2, 4, 8):
                assert (pblend.plan_shard_levels(h, levels, n, sigma)
                        == jpblend.plan_shard_levels(h, levels, n, sigma))
    for n_src in (1, 2, 3, 8, 47, 188):
        for w, jw in zip(pblend._enlarge2_parity_weights(n_src),
                         jpblend._enlarge2_parity_weights(n_src)):
            np.testing.assert_array_equal(w, jw)


def test_blend_weight_tables_match_jax():
    """The tables _blend_program puts on the stripes, concatenated, equal
    the JAX program's operands (its banded shrink and parity enlarge
    weights, built from the port's own copy of ops/resize.py)."""
    h, w = 256, 192
    widths, shrink, enlarge = pblend._blend_program(_mesh(), "sp", h, w, 8,
                                                    3, 2.0)
    _, jshrink, jenlarge = jpblend._blend_program(jmake_mesh(8, sp=8), "sp",
                                                  h, w, 8, 3, 2.0)
    assert widths == (192, 96, 48, 24, 12, 6, 3, 1)
    for lvl, jlvl in zip(shrink, jshrink):
        np.testing.assert_array_equal(_cat(lvl), np.asarray(jlvl))
    for (w0, w1), (jw0, jw1) in zip(enlarge, jenlarge):
        np.testing.assert_array_equal(_cat(w0), np.asarray(jw0))
        np.testing.assert_array_equal(_cat(w1), np.asarray(jw1))


def test_sharded_programs_are_cached_across_calls():
    """tests/test_parallel.py:123-148: two edges of one geometry with
    different offsets build the blend's weight tables once (one miss, then
    one hit)."""
    rng = np.random.default_rng(0)
    h, w = 64, 96
    src = T(rng.uniform(10, 250, (h, w, 3)).astype(np.float32))
    prev = T(rng.uniform(10, 250, (h, w - 16, 3)).astype(np.float32))
    coeffs = np.array([1.0, 0.01, 1e-5, -0.005, 1.0, 2e-5, 0.0, 2.0],
                      np.float32)
    pblend._blend_program.cache_clear()
    for min_x in (-3.5, -7.25):
        sharded_composite_and_blend(src, prev, coeffs, min_x, -2.0, (h, w),
                                    _mesh())
    assert pblend._blend_program.cache_info().misses == 1
    assert pblend._blend_program.cache_info().hits == 1


# -------------------------------------------------------------- Stitcher
def _mesh_scene():
    """tests/test_parallel.py:288-292: three 128 x 112 crops, 40% apart."""
    h, w, k = 128, 112, 3
    base = make_scene(np.random.default_rng(3), h, 3 * w)
    step = int(w * 0.4)
    return [base[:, i * step: i * step + w] for i in range(k)]


MESH_CFG = dataclasses.replace(TINY, ordering="chain", exact_canvas=False)


def _count_sharded_edges(monkeypatch):
    calls = []
    orig = pblend.sharded_composite

    def counted(*args, **kw):
        calls.append(args[5])
        return orig(*args, **kw)
    monkeypatch.setattr(pblend, "sharded_composite", counted)
    return calls


@pytest.fixture(scope="module")
def single_panorama():
    return Stitcher(MESH_CFG, device="cpu").stitch(_mesh_scene())


def test_stitcher_mesh_mode_matches_single_device(single_panorama,
                                                  monkeypatch):
    """tests/test_parallel.py:285-314 in the port: Stitcher(mesh=...) with
    every edge row-sharded over 8 stripes against the single-device
    Stitcher, (|diff| > 1).mean() < 1e-3 and max <= 16."""
    calls = _count_sharded_edges(monkeypatch)
    meshed = Stitcher(MESH_CFG, device="cpu", mesh=_mesh()).stitch(
        _mesh_scene())
    assert len(calls) == 2 and all(h % 16 == 0 for h, _ in calls), calls
    assert meshed.shape == single_panorama.shape
    diff = np.abs(meshed.astype(np.int32) - single_panorama.astype(np.int32))
    assert (diff > 1).mean() < 1e-3, (diff > 1).mean()
    assert diff.max() <= 16, diff.max()


def test_stitcher_refuses_a_mesh_of_another_device_type():
    """A mesh spreads the work over devices of the Stitcher's own type: a
    CPU Stitcher refuses a mesh that holds a CUDA device, before anything
    runs."""
    for devices in (["cuda:0"] * 2, ["cpu", "cuda:0"]):
        with pytest.raises(ValueError, match="device type 'cpu'"):
            Stitcher(MESH_CFG, device="cpu",
                     mesh=make_mesh(2, sp=2, devices=devices))


def test_incremental_ignores_the_mesh(monkeypatch):
    """planned=False takes the single-device program with or without a
    mesh (the JAX package's incremental loop ignores it too)."""
    cfg = dataclasses.replace(MESH_CFG, planned=False)
    calls = _count_sharded_edges(monkeypatch)
    meshed = Stitcher(cfg, device="cpu", mesh=_mesh()).stitch(_mesh_scene())
    plain = Stitcher(cfg, device="cpu").stitch(_mesh_scene())
    assert not calls
    np.testing.assert_array_equal(meshed, plain)


@pytest.mark.parametrize("case", ["gain", "seam_band", "vanvliet"])
def test_mesh_gate_falls_back_like_jax(case, single_panorama, monkeypatch):
    """Edges the gate refuses (gain compensation, an explicit seam band,
    the Van Vliet blur) take the single-device program: equal to the
    mesh-less Stitcher of that config, bit for bit."""
    blend = {"gain": {"gain_compensation": True},
             "seam_band": {"seam_band": 16},
             "vanvliet": {"blur_impl": "vanvliet"}}[case]
    cfg = dataclasses.replace(MESH_CFG, blend=dataclasses.replace(
        MESH_CFG.blend, **blend))
    calls = _count_sharded_edges(monkeypatch)
    meshed = Stitcher(cfg, device="cpu", mesh=_mesh()).stitch(_mesh_scene())
    assert not calls
    np.testing.assert_array_equal(
        meshed, Stitcher(cfg, device="cpu").stitch(_mesh_scene()))


def test_mesh_gate_ignores_the_seam_auto_area(single_panorama, monkeypatch):
    """The JAX gate (models/stitcher.py:211-213 there) does not test the
    area-gated seam band: with seam_auto_area below the canvas, the
    single-device Stitcher blends a seam window with rgb gain, the mesh
    Stitcher still shards every edge and blends the whole canvas, so it
    equals its own panorama with the gate off. Recorded in ROADMAP §C."""
    gated = dataclasses.replace(MESH_CFG, blend=dataclasses.replace(
        MESH_CFG.blend, seam_auto_area=10_000, seam_auto_band=16))
    calls = _count_sharded_edges(monkeypatch)
    meshed = Stitcher(gated, device="cpu", mesh=_mesh()).stitch(
        _mesh_scene())
    assert len(calls) == 2
    off = Stitcher(MESH_CFG, device="cpu", mesh=_mesh()).stitch(
        _mesh_scene())
    np.testing.assert_array_equal(meshed, off)
    single = Stitcher(gated, device="cpu").stitch(_mesh_scene())
    assert single.shape == meshed.shape
    assert np.abs(single.astype(int) - meshed.astype(int)).mean() > 0.5


def _shape_mad_close(a, b):
    assert abs(a.shape[0] - b.shape[0]) <= 3 and \
        abs(a.shape[1] - b.shape[1]) <= 3, (a.shape, b.shape)
    h, w = min(a.shape[0], b.shape[0]), min(a.shape[1], b.shape[1])
    mad = np.abs(a[:h, :w].astype(int) - b[:h, :w].astype(int)).mean()
    assert mad <= 3, mad
    return mad


GATE_CASES = {"gate_off": {"seam_auto_area": 0},
              "seam_auto_low": {"seam_auto_area": 10_000,
                                "seam_auto_band": 16},
              "bf16_auto_low": {"seam_auto_area": 0, "dtype": "auto",
                                "bf16_auto_area": 10_000}}


@pytest.mark.slow  # the JAX mesh Stitcher (tests/test_parallel.py: slow)
@pytest.mark.parametrize("case", list(GATE_CASES))
def test_stitcher_mesh_mode_matches_jax(case):
    """The port's Stitcher(mesh=...) against the JAX package's, shape
    within 3 px and MAD <= 3 u8 levels, on the three crops of
    tests/test_torch_incremental.py in scene order (SMALL_DEFAULT, chain,
    bucketed): on tests/test_parallel.py's TINY crops the two packages'
    plans differ by 5 px of extent even on one device (their CPU
    projections differ by one u8 level on a few values, and TINY keeps
    few keypoints). With the seam-auto gate or the bf16 gate below the
    canvas, the mesh Stitcher of each package departs from its
    single-device one in the same way (ROADMAP §C): the sharded path
    ignores both gates. Prints the distances that ROADMAP records."""
    def cfg(base):
        small = dataclasses.replace(
            base, ordering="chain", exact_canvas=False,
            sift=dataclasses.replace(base.sift, n_octaves=2,
                                     max_keypoints_per_octave=512,
                                     max_keypoints=1024),
            match=dataclasses.replace(base.match, max_matches=512,
                                      pair_threshold=5),
            ransac=dataclasses.replace(base.ransac, n_hypotheses=64))
        return dataclasses.replace(small, blend=dataclasses.replace(
            small.blend, **GATE_CASES[case]))
    scene = make_scene(np.random.default_rng(0), h=160, w=320)
    images = [scene[:, s:s + 160] for s in (0, 80, 160)]
    ours = Stitcher(cfg(tconfig.DEFAULT_CONFIG), device="cpu",
                    mesh=_mesh()).stitch(images)
    single = Stitcher(cfg(tconfig.DEFAULT_CONFIG), device="cpu").stitch(
        images)
    theirs = JStitcher(cfg(jconfig.DEFAULT_CONFIG),
                       mesh=jmake_mesh(8, sp=8)).stitch(images)
    jsingle = JStitcher(cfg(jconfig.DEFAULT_CONFIG)).stitch(images)
    mad = _shape_mad_close(ours, theirs)
    ours_gap = _shape_mad_close(ours, single) if case == "gate_off" else \
        np.abs(ours.astype(int) - single.astype(int)).mean()
    theirs_gap = np.abs(theirs.astype(int) - jsingle.astype(int)).mean()
    print(f"{case}: canvas {ours.shape} / JAX {theirs.shape}; port mesh vs "
          f"JAX mesh MAD {mad:.4f}; mesh vs single MAD port "
          f"{ours_gap:.4f}, JAX {theirs_gap:.4f}")
    if case == "gate_off":
        assert ours_gap == theirs_gap == 0
    else:
        assert ours_gap > 0 and theirs_gap > 0
        assert abs(ours_gap - theirs_gap) < 0.5


# ----------------------------------------------------------- shard_batch
def test_shard_batch_splits_over_the_data_axis():
    mesh = make_mesh(4, sp=2, devices=["cpu"] * 4)
    (sb,) = shard_batch(mesh, np.arange(12).reshape(4, 3))
    assert [c.shape for c in sb.chunks] == [(2, 3), (2, 3)]
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(mesh, np.zeros((3, 2)))


def test_shard_batch_stitch_chain_equals_unsharded():
    """A 2 x 3 panorama batch sharded over a 2-device data axis stitches
    to the unsharded call's canvases and plans, bit for bit
    (tests/test_parallel.py:248-279 in the port)."""
    images = _panoramas()
    mesh = make_mesh(2, sp=1, devices=["cpu"] * 2)
    (sharded,) = shard_batch(mesh, images)
    out_sh, plans_sh = batched.batched_stitch_chain(sharded, TINY,
                                                    (192, 256))
    out, plans = batched.batched_stitch_chain(images, TINY, (192, 256),
                                              device="cpu")
    np.testing.assert_array_equal(out_sh.numpy(), out.numpy())
    np.testing.assert_array_equal(plans_sh, plans)


def test_shard_batch_register_and_extract_equal_unsharded():
    """batched_pairwise_register and batched_project_and_extract on a
    sharded batch equal the unsharded calls (tests/test_parallel.py:
    161-208 holds the JAX package's to its RANSAC tolerance)."""
    a, b = _register_scene()
    ga, gb = np.stack([a, a]), np.stack([b, b])
    mesh = make_mesh(2, sp=1, devices=["cpu"] * 2)
    sa, sb = shard_batch(mesh, ga, gb)
    c_sh, n_sh = batched.batched_pairwise_register(sa, sb, TINY)
    c, n = batched.batched_pairwise_register(ga, gb, TINY, device="cpu")
    assert torch.equal(c_sh, c) and torch.equal(n_sh, n)
    images = _panoramas()[0, :2]
    (si,) = shard_batch(mesh, images)
    f_sh, p_sh = batched.batched_project_and_extract(si, TINY)
    f, p = batched.batched_project_and_extract(images, TINY, device="cpu")
    assert torch.equal(p_sh, p)
    for x, y in zip(f_sh, f):
        assert torch.equal(x, y)
