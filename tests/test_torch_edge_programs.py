"""The port's per-edge, tail and batched-panorama programs and the device
forms of what they run, on the CPU: ``shift_image`` at device offsets,
``half_plane_mask`` at a device content height and ``blend_seam_band``
with its window on the device, each against its host-int form (bit for
bit) and the JAX package's; the composite + blend program
(``models/stitcher.py::_composite_and_blend``) against the JAX package's;
the enhance tail's histogram against ``torch.bincount`` and the tail
against the JAX package's; and the three programs' keys, which hold no
model, offset or content height (on the stand-in for CUDA graphs of
tests/test_torch_programs.py). The batched panorama against the JAX
package's ``_stitch_one_fixed`` is tests/test_torch_batched.py's.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from computervisionimagestich2_tpu import config as jconfig
from computervisionimagestich2_tpu.models import blender as jblend
from computervisionimagestich2_tpu.models import compose as jcompose
from computervisionimagestich2_tpu.models import equalization as jeq
from computervisionimagestich2_tpu.models import stitcher as jstm
from computervisionimagestich2_tpu.ops import warp as jwarp
from computervisionimagestich2_tpu_torch import config as tconfig
from computervisionimagestich2_tpu_torch.core import programs
from computervisionimagestich2_tpu_torch.models import blender as tblend
from computervisionimagestich2_tpu_torch.models import compose as tcompose
from computervisionimagestich2_tpu_torch.models import equalization as teq
from computervisionimagestich2_tpu_torch.models import stitcher as tstm
from computervisionimagestich2_tpu_torch.ops import warp as twarp
from computervisionimagestich2_tpu_torch.parallel import batched
from test_integration import make_scene
from test_torch_batched import TINY, _panoramas
from test_torch_compose import BWD, COEF, _assert_u8_close
from test_torch_incremental import _one_torch_thread  # noqa: F401
from test_torch_programs import fake_graphs  # noqa: F401

T = torch.as_tensor


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


@pytest.fixture(scope="module")
def step():
    """One stitch step on a make_scene pair (tests/test_torch_compose.py's
    canvases): the source, the previous result, the canvas plan and the
    composited canvases a (warped) and b (shifted)."""
    scene = make_scene(np.random.default_rng(1), h=120, w=200).astype(
        np.float32)
    src, res = scene[:, 60:], scene[:, :140]
    plan = tcompose.canvas_plan(COEF, (120, 140), (120, 140))
    new_h, new_w, min_x, min_y = plan
    a, b = tcompose.composite(T(src), T(res), T(BWD), min_x, min_y,
                              (new_h, new_w))
    return src, res, plan, a, b


# ------------------------------------------------------- device arguments
@pytest.mark.parametrize("off", [(0.0, 0.0), (-7.9, 3.2), (12.5, -20.7),
                                 (-100.0, 0.0), (3.99, -0.5), (39.0, 29.0)])
def test_shift_image_device_offsets(off):
    """Float offsets on the device, truncated there, give the Python-int
    form's bits, and the JAX package's shift at the truncated offsets
    (tests/test_torch_ops.py::test_shift_image_exact: exact)."""
    src = np.random.default_rng(4).uniform(0, 255, (30, 40, 3)).astype(
        np.float32)
    ox, oy = (np.float32(v) for v in off)
    host = twarp.shift_image(T(src), int(ox), int(oy), (45, 50))
    dev = twarp.shift_image(T(src), T(ox), T(oy), (45, 50))
    np.testing.assert_array_equal(_bits(dev), _bits(host))
    ref = np.asarray(jwarp.shift_image(
        jnp.asarray(src), jnp.int32(int(ox)), jnp.int32(int(oy)),
        out_shape=(45, 50)))
    np.testing.assert_array_equal(dev.numpy(), ref)


def test_warp_image_tensor_offsets_match_host_floats(step):
    """The model and offsets as float32 tensors give the host floats' bits
    (on the CPU both reach the plain version; the card's two entries are
    held equal in tests/test_torch_kernels.py)."""
    src, _, (new_h, new_w, min_x, min_y), a, _ = step
    got = twarp.warp_image(T(src), T(BWD), T(np.float32(min_x)),
                           T(np.float32(min_y)), (new_h, new_w))
    np.testing.assert_array_equal(_bits(got), _bits(a))


@pytest.mark.parametrize("rows", [None, -10, 7, "beyond"])
def test_half_plane_mask_device_content_h(step, rows):
    """A content height as a device tensor: the mid row picked on the
    device equals the int form's and the JAX package's traced one (exact,
    tests/test_torch_compose.py::test_half_plane_mask_exact), beyond the
    canvas too (clamped, as a dynamic index is)."""
    *_, a, b = step
    h = a.shape[0]
    ch = 2 * h + 6 if rows == "beyond" else h + (rows or 0)
    dev = tblend.half_plane_mask(a, b, T(np.float32(ch)))
    ref = np.asarray(jblend.half_plane_mask(jnp.asarray(a.numpy()),
                                            jnp.asarray(b.numpy()),
                                            jnp.int32(ch)))
    np.testing.assert_array_equal(dev.numpy(), ref)
    if ch // 2 < h:
        np.testing.assert_array_equal(
            dev.numpy(), tblend.half_plane_mask(a, b, ch).numpy())


def _seam_band_host(a, b, band, content_h, dtype="f32"):
    """``blend_seam_band`` with the window's start read back to the host
    and cut by slicing (the port's form before its window moved to the
    device), on the full canvas (4 * band <= width)."""
    h, w = a.shape[0], a.shape[1]
    wb = 4 * band
    mask0 = tblend.half_plane_mask(a, b, content_h)
    mask_row = mask0[0]
    t = int((mask_row == mask_row[0]).sum())
    s = min(max(t - wb // 2, 0), w - wb)
    stacked = torch.cat([a, b, mask0[..., None]], dim=-1)
    levels = max(1, min(tblend.n_levels(h, wb, "max"),
                        int(math.log2(max(band // 8, 2)))))
    blended = tblend.blend_stacked(stacked[:, s:s + wb], levels, 2.0,
                                   "fir", dtype)
    out = torch.where(mask0[..., None] == 1.0, a, b)
    out[:, s + band:s + 3 * band] = blended[:, band:3 * band]
    return out, s


@pytest.mark.parametrize("band,flip,content,width", [
    (16, False, None, None), (24, False, 100, None), (16, True, None, None),
    (32, False, None, 150)])
def test_blend_seam_band_device_window(step, band, flip, content, width):
    """The window gathered and pasted on the device equals the host-int
    form bit for bit, with the seam in the canvas, on the mask's other
    side (the canvases swapped and mirrored) and with the start clamped
    (a window of 128 columns on the canvases cut to 150, the seam ~100 in);
    the blend equals the JAX package's within tests/test_torch_compose.py's
    u8 tolerance."""
    *_, a, b = step
    if flip:
        a, b = b.flip(1).contiguous(), a.flip(1).contiguous()
    if width:
        a, b = a[:, :width].contiguous(), b[:, :width].contiguous()
    ch = None if content is None else T(np.float32(content))
    got = tblend.blend_seam_band(a, b, band, content_h=ch)
    host, s = _seam_band_host(a, b, band, content)
    np.testing.assert_array_equal(_bits(got), _bits(host))
    if width:
        assert s == width - 4 * band, s  # the clamped start
    ref = np.asarray(jwarp.trunc_u8(jblend.blend_seam_band(
        jnp.asarray(a.numpy()), jnp.asarray(b.numpy()), band,
        content_h=None if content is None else jnp.int32(content))))
    _assert_u8_close(twarp.trunc_u8(got).numpy(), ref)


# --------------------------------------------------- composite + blend
def _cfgs(module, seam: bool, bucket: bool):
    cfg = module.DEFAULT_CONFIG
    blend = dataclasses.replace(cfg.blend, seam_auto_area=(
        20_000 if seam else cfg.blend.seam_auto_area), seam_auto_band=16)
    return dataclasses.replace(cfg, blend=blend, exact_canvas=not bucket)


@pytest.mark.parametrize("seam,bucket", [(False, False), (True, False),
                                         (True, True)])
def test_composite_and_blend_matches_jax(step, seam, bucket):
    """The per-edge program on one stitch step against the JAX package's
    ``_composite_and_blend`` run op by op (``jax.disable_jit``: the warp
    and shift exact, tests/test_torch_compose.py), with the area-gated
    seam band and rgb gain on the exact and on a bucketed canvas (the seam
    at the content's mid row), and with the full-canvas blend, there
    against the JAX program's steps (the composite op by op, the blend
    jitted as in tests/test_torch_compose.py::test_blend_edge: op by op
    its six pyramid levels take ~45 s): u8 within
    tests/test_torch_compose.py's tolerance; and the program on device
    tensors equals the host floats' composite + blend bit for bit."""
    src, res, (new_h, new_w, min_x, min_y), *_ = step
    cfg, jcfg = _cfgs(tconfig, seam, bucket), _cfgs(jconfig, seam, bucket)
    comp_hw = ((tcompose.bucket_size(new_h, 64),
                tcompose.bucket_size(new_w, 64)) if bucket
               else (new_h, new_w))
    assert tblend.seam_auto_engaged(cfg.blend, *comp_hw) == seam
    offsets = T(np.array([min_x, min_y], np.float32))
    got = tstm._composite_and_blend(T(src), T(res), T(BWD), offsets,
                                    comp_hw, (new_h, new_w), cfg)
    a, b = tcompose.composite(T(src), T(res), BWD, min_x, min_y, comp_hw)
    a = tblend.apply_composite_gain(a, b, cfg.blend, *comp_hw)
    host = twarp.trunc_u8(tblend.blend_edge(a, b, cfg.blend, new_h)[
        :new_h, :new_w])
    np.testing.assert_array_equal(_bits(got), _bits(host))
    jargs = (jnp.asarray(src), jnp.asarray(res), jnp.asarray(BWD),
             jnp.float32(min_x), jnp.float32(min_y), comp_hw)
    if seam:
        with jax.disable_jit():
            ref = np.asarray(jstm._composite_and_blend(
                *jargs, (new_h, new_w), jcfg))
    else:
        with jax.disable_jit():
            ja, jb = jcompose.composite(*jargs)
        ja = jblend.apply_composite_gain(ja, jb, jcfg.blend, *comp_hw)
        ref = np.asarray(jwarp.trunc_u8(jblend.blend_edge(
            ja, jb, jcfg.blend, new_h)[:new_h, :new_w]))
    assert got.shape == ref.shape == (new_h, new_w, 3)
    _assert_u8_close(got.numpy(), ref)


# ------------------------------------------------------------ enhance tail
@pytest.mark.parametrize("fill", ["scene", "flat", "extremes"])
def test_histogram_equals_bincount(fill):
    """The graph-safe histogram (ones added at each value) equals
    ``torch.bincount``'s counts, so the LUT keeps its bits."""
    rng = np.random.default_rng(5)
    ch = {"scene": make_scene(rng, h=60, w=70)[..., 0],
          "flat": np.full((40, 30), 17),
          "extremes": rng.choice([0, 255], (50, 20))}[fill]
    ch = T(ch.astype(np.float32))
    hist = teq._histogram(ch)
    ref = torch.bincount(ch.reshape(-1).long(), minlength=256)
    assert hist.dtype == ref.dtype == torch.int64
    np.testing.assert_array_equal(hist.numpy(), ref.numpy())
    n = ch.numel()
    lut = torch.round(255.0 * torch.cumsum(ref.float() / n, 0))
    np.testing.assert_array_equal(_bits(teq._equalize_lut(ch)), _bits(lut))


def test_equalize_and_mix_program_matches_jax():
    """The tail as a program on a seeded canvas with an empty band (the
    enhance step's input) against the JAX package's run op by op: within
    tests/test_torch_compose.py's u8 tolerance."""
    img = make_scene(np.random.default_rng(6), h=80, w=150).astype(
        np.float32)
    img[:, :12] = 0.0
    got = teq.equalize_and_mix(T(img)).numpy()
    with jax.disable_jit():
        ref = np.asarray(jeq.equalize_and_mix(jnp.asarray(img)))
    _assert_u8_close(got, ref)


# ------------------------------------------------------------------ keys
def test_program_keys_hold_no_model_offset_or_content(fake_graphs, step):
    """Two edges of one canvas shape with other models and offsets replay
    one composite + blend graph, two canvases of one shape one enhance
    graph, two panoramas of one frame shape one ``_stitch_one_fixed``
    graph (their plans' content heights differ); each call gives its
    eager output bit for bit, and the calls differ."""
    src, res, (new_h, new_w, min_x, min_y), *_ = step
    cfg = _cfgs(tconfig, True, False)
    edge = fake_graphs(tstm._composite_and_blend.fn, "edge")
    calls = [(T(src), T(res), T(BWD), T(np.array([min_x, min_y],
                                                 np.float32))),
             (T(src[:, ::-1].copy()), T(res), T(BWD * np.float32(1.001)),
              T(np.array([min_x - 1.5, min_y + 0.75], np.float32)))]
    outs = [edge(*c, (new_h, new_w), (new_h, new_w), cfg) for c in calls]
    assert edge.captures == 1 and len(edge.graphs) == 1
    with programs.disable_graphs():
        for out, c in zip(outs, calls):
            np.testing.assert_array_equal(_bits(out), _bits(
                tstm._composite_and_blend(*c, (new_h, new_w),
                                          (new_h, new_w), cfg)))
    assert not torch.equal(outs[0], outs[1])

    tail = fake_graphs(teq.equalize_and_mix.fn, "tail")
    got = [tail(o) for o in outs]
    assert tail.captures == 1
    for g, o in zip(got, outs):
        np.testing.assert_array_equal(_bits(g), _bits(
            teq.equalize_and_mix.fn(o)))

    pano = fake_graphs(batched._stitch_one_fixed.fn, "panorama")
    pans = _panoramas((0, 30))
    seq = batched.chain_edge_seq(3)
    got = [pano(T(p), TINY, (192, 256), seq) for p in pans]
    assert pano.captures == 1 and len(pano.graphs) == 1
    with programs.disable_graphs():
        for (canvas, plan), p in zip(got, pans):
            ref_canvas, ref_plan = batched._stitch_one_fixed(
                T(p), TINY, (192, 256), seq)
            np.testing.assert_array_equal(_bits(canvas), _bits(ref_canvas))
            np.testing.assert_array_equal(_bits(plan), _bits(ref_plan))
    assert not torch.equal(got[0][1][:, 18:22], got[1][1][:, 18:22])
