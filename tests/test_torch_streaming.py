"""The PyTorch port's ``StreamingStitcher`` (BASELINE.json config 5) on the
CPU against the JAX package's: four frames panning across one scene, both
anchors and the rolling window. Each JAX stream runs once per module.
"""
import dataclasses

import numpy as np
import pytest

from computervisionimagestich2_tpu.models.streaming import (
    StreamingStitcher as JStreaming)
from computervisionimagestich2_tpu_torch.models.streaming import (
    StreamingStitcher as TStreaming)
from test_integration import SMALL, make_scene
from test_torch_incremental import _one_torch_thread  # noqa: F401

CFG = dataclasses.replace(SMALL, canvas_bucket=32)
# (anchor, max_width, project): the keyframe stops matching within four
# frames at this pan (60 px of 140); the rolling window caps at 256 px
RUNS = {"keyframe": ("keyframe", None, False),
        "previous": ("previous", None, True),
        "rolling": ("keyframe", 256, False)}


def _frames():
    scene = make_scene(np.random.default_rng(0), h=140, w=340)
    return [scene[:, i * 60: i * 60 + 140] for i in range(4)]


def _stream(cls, run, **kw):
    anchor, max_width, project = RUNS[run]
    ss = cls(CFG, max_width=max_width, project=project, anchor=anchor, **kw)
    sizes = [ss.push(f) for f in _frames()]
    return ss, sizes


@pytest.fixture(scope="module")
def jax_streams():
    return {run: _stream(JStreaming, run) for run in RUNS}


@pytest.mark.parametrize("run", list(RUNS))
def test_stream_matches_jax(jax_streams, run):
    """Equal canvas sizes after every frame, equal keyframe switches, and
    the final canvases within MAD <= 3 u8 levels."""
    ss_j, sizes_j = jax_streams[run]
    ss_t, sizes_t = _stream(TStreaming, run, device="cpu")
    assert sizes_t == sizes_j
    assert ss_t.n_keyframe_switches == ss_j.n_keyframe_switches
    out_t, out_j = ss_t.canvas(), ss_j.canvas()
    assert out_t.dtype == np.uint8 and out_t.shape == out_j.shape
    mad = np.abs(out_t.astype(np.int64) - out_j.astype(np.int64)).mean()
    assert mad <= 3.0, mad
    assert set(ss_t.stage_times) == {"sift", "register", "composite"}
    if run == "keyframe":
        assert ss_t.n_keyframe_switches >= 1
        assert sizes_t[-1][1] > 2 * 140  # the canvas grew with the pan
    if run == "rolling":
        assert all(w <= 256 for _, w in sizes_t)


def test_stream_refusals():
    ss = TStreaming(CFG, project=False, device="cpu")
    with pytest.raises(ValueError, match="no frames"):
        ss.canvas()
    with pytest.raises(ValueError, match="anchor"):
        TStreaming(CFG, anchor="first", device="cpu")


@pytest.mark.parametrize("content_h", [20, 50], ids=["content", "past"])
def test_seam_row_past_the_content_matches_jax(content_h):
    """The stream keeps its padded canvas, so the content height it hands
    the blend can pass the content (ROADMAP.md §C): the seam row is then
    empty and the seam flips, and the new frame's zeros replace the old
    canvas. The port reproduces the JAX package there too: the blend
    equals JAX's within 1e-3, and the old-only columns survive (mean over
    50 u8 levels) only when the seam row lies in the content; past it they
    fall under 10."""
    import jax.numpy as jnp
    import torch

    from computervisionimagestich2_tpu.models import blender as jblender
    from computervisionimagestich2_tpu_torch.models import blender

    rng = np.random.default_rng(0)
    a = np.zeros((64, 48, 3), np.float32)
    b = np.zeros((64, 48, 3), np.float32)
    b[:20, :30] = rng.uniform(20, 235, (20, 30, 3))   # the old canvas
    a[:20, 20:] = rng.uniform(20, 235, (20, 28, 3))   # the new frame
    cfg = CFG.blend
    out = blender.blend_edge(torch.as_tensor(a), torch.as_tensor(b), cfg,
                             content_h).numpy()
    ref = np.asarray(jblender.blend_edge(jnp.asarray(a), jnp.asarray(b), cfg,
                                         content_h))
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)
    old_only = out[:20, 4:16]  # beyond the low-pass bleed of column 0
    if content_h == 20:
        assert old_only.mean() > 50, old_only.mean()
    else:
        assert old_only.mean() < 10, old_only.mean()
