"""The PyTorch port's slice end to end: ``Stitcher(SLICE_CONFIG)`` on the
CPU against the JAX package's ``Stitcher`` with the same configuration.
The slice's boundary and its independence from JAX are in
tests/test_torch_slice.py.
"""
import dataclasses

import numpy as np

from computervisionimagestich2_tpu.models.stitcher import Stitcher as JStitcher
from computervisionimagestich2_tpu_torch import SLICE_CONFIG
from computervisionimagestich2_tpu_torch.models.stitcher import (
    Stitcher as TStitcher)
from test_integration import make_scene

# SLICE_CONFIG at the small sizes of tests/test_integration.py::SMALL
SMALL_SLICE = dataclasses.replace(
    SLICE_CONFIG,
    sift=dataclasses.replace(SLICE_CONFIG.sift, n_octaves=2,
                             max_keypoints_per_octave=512,
                             max_keypoints=1024),
    match=dataclasses.replace(SLICE_CONFIG.match, max_matches=512),
    ransac=dataclasses.replace(SLICE_CONFIG.ransac, n_hypotheses=64))


def test_slice_matches_jax_stitcher():
    """Three overlapping make_scene crops: canvas shape within +-3 px (the
    golden gate's tolerance, README.md) and MAD over the common canvas
    <= 3 u8 levels."""
    scene = make_scene(np.random.default_rng(0), h=160, w=320)
    crops = [scene[:, s:s + 160] for s in (0, 80, 160)]
    st = TStitcher(SMALL_SLICE, device="cpu")
    out_t = st.stitch(crops)
    out_j = JStitcher(SMALL_SLICE).stitch(crops)
    assert out_t.dtype == np.uint8
    assert abs(out_t.shape[0] - out_j.shape[0]) <= 3
    assert abs(out_t.shape[1] - out_j.shape[1]) <= 3
    # a real panorama: about as wide as the scene
    assert abs(out_j.shape[1] - scene.shape[1]) <= 16, out_j.shape
    h = min(out_t.shape[0], out_j.shape[0])
    w = min(out_t.shape[1], out_j.shape[1])
    mad = np.abs(out_t[:h, :w].astype(np.int64)
                 - out_j[:h, :w].astype(np.int64)).mean()
    assert mad <= 3.0, mad
    # the four stages and the totals of the spans inside the call (the
    # edges' blends all float32 over the full canvas at this size); on the
    # CPU no graph replays, so no replay, launch or capture
    assert set(st.stage_times) == {"features", "ordering", "stitching",
                                   "enhance", "stitch", "upload",
                                   "readback", "blend.f32"}
