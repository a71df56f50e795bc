"""BASELINE config 4's mechanisms (gain compensation, both blend gates, the
static capacities binding) at a small size, the port against the JAX
package on the CPU. Config 4 itself runs at 4 x 3840x2160 on the card
(``chip_smoke.py`` phase 17); here the area gates are set below the
canvas and the capacities below the live counts, so that every mechanism
that 4K engages engages on a few 160 x 160 crops.

The per-octave keypoint capacity has a floor of 128 slots a level
(``models/sift.py::keypoint_capacity``), which a 160 x 160 crop never
fills: it binds in the SIFT case, on a 320 x 320 scene.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from computervisionimagestich2_tpu.models import sift as jsift
from computervisionimagestich2_tpu.models.stitcher import Stitcher as JStitcher
from computervisionimagestich2_tpu.utils import obs as jobs
from computervisionimagestich2_tpu_torch.models import sift as tsift
from computervisionimagestich2_tpu_torch.models import stitcher as tstm
from computervisionimagestich2_tpu_torch.models.blender import (
    resolve_dtype, seam_auto_engaged)
from computervisionimagestich2_tpu_torch.ops.color import to_gray
from computervisionimagestich2_tpu_torch.ops.warp import cylindrical_project
from computervisionimagestich2_tpu_torch.utils import obs as tobs
from test_integration import make_scene
from test_torch_graph_stitch import SMALL_DEFAULT, _record_ordering
from test_torch_incremental import _one_torch_thread  # noqa: F401

R = dataclasses.replace
# config 4 (scripts/bench_configs.py:109-112: DEFAULT_CONFIG with gain
# compensation) on SMALL_DEFAULT, with the gates below a 166 x 404 canvas
# (bf16 pyramids; a 4 x 16-px seam band, which forces rgb gain) and the
# final keypoint capacity and the match capacity below the live counts
CONFIG4_SMALL = R(
    SMALL_DEFAULT,
    sift=R(SMALL_DEFAULT.sift, max_keypoints=64),
    match=R(SMALL_DEFAULT.match, max_matches=16),
    blend=R(SMALL_DEFAULT.blend, gain_compensation=True,
            bf16_auto_area=10_000, seam_auto_area=10_000, seam_auto_band=16))
SCRAMBLE = [2, 0, 3, 1]


def _crops() -> list[np.ndarray]:
    """Four 160 x 160 crops of one scene, 80 px apart, scrambled."""
    scene = make_scene(np.random.default_rng(0), h=160, w=400)
    crops = [scene[:, i * 80:i * 80 + 160] for i in range(4)]
    return [crops[k] for k in SCRAMBLE]


def _gray(img: np.ndarray) -> np.ndarray:
    """The stitch's SIFT input: cylindrical projection, then u8 luma."""
    proj = cylindrical_project(torch.as_tensor(img).float(),
                               SMALL_DEFAULT.projection.angle_deg)
    return to_gray(proj).numpy()


def _telemetry(obs_module) -> dict:
    """Record what a package's ``obs`` reports: the SIFT drop counters
    handed to ``log_sift_overflow`` and the ``match_overflow`` warnings.
    Returns the record and a function that restores the module."""
    seen = {"sift": [], "match_overflow": []}
    log_sift, warn = obs_module.log_sift_overflow, obs_module.warn

    def log_sift_rec(stats):
        seen["sift"].extend(np.asarray(stats).reshape(-1, 4).tolist())
        log_sift(stats)

    def warn_rec(stage, **kv):
        if stage == "match_overflow":
            seen["match_overflow"].append(kv)
        warn(stage, **kv)

    obs_module.log_sift_overflow, obs_module.warn = log_sift_rec, warn_rec

    def restore():
        obs_module.log_sift_overflow, obs_module.warn = log_sift, warn
    return seen, restore


def test_sift_drop_counters_equal_jax():
    """On the same luma input, a 320 x 320 scene projected as the stitch
    projects it, the port's four drop counters equal the JAX package's
    exactly, with the per-octave capacity (at its floor, 128 slots a
    level) and a 96-slot final capacity binding. The JAX side runs under
    ``jax.disable_jit()``: jitted XLA:CPU contracts multiply-adds into
    FMAs, which moves a keypoint now and then (one of the four crops of
    the stitch below, by one)."""
    g = _gray(make_scene(np.random.default_rng(0), h=320, w=320))
    cfg = R(SMALL_DEFAULT.sift, max_keypoints_per_octave=1, max_keypoints=96)
    _, ts = tsift.sift_extract_stats(torch.as_tensor(g), cfg)
    with jax.disable_jit():
        _, js = jsift.sift_extract_stats(jnp.asarray(g), cfg)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[1] > 0 and ts[3] > 0, ts  # both capacities bind


def test_config4_small_stitch_matches_jax():
    """CONFIG4_SMALL on four scrambled crops, port against the JAX
    ``Stitcher``: the same graph and start; every blend of the port's run
    on a canvas above both gates (bf16, seam band with its rgb gain); per
    image the same drop counters binding, each within max(2, 5%) of the
    live count of JAX's (the jitted JAX stitch rounds the luma apart in a
    few pixels, and contracts multiply-adds in SIFT, which moves a
    keypoint or two); ``match_overflow`` logged on the same edges with
    the same counts; the panorama within shape +-3 px and MAD <= 3 u8
    levels (tests/test_torch_stitch.py's gate; 0.568 measured on the
    CPU)."""
    crops = _crops()
    blends, blend = [], tstm.blend_edge

    def blend_rec(a, b, bcfg, *rest):
        blends.append((tuple(a.shape[:2]), bcfg))
        return blend(a, b, bcfg, *rest)

    st_t = tstm.Stitcher(CONFIG4_SMALL, device="cpu")
    st_j = JStitcher(CONFIG4_SMALL)
    seen_t, seen_j = _record_ordering(st_t), _record_ordering(st_j)
    tel_t, restore_t = _telemetry(tobs)
    tel_j, restore_j = _telemetry(jobs)
    tstm.blend_edge = blend_rec
    try:
        out_t = st_t.stitch(crops)
        out_j = st_j.stitch(crops)
    finally:
        tstm.blend_edge = blend
        restore_t()
        restore_j()
    assert seen_t == seen_j
    assert len(blends) == 3
    for (h, w), bcfg in blends:
        assert resolve_dtype(bcfg.dtype, h, w, bcfg.bf16_auto_area) == "bf16"
        assert seam_auto_engaged(bcfg, h, w), (h, w)
    assert len(tel_t["sift"]) == len(tel_j["sift"]) == 4
    for t_row, j_row in zip(tel_t["sift"], tel_j["sift"]):
        assert [v > 0 for v in t_row] == [v > 0 for v in j_row]
        live = CONFIG4_SMALL.sift.max_keypoints + j_row[3]
        assert all(abs(a - b) <= max(2, 0.05 * live)
                   for a, b in zip(t_row, j_row)), (t_row, j_row)
    assert sum(r[3] > 0 for r in tel_t["sift"]) == 4
    assert tel_t["match_overflow"], "the match capacity must bind"
    assert tel_t["match_overflow"] == tel_j["match_overflow"]
    assert abs(out_t.shape[0] - out_j.shape[0]) <= 3
    assert abs(out_t.shape[1] - out_j.shape[1]) <= 3
    assert out_j.shape[1] > 380, out_j.shape  # all four crops stitched
    h = min(out_t.shape[0], out_j.shape[0])
    w = min(out_t.shape[1], out_j.shape[1])
    mad = np.abs(out_t[:h, :w].astype(np.int64)
                 - out_j[:h, :w].astype(np.int64)).mean()
    assert mad <= 3.0, mad
