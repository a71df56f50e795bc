"""The PyTorch port's boundary: the configuration switches it accepts
and refuses, the device it refuses without a GPU, and whole stitches (the
chain slice and the default graph path) in a fresh interpreter that loads
no jax.
"""
import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from computervisionimagestich2_tpu_torch import (
    DEFAULT_CONFIG, SLICE_CONFIG, check_supported)
from computervisionimagestich2_tpu_torch.models.stitcher import (
    Stitcher as TStitcher)
from test_torch_stitch import SMALL_SLICE

REPO = Path(__file__).resolve().parents[1]


_NO_JAX = textwrap.dedent("""
    import sys
    import numpy as np
    from computervisionimagestich2_tpu_torch import {config}
    from computervisionimagestich2_tpu_torch.models.stitcher import Stitcher
    import dataclasses as dc
    rng = np.random.default_rng(0)
    img = rng.uniform(60, 200, (120, 200, 3))
    ys, xs = np.mgrid[0:120, 0:200]
    for _ in range(20):
        cy, cx, r = rng.uniform(10, 110), rng.uniform(10, 190), rng.uniform(3, 9)
        img[(ys - cy) ** 2 + (xs - cx) ** 2 < r * r] = rng.uniform(0, 255, 3)
    img = img.astype(np.uint8)
    cfg = dc.replace({config}, sift=dc.replace({config}.sift,
        n_octaves=2, max_keypoints_per_octave=512, max_keypoints=1024),
        match=dc.replace({config}.match, pair_threshold=5))
    out = Stitcher(cfg, device="cpu").stitch({crops})
    assert out.dtype == np.uint8 and out.ndim == 3, out.shape
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib"))
    assert not loaded, loaded
    print("NO_JAX_OK", out.shape)
""")


def _run_without_jax(config: str, crops: str):
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX.format(config=config, crops=crops)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


def test_slice_runs_without_jax():
    """The port never imports jax: a whole stitch of the chain slice in a
    fresh interpreter leaves no jax module loaded."""
    _run_without_jax("SLICE_CONFIG", "[img[:, :120], img[:, 80:]]")


def test_default_path_runs_without_jax():
    """The same for the default configuration: graph ordering over
    scrambled crops and the fused detect."""
    _run_without_jax("DEFAULT_CONFIG", "[img[:, 60:], img[:, :140]]")


def test_cuda_request_raises_without_gpu():
    """device="cuda" on a host with no GPU raises; nothing falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        TStitcher(SMALL_SLICE, device="cuda")


@pytest.mark.parametrize("change", [
    dict(sift=dataclasses.replace(SLICE_CONFIG.sift, walk_dtype="bf16")),
    dict(blend=dataclasses.replace(SLICE_CONFIG.blend,
                                   blur_impl="fir_fused")),
])
def test_outside_the_slice_raises(change):
    cfg = dataclasses.replace(SLICE_CONFIG, **change)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        check_supported(cfg)
    with pytest.raises(NotImplementedError):
        TStitcher(cfg, device="cpu")


@pytest.mark.parametrize("cfg", [
    dataclasses.replace(SLICE_CONFIG, ordering="graph"),
    dataclasses.replace(SLICE_CONFIG, sift=dataclasses.replace(
        SLICE_CONFIG.sift, detect_impl="pallas")),
    dataclasses.replace(SLICE_CONFIG, match=dataclasses.replace(
        SLICE_CONFIG.match, method="auto")),
    DEFAULT_CONFIG,
    dataclasses.replace(SLICE_CONFIG, planned=False),
    dataclasses.replace(SLICE_CONFIG, exact_canvas=False),
    dataclasses.replace(SLICE_CONFIG, color_transfer=True),
    dataclasses.replace(SLICE_CONFIG, warp_model="projective"),
    dataclasses.replace(SLICE_CONFIG, blend=dataclasses.replace(
        SLICE_CONFIG.blend, blur_impl="vanvliet")),
    dataclasses.replace(SLICE_CONFIG, sift=dataclasses.replace(
        SLICE_CONFIG.sift, o_min=-1)),
    dataclasses.replace(SLICE_CONFIG, blend=dataclasses.replace(
        SLICE_CONFIG.blend, gain_compensation=True, gain_mode="luma")),
    dataclasses.replace(SLICE_CONFIG, match=dataclasses.replace(
        SLICE_CONFIG.match, method="l2pre")),
    dataclasses.replace(SLICE_CONFIG, match=dataclasses.replace(
        SLICE_CONFIG.match, distance="l2")),
], ids=["graph", "fused_detect", "method_auto", "default_config",
        "incremental", "bucketed_canvas", "color_transfer", "projective",
        "vanvliet", "o_min_-1", "luma_gain", "l2pre", "distance_l2"])
def test_default_path_switches_are_accepted(cfg):
    """The default configuration's switches are ported: graph ordering,
    the fused detect and method="auto" (exact L1 off a TPU); so are the
    incremental stitch, bucketed canvases (the command line's default),
    the per-edge color transfer, projective warps, the Van Vliet blend, an
    upsampled first octave, the luma gain, the L2-prefiltered matcher and
    squared-L2 matching."""
    check_supported(cfg)
    assert TStitcher(cfg, device="cpu").config is cfg


def test_slice_config_is_supported_and_mixed_shapes_prepare():
    """Images of mixed shapes are prepared one by one, each projected at
    its own shape, and nothing is stacked for the planned path, even where
    the feature capacities agree."""
    check_supported(SLICE_CONFIG)
    assert SLICE_CONFIG.ordering == "chain"
    assert SLICE_CONFIG.sift.detect_impl == "xla"
    assert SLICE_CONFIG.match.method == "exact"
    rgb = np.random.default_rng(0).integers(0, 256, (40, 40, 3), np.uint8)
    images = [rgb, rgb[:, :30], rgb[:36]]
    st = TStitcher(SMALL_SLICE, device="cpu")
    projected, feats = st.prepare(images)
    assert [tuple(p.shape) for p in projected] == [i.shape for i in images]
    assert len(feats) == 3
    assert len({f.desc.shape for f in feats}) == 1  # one capacity here
    assert st._feats_stacked is None
