"""The PyTorch port's incremental stitch (``planned=False``), bucketed
canvases (``exact_canvas=False``), the per-edge color transfer and
dump / resume, on the CPU against the JAX package's ``Stitcher``.

The JAX side runs once per module (its incremental stitch compiles per
canvas shape): ``planned=False``, ``exact_canvas=False`` and
``color_transfer=True`` together on three crops in scrambled order, with
an artifact directory, so one run covers the three switches and writes
the ``features.npz`` a port resume reads. The port's own run of the same
configuration is shared the same way, and the comparisons between the
port's paths resume from its ``features.npz``: SIFT does not depend on
the switches compared, so each of them costs a stitch without SIFT.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from computervisionimagestich2_tpu.models import compose as jcompose
from computervisionimagestich2_tpu.models.stitcher import Stitcher as JStitcher
from computervisionimagestich2_tpu.utils import artifacts as jartifacts
from computervisionimagestich2_tpu_torch.models import compose
from computervisionimagestich2_tpu_torch.models.stitcher import (
    Stitcher as TStitcher)
from computervisionimagestich2_tpu_torch.utils import artifacts
from test_integration import make_scene
from test_torch_graph_stitch import SMALL_DEFAULT

INCREMENTAL = dataclasses.replace(SMALL_DEFAULT, planned=False,
                                  exact_canvas=False, color_transfer=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run the port's CPU tensors on one thread: with the test workers
    side by side, a full thread pool per worker spins against the others'
    JAX compiles and runs many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _crops():
    scene = make_scene(np.random.default_rng(0), h=160, w=320)
    return [scene[:, s:s + 160] for s in (160, 0, 80)]


def resumed_stitch(cfg, features_npz, run_dir, images):
    """The port's stitch of ``images`` under ``cfg`` from a copy of
    ``features_npz`` in ``run_dir``; SIFT cannot run (prepare is None)."""
    os.makedirs(run_dir, exist_ok=True)
    shutil.copy(features_npz, os.path.join(run_dir, "features.npz"))
    st = TStitcher(cfg, device="cpu", artifact_dir=str(run_dir))
    st.prepare = None  # raises if the resume path falls through to SIFT
    return st.stitch(images, resume=True)


def assert_close_canvas(out, ref, mad_max=3.0):
    """Shape within +-3 px and MAD over the common canvas <= ``mad_max``
    u8 levels (the end-to-end gate of tests/test_torch_stitch.py)."""
    assert out.dtype == np.uint8
    assert abs(out.shape[0] - ref.shape[0]) <= 3, (out.shape, ref.shape)
    assert abs(out.shape[1] - ref.shape[1]) <= 3, (out.shape, ref.shape)
    h, w = min(out.shape[0], ref.shape[0]), min(out.shape[1], ref.shape[1])
    mad = np.abs(out[:h, :w].astype(np.int64)
                 - ref[:h, :w].astype(np.int64)).mean()
    assert mad <= mad_max, mad


def assert_one_step(out_a, out_b):
    """The planned-vs-incremental gate of tests/test_integration.py:151-154:
    equal shape, isolated one-step u8 differences only."""
    assert out_a.shape == out_b.shape
    diff = np.abs(out_a.astype(int) - out_b.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    art = str(tmp_path_factory.mktemp("jax_artifacts"))
    out = JStitcher(INCREMENTAL, artifact_dir=art).stitch(_crops())
    return out, art


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The port's INCREMENTAL stitch with an artifact directory: (panorama,
    the directory's features.npz, the directory)."""
    art = str(tmp_path_factory.mktemp("port_artifacts"))
    out = TStitcher(INCREMENTAL, device="cpu", artifact_dir=art).stitch(
        _crops())
    return out, f"{art}/features.npz", art


def test_incremental_matches_jax_stitcher(jax_run, port_run):
    """planned=False + exact_canvas=False + color_transfer=True: the port
    against the JAX incremental stitch, shape +-3 px, MAD <= 3."""
    out_j, _ = jax_run
    assert_close_canvas(port_run[0], out_j)
    # a real panorama: about as wide as the 320-column scene
    assert abs(out_j.shape[1] - 320) <= 16, out_j.shape


@pytest.mark.parametrize("change", [
    dict(),
    dict(exact_canvas=False, color_transfer=True),
], ids=["exact", "bucketed_transfer"])
def test_incremental_matches_planned(change, port_run, tmp_path):
    """The port's per-edge loop against its planned path (host canvas plan
    in numpy f32 vs device bounds), at the gate of
    tests/test_integration.py:151-154."""
    cfg = dataclasses.replace(SMALL_DEFAULT, **change)
    _, feats, _ = port_run
    out_p = resumed_stitch(cfg, feats, tmp_path / "planned", _crops())
    if dataclasses.replace(cfg, planned=False) == INCREMENTAL:
        out_i = port_run[0]
    else:
        out_i = resumed_stitch(dataclasses.replace(cfg, planned=False),
                               feats, tmp_path / "incremental", _crops())
    assert_one_step(out_p, out_i)


def test_bucketed_canvas_matches_exact(tmp_path):
    """tests/test_integration.py:157-189 on the port: with the luma mix
    off, mean |diff| < 1 and |diff| > 30 on under 0.5% of the canvas;
    with enhancement on, mean |diff| < 8."""
    scene = make_scene(np.random.default_rng(0), h=140, w=320)
    parts = [scene[:, :140], scene[:, 90:230], scene[:, 180:]]
    chain = dataclasses.replace(SMALL_DEFAULT, ordering="chain")
    no_mix = dataclasses.replace(chain.enhance, mix_weight=0.0)
    first = str(tmp_path / "first")
    out_e = TStitcher(dataclasses.replace(chain, enhance=no_mix),
                      device="cpu", artifact_dir=first).stitch(parts)
    for k, (enhance, mean_max) in enumerate(((no_mix, 1.0),
                                             (chain.enhance, 8.0))):
        base = dataclasses.replace(chain, enhance=enhance)
        if k:
            out_e = resumed_stitch(base, f"{first}/features.npz",
                                   tmp_path / "exact", parts)
        out_b = resumed_stitch(dataclasses.replace(base, exact_canvas=False),
                               f"{first}/features.npz",
                               tmp_path / f"bucketed{k}", parts)
        assert out_e.shape == out_b.shape  # the crop restores the size
        diff = np.abs(out_e.astype(int) - out_b.astype(int))
        assert diff.mean() < mean_max, diff.mean()
        if mean_max == 1.0:
            assert (diff > 30).mean() < 0.005, (diff > 30).mean()


def test_resume_is_bit_identical(port_run, tmp_path):
    """Dump and resume in the port: the resumed stitch (SIFT skipped,
    prepare() unreachable) equals the original bit for bit, and the
    artifact directory holds the features, the canvas and the manifest;
    resume=True without features.npz runs the normal path."""
    out, feats, art = port_run
    np.testing.assert_array_equal(
        out, resumed_stitch(INCREMENTAL, feats, tmp_path / "run", _crops()))
    np.testing.assert_array_equal(
        artifacts.load_stage(art, "canvas")["canvas"], out)
    assert artifacts.load_manifest(art) == {
        "n_images": 3, "ordering": "graph", "canvas_hw": list(out.shape[:2])}

    class SiftRan(Exception):
        pass

    def prepare(images):
        raise SiftRan

    empty = TStitcher(INCREMENTAL, device="cpu",
                      artifact_dir=str(tmp_path / "empty"))
    empty.prepare = prepare
    with pytest.raises(SiftRan):
        empty.stitch(_crops(), resume=True)


def test_resume_from_jax_features(jax_run, tmp_path):
    """A features.npz written by the JAX package resumes in the port: the
    panorama is the JAX one within shape +-3 px and MAD <= 3."""
    out_j, art = jax_run
    assert_close_canvas(resumed_stitch(INCREMENTAL, f"{art}/features.npz",
                                       tmp_path / "run", _crops()), out_j)


def test_features_npz_layout_is_shared(jax_run, tmp_path):
    """The port writes the JAX package's npz layout: the same keys, and
    the JAX loader reads back the arrays the port loaded, bit for bit."""
    _, art = jax_run
    feats = artifacts.load_features(f"{art}/features.npz")
    path = str(tmp_path / "features.npz")
    artifacts.save_features(path, feats)
    assert sorted(np.load(path).files) == sorted(
        np.load(f"{art}/features.npz").files)
    for ours, theirs in zip(jartifacts.load_features(path),
                            jartifacts.load_features(f"{art}/features.npz")):
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_resume_refuses_a_stale_artifact(port_run, tmp_path):
    art = str(tmp_path / "run")
    artifacts.save_features(f"{art}/features.npz",
                            artifacts.load_features(port_run[1])[:2])
    with pytest.raises(ValueError, match="stale"):
        TStitcher(INCREMENTAL, device="cpu", artifact_dir=art).stitch(
            _crops(), resume=True)


@pytest.mark.parametrize("base", [32, 64, 128, 256])
def test_bucket_size_matches_jax(base):
    for v in [1, base - 1, base, base + 1, 333, 1000, 1057, 4095, 4096,
              7777, 20000]:
        assert compose.bucket_size(v, base) == jcompose.bucket_size(v, base)


def test_validate_canvas_matches_jax():
    """Both packages accept and refuse the same canvases, including the
    16 x 4096 x 4096 allowance and non-finite sizes."""
    cases = [(100, 200, (100, 100)), (0, 10, (10, 10)), (10, -1, (10, 10)),
             (float("nan"), 10, (10, 10)), (4096 * 4, 4096, (1, 1)),
             (4096 * 4 + 1, 4096, (1, 1)), (2000, 3000, (1080, 1920)),
             (40000, 30000, (1080, 1920)), (1, 1, (1, 1))]
    for h, w, img_hw in cases:
        outcome = []
        for validate in (TStitcher._validate_canvas,
                         JStitcher._validate_canvas):
            try:
                validate(h, w, img_hw, "test")
                outcome.append("ok")
            except ValueError:
                outcome.append("refused")
        assert outcome[0] == outcome[1], (h, w, img_hw, outcome)
