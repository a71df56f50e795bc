"""Whole runs of the harness on the CPU at small sizes, its look for a card
skipped: the port against the plain reference (every compared number 0),
the run with the timed path broken underneath (``correct`` false for
each fault a cell can have), the lower-precision control failing the
cells' limits, and ``run.py`` refusing to report without a card."""
from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import calibrate
from harness import check, registry, window

SMALL = {"height": 256, "width": 192, "step": 112, "feature_scale": 1}


def small(name: str) -> registry.Cell:
    """The cell at a size a test can hold: its geometry shrunk (the scene
    the seed's own), a bank of 4 sets in batches of 2."""
    cell = registry.cell(name)
    frames = dict(cell.config["frames"], **SMALL)
    mix = dict(cell.traffic)
    if mix["sets"] == "bank":
        mix.update(bank=4, batch=2)
    return dataclasses.replace(cell, config=dict(cell.config, frames=frames),
                               traffic=mix)


def run(cell, seed=3, fault=None) -> dict:
    return window.run_cell(cell, seed, 0.5, 0, "cpu", time.perf_counter(),
                           fault=fault)


@pytest.mark.parametrize("name", ["dataset1_repeat", "dataset1_batch8_fresh",
                                  "config4_4k_repeat"])
def test_the_port_equals_the_reference(name):
    out = run(small(name))
    assert out["correct"], out["checks"]
    # every number against the reference 0; the fit apart from both
    # sides' RANSAC only close
    assert all(c["value"] == 0 for k, c in out["checks"].items()
               if k != "fit_gap_px")
    assert out["checks"].get("fit_gap_px", {"value": 0})["value"] < 0.01
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_a_stitch_that_finds_no_edge():
    """At 192 x 144 the ordering of this scene finds no pair: the record
    holds no plan, and both sides return the start frame."""
    cell = small("dataset1_repeat")
    frames = dict(cell.config["frames"], height=192, width=144, step=84)
    out = run(dataclasses.replace(cell, config=dict(cell.config,
                                                    frames=frames)))
    assert out["correct"], out["checks"]


@pytest.fixture
def stitcher_module():
    from computervisionimagestich2_tpu_torch.models import stitcher
    return stitcher


def test_a_blend_that_returns_its_state_unchanged(monkeypatch,
                                                  stitcher_module):
    monkeypatch.setattr(stitcher_module, "_composite_and_blend",
                        lambda dst, result, *a: result)
    out = run(small("dataset1_repeat"))
    assert not out["correct"]


def test_an_answer_altered_where_it_is_produced(monkeypatch,
                                               stitcher_module):
    tail = stitcher_module.equalize_and_mix
    monkeypatch.setattr(stitcher_module, "equalize_and_mix",
                        lambda *a: torch.clamp(tail(*a) + 2.0, max=255.0))
    out = run(small("dataset1_repeat"))
    assert not out["correct"]
    assert out["checks"]["panorama_mad"]["value"] > 1.0


def test_keypoints_altered_where_they_are_produced(monkeypatch):
    from computervisionimagestich2_tpu_torch.parallel import batched
    extract = batched._project_and_extract_one.fn

    def shifted(image, cfg):
        feats, proj, stats = extract(image, cfg)
        return feats._replace(xy=feats.xy + 0.5), proj, stats
    monkeypatch.setattr(batched._project_and_extract_one, "fn", shifted)
    out = run(small("dataset1_repeat"))
    assert not out["correct"]
    assert out["checks"]["keypoint_miss"]["value"] == 1.0


def half_batch(call):
    """Half of the batch left out: the second half of the members
    answered with the first half's results."""
    def broken(sets, record):
        half = len(sets) // 2
        return call(sets[:half] * 2, record)
    return broken


def stale(call):
    """A call that returns the state of the call before it."""
    last = {}

    def broken(sets, record):
        out = call(sets, True)
        prev = last.get("out", out)
        last["out"] = out
        return prev if record else None
    return broken


@pytest.mark.parametrize("fault", [half_batch, stale])
def test_a_broken_batch(fault):
    out = run(small("dataset1_batch8_fresh"), fault=fault)
    assert not out["correct"]


@pytest.mark.parametrize("name", ["dataset1_repeat", "dataset1_batch8_fresh"])
def test_the_lower_precision_control_fails(name):
    cell = small(name)
    values = calibrate.control_readings(cell, 4, torch.device("cpu"))
    correct, checks = check.judge(values, cell.limits["limits"], 0)
    assert not correct, checks


def test_keypoint_partners():
    rng = np.random.default_rng(0)
    desc = rng.uniform(0, 0.2, (6, 128)).astype(np.float32)
    xy = rng.uniform(0, 100, (6, 2)).astype(np.float32)
    scale = np.full(6, 2.0, np.float32)
    valid = np.array([1, 1, 1, 1, 1, 0], bool)
    feats = (desc, xy, scale, valid)
    assert check.keypoints(feats, feats) == (0, 10, 0.0)
    moved = (desc, xy + np.float32(0.02), scale, valid)
    assert check.keypoints(moved, feats)[0] == 10
    other = (desc + np.float32(0.01), xy, scale, valid)
    assert check.keypoints(other, feats)[0] == 10
    fewer = (desc, xy, scale, np.array([1, 1, 1, 1, 0, 0], bool))
    assert check.keypoints(fewer, feats)[:2] == (1, 9)


def test_plan_gap_and_mad():
    plan = np.zeros((2, 23))
    plan[:, 0] = plan[:, 4] = 1.0
    plan[:, 20:22] = (500, 400)
    edges = [(1, 0, 1), (1, 2, 0)]
    assert check.plan_gap(plan, edges, plan, edges, (100, 80)) == 0.0
    moved = plan.copy()
    moved[1, 3] += 0.25
    assert check.plan_gap(moved, edges, plan, edges, (100, 80)) == 0.25
    assert check.plan_gap(plan, edges[::-1], plan, edges,
                          (100, 80)) == check.NO_MATCH
    a = np.full((4, 4, 3), 10, np.uint8)
    assert check.image_mad(a, a) == 0.0
    assert check.image_mad(a, a[:2]) == pytest.approx(5.0)


def test_the_independent_fit():
    """The fit finds the bilinear model of matches a third of which are
    outliers, and ``fit_gap_px`` reads a plan whose model both sides
    share but the matches do not hold."""
    rng = np.random.default_rng(1)
    true = np.array([1.01, 0.02, 1e-5, 224.0, -0.01, 0.99, 2e-5, 3.0])
    src = rng.uniform(0, 380, (300, 2))
    dst = check._warp(true, src[:, 0], src[:, 1]).T
    dst = dst + rng.normal(0, 0.3, dst.shape)
    dst[::3] = rng.uniform(0, 600, (100, 2))
    valid = np.ones(300, bool)
    coef = check.independent_fit(src, dst, valid)
    corners = (np.array([0.0, 383, 0, 383]), np.array([0.0, 0, 511, 511]))
    assert np.hypot(*(check._warp(coef, *corners)
                      - check._warp(true, *corners))).max() < 1.0
    plan = np.zeros((1, 23))
    plan[0, :8] = true
    edges = [(1, 0, 1)]
    pairs = [(src, dst, valid)]
    assert check.fit_gap(plan, edges, edges, pairs, (512, 384)) < 1.0
    plan[0, 3] += 20.0
    assert check.fit_gap(plan, edges, edges, pairs, (512, 384)) > 19.0
    assert check.fit_gap(plan, edges, [(0, 1, 0)], pairs,
                         (512, 384)) == check.NO_MATCH
    assert check.independent_fit(src[:3], dst[:3], valid[:3]) is None


def test_no_card_no_result(tmp_path):
    """Without a CUDA device run.py exits non-zero and prints nothing on
    standard output; so does a directory that holds only BENCHMARK.json
    and the benchmark's files."""
    root = registry.ROOT
    shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(root / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd in (root, tmp_path):
        p = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "dataset1_repeat", "--seed", "1", "--seconds", "1", "--trace",
             "0"], cwd=cwd, env=env, capture_output=True, text=True,
            timeout=300)
        assert p.returncode != 0 and p.stdout == "", (p.returncode, p.stdout)


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """One short run of the first cell on the card (skips elsewhere)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "dataset1_repeat",
         "--seed", "5", "--seconds", "2", "--trace", "0"],
        cwd=registry.ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    import json
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
