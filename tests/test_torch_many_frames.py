"""Many frames through the port's default stitch (``DEFAULT_CONFIG``: graph
ordering over every pair, the planned path), as the reference app's
18-photo dataset2 runs it, at a size the CPU can hold: ten crops of one
seeded scene in scene order, nine edges, one more edge canvas than the
composite + blend program keeps (``core/programs.py::MAX_GRAPHS``), and
the blend's area gates set low so that one stitch blends in float32, in
bfloat16 and on the seam band.

(a) ``Stitcher.stitch`` against the benchmark's plain reference
    (``benchmark/stitch_reference/pipeline.py::stitch``): counts, edges,
    plan and panorama bit for bit;
(b) the port's ordering of those counts (``directed_adjacency``,
    ``_middle_index``, ``bfs_edge_seq``) against the JAX package's;
(c) on stand-in CUDA graphs (``test_torch_programs._FakeGraphs``): the
    edges beyond ``MAX_GRAPHS`` run eagerly on every call, the second
    call captures nothing, each edge's ``blend:<mode>`` span names the
    blend its canvas takes, and the panoramas equal the eager one.
"""
import dataclasses
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from computervisionimagestich2_tpu.models import stitcher as jstm
from computervisionimagestich2_tpu_torch import DEFAULT_CONFIG
from computervisionimagestich2_tpu_torch.core import programs
from computervisionimagestich2_tpu_torch.models import blender
from computervisionimagestich2_tpu_torch.models import stitcher as tstm
from computervisionimagestich2_tpu_torch.tools.scenes import crops
from test_torch_programs import _FakeGraphs

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
N_FRAMES, H, W, STEP, SCALE, SEED = 10, 160, 120, 60, 2, 0
F32_AREA, BF16_AREA, BAND = 45_000, 70_000, 16
# the same overrides of both sides' DEFAULT_CONFIG: the small sizes of the
# CPU tests, the pair threshold lowered as in tests/test_integration.py
# (neighbours here match 14-24 times, pairs that share nothing <= 3), and
# both blend gates inside this stitch's canvases (~0.03-0.11 Mpx)
OVERRIDES = {
    "sift": {"n_octaves": 2, "max_keypoints_per_octave": 128,
             "max_keypoints": 256},
    "match": {"max_matches": 512, "pair_threshold": 5},
    "ransac": {"n_hypotheses": 64},
    "blend": {"bf16_auto_area": F32_AREA, "seam_auto_area": BF16_AREA,
              "seam_auto_band": BAND},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """A thread pool per pytest worker oversubscribes the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def replace(cfg, overrides: dict):
    return dataclasses.replace(cfg, **{
        k: replace(getattr(cfg, k), v) if isinstance(v, dict) else v
        for k, v in overrides.items()})


CFG = replace(DEFAULT_CONFIG, OVERRIDES)


def reference():
    """The benchmark's plain reference, imported by path as its own tests
    do (``benchmark/tests/conftest.py``)."""
    for p in (str(BENCH.parent), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)
    return (importlib.import_module("stitch_reference.pipeline"),
            importlib.import_module("stitch_reference.config"))


@pytest.fixture(scope="module")
def images():
    return crops(H, W, STEP, SCALE, SEED, N_FRAMES)


@pytest.fixture(scope="module")
def eager(images, tmp_path_factory):
    """The port's stitch on the CPU (every program eager), its ordering
    counts and plan kept where the stitcher calls them; its features
    saved for (c) to resume from."""
    got = {}
    counts_fn, plan_fn = tstm.all_pairs_match_counts, tstm.plan_edges_with_rows

    def counts_rec(*a, **k):
        got["counts"] = counts_fn(*a, **k)
        return got["counts"]

    def plan_rec(feats, edges, *a, **k):
        got["edges"] = [tuple(e) for e in edges]
        got["plan"], rows = plan_fn(feats, edges, *a, **k)
        return got["plan"], rows

    run_dir = tmp_path_factory.mktemp("many_frames")
    tstm.all_pairs_match_counts, tstm.plan_edges_with_rows = (counts_rec,
                                                              plan_rec)
    try:
        got["panorama"] = tstm.Stitcher(
            CFG, device="cpu", artifact_dir=str(run_dir)).stitch(images)
    finally:
        tstm.all_pairs_match_counts, tstm.plan_edges_with_rows = (counts_fn,
                                                                  plan_fn)
    got["run_dir"] = str(run_dir)
    return got


def expected_modes(plan) -> list[str]:
    """Each edge's blend by its canvas's area against the gates set here."""
    areas = [int(r[20]) * int(r[21]) for r in plan]
    return ["f32" if a <= F32_AREA else "bf16" if a <= BF16_AREA else "band"
            for a in areas]


def test_many_frames_equal_the_plain_reference(images, eager):
    pipeline, rconfig = reference()
    from harness.entries import replace_config

    ref = pipeline.stitch(torch.as_tensor(np.stack(images)),
                          replace_config(rconfig.StitchConfig(), OVERRIDES))
    np.testing.assert_array_equal(eager["counts"].numpy(),
                                  ref["counts"].numpy())
    # the scene's chain: every neighbour passes the threshold, nothing else
    adj = tstm.directed_adjacency(ref["counts"].tolist(), 5)
    assert {(i, j) for i in range(N_FRAMES) for j in range(N_FRAMES)
            if adj[i][j]} == {(i, j) for i in range(N_FRAMES)
                              for j in range(N_FRAMES) if abs(i - j) == 1}
    assert eager["edges"] == ref["edges"] and len(ref["edges"]) == N_FRAMES - 1
    np.testing.assert_array_equal(eager["plan"], ref["plan"].numpy())
    np.testing.assert_array_equal(eager["panorama"], ref["panorama"])
    # the stitch crosses both blend gates
    assert set(expected_modes(eager["plan"])) == {"f32", "bf16", "band"}


@pytest.mark.parametrize("asymmetric", [False, True])
def test_many_frames_ordering_equals_jax(eager, asymmetric):
    counts = eager["counts"].tolist()
    if asymmetric:  # one direction of a neighbour pair under the threshold
        counts[3][4] = 4
    port = tstm.directed_adjacency(counts, 5)
    jax_adj = jstm.directed_adjacency(counts, 5)
    assert port == jax_adj
    start = tstm.Stitcher._middle_index(port)
    assert start == jstm.Stitcher._middle_index(jax_adj)
    assert tstm.bfs_edge_seq(port, start) == jstm.bfs_edge_seq(jax_adj, start)


def test_many_frames_overflow_on_stand_in_graphs(images, eager, monkeypatch):
    monkeypatch.setattr(programs, "_BACKEND", _FakeGraphs)
    monkeypatch.setattr(programs, "_graphable", lambda device: True)
    edge = tstm._composite_and_blend
    assert edge.max_graphs == programs.MAX_GRAPHS == 8
    n_edges = len(eager["edges"])
    assert n_edges > edge.max_graphs
    programs.clear_graphs()
    st = tstm.Stitcher(CFG, device="cpu", artifact_dir=eager["run_dir"])
    try:
        c0 = programs.capture_stats()
        cold = st.stitch(images, resume=True)
        cold_d, c1 = programs.captures_since(c0), programs.capture_stats()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            warm = st.stitch(images, resume=True)
        warm_d = programs.captures_since(c1)
    finally:
        programs.clear_graphs()
    np.testing.assert_array_equal(cold, eager["panorama"])
    np.testing.assert_array_equal(warm, eager["panorama"])
    excess = n_edges - edge.max_graphs
    assert cold_d["by_program"]["composite_and_blend"] == edge.max_graphs
    assert cold_d["overflows"] == excess == warm_d["overflows"]
    assert warm_d["captures"] == 0 and warm_d["evictions"] == 0, warm_d
    assert warm_d["replays_by_program"]["composite_and_blend"] == \
        edge.max_graphs
    spans = sorted((e.time_range.start, e.name) for e in prof.events()
                   if e.name.startswith("blend:"))
    modes = expected_modes(eager["plan"])
    assert [name for _, name in spans] == [f"blend:{m}" for m in modes]
    totals = {k: v for k, v in st.stage_times.items()
              if k.startswith("blend.")}
    assert set(totals) == {f"blend.{m}" for m in modes}
    assert all(v > 0 for v in totals.values())
    assert sum(totals.values()) <= st.stage_times["stitching"]


@pytest.mark.parametrize("hw, mode", [
    ((828, 1637), "f32"), ((828, 1980), "bf16"), ((828, 2673), "band"),
    ((2100, 1000), "bf16")])
def test_blend_mode_at_dataset2_canvases(hw, mode):
    """The default gates at dataset2's canvases: float32 up to 1.5 Mpx,
    bfloat16 up to 2 Mpx, the seam band above; a canvas over 2 Mpx but
    narrower than the band's 1024-column window blends the full canvas in
    bfloat16."""
    assert blender.blend_mode(DEFAULT_CONFIG.blend, *hw) == mode
