"""The port's bench (``bench_torch.py``, ``tools/bench.py``) on the CPU:
the scenes it stitches, one cell end to end at a reduced size, its import
(no jax, no build) and its refusal to run without a card; and the report
of its traced run (``tools/probes.py``: the idle gaps, the summary of a
Chrome trace) on synthetic events and on a CPU profile.
"""
import contextlib
import hashlib
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from computervisionimagestich2_tpu_torch.models import stitcher as stm
from computervisionimagestich2_tpu_torch.tools import bench, probes, scenes

REPO = Path(__file__).resolve().parents[1]

# SHA-256 of the scenes as chip_smoke.py made them before they moved to
# tools/scenes.py: every phase of chip_smoke.py and every cell of the bench
# stitches these bits
PINNED = {
    "crops(512, 384, 224, 2, seed=0)": (
        lambda: scenes.crops(512, 384, 224, 2, seed=0),
        "729340e9bb16b5c4aae65e9ec5e6e943378216f88dafbc091f2812e26d19ee99"),
    "the 1440x1080 scene, seed 1": (
        lambda: [scenes.make_scene(np.random.default_rng(1), 1440,
                                   1080 + 3 * 630, 6)],
        "26b54aef6867fbdc3067a00b7253bbf15e3fb3e538e3014d8e6ec6c5a6207cf3"),
}

# every key of a panorama cell's line
LINE_KEYS = {
    "cell", "kind", "config", "frame", "reduced", "images_per_panorama",
    "device", "torch", "gpu", "nvidia_smi", "scene", "setup", "cold_ms",
    "panorama_ms", "peak_mem_gib", "sift_kpts_per_s", "stage_ms", "canvas",
    "launches", "profile", "checks", "correct",
    "panorama_4img_384x512_e2e_ms", "vs_baseline", "baseline_ms",
    "baseline_note", "regression_bounds", "seconds", "elapsed_s"}
# what only a card can measure: null in a CPU run
DEVICE_METRICS = ("gpu", "nvidia_smi", "peak_mem_gib", "launches",
                  "profile")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """A thread pool per pytest worker oversubscribes the shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(PINNED))
def test_scenes_keep_their_bits(name):
    make, digest = PINNED[name]
    h = hashlib.sha256()
    for a in make():
        h.update(np.ascontiguousarray(a).tobytes())
    assert h.hexdigest() == digest


ARGV = ["--device", "cpu", "--cells", "pano4_512x384", "--runs", "1",
        "--frame", "256x192"]


@pytest.fixture(scope="module")
def cpu_run():
    """The headline cell on the CPU at 256x192 (step and feature scale
    halved with the width), one warm run: the exit code, the printed
    lines, the record of the cold stitch's plan that its parity was scored
    on, and each image's SIFT output by the digest of its luma."""
    recs, parity = [], bench.plan_parity
    sift, sift_fn = {}, stm.sift_extract_stats

    def keep(rec, *a):
        recs.append(rec)
        return parity(rec, *a)

    def keep_sift(gray, *a):
        sift[_digest(gray)] = out = sift_fn(gray, *a)
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(bench, "plan_parity", keep)
    mp.setattr(stm, "sift_extract_stats", keep_sift)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = bench.main(ARGV)
    finally:
        mp.undo()
    lines = [json.loads(t) for t in out.getvalue().splitlines()]
    return rc, lines, recs, sift


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()


def test_bench_cpu_line(cpu_run):
    """Every key of the headline cell's line, correct, and no device
    metric."""
    rc, lines, _, _ = cpu_run
    assert rc == 0 and len(lines) == 1
    line = lines[0]
    assert set(line) == LINE_KEYS, set(line) ^ LINE_KEYS
    assert line["correct"] is True, line["checks"]
    assert line["device"] == "cpu" and line["reduced"] is True
    assert line["frame"] == [256, 192]
    assert line["scene"] == {"step": 112, "feature_scale": 1, "seed": 0,
                             "order": scenes.SCRAMBLE}
    for key in DEVICE_METRICS:
        assert line[key] is None, key
    assert line["setup"]["build_s"] is None
    # at a reduced size the headline is not comparable with bench.py's
    assert line["panorama_4img_384x512_e2e_ms"] is None
    assert line["vs_baseline"] is None
    checks = line["checks"]
    assert set(checks) == {"chain", "reprojection_parity_px",
                           "warm_equals_cold", "canvas_vs_cpu"}
    assert checks["chain"]["ok"] and len(checks["chain"]["edges"]) == 3
    parity = checks["reprojection_parity_px"]
    assert parity["value"] <= parity["limit"] == bench.MAX_REPROJECTION_PX
    assert parity["edges"] == [0, 1, 2]
    assert min(parity["pairs_per_model"]) > 0
    assert checks["canvas_vs_cpu"]["shape_diff"] == [0, 0]
    assert checks["canvas_vs_cpu"]["mad"] == 0.0
    assert checks["warm_equals_cold"]["ok"] is True
    assert line["panorama_ms"]["n"] == 1
    assert line["canvas"][0] >= 256 and line["canvas"][1] > 2 * 192
    # the stages and the spans' totals; every edge of this size blends
    # in float32 over the full canvas
    assert set(line["stage_ms"]) == {"features", "ordering", "stitching",
                                     "enhance", "stitch", "upload",
                                     "readback", "blend.f32"}
    kpts = line["sift_kpts_per_s"]
    assert kpts["live_keypoints"] > 100 and kpts["median"] > 0


def test_last_edge_parity(cpu_run):
    """The parity of the last edge alone (the 4K cell's) rebuilt on the
    CPU from the features recorded in the cold stitch: the same pairs as
    the whole plan's last edge, and a forward model moved by 0.5 px in
    the plan is caught."""
    _, lines, recs, _ = cpu_run
    whole = lines[0]["checks"]["reprojection_parity_px"]
    last = bench.plan_parity(recs[0], last_edge=True)
    assert last["ok"] and last["edges"] == [2]
    assert last["value"] <= bench.MAX_REPROJECTION_PX
    assert last["pairs_per_model"] == whole["pairs_per_model"][-2:]
    moved = dict(recs[0], plan=recs[0]["plan"].copy())
    moved["plan"][-1, 3] += 0.5  # the forward model's x translation
    assert not bench.plan_parity(moved, last_edge=True)["ok"]


def test_bench_cpu_catches_faults(cpu_run, monkeypatch, capsys):
    """Two faults planted in one CPU run of the headline cell: the plan's
    first forward model moved by 0.5 px after the card made it, and every
    edge after the cold stitch's three blended inverted. The parity, the
    timed run against the cold one and against the CPU's fail, the chain
    still holds; ``correct`` is false and the exit code 1. The same frames
    give the same features: they are replayed from the clean run, which
    saves SIFT's plain version its seconds."""
    sift = cpu_run[3]
    plan_fn, blend_fn = stm.plan_edges_with_rows, stm._composite_and_blend
    blends = []

    def plan(*a):
        out, rows = plan_fn(*a)
        out = out.copy()
        out[0, 3] += 0.5  # the forward model's x translation
        return out, rows

    def blend(*a):
        blends.append(a)
        out = blend_fn(*a)
        return out if len(blends) <= 3 else 255.0 - out

    monkeypatch.setattr(stm, "sift_extract_stats",
                        lambda gray, *a: sift[_digest(gray)])
    monkeypatch.setattr(stm, "plan_edges_with_rows", plan)
    monkeypatch.setattr(stm, "_composite_and_blend", blend)
    rc = bench.main(ARGV)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    checks = line["checks"]
    assert rc == 1 and line["correct"] is False
    assert checks["chain"]["ok"]
    parity = checks["reprojection_parity_px"]
    assert not parity["ok"] and parity["value"] > 0.1, parity
    assert not checks["warm_equals_cold"]["ok"]
    assert not checks["canvas_vs_cpu"]["ok"]
    assert checks["canvas_vs_cpu"]["mad"] > bench.MAX_MAD


def _build_files() -> dict:
    build = REPO / "build"
    return {str(p): p.stat().st_mtime_ns for p in build.rglob("*")} \
        if build.exists() else {}


def test_import_loads_no_jax_and_builds_nothing():
    """Importing ``bench_torch.py`` and ``tools/bench.py`` in a fresh
    interpreter loads no module of jax or of the JAX package, and leaves
    ``build/`` as it was."""
    before = _build_files()
    code = ("import sys, bench_torch\n"
            "import computervisionimagestich2_tpu_torch.tools.bench\n"
            "print('LOADED', sorted(m for m in sys.modules if m.split('.')[0]"
            " in ('jax', 'jaxlib', 'computervisionimagestich2_tpu')))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout
    assert _build_files() == before


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        bench.main(["--device", "cuda", "--cells", "pano4_512x384"])


@pytest.mark.parametrize("argv", [["--cells", "pano4_512x384,nope"],
                                  ["--runs", "0"], ["--frame", "256"]])
def test_bench_refuses_bad_arguments(argv):
    with pytest.raises(SystemExit):
        bench.main(["--device", "cpu", *argv])


def test_launch_check_holds_graph_launches_to_program_calls():
    """A traced run's graph launches against its program calls: a 4-frame
    panorama under ``DEFAULT_CONFIG`` makes 10 (frames, the ordering's
    counts, the plan, three edges, the tail), the chain slice 9 (no
    ordering program); a launch more or fewer fails the check; under
    ``disable_graphs()`` none is expected."""
    from computervisionimagestich2_tpu_torch import (DEFAULT_CONFIG,
                                                     SLICE_CONFIG)
    from computervisionimagestich2_tpu_torch.core import programs

    assert bench._stitch_calls(DEFAULT_CONFIG, 4, 3) == 10
    assert bench._stitch_calls(SLICE_CONFIG, 4, 3) == 9
    kernels = {"warp_image": {"counted_launches": 3, "device_launches": 3}}

    def traced(n):
        return {"kernels": kernels, "graph_launches": n}
    good = bench._launch_check((traced(10), 10), (traced(6), 6))
    assert good["ok"] and good["graph_launches"] == [[10, 10], [6, 6]]
    for n in (9, 11):
        assert not bench._launch_check((traced(n), 10))["ok"]
    with programs.disable_graphs():
        assert bench._launch_check((traced(0), 10))["ok"]
        assert not bench._launch_check((traced(10), 10))["ok"]


def test_idle_gaps():
    """Device busy 10-20 and 25-40 (one kernel inside another's span)
    and 45-50 in a window 0-60 us: gaps 0-10, 20-25, 40-45, 50-60; the
    longest first, each with the stage span and the host ops (outermost
    first) over its midpoint."""
    device = [(25, 40), (10, 20), (30, 35), (45, 50)]
    host = [(probes.CALL_SPAN, 0, 60), ("stage:features", 0, 30),
            ("stage:stitching", 30, 60), ("aten::copy_", 2, 8),
            ("cudaMemcpy", 3, 7), ("aten::item", 52, 58)]
    gaps = probes.idle_gaps(device, host, (0, 60), 3)
    assert gaps["count"] == 4 and gaps["total_ms"] == pytest.approx(0.030)
    assert [(g["start_ms"], g["ms"]) for g in gaps["longest"]] == [
        (0.0, 0.010), (0.050, 0.010), (0.020, 0.005)]
    assert [g["stage"] for g in gaps["longest"]] == [
        "features", "stitching", "features"]
    assert [g["host_ops"] for g in gaps["longest"]] == [
        ["aten::copy_", "cudaMemcpy"], ["aten::item"], []]


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summarize_a_trace():
    """The profile report from Chrome-trace events: the port's kernels by
    ``DEVICE_KERNELS``, copies and memsets counted as device work, spans
    and host ops not, the idle share against the wall."""
    events = [
        _x("user_annotation", probes.CALL_SPAN, 0, 100),
        _x("user_annotation", "stage:features", 0, 100),
        _x("gpu_user_annotation", "stage:features", 5, 90),
        _x("cpu_op", "aten::copy_", 0, 12),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 8, 2),
        _x("kernel", "void detect_octaves_kernel<4>(float const*)", 20, 10),
        _x("kernel", "void detect_octaves_kernel<4>(float const*)", 40, 6),
        _x("kernel", "(anonymous namespace)::descriptors_kernel()", 60, 4),
        _x("gpu_memset", "Memset (Device)", 70, 1),
        _x("cuda_runtime", "cudaLaunchKernel", 50, 6)]
    out = probes.summarize(events, wall=1e-4, gaps=2)
    assert out["device_busy_ms"] == pytest.approx(0.023)
    assert out["idle_share"] == pytest.approx(0.77)
    assert out["device_events"] == 5 and out["memcpy_htod_events"] == 1
    assert out["kernels"]["detect_compact"] == {
        "ms": pytest.approx(0.016), "device_launches": 2}
    assert out["kernels"]["sift_descriptors"]["device_launches"] == 1
    assert out["kernels"]["warp_image"] == {"ms": 0.0, "device_launches": 0}
    assert out["top"][0][0].startswith("void detect_octaves_kernel")
    longest = out["idle_gaps"]["longest"]
    assert [(g["start_ms"], g["ms"]) for g in longest] == [
        (0.071, pytest.approx(0.029)), (0.046, pytest.approx(0.014))]
    assert longest[1]["host_ops"] == ["cudaLaunchKernel"]
    assert longest[0]["stage"] == "features"
    assert out["idle_gaps"]["count"] == 6


def test_trace_of_a_cpu_profile():
    """A profile's Chrome trace as the profiler writes it: the call's
    span and its host ops are read back; no device work on the CPU."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(probes.CALL_SPAN):
            torch.ones(64).add_(1).sum()
    events = probes._trace(prof)
    out = probes.summarize(events, wall=1.0, gaps=1)
    assert out["device_events"] == 0 and out["device_busy_ms"] == 0.0
    assert any(e["name"] == "aten::sum" for e in events)
    assert out["idle_gaps"]["count"] == 1


def test_bench_spread_gives_the_bounds():
    """Two calls of one cell: each metric's medians, the spread inside a
    call (IQR over median) and across calls, and the bound, the larger
    rounded up to 5%, at least 5%."""
    from computervisionimagestich2_tpu_torch.tools import bench_spread

    def line(median, q1, q3, cold, peak):
        return {"cell": "c", "panorama_ms": {"median": median, "q1": q1,
                                             "q3": q3},
                "cold_ms": cold, "peak_mem_gib": peak,
                "sift_kpts_per_s": None}

    out = bench_spread.spread([[line(400.0, 380.0, 440.0, 1500.0, 0.15)],
                               [line(440.0, 430.0, 450.0, 1200.0, 0.15)]])
    pano = out["c"]["panorama_ms"]
    assert pano["medians"] == [400.0, 440.0]
    assert pano["inner_spread"] == pytest.approx([0.15, 20 / 440])
    assert pano["across_calls"] == pytest.approx(0.10)
    assert pano["bound"] == pytest.approx(0.15)
    assert out["c"]["cold_ms"]["bound"] == pytest.approx(0.25)
    assert out["c"]["peak_mem_gib"]["bound"] == 0.05
    assert "sift_kpts_per_s" not in out["c"] and "batch_ms" not in out["c"]
