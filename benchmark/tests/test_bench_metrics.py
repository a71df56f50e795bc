"""Each per-layer metric's arithmetic on a small canned trace, and the end-
to-end metrics' on canned timings."""
from __future__ import annotations

import pytest
import torch

from harness import peaks, registry, trace, work


def ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


# a window of 1000 us holding two panoramas: device work 0-100, 150-260
# (overlapping 220-270), 600-700; two graph launches of 40
# and 60 us on the host; one DtoH copy of 30 us
EVENTS = [
    ev(trace.WINDOW_SPAN, "user_annotation", 0, 1000),
    ev("pair_tile_kernel", "kernel", 0, 100),
    ev("l1_bidir_tile_kernel", "kernel", 150, 110),
    ev("l1_bidir_merge_kernel", "kernel", 220, 50),
    ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 600, 30),
    ev("elementwise", "kernel", 630, 70),
    ev("cudaGraphLaunch", "cuda_runtime", 300, 40),
    ev("cudaGraphLaunch", "cuda_runtime", 700, 60),
    ev("aten::copy_", "cpu_op", 800, 150),
]


@pytest.fixture
def view():
    return trace.View(EVENTS, panoramas=2)


def test_view_busy_window_and_breakdown(view):
    assert view.window_s() == pytest.approx(1000e-6)
    # union: 0-100, 150-270, 600-700
    assert view.busy_s() == pytest.approx(320e-6)
    top = view.top_device_ops(2)
    assert top[0] == ["l1_bidir_tile_kernel", pytest.approx(110e-6)]
    gaps = view.idle_gaps(3)
    # the gaps: 100-150, 270-600, 700-1000 (host in aten::copy_ at 850)
    assert [g[1] for g in gaps] == pytest.approx([330e-6, 300e-6, 50e-6])
    assert gaps[1][0] == "aten::copy_"


def run_of(view, live=(1000, 800, 900, 700), edges=((0, 1, 0), (1, 2, 1))):
    feats = [[None, None, None, torch.ones(n, dtype=torch.bool)]
             for n in live]
    rec = {"features": feats, "edges": list(edges)}
    return {"view": view, "stage_ms": {"features": 3.0, "stitching": 4.0},
            "graph_memory": {"graph_pools_reserved_gib": 0.5},
            "records": [([0], [rec])], "sets": []}


def read(name, run):
    return registry.reader("metrics", name).read(run)


def test_trace_metrics(view):
    run = run_of(view)
    assert read("graph_launch_host_ms.single", run) == pytest.approx(0.05)
    assert read("graph_launch_host_ms.batch", run) == pytest.approx(0.05)
    assert read("idle_share.single", run) == pytest.approx(68.0)
    assert read("idle_share.batch", run) == pytest.approx(68.0)
    assert read("readback_ms", run) == pytest.approx(0.015)
    assert read("graph_pool_gib", run) == 0.5
    assert read("host_ms.features", run) == 3.0
    assert read("host_ms.stitching", run) == 4.0


def test_rooflines(view):
    run = run_of(view)
    live = [1000, 800, 900, 700]
    cap = 1024
    b5 = work.pair_counts(live, cap)
    ops = sum(work.L1_OPS_PER_PAIR * live[i] * live[j]
              for i in range(4) for j in range(i + 1, 4))
    assert b5 == pytest.approx(ops / peaks.OPS_PER_S)
    # B5 ran 100 us over two panoramas
    assert read("pair_match_counts_roofline", run) == pytest.approx(
        b5 / 50e-6 * 100)
    b4 = work.l1_bidir(1000, 800, cap, cap) + work.l1_bidir(800, 900, cap,
                                                           cap)
    assert read("l1_two_nearest_bidir_roofline", run) == pytest.approx(
        b4 / 80e-6 * 100)


def test_a_reader_with_nothing_to_read_returns_none():
    quiet = trace.View([ev(trace.WINDOW_SPAN, "user_annotation", 0, 10),
                        ev("k", "kernel", 0, 5)], panoramas=1)
    run = run_of(quiet)
    for name in ("pair_match_counts_roofline",
                 "l1_two_nearest_bidir_roofline", "readback_ms"):
        assert read(name, run) is None
    assert read("graph_pool_gib", dict(run, graph_memory=None)) is None
    assert read("host_ms.features", dict(run, stage_ms={})) is None


def test_end_to_end_arithmetic():
    timing = {"setup_s": 12.5, "window_s": 10.0, "panoramas": 200,
              "durations": [0.04] * 9 + [0.14], "per_call": 1}
    e2e = {n: registry.reader("end_to_end", n).read(timing, 2 ** 31)
           for n in ("setup_s", "panorama_ms", "panorama_p90_ms",
                     "panoramas_per_s", "device_mem_gib")}
    assert e2e == pytest.approx({"setup_s": 12.5, "panorama_ms": 50.0,
                                 "panorama_p90_ms": 50.0,
                                 "panoramas_per_s": 20.0,
                                 "device_mem_gib": 2.0})
