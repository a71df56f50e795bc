"""The 18-frame dataset2 cell: it loads through the registry, its frame set
is the seed's scene in scene order, and its new readers read the spans
the program gives and nothing where the program gives none."""
from __future__ import annotations

import numpy as np
import pytest

from harness import registry, scenes, trace, traffic

NEW = ("host_ms.ordering", "device_busy_ms.ordering",
       "overflow_host_ms.single", "blend_band_device_ms.single",
       "blend_full_device_ms.single")


def ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": args}


def read(name, run):
    return registry.reader("metrics", name).read(run)


def test_the_cell_loads_and_makes_its_frames():
    cell = registry.cell("dataset2_repeat")
    assert cell.chips == 1 and cell.config["name"] == "dataset2_18x800x600"
    assert cell.traffic["entry"] == "stitch"
    assert cell.traffic["order"] == "chain"
    assert {m["name"] for m in cell.per_layer} >= set(NEW)
    assert "panorama_ms" in {m["name"] for m in cell.end_to_end}
    seed = 2 ** 31 + 21
    (frames,) = traffic.frame_sets(cell.config["frames"], cell.traffic, seed)
    assert frames.shape == (18, 800, 600, 3) and frames.dtype == np.uint8
    assert np.array_equal(frames, np.stack(scenes.crops(800, 600, 350, 2,
                                                        seed, 18)))


def test_the_new_readers_on_a_trace_with_their_spans():
    """Two panoramas: the ordering stage (device 10-60 inside it), one
    band edge whose graph launch at 110 runs its nodes at 300-400 and
    380-450, after its span closed, one full-canvas float32 edge, and a
    kernel launched outside every blend span."""
    events = [
        ev(trace.WINDOW_SPAN, "user_annotation", 0, 1000),
        ev("stage:ordering", "user_annotation", 0, 90),
        ev("pair_tile_kernel", "kernel", 10, 50, correlation=1),
        ev("blend:band", "user_annotation", 100, 50),
        ev("cudaGraphLaunch", "cuda_runtime", 110, 20, correlation=7),
        ev("cudaLaunchKernel", "cuda_runtime", 200, 5, correlation=8),
        ev("blend:f32", "user_annotation", 600, 50),
        ev("cudaLaunchKernel", "cuda_runtime", 610, 5, correlation=9),
        ev("blur", "kernel", 300, 100, correlation=7),
        ev("resize", "kernel", 380, 70, correlation=7),
        ev("other", "kernel", 500, 50, correlation=8),
        ev("Memcpy DtoD", "gpu_memcpy", 700, 20, correlation=9),
    ]
    run = {"view": trace.View(events, panoramas=2),
           "stage_ms": {"ordering": 12.5, "overflow": 3.25},
           "graph_memory": None, "records": [], "sets": []}
    assert read("host_ms.ordering", run) == 12.5
    assert read("overflow_host_ms.single", run) == 3.25
    assert read("device_busy_ms.ordering", run) == pytest.approx(0.025)
    assert read("blend_band_device_ms.single", run) == pytest.approx(0.075)
    assert read("blend_full_device_ms.single", run) == pytest.approx(0.010)


@pytest.mark.parametrize("name", NEW)
def test_a_new_reader_without_its_span_returns_none(name):
    """A program without the spans (the parent of the change that adds
    them), or a stitch with no edge overflowed: nothing to read."""
    quiet = trace.View([ev(trace.WINDOW_SPAN, "user_annotation", 0, 10),
                        ev("stitch", "user_annotation", 0, 10),
                        ev("k", "kernel", 0, 5, correlation=1)],
                       panoramas=1)
    run = {"view": quiet, "stage_ms": {"features": 3.0},
           "graph_memory": None, "records": [], "sets": []}
    assert read(name, run) is None
