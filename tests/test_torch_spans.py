"""The port's spans (``utils/obs.py::span``): their totals per call in a
``StageTimer``, the programs' capture, replay, launch and overflow spans
on a stand-in for CUDA graphs, their annotations in a CPU
``torch.profiler`` trace (and none entered without a profiler), and the
benchmark's six readers of them (``benchmark/metrics/``) on a canned
trace.
"""
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from computervisionimagestich2_tpu_torch import SLICE_CONFIG
from computervisionimagestich2_tpu_torch.core import programs
from computervisionimagestich2_tpu_torch.core.types import Features
from computervisionimagestich2_tpu_torch.models import stitcher as tstm
from computervisionimagestich2_tpu_torch.parallel import batched
from computervisionimagestich2_tpu_torch.utils import obs

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))
from harness import registry, trace  # noqa: E402


def _annotations(prof) -> list:
    """The ``user_annotation`` events of a profile's Chrome trace."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return [e for e in json.load(f)["traceEvents"]
                    if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"]
    finally:
        os.unlink(path)


def _inside(inner: dict, outer: dict) -> bool:
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


# ------------------------------------------------------------ the recorder
def test_spans_sum_per_call_and_reset_when_a_call_opens():
    """Spans of one name add up in the open call, nested or not; a stage
    keeps its key without the prefix; a new call starts from nothing;
    with no call open a span totals nothing and a stage keeps its own
    seconds."""
    timer = obs.StageTimer()
    with timer.call("root") as root:
        with obs.span("a") as a1:
            with obs.span("a", "inner") as a2:
                pass
        with timer.stage("s") as s:
            with obs.span("b") as b:
                pass
    assert set(timer.times) == {"root", "a", "s", "b"}
    assert timer.times["a"] == pytest.approx(a1.seconds + a2.seconds)
    assert timer.times["s"] == s.seconds and timer.times["b"] == b.seconds
    assert timer.times["root"] == root.seconds >= s.seconds
    assert s.name == obs.STAGE_SPAN + "s"
    first = timer.times
    with timer.call("root"):
        with obs.span("c"):
            pass
    assert set(timer.times) == {"root", "c"}
    assert set(first) == {"root", "a", "s", "b"}  # the last call's, kept
    with obs.span("d"):  # no call open
        pass
    with timer.stage("s"):
        pass
    assert set(timer.times) == {"root", "c", "s"}


@pytest.fixture
def fake_graphs(monkeypatch):
    """Programs on CPU tensors take the graph path, on the stand-in of
    tests/test_torch_programs.py."""
    from test_torch_programs import _FakeGraphs
    monkeypatch.setattr(programs, "_BACKEND", _FakeGraphs)
    monkeypatch.setattr(programs, "_graphable", lambda device: True)
    made = []

    def make(fn, name):
        p = programs.Program(fn, name)
        made.append(p)
        return p
    yield make
    for p in made:
        programs._PROGRAMS.remove(p)
    programs.clear_graphs()  # the stand-in's graphs of the port's programs


def test_programs_record_capture_replay_launch_and_overflow(fake_graphs):
    """A key's first call records a capture (then replays it), a later
    call a replay with the launch inside it, and a key that finds the
    scope's graphs all used an overflow; the capture's total is the
    graph's own seconds."""
    prog = fake_graphs(lambda x, k: x * k, "spanned")
    prog.max_graphs = 1
    x = torch.ones(2)
    timer = obs.StageTimer()
    with programs.scope():
        with timer.call("call"):
            prog(x, 1)
        assert {"capture", "replay", "launch"} <= set(timer.times)
        assert timer.times["capture"] == pytest.approx(
            prog.graphs[prog.key(x, 1)[0]].seconds)
        with timer.call("call"):
            prog(x, 1)
        assert set(timer.times) == {"call", "replay", "launch"}
        assert timer.times["launch"] <= timer.times["replay"]
        with timer.call("call"):
            np.testing.assert_array_equal(prog(x, 2).numpy(), [2, 2])
        assert set(timer.times) == {"call", "overflow"}
    assert prog.overflows == 1 and prog.captures == 1


def test_annotations_nest_in_the_trace(fake_graphs, monkeypatch):
    """Under a CPU profiler a stitch's spans are ``user_annotation``
    events: one ``upload`` a frame, each inside ``stage:features`` inside
    ``stitch``, the enhance tail's replay and the readback inside
    ``stage:enhance``; a program's spans carry its name, ``launch:<name>``
    inside ``replay:<name>``. The features program and the edges are stubbed:
    the spans, not the stitch, are under test."""
    def features(image, cfg):
        proj = image.float()
        cap = 8
        feats = Features(torch.zeros(cap, 128), torch.zeros(cap, 2),
                         torch.zeros(cap), torch.zeros(cap, dtype=torch.bool))
        return feats, proj, torch.zeros(4, dtype=torch.int32)

    monkeypatch.setattr(batched, "_project_and_extract_one", features)
    st = tstm.Stitcher(SLICE_CONFIG, device="cpu")
    monkeypatch.setattr(st, "_stitch_planned", lambda result, *a: result)
    images = [np.full((24, 32, 3), 40 * i, np.uint8) for i in range(3)]
    prog = fake_graphs(lambda x: x + 1, "inc")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = st.stitch(images)
        prog(torch.ones(2)), prog(torch.ones(2))
    assert out.shape == (24, 32, 3)
    notes = _annotations(prof)

    def one(name):
        hits = [e for e in notes if e["name"] == name]
        assert len(hits) == 1, (name, [e["name"] for e in notes])
        return hits[0]
    uploads = [e for e in notes if e["name"] == "upload"]
    assert len(uploads) == len(images)
    assert all(_inside(u, one("stage:features")) for u in uploads)
    assert _inside(one("stage:features"), one("stitch"))
    assert _inside(one("readback"), one("stage:enhance"))
    assert _inside(one("replay:equalize_and_mix"), one("stage:enhance"))
    assert _inside(one("stage:enhance"), one("stitch"))
    assert set(st.stage_times) == {"stitch", "features", "upload",
                                   "ordering", "stitching", "enhance",
                                   "readback", "capture", "replay",
                                   "launch"}
    one("capture:inc")
    replays = [e for e in notes if e["name"] == "replay:inc"]
    launches = [e for e in notes if e["name"] == "launch:inc"]
    assert len(replays) == len(launches) == 2
    assert all(_inside(a, r) for a, r in zip(launches, replays))


def test_no_profiler_enters_no_record_function(fake_graphs, monkeypatch):
    """With no profiler recording, a span, a stage, a call and a
    program's capture and replays never enter ``record_function``; under
    a profiler the same patched entry is reached."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(obs, "record_function", refuse)
    prog = fake_graphs(lambda x: x * 2, "quiet")
    timer = obs.StageTimer()
    with timer.call("call"), timer.stage("s"), obs.span("a", "b"):
        prog(torch.ones(2)), prog(torch.ones(2))
    assert {"call", "s", "a", "capture", "replay", "launch"} <= set(
        timer.times)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="record_function"):
            with obs.span("a"):
                pass


# ------------------------------------------------------------- the readers
def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "args": {}}


def _view(root="stitch", stages=True, panoramas=2):
    """A window of 1000 us holding two panoramas: a ``root`` span over
    0-900, the features stage 10-400 and the stitching stage 450-800
    (with ``stages``), device work 0-50, 100-200, 150-250, 500-600 and
    850-950, a capture and an overflow inside the root span and one
    capture outside the window."""
    events = [ev(trace.WINDOW_SPAN, "user_annotation", 0, 1000),
              ev(root, "user_annotation", 0, 900),
              ev("capture:plan", "user_annotation", 20, 5),
              ev("overflow:composite_and_blend", "user_annotation", 500, 5),
              ev("capture:plan", "user_annotation", 1200, 5),
              ev("k", "kernel", 0, 50), ev("k", "kernel", 100, 100),
              ev("Memcpy HtoD", "gpu_memcpy", 150, 100),
              ev("k", "kernel", 500, 100), ev("k", "kernel", 850, 100)]
    if stages:
        events += [ev("stage:features", "user_annotation", 10, 390),
                   ev("stage:stitching", "user_annotation", 450, 350)]
    return trace.View(events, panoramas=panoramas)


def read(name, run):
    return registry.reader("metrics", name).read(run)


def test_the_readers_of_the_spans():
    """Each reader's arithmetic on the canned window, and None wherever
    its spans or totals are absent (a program without them)."""
    run = {"view": _view(), "stage_ms": {"launch": 1.5, "upload": 0.25}}
    assert read("launch_host_ms.single", run) == 1.5
    assert read("upload_host_ms", run) == 0.25
    # features: 10-50 and the union 100-250, over two panoramas
    assert read("device_busy_ms.features", run) == pytest.approx(0.095)
    # stitching: 500-600; 850-950 lies past the stage
    assert read("device_busy_ms.stitching", run) == pytest.approx(0.05)
    assert read("graph_misses.single", run) == pytest.approx(1.0)
    assert read("graph_misses.batch", run) is None
    batch = {"view": _view(root="batch_chain", stages=False),
             "stage_ms": {}}
    assert read("graph_misses.batch", batch) == pytest.approx(1.0)
    assert read("graph_misses.single", batch) is None
    bare = {"view": _view(root="other", stages=False), "stage_ms": {}}
    for name in ("launch_host_ms.single", "upload_host_ms",
                 "device_busy_ms.features", "device_busy_ms.stitching",
                 "graph_misses.single", "graph_misses.batch"):
        assert read(name, bare) is None, name
    empty = {"view": _view(panoramas=0), "stage_ms": {}}
    assert read("device_busy_ms.features", empty) is None
    assert read("graph_misses.single", empty) is None
