"""What ``chip_smoke.py`` and the bench (``tools/bench.py``) both read off
a stitch: the ordering graph discovery found, the canvas against the
port's CPU run, the last edge's composite + blend again on the CPU, and
one call under ``torch.profiler`` (device time per kernel, busy and idle
share, the CUDA graph replays and what ran in them, the longest idle gaps
with the host work that ran through them).
"""
from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np
import torch

from ..ops import _native
from ..utils import obs
from .scenes import SCRAMBLE

CSRC = "computervisionimagestich2_tpu_torch/csrc/"
TPU_OPS = "computervisionimagestich2_tpu/ops/"
# launch counter -> (id, route, source, replaced Pallas call site)
KERNELS = {
    "detect_compact": (
        "B1", "cuda", CSRC + "detect.cu", TPU_OPS + "pallas_detect.py:168"),
    "sift_orientation_hist": (
        "B2", "cuda", CSRC + "sift_walks.cu", TPU_OPS + "pallas_sift.py:491"),
    "sift_descriptors": (
        "B3", "cuda", CSRC + "sift_walks.cu", TPU_OPS + "pallas_sift.py:356"),
    "l1_two_nearest_bidir": (
        "B4", "cuda", CSRC + "l1_2nn.cu", TPU_OPS + "pallas_distance.py:209"),
    "pair_match_counts": (
        "B5", "cuda", CSRC + "pair_counts.cu",
        TPU_OPS + "pallas_distance.py:431"),
    "warp_image": (
        "B6", "cuda", CSRC + "warp.cu", TPU_OPS + "pallas_warp.py:237"),
    "warp_image_projective": (
        "B6", "cuda", CSRC + "warp.cu", TPU_OPS + "pallas_warp.py:237"),
    "l1_two_nearest": (
        "B7", "cuda", CSRC + "l1_2nn.cu", TPU_OPS + "pallas_distance.py:283"),
    "separable_blur": (
        "B8", "cuda", CSRC + "blur.cu",
        "none: XLA's shift-and-add, " + TPU_OPS + "gaussian.py:50"),
}
# the device kernels each wrapper launches (substrings of their names;
# B6's cover both of its entries, ``warp_bilinear_kernel`` and
# ``warp_bilinear_kernel_dev``, one kernel a launch either way)
DEVICE_KERNELS = {
    "detect_compact": ("detect_octaves_kernel",),
    "sift_orientation_hist": ("orientation_hist_kernel",),
    "sift_descriptors": ("descriptors_kernel",),
    "l1_two_nearest_bidir": ("l1_bidir_tile_kernel", "l1_bidir_merge_kernel"),
    "pair_match_counts": ("pair_plan_kernel", "pair_tile_kernel",
                          "pair_count_kernel"),
    "warp_image": ("warp_bilinear_kernel",),
    "warp_image_projective": ("warp_projective_kernel",),
    "l1_two_nearest": ("l1_one_way_tile_kernel", "l1_one_way_merge_kernel"),
    "separable_blur": ("separable_blur_kernel",),
}
# B6's launch counter for each warp model; a stitch runs one of the two
B6_BRANCH = {"bilinear": "warp_image", "projective": "warp_image_projective"}
# Chrome-trace categories of the device's work and of the host's
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
CALL_SPAN = "profile_call"  # the span around the profiled call
# the spin kernels (``torch.cuda._sleep``) that open a profiled session
LEAD_KERNELS = 2000
LEAD_KERNEL = "spin_kernel"
LEAD_TRIES = 3  # sessions that may lose all of them before a call raises
STAGE_SPAN = obs.STAGE_SPAN  # prefix of the spans of the stitcher's stages


def off_branch(model: str) -> set:
    """B6's counter of the warp model a path does not run."""
    return {v for k, v in B6_BRANCH.items() if k != model}


def record_ordering(stitcher) -> dict:
    """Keep the adjacency and start image that graph discovery finds."""
    seen = {}
    graph, middle = stitcher._match_graph, stitcher._middle_index

    def match_graph(*args):
        adj = graph(*args)
        seen["adj"] = [row[:] for row in adj]  # bfs_edge_seq consumes adj
        return adj

    def middle_index(adj):
        seen["start"] = middle(adj)
        return seen["start"]

    stitcher._match_graph, stitcher._middle_index = match_graph, middle_index
    return seen


def graph_edges(seen: dict) -> list:
    """The undirected edges of the adjacency graph discovery found."""
    adj = seen["adj"]
    return [list(e) for e in sorted({tuple(sorted((i, j)))
                                     for i, row in enumerate(adj)
                                     for j, a in enumerate(row) if a})]


def is_chain(edges: list) -> bool:
    """Three edges, each between crops that neighbour in the scene."""
    return len(edges) == 3 and all(abs(SCRAMBLE[i] - SCRAMBLE[j]) == 1
                                   for i, j in edges)


def check_chain(seen: dict) -> list:
    """Graph discovery on the scrambled crops must find the scene's chain:
    three edges, each between crops that neighbour in the scene."""
    edges = graph_edges(seen)
    assert is_chain(edges), edges
    return edges


def canvas_diff(out, ref) -> tuple[list, float]:
    """(|shape difference| in rows and columns, mean |diff| in u8 levels
    over the common canvas) of two u8 canvases."""
    h = min(out.shape[0], ref.shape[0])
    w = min(out.shape[1], ref.shape[1])
    mad = float(np.abs(out[:h, :w].astype(np.int64)
                       - ref[:h, :w].astype(np.int64)).mean())
    return [abs(out.shape[0] - ref.shape[0]),
            abs(out.shape[1] - ref.shape[1])], mad


def canvas_vs_cpu(out, out_cpu) -> float:
    """Shape within +-3 px and MAD <= 3 u8 levels over the common canvas
    (the end-to-end gate of tests/test_torch_stitch.py)."""
    shape_diff, mad = canvas_diff(out, out_cpu)
    assert max(shape_diff) <= 3, (out.shape, out_cpu.shape)
    assert mad <= 3.0, mad
    return mad


def u8(t) -> np.ndarray:
    """A u8-valued float canvas (a tensor on any device) as u8 numpy."""
    return t.cpu().numpy().astype(np.uint8)


def last_edge_vs_cpu(st, images) -> dict:
    """The last edge's composite + blend (warp, gain, blend, u8
    truncation: ``stitcher._composite_and_blend``) of a warm run on the
    card, again on the CPU (the plain versions) on the same arguments: the
    canvases' shape difference and MAD (``canvas_diff``)."""
    from ..models import stitcher as stm

    last, fn = {}, stm._composite_and_blend

    def rec(*a):
        out = fn(*a)
        last.update(args=a, out=out)
        return out

    stm._composite_and_blend = rec
    try:
        st.stitch(images)
    finally:
        stm._composite_and_blend = fn
    args = tuple(x.cpu() if isinstance(x, torch.Tensor) else x
                 for x in last["args"])
    t = time.perf_counter()
    out_cpu = fn(*args)
    secs = time.perf_counter() - t
    card = u8(last["out"])
    shape_diff, mad = canvas_diff(card, u8(out_cpu))
    return {"edge_canvas": list(card.shape), "comp_hw": list(args[4]),
            "cpu_s": secs, "shape_diff": shape_diff, "mad_vs_cpu": mad}


def dev_us(e) -> float:
    """Device time (us) of one ``torch.profiler`` key_averages entry."""
    return (getattr(e, "self_device_time_total", 0)
            or getattr(e, "self_cuda_time_total", 0))


def device_events(prof) -> list:
    return [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]


def idle_gaps(device: list, host: list, window: tuple, n: int) -> dict:
    """The ``n`` longest stretches of ``window`` (start, end) in which no
    interval of ``device`` [(start, end)] runs, longest first, each with
    its start from the window's start and its length (ms), the stage span
    (``STAGE_SPAN`` + name among ``host`` [(name, start, end)]) and the
    host ops (outermost first) that cover its midpoint; and the number and
    sum of all the gaps. Times in microseconds in, milliseconds out."""
    w0, w1 = window
    gaps, at = [], w0
    for s, e in sorted(device):
        if s > at:
            gaps.append((at, min(s, w1)))
        at = max(at, e)
        if at >= w1:
            break
    if at < w1:
        gaps.append((at, w1))
    gaps = [(s, e) for s, e in gaps if e > s]
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        mid = (s + e) / 2
        cover = sorted(((hs, -(he - hs), name) for name, hs, he in host
                        if hs <= mid <= he and name != CALL_SPAN),
                       key=lambda c: c[:2])
        stages = [c[2][len(STAGE_SPAN):] for c in cover
                  if c[2].startswith(STAGE_SPAN)]
        out.append({"start_ms": (s - w0) / 1e3, "ms": (e - s) / 1e3,
                    "stage": stages[-1] if stages else None,
                    "host_ops": [c[2] for c in cover
                                 if not c[2].startswith(STAGE_SPAN)]})
    return {"longest": out, "count": len(gaps),
            "total_ms": sum(e - s for s, e in gaps) / 1e3}


def _trace(prof) -> list:
    """The complete events of a profile as its Chrome trace lists them,
    written by the profiler's own exporter: an order of magnitude quicker
    than building torch's event objects for a stitch's ~10^5 events."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return [e for e in json.load(f)["traceEvents"]
                    if e.get("ph") == "X"]


def _lead_kernels() -> int:
    """The spin kernels that open a profiled session: none off a card."""
    import torch

    return LEAD_KERNELS if torch.cuda.is_available() else 0


def profile_call(fn, off, gaps: int = 0) -> dict:
    """One warm call of ``fn`` (which synchronises the card) under
    ``torch.profiler``: device time and launches per kernel of the port
    (by ``DEVICE_KERNELS``; every one not in ``off`` must have run) beside
    the launches its wrapper's counter recorded in the same call
    (``counted_launches``; a graph replay adds its graph's), all device
    kernels and the host-to-device copies among them (the ``top`` device
    operations by time), the device's busy time (kernels, copies and
    memsets) against the wall; with ``gaps``, that many of the longest
    idle gaps (``idle_gaps``).

    In a long-lived process the profiler loses the first device records
    of a session, more the older the process (on an H100: 0 to 19 of 200
    kernels over four minutes, and a whole window's once). So on a card the
    session opens with ``LEAD_KERNELS`` spin kernels of its own, left out
    of the report: while one of them is kept, nothing of the call was
    lost. The call is traced again, up to ``LEAD_TRIES`` times, until one is
    kept (``profiler_lead_kept``), else this raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    lead = _lead_kernels()
    for _ in range(LEAD_TRIES):
        before = _native.launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                torch.cuda._sleep(1)
            if lead:
                torch.cuda.synchronize()
            t = time.perf_counter()
            with record_function(CALL_SPAN):
                fn()
            wall = time.perf_counter() - t
        after = _native.launch_counts()
        events = _trace(prof)
        kept = sum(1 for e in events if e.get("cat") in DEVICE_CATS
                   and LEAD_KERNEL in e["name"])
        if kept or not lead:
            break
    else:
        raise RuntimeError(f"the profiler lost all {lead} lead kernels of "
                           f"{LEAD_TRIES} sessions: the call's trace may be "
                           "cut")
    out = summarize([e for e in events if LEAD_KERNEL not in e["name"]],
                    wall, gaps)
    out["profiler_lead_kept"] = kept if lead else None
    for name, k in out["kernels"].items():
        k["counted_launches"] = after[name] - before[name]
    assert out["device_busy_ms"] > 0 and all(
        k["ms"] > 0 for n, k in out["kernels"].items() if n not in off), out
    return out


def launches_vs_trace(kernels: dict) -> dict:
    """The kernels of a ``profile_call`` report whose counted launches
    disagree with the trace: each wrapper's launch runs one device kernel
    of each of its ``DEVICE_KERNELS`` (B4 and B7 a tile and a merge pass,
    B5 its plan, tile and count kernels once per chunk of pairs, one
    chunk on a stitch's few frames), so the trace must hold that many per
    counted launch. Empty when every counter matches what ran."""
    return {name: {"counted_launches": k["counted_launches"],
                   "device_launches": k["device_launches"],
                   "device_kernels_per_launch": len(DEVICE_KERNELS[name])}
            for name, k in kernels.items()
            if k["device_launches"]
            != k["counted_launches"] * len(DEVICE_KERNELS[name])}


def graph_replays(events: list, dev: list) -> dict:
    """The CUDA graph replays of a trace: the host's graph launches, the
    device events that carry a launch's correlation id (the graph's nodes,
    as the trace lists them), the host-to-device copies that ran inside a
    replay, by correlation or between a replay's first and last node, and
    per launch in trace order its host time (ms) beside its device events
    (``graph_launch_host_ms``: how the launch's cost grows with its
    nodes)."""
    launches = sorted((e for e in events if e.get("cat") in HOST_CATS
                       and "GraphLaunch" in e["name"]),
                      key=lambda e: e["ts"])
    corr = {e.get("args", {}).get("correlation") for e in launches} - {None}
    windows: dict = {}
    nodes: dict = {}
    for e in dev:
        c = e.get("args", {}).get("correlation")
        if c in corr:
            lo, hi = windows.get(c, (e["ts"], e["ts"] + e["dur"]))
            windows[c] = (min(lo, e["ts"]), max(hi, e["ts"] + e["dur"]))
            nodes[c] = nodes.get(c, 0) + 1
    htod = [e for e in dev if "HtoD" in e["name"]]
    inside = [e for e in htod
              if e.get("args", {}).get("correlation") in corr
              or any(lo <= e["ts"] < hi for lo, hi in windows.values())]
    return {"graph_launches": len(launches),
            "graph_device_events": sum(nodes.values()),
            "memcpy_htod_in_replays": len(inside),
            "graph_launch_host_ms": [
                [e["dur"] / 1e3,
                 nodes.get(e.get("args", {}).get("correlation"), 0)]
                for e in launches]}


def summarize(events: list, wall: float, gaps: int = 0) -> dict:
    """``profile_call``'s report from the complete events of a Chrome
    trace (``ts`` and ``dur`` in microseconds) and the call's wall time
    (s)."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    by_name: dict[str, list] = {}
    for e in dev:
        s = by_name.setdefault(e["name"], [0.0, 0])
        s[0] += e["dur"]
        s[1] += 1
    busy_ms = sum(s[0] for s in by_name.values()) / 1e3
    per = {}
    for name, subs in DEVICE_KERNELS.items():
        hits = [s for k, s in by_name.items() if any(x in k for x in subs)]
        per[name] = {"ms": sum(s[0] for s in hits) / 1e3,
                     "device_launches": sum(s[1] for s in hits)}
    out = {"wall_s": wall, "device_busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / 1e3 / wall if busy_ms else None,
           "device_events": len(dev),
           "memcpy_htod_events": sum(s[1] for k, s in by_name.items()
                                     if "HtoD" in k),
           **graph_replays(events, dev),
           "top": sorted(((k[:200], s[0] / 1e3, s[1])
                          for k, s in by_name.items()),
                         key=lambda x: -x[1])[:12],
           "kernels": per}
    if gaps:
        call = next(e for e in events if e["name"] == CALL_SPAN
                    and e.get("cat") == "user_annotation")
        host = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("cat") in HOST_CATS]
        out["idle_gaps"] = idle_gaps(
            [(e["ts"], e["ts"] + e["dur"]) for e in dev], host,
            (call["ts"], call["ts"] + call["dur"]), gaps)
    return out
