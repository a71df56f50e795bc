"""The port's benchmark: BASELINE configs 2-4 on one NVIDIA GPU, one JSON
line per cell.

    python3 bench_torch.py [--cells a,b] [--seed S] [--runs N]
                           [--device cuda|cpu] [--frame HxW] [--eager]

Every cell runs on one card, as a closed loop of one caller: the next
panorama starts when the last has returned to the host. The frames are the
seeded synthetic scenes of ``tools/scenes.py`` (no reference dataset is on
the machines the port runs on); the program receives only the u8 frames.

Cells (``CELLS``):

- ``pano4_512x384``: ``DEFAULT_CONFIG``, ``Stitcher.stitch`` on four
  512x384 crops handed over scrambled: the reference's own use, four
  photos of its ``Input/`` size in any order (``bench.py``'s headline,
  BASELINE config 2). Every layer; launch-bound.
- ``pano4_1440x1080``: the same at 1440x1080, BASELINE's north star
  (``scripts/bench_northstar.py``): 7.9x the pixels, and the last canvas
  above both blend gates.
- ``batch2x4_512x384``: BASELINE config 3, ``batched_stitch_chain`` on two
  panoramas of four chain-ordered crops on the default fixed canvas; beside
  it ``batched_pairwise_register`` on the batch's neighbouring pairs
  (``scripts/bench_configs.py:94-106``), the measured path of kernel B7.
  Bypasses graph ordering (B5) and enhancement.
- ``pano4_4k_gain``: BASELINE config 4 (``scenes.config4``: gain
  compensation) on four scrambled 3840x2160 crops: B5 on ~10.5k slots,
  bf16 and the seam band with rgb gain. The most device-heavy cell.

Each line holds, end to end: ``cold_ms`` (the first stitch of the cell in
the process: caches and lazy set-up; the kernels are built before the
first cell, ``setup.build_s``), the warm wall ``panorama_ms`` (u8 frames
in, u8 panorama on the host; ``batch_ms`` for a batch) as median, p90,
quartiles, extremes and sample count, ``peak_mem_gib`` over the warm runs
and ``sift_kpts_per_s`` (live keypoints over the ``features`` stage). Per
layer: the stage times (median of the warm runs), each kernel's launches
in one warm run, and one run under ``torch.profiler`` apart from the timed
ones (``profile``: device busy ms and idle share, device events, host-to-
device copies, device ms and launches per kernel, the ten device
operations that took the most time and the five longest idle gaps with
the stage and host ops that ran through each). ``checks`` holds each
correctness number beside its limit, ``correct`` their conjunction. Every
timed run must give the cold run's output bit for bit, and the last timed
run is held against the port's CPU run on the same frames: for a
panorama, the scene's chain found; the last timed panorama against the
CPU's (``MAX_SHAPE_DIFF``, ``MAX_MAD``), or at 4K, where the whole CPU
run takes minutes, the last edge's composite + blend of one more run on
the CPU (``MAX_LAST_EDGE_MAD``); the cold run's edge plan against the
CPU's on the same features (at 4K its last edge alone), as the largest
difference of their models' reprojection errors
(``models/ransac.py::reprojection_errors``) on every matched pair
(``MAX_REPROJECTION_PX``). For a batch, each member equal bit for bit to
itself stitched alone, the first member against the CPU batch of it alone
(``MAX_MAD``), and the first member's registered pairs against the CPU's
(``MAX_REGISTER_PX``, ``MAX_INLIER_DIFF``). ``regression_bounds``: by how
much each end-to-end median may grow before a change counts as a
regression (``REGRESSION_BOUNDS``). The checks run outside the timed
window.

The main path runs as users get it: the features program, the
ordering's counts, the edge plan, each edge's composite + blend and the
enhance tail as CUDA graphs (a batch's member as one graph:
``_stitch_one_fixed``; a registration pair as one: ``_register_one``;
``core/programs.py``), captured in the cold run (``setup.graphs``, and
``register.graphs`` for the registration: the captures and their host
seconds, inside ``cold_ms``); ``--eager`` runs every program eagerly
instead, the port before its graphs, for a comparison in one call. The profile counts what
the replays ran: the kernels of a replayed graph are device events of the
trace, named as when launched one by one, so ``profile.kernels`` and the
busy time hold them; ``graph_launches``, ``graph_device_events`` and
``memcpy_htod_in_replays`` count the replays, their device events and the
host-to-device copies inside them; ``graph_launch_host_ms`` holds each
launch's host time beside its device events. ``launches`` are the wrappers'
counters, which every replay advances by its graph's launches; on the
card ``checks.launches_vs_trace`` holds the counters of each traced run
against the device kernels its trace holds (``probes.launches_vs_trace``),
and its graph launches against its program calls (a panorama: one a
frame, the ordering, the plan, one an edge, the tail; a batch member or
a registration pair: one; none under ``--eager``).
``setup.memory``: the allocator's peak reserved bytes over the warm runs,
what it holds reserved after them and the part of that in the graphs'
private pools (``programs.graph_memory``); ``peak_mem_gib`` counts
allocated bytes, which a replay does not move.

``--device cpu`` exists for the tests: a CPU run reports no device metric
(``null``), says ``"device": "cpu"`` in every line and is its own CPU
reference. Without a card and without ``--device cpu`` the bench raises.
``--frame`` replaces every selected cell's frame size (step and feature
scale follow the width), for tests at a reduced size. The exit code is 0
when every cell is correct.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .. import DEFAULT_CONFIG
from ..core import programs
from ..core.types import Features
from ..device import resolve_device
from ..models import registration
from ..models import stitcher as stm
from ..models.ransac import reprojection_errors
from ..ops import _native
from ..ops.color import to_gray
from ..ops.warp import cylindrical_project, warp_xy
from ..parallel import batched
from .probes import (KERNELS, canvas_diff, graph_edges, is_chain,
                     last_edge_vs_cpu, launches_vs_trace,
                     off_branch, profile_call, record_ordering, u8)
from .scenes import SCRAMBLE, config4, crops, scrambled

# the reference stitches its Input/ (4 x 384x512 photos) in 1.83 s on an
# i9-9900K (bench.py, BASELINE.md)
BASELINE_MS = 1830.0
# the canvas against the CPU run: tests/test_torch_stitch.py's gate
MAX_SHAPE_DIFF = 3  # px, rows and columns
MAX_MAD = 3.0  # u8 levels
MAX_LAST_EDGE_MAD = 1.0  # u8 levels: one edge on identical arguments
MAX_REPROJECTION_PX = 0.01  # the two plans agree to 0.001 px (ROADMAP §C)
# batched_pairwise_register against its CPU run: the card's warps moved an
# 8 x 8 grid at most 6.8e-5 px from the CPU's, with equal inlier counts
# (chip_smoke.py phase 14 on an NVIDIA H100 80GB HBM3)
MAX_REGISTER_PX = 0.01
MAX_INLIER_DIFF = 2
# By how much (a fraction of the parent's median) each end-to-end median
# may grow (sift_kpts_per_s: fall) before a change counts as a regression:
# the spread inside and across three calls of the default run (the
# programs as CUDA graphs) on one NVIDIA H100 80GB HBM3 at 700 W, by
# tools/bench_spread.py (PERF.md §2).
REGRESSION_BOUNDS = {
    "pano4_512x384": {"panorama_ms": 0.2, "cold_ms": 0.4,
                      "peak_mem_gib": 0.05, "sift_kpts_per_s": 0.05},
    "pano4_1440x1080": {"panorama_ms": 0.2, "cold_ms": 0.15,
                        "peak_mem_gib": 0.05, "sift_kpts_per_s": 0.1},
    "batch2x4_512x384": {"batch_ms": 0.2, "register_ms": 0.1,
                         "cold_ms": 0.25, "peak_mem_gib": 0.05},
    "pano4_4k_gain": {"panorama_ms": 0.05, "cold_ms": 0.3,
                      "peak_mem_gib": 0.05, "sift_kpts_per_s": 0.05},
}


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    kind: str  # "panorama" (Stitcher.stitch) or "batch"
    frame: tuple[int, int]  # (h, w) of every frame
    step: int  # columns between neighbouring crops of the scene
    scale: int  # feature scale of the scene (scenes.make_scene)
    seeds: tuple[int, ...]  # scene seed of each panorama
    config: str  # "default" or "config4"
    runs: int  # warm runs by default
    cpu_check: str = "full"  # panoramas: "full" CPU run, or "last_edge"


CELLS = {c.name: c for c in (
    Cell("pano4_512x384", "panorama", (512, 384), 224, 2, (0,), "default",
         20),
    Cell("pano4_1440x1080", "panorama", (1440, 1080), 630, 6, (1,),
         "default", 20),
    Cell("batch2x4_512x384", "batch", (512, 384), 224, 2, (0, 3), "default",
         20),
    Cell("pano4_4k_gain", "panorama", (2160, 3840), 2240, 6, (4,),
         "config4", 10, cpu_check="last_edge"),
)}
HEADLINE = "pano4_512x384"  # bench.py's panorama_4img_384x512_e2e_ms


def _reduced(cell: Cell, frame: tuple[int, int] | None) -> Cell:
    """``cell`` at ``frame`` (h, w): step and feature scale follow the
    width."""
    if frame is None or frame == cell.frame:
        return cell
    r = frame[1] / cell.frame[1]
    return dataclasses.replace(cell, frame=frame,
                               step=max(1, round(cell.step * r)),
                               scale=max(1, round(cell.scale * r)))


def _config(cell: Cell):
    return config4() if cell.config == "config4" else DEFAULT_CONFIG


def _stats(ms: list[float]) -> dict:
    q1, q3, p90 = np.percentile(ms, [25, 75, 90]).tolist()
    return {"median": statistics.median(ms), "p90": p90, "q1": q1, "q3": q3,
            "min": min(ms), "max": max(ms), "n": len(ms)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _recorded_plan():
    """While open, keep the arguments and the host plan of the stitcher's
    ``plan_edges_with_rows`` call."""
    rec, plan_fn = {}, stm.plan_edges_with_rows

    def plan(*a):
        rec["args"] = a
        rec["plan"], rows = plan_fn(*a)
        return rec["plan"], rows

    stm.plan_edges_with_rows = plan
    try:
        yield rec
    finally:
        stm.plan_edges_with_rows = plan_fn


def _edge_inputs(args) -> list:
    """The arguments of each edge's ``register_edge`` in the plan of
    ``args`` (a recorded ``plan_edges`` call), on the host: the plan runs
    again eagerly (``disable_graphs``: a replayed graph runs no Python)
    and the features of each edge are copied as that edge saw them (a
    later edge updates them in place)."""
    edges, edge_fn = [], registration.register_edge

    def cpu(x):
        return x.cpu() if isinstance(x, torch.Tensor) else x

    def register_edge(src, dst, *a, **kw):
        edges.append((_cpu_features(src), _cpu_features(dst),
                      tuple(cpu(x) for x in a),
                      {k: cpu(v) for k, v in kw.items()}))
        return edge_fn(src, dst, *a, **kw)

    registration.register_edge = register_edge
    try:
        with programs.disable_graphs():
            registration.plan_edges(*args)
    finally:
        registration.register_edge = edge_fn
    return edges


@contextlib.contextmanager
def _ransac_pairs():
    """While open, keep the matched pairs of each ``ransac_warp`` call
    that registration makes: ``register_edge`` fits forward, then
    backward."""
    pairs, fn = [], registration.ransac_warp

    def ransac(p, *a, **kw):
        pairs.append(p)
        return fn(p, *a, **kw)

    registration.ransac_warp = ransac
    try:
        yield pairs
    finally:
        registration.ransac_warp = fn


def _cpu_features(f: Features) -> Features:
    return Features(*(x.cpu() for x in f))


def plan_parity(rec: dict, last_edge: bool = False) -> dict:
    """The recorded edge plan against the port's CPU run on the same
    features: the CPU ``plan_edges`` on every edge, or with ``last_edge``
    the CPU ``register_edge`` on the last edge's features as the device
    updated them (``_edge_inputs``). Both models
    (forward, backward) of each edge are scored by ``reprojection_errors``
    on the matched pairs the CPU run fitted that model to; ``value`` is the
    largest difference between the card's and the CPU's errors over every
    pair."""
    if "args" not in rec:
        return {"ok": False, "value": None, "limit": MAX_REPROJECTION_PX,
                "reason": "the stitch planned no edge"}
    feats, edges, img_hw, start_hw, cfg = rec["args"]
    if cfg.warp_model != "bilinear":
        raise ValueError("reprojection parity scores bilinear models")
    plan = rec["plan"]
    t = time.perf_counter()
    last = _edge_inputs(rec["args"])[-1] if last_edge else None
    with _ransac_pairs() as pairs:
        if last_edge:
            src, dst, a, kw = last
            fwd, bwd, _, _ = registration.register_edge(src, dst, *a, **kw)
            scored = {len(edges) - 1: (fwd.numpy(), bwd.numpy())}
        else:
            plan_cpu = registration.plan_edges(
                _cpu_features(feats), edges, img_hw, start_hw, cfg)
            scored = {k: (plan_cpu[k, 0:8], plan_cpu[k, 9:17])
                      for k in range(len(edges))}
    cpu_s = time.perf_counter() - t
    diffs, n_pairs = [], []
    for i, (k, models) in enumerate(scored.items()):
        for cols, model, p in zip((slice(0, 8), slice(9, 17)), models,
                                  pairs[2 * i:2 * i + 2]):
            ok = p.valid
            err = [reprojection_errors(torch.from_numpy(m.copy()), p)[ok]
                   for m in (plan[k, cols], model)]
            diffs.append(float((err[0] - err[1]).abs().max())
                         if bool(ok.any()) else 0.0)
            n_pairs.append(int(ok.sum()))
    out = {"ok": max(diffs) <= MAX_REPROJECTION_PX, "value": max(diffs),
           "limit": MAX_REPROJECTION_PX, "edges": list(scored),
           "per_model": diffs, "pairs_per_model": n_pairs, "cpu_s": cpu_s}
    if not last_edge:
        out.update(
            canvas_sizes_equal=bool(np.array_equal(plan[:, 20:22],
                                                   plan_cpu[:, 20:22])),
            offsets_max_diff_px=float(np.abs(plan[:, 18:20]
                                             - plan_cpu[:, 18:20]).max()))
    return out


def _profile(fn, off, device: torch.device) -> dict | None:
    """One call of ``fn`` under ``torch.profiler`` (``profile_call``),
    apart from the timed runs; None on the CPU, where there is no device
    to read."""
    if device.type != "cuda":
        return None
    p = profile_call(fn, off, gaps=5)
    return {"wall_ms": p["wall_s"] * 1e3,
            "device_busy_ms": p["device_busy_ms"],
            "idle_share": p["idle_share"],
            "device_events": p["device_events"],
            "memcpy_htod_events": p["memcpy_htod_events"],
            "graph_launches": p["graph_launches"],
            "graph_device_events": p["graph_device_events"],
            "memcpy_htod_in_replays": p["memcpy_htod_in_replays"],
            "profiler_lead_kept": p["profiler_lead_kept"],
            "graph_launch_host_ms": p["graph_launch_host_ms"],
            "kernels": {name: {"id": KERNELS[name][0],
                               "device_ms": k["ms"],
                               "device_launches": k["device_launches"],
                               "counted_launches": k["counted_launches"]}
                        for name, k in p["kernels"].items()},
            "top_device_ops": [{"name": n, "ms": ms, "count": c}
                               for n, ms, c in p["top"][:10]],
            "idle_gaps": p["idle_gaps"]}


def _warm(fn, runs: int, device: torch.device, stages=None) -> dict:
    """``runs`` timed calls of ``fn`` (each ends with its result on the
    host): their wall times (ms), the kernel launches of the first, the
    peak device memory allocated over them, the allocator's memory
    (``_memory``) and, with ``stages`` (a Stitcher), the stage times of
    each."""
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    walls, stage_s, launches = [], [], None
    for i in range(runs):
        if i == 0:
            _native.reset_launch_counts()
        t = time.perf_counter()
        out = fn()
        walls.append((time.perf_counter() - t) * 1e3)
        if i == 0:
            launches = _native.launch_counts()
        if stages is not None:
            stage_s.append(dict(stages.stage_times))
    cuda = device.type == "cuda"
    return {"out": out, "walls": walls, "stage_s": stage_s,
            "launches": launches if cuda else None,
            "peak_mem_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                             if cuda else None),
            "memory": _memory(device) if cuda else None}


def _memory(device: torch.device) -> dict:
    """What the caching allocator holds on the card after timed runs: the
    peak reserved over them, what is reserved now and the part of it in
    the graphs' private pools (``programs.graph_memory``). The allocated
    peak (``peak_mem_gib``) misses the pools' free blocks: a replay
    allocates nothing."""
    return {"peak_reserved_gib": torch.cuda.max_memory_reserved(device)
            / 2 ** 30, **programs.graph_memory(device)}


def _launch_check(*runs) -> dict:
    """Each traced run, a (profile, program calls) pair: its launch
    counters against the device kernels its trace holds
    (``probes.launches_vs_trace``: what disagrees), and its graph
    launches against its program calls, one replay each (none under
    ``--eager``): [traced, expected] per run."""
    wrong = [launches_vs_trace(p["kernels"]) for p, _ in runs]
    graphs = [[p["graph_launches"], n if programs.graphs_enabled() else 0]
              for p, n in runs]
    return {"ok": not any(wrong) and all(a == b for a, b in graphs),
            "mismatches": wrong, "graph_launches": graphs,
            "limit": "each counted launch's device kernels in the trace; "
                     "one graph launch a program call"}


def _stitch_calls(cfg, n_frames: int, n_edges: int) -> int:
    """The program calls of a ``Stitcher.stitch`` on the planned path: the
    features program per frame, the ordering's counts (graph ordering),
    the plan, the composite + blend per edge and the enhance tail."""
    return (n_frames + (cfg.ordering == "graph") + 1 + n_edges
            + cfg.enhance.enabled)


def run_panorama(cell: Cell, device: torch.device, runs: int,
                 shift: int, keep: dict | None = None) -> dict:
    """One panorama cell: cold stitch (recording the ordering and the edge
    plan), the plan's parity, the timed warm runs, the last one's panorama
    against the CPU (or the last edge of one more run), one traced run.
    ``keep`` (a dict, for callers that check more): receives the
    ``stitcher``, the ``images`` and the last timed run's panorama
    (``out``)."""
    cfg = _config(cell)
    h, w = cell.frame
    t = time.perf_counter()
    images = scrambled(crops(h, w, cell.step, cell.scale,
                             seed=cell.seeds[0] + shift))
    scenes_s = time.perf_counter() - t
    st = stm.Stitcher(cfg, device=device)
    seen = record_ordering(st)
    before = programs.capture_stats()
    with _recorded_plan() as plan_rec:
        t = time.perf_counter()
        out_cold = st.stitch(images)
        cold_ms = (time.perf_counter() - t) * 1e3
    graphs = _graph_stats(before)
    live = int(st._feats_stacked.valid.sum())

    edges = graph_edges(seen)
    last_edge = cell.cpu_check == "last_edge"
    checks = {"chain": {"ok": is_chain(edges), "edges": edges,
                        "limit": "3 edges, each between scene neighbours"},
              "reprojection_parity_px": plan_parity(plan_rec, last_edge)}
    del plan_rec
    if not last_edge:
        t = time.perf_counter()
        # on the CPU the cold run is itself the port's CPU run
        out_cpu = (out_cold if device.type == "cpu"
                   else stm.Stitcher(cfg, device="cpu").stitch(images))
        cpu_s = time.perf_counter() - t

    warm = _warm(lambda: st.stitch(images), runs, device, stages=st)
    checks["warm_equals_cold"] = _equal_check((warm["out"], out_cold))
    if last_edge:
        rep = last_edge_vs_cpu(st, images)
        checks["last_edge_vs_cpu"] = {
            "ok": (max(rep["shape_diff"]) <= MAX_SHAPE_DIFF
                   and rep["mad_vs_cpu"] <= MAX_LAST_EDGE_MAD),
            **rep, "shape_limit": MAX_SHAPE_DIFF,
            "mad_limit": MAX_LAST_EDGE_MAD}
    else:  # the last timed run's panorama
        checks["canvas_vs_cpu"] = _canvas_check(warm["out"], out_cpu,
                                                cpu_s)
    profile = _profile(lambda: st.stitch(images), {"l1_two_nearest"}
                       | off_branch(cfg.warp_model), device)
    traced_stages = dict(st.stage_times)
    if profile is not None:
        profile["stage_ms"] = {k: v * 1e3 for k, v in traced_stages.items()}
        # the stitched edges: a spanning tree of the frames
        checks["launches_vs_trace"] = _launch_check(
            (profile, _stitch_calls(cfg, len(images), len(images) - 1)))
    if keep is not None:
        keep.update(stitcher=st, images=images, out=warm["out"])
    panorama_ms = _stats(warm["walls"])
    features_s = [s["features"] for s in warm["stage_s"]]
    line = {
        "scene": {"step": cell.step, "feature_scale": cell.scale,
                  "seed": cell.seeds[0] + shift, "order": SCRAMBLE},
        "setup": {"scenes_s": scenes_s, "graphs": graphs,
                  "memory": warm["memory"]},
        "cold_ms": cold_ms, "panorama_ms": panorama_ms,
        "peak_mem_gib": warm["peak_mem_gib"],
        "sift_kpts_per_s": {"median": live / statistics.median(features_s),
                            "live_keypoints": live},
        "stage_ms": {k: statistics.median(s.get(k, 0.0)
                                          for s in warm["stage_s"]) * 1e3
                     for k in dict.fromkeys(k for s in warm["stage_s"]
                                            for k in s)},
        "canvas": list(out_cold.shape), "launches": warm["launches"],
        "profile": profile, "checks": checks, "correct": _correct(checks)}
    if cell.name == HEADLINE:
        full_size = cell.frame == CELLS[HEADLINE].frame
        line.update(
            panorama_4img_384x512_e2e_ms=(panorama_ms["median"]
                                          if full_size else None),
            vs_baseline=(BASELINE_MS / panorama_ms["median"]
                         if full_size else None),
            baseline_ms=BASELINE_MS,
            baseline_note="the median of the warm runs (bench.py reports "
                          "their minimum) on synthetic crops of the "
                          "reference's Input/ frame size, not its photos; "
                          "the reference's 1830 ms is an i9-9900K on those "
                          "photos")
    return line


def _graph_stats(before: dict) -> dict:
    """The CUDA graphs of a cell's cold run: whether programs run as
    graphs (``--eager`` says not), the captures the run made (in all and
    by program) and the host seconds of their warm-ups and captures (both
    inside ``cold_ms``)."""
    delta = programs.captures_since(before)
    return {"enabled": programs.graphs_enabled(),
            **{k: delta[k] for k in ("captures", "by_program", "capture_s")}}


def _correct(checks: dict) -> bool:
    """Every check within its limit."""
    return all(c["ok"] for c in checks.values())


def _equal_check(*pairs) -> dict:
    """Bit for bit equal: each (output of the last timed run, the cold
    run's) pair."""
    return {"ok": all(bool(np.array_equal(a, b)) for a, b in pairs),
            "limit": "bit for bit"}


def _register_check(got, ref, hw: tuple[int, int], cpu_s: float) -> dict:
    """Registered pairs (coeffs [B, 8], inliers [B]) against the port's
    CPU run on the same pairs: how far each warp moves an 8 x 8 grid over
    the frame from where the CPU's warp puts it (``MAX_REGISTER_PX``), and
    the inlier counts' difference (``MAX_INLIER_DIFF``)."""
    (coeffs, inliers), (ref_coeffs, ref_inliers) = got, ref
    h, w = hw
    px, py = (g.ravel() for g in torch.meshgrid(
        torch.linspace(4, w - 4, 8), torch.linspace(4, h - 4, 8),
        indexing="xy"))
    warp_px = []
    for a, b in zip(coeffs, ref_coeffs):
        (xa, ya), (xb, yb) = (warp_xy(torch.from_numpy(c.copy()), px, py)
                              for c in (a, b))
        warp_px.append(float(torch.hypot(xa - xb, ya - yb).max()))
    inlier_diff = int(np.abs(inliers.astype(np.int64)
                             - ref_inliers.astype(np.int64)).max())
    return {"ok": (max(warp_px) <= MAX_REGISTER_PX
                   and inlier_diff <= MAX_INLIER_DIFF),
            "warp_px": warp_px, "warp_limit_px": MAX_REGISTER_PX,
            "inliers": inliers.tolist(), "cpu_inliers": ref_inliers.tolist(),
            "inlier_diff": inlier_diff, "inlier_limit": MAX_INLIER_DIFF,
            "cpu_s": cpu_s}


def _canvas_check(out, ref, cpu_s: float) -> dict:
    """A u8 canvas against the port's CPU run: shape within
    ``MAX_SHAPE_DIFF`` and MAD within ``MAX_MAD``."""
    shape_diff, mad = canvas_diff(out, ref)
    return {"ok": max(shape_diff) <= MAX_SHAPE_DIFF and mad <= MAX_MAD,
            "shape_diff": shape_diff, "shape_limit": MAX_SHAPE_DIFF,
            "mad": mad, "mad_limit": MAX_MAD, "cpu_canvas": list(ref.shape),
            "cpu_s": cpu_s}


def run_batch(cell: Cell, device: torch.device, runs: int,
              shift: int) -> dict:
    """The batch cell: ``batched_stitch_chain`` cold, each member against
    itself alone, timed warm batches, the last one's first member against
    the CPU, one traced batch; then ``batched_pairwise_register`` on the
    batch's neighbouring pairs, cold, timed and traced, the last timed
    run's first member's pairs against the CPU."""
    cfg = _config(cell)
    h, w = cell.frame
    t = time.perf_counter()
    pans = np.stack([np.stack(crops(h, w, cell.step, cell.scale,
                                    seed=s + shift)) for s in cell.seeds])
    scenes_s = time.perf_counter() - t
    n_pan, k = pans.shape[:2]
    canvas = batched.default_canvas(h, w, k, cfg)

    def stitch_batch():
        out, plans = batched.batched_stitch_chain(pans, cfg, device=device)
        return out.to(torch.uint8).cpu().numpy(), plans

    before = programs.capture_stats()
    t = time.perf_counter()
    out_cold, plans = stitch_batch()
    cold_ms = (time.perf_counter() - t) * 1e3
    graphs = _graph_stats(before)
    seq = batched.chain_edge_seq(k)
    equal = []
    for i in range(n_pan):
        one, plan = batched._stitch_one_fixed(
            torch.as_tensor(pans[i], device=device), cfg, canvas, seq)
        equal.append(bool(np.array_equal(
            one.to(torch.uint8).cpu().numpy(), out_cold[i])
            and np.array_equal(plan.cpu().numpy(), plans[i])))
    content = plans[:, -1, 20:22].astype(int).tolist()  # (w, h) a member
    checks = {
        "members_equal_alone": {"ok": all(equal), "per_member": equal},
        "content_within_canvas": {
            "ok": all(cw <= canvas[1] and ch <= canvas[0]
                      for cw, ch in content),
            "content_wh": content, "canvas": list(canvas)}}

    warm = _warm(stitch_batch, runs, device)
    last_out, last_plans = warm["out"]
    checks["warm_equals_cold"] = _equal_check((last_out, out_cold),
                                               (last_plans, plans))
    t = time.perf_counter()
    # member 0 of the last timed batch against the CPU batch of it alone;
    # on the CPU the cold batch is itself the port's CPU run
    ref = (out_cold[0] if device.type == "cpu" else u8(
        batched.batched_stitch_chain(pans[:1], cfg, device="cpu")[0][0]))
    checks["member_vs_cpu"] = _canvas_check(last_out[0], ref,
                                            time.perf_counter() - t)
    profile = _profile(stitch_batch, {"l1_two_nearest", "pair_match_counts"}
                       | off_branch(cfg.warp_model), device)

    def register(dev=device, members=n_pan):
        frames = pans[:members].reshape(-1, h, w, 3)
        gray = [to_gray(cylindrical_project(
            torch.as_tensor(f, device=dev).float(),
            cfg.projection.angle_deg)) for f in frames]
        gray = torch.stack(gray).reshape(members, k, h, w)
        coeffs, inliers = batched.batched_pairwise_register(
            gray[:, :-1].reshape(-1, h, w), gray[:, 1:].reshape(-1, h, w),
            cfg, dev)
        return coeffs.cpu().numpy(), inliers.cpu().numpy()

    before = programs.capture_stats()
    t = time.perf_counter()
    reg_cold = register()
    reg_cold_ms = (time.perf_counter() - t) * 1e3
    reg_graphs = _graph_stats(before)
    reg = _warm(register, runs, device)
    reg_profile = _profile(register, {
        "l1_two_nearest_bidir", "pair_match_counts", "warp_image",
        "warp_image_projective"}, device)
    coeffs, inliers = reg["out"]
    checks["register_warm_equals_cold"] = _equal_check(
        *zip(reg["out"], reg_cold))
    t = time.perf_counter()
    # member 0's pairs of the last timed registration against the CPU's
    ref = (tuple(x[:k - 1] for x in reg_cold) if device.type == "cpu"
           else register("cpu", 1))
    checks["register_vs_cpu"] = _register_check(
        (coeffs[:k - 1], inliers[:k - 1]), ref, (h, w),
        time.perf_counter() - t)
    n_pairs = n_pan * (k - 1)
    if profile is not None:
        # a member's panorama is one program call, a pair's registration
        checks["launches_vs_trace"] = _launch_check((profile, n_pan),
                                                    (reg_profile, n_pairs))
    if reg["launches"] is not None:
        checks["register_b7_once_per_pair"] = {
            "ok": reg["launches"]["l1_two_nearest"] == n_pairs,
            "launches": reg["launches"]["l1_two_nearest"], "pairs": n_pairs}
    return {
        "scene": {"step": cell.step, "feature_scale": cell.scale,
                  "seeds": [s + shift for s in cell.seeds],
                  "order": "scene order (chain)"},
        "panoramas": int(n_pan),
        "setup": {"scenes_s": scenes_s, "graphs": graphs,
                  "memory": warm["memory"]},
        "cold_ms": cold_ms, "batch_ms": _stats(warm["walls"]),
        "peak_mem_gib": warm["peak_mem_gib"], "sift_kpts_per_s": None,
        "stage_ms": None, "canvas": list(canvas),
        "launches": warm["launches"], "profile": profile,
        "register": {"pairs": n_pairs, "cold_ms": reg_cold_ms,
                     "graphs": reg_graphs,
                     "register_ms": _stats(reg["walls"]),
                     "inliers": inliers.tolist(),
                     "launches": reg["launches"], "profile": reg_profile},
        "checks": checks, "correct": _correct(checks)}


def _environment(device: torch.device) -> dict:
    """The device every line names: on the card its name and the power
    limit nvidia-smi reports, and the seconds to build and load the
    kernels (``ops/_native.py``), before any cell."""
    env = {"device": device.type, "torch": torch.__version__}
    if device.type != "cuda":
        return {**env, "gpu": None, "nvidia_smi": None, "build_s": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    t = time.perf_counter()
    _native.library()
    torch.zeros(1, device=device)
    _sync(device)
    return {**env, "gpu": torch.cuda.get_device_name(device),
            "nvidia_smi": smi, "cuda": torch.version.cuda,
            "build_s": time.perf_counter() - t}


def _frame(text: str) -> tuple[int, int]:
    h, w = (int(v) for v in text.lower().split("x"))
    return h, w


def _parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="bench_torch.py",
        description="The port's benchmark: one JSON line per cell.")
    p.add_argument("--cells", default=",".join(CELLS),
                   help="comma-separated cells (default: all): "
                        + ", ".join(CELLS))
    p.add_argument("--seed", type=int, default=0,
                   help="added to every cell's scene seed (default 0: the "
                        "scenes of chip_smoke.py)")
    p.add_argument("--runs", type=int, default=None,
                   help="warm runs per cell (default: 20, 10 at 4K)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default), or cpu for the tests: no device "
                        "metric")
    p.add_argument("--frame", type=_frame, default=None,
                   help="HxW replacing every cell's frame size (tests)")
    p.add_argument("--eager", action="store_true",
                   help="run every program eagerly (no CUDA graphs), to "
                        "compare with the default in one call")
    args = p.parse_args(argv)
    unknown = [c for c in args.cells.split(",") if c not in CELLS]
    if unknown:
        p.error(f"unknown cells {unknown}; known: {list(CELLS)}")
    if args.runs is not None and args.runs < 1:
        p.error("--runs must be at least 1")
    return args


def main(argv=None) -> int:
    t0 = time.perf_counter()
    args = _parse(argv)
    device = resolve_device(args.device)  # raises without a card
    env = _environment(device)
    ok = True
    with (programs.disable_graphs() if args.eager
          else contextlib.nullcontext()):
        for name in args.cells.split(","):
            cell = _reduced(CELLS[name], args.frame)
            t = time.perf_counter()
            run = run_batch if cell.kind == "batch" else run_panorama
            body = run(cell, device, args.runs or cell.runs, args.seed)
            body["setup"]["build_s"] = env["build_s"]
            line = {"cell": name, "kind": cell.kind, "config": cell.config,
                    "frame": list(cell.frame),
                    "reduced": cell != CELLS[name], "images_per_panorama": 4,
                    **{k: v for k, v in env.items() if k != "build_s"},
                    **body, "regression_bounds": REGRESSION_BOUNDS.get(name),
                    "seconds": time.perf_counter() - t,
                    "elapsed_s": time.perf_counter() - t0}
            print(json.dumps(line), flush=True)
            ok &= line["correct"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
