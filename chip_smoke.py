#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It drives ``computervisionimagestich2_tpu_torch``'s main path
(``Stitcher(DEFAULT_CONFIG, device="cuda").stitch``: graph ordering, the
fused detect) and the chain slice in phases, and prints one JSON line per
phase with its result and seconds:

1. environment: a CUDA device, its name and power limit (nvidia-smi);
2. build: the CUDA kernels, compiled from ``csrc/`` with nvcc (one process
   per source, in parallel), and the native BMP codec (``native/``, g++),
   which ``utils/io.py`` must take on this machine;
3. a cold default-path stitch of four synthetic 512x384 portrait crops
   handed over in scrambled order; graph discovery must find the scene's
   chain. It records the inputs of every kernel call (the programs run
   eagerly while a ``Recorder`` is open: a replayed CUDA graph calls no
   wrapper, and its capture allocates in the graph's pool), then every kernel
   is held against its plain PyTorch version on the first call's inputs,
   on the card, with the time of each, of PyTorch's own call for the same
   function where one exists (``library_ms``, timed here and used nowhere
   in the port) and of the least time the card could take (the bound,
   from these inputs: see ``bound``). B1 is held exactly on every octave
   of the call (one launch detects an image's four), B8 exactly on every
   call of the stitch (and timed on the largest of each of its four
   passes); B1-B5 must give the same bits twice; B4 the bits of B7 run
   each way; B5 the ratio counts of B4 on every pair; B1, B2 and B6 are
   also timed on a call with nothing to do (what a launch alone costs),
   and B6 on the panorama's last and largest canvas through both of its
   entries (the model and offsets by value, and in device memory, as the
   main path's programs hand them over: equal bit for bit);
4. the bench's headline cell on the same images (``tools/bench.py::
   run_panorama``, three warm runs; its JSON line is printed and must say
   ``correct``: the chain, the plan's reprojection parity with the CPU's,
   every timed run equal to its cold one, the canvas against the CPU
   run, and each kernel's launch counter in the traced run equal to the
   device kernels its trace holds, a launch's one to three), as users
   get it, the features program and the edge plan replayed
   as CUDA graphs (``core/programs.py``), and so are each edge's
   composite + blend and the enhance tail; the warm panorama equal to
   phase 3's eager one bit for bit; each kernel's launch count in one run
   (all six of the path must have launched, B1 once per image, B4 once
   per edge; a replay counts its graph's launches) and, from the cell's
   ``torch.profiler`` pass, device time per kernel and per panorama (a
   replayed graph's kernels are device events of the trace), all
   launches and host-to-device copies, the device's busy and idle share;
   B6 per panorama beside the floor its launches set;
5. the chain slice (``SLICE_CONFIG``) on the crops in scene order: one cold
   and one warm run, the CPU-canvas check, and no launch of the fused
   detect (B1) or the pair counts (B5);
6. the matcher API (kernel B7): ``match_features`` and ``match_count`` on
   two feature sets of phase 4, ``match_features`` against the first
   direction of ``match_features_bidir``, and the kernel against its plain
   version on a reference mask with a hole inside the live prefix;
7. the default path on four scrambled 1440x1080 images (the north-star
   size): canvas, discovered edges and start, SIFT and match telemetry
   from an eager cold run, then the bench's north-star cell
   (``run_panorama`` with its last edge against the CPU, three warm
   runs, its line printed) with warm walls, stage times and peak device
   memory, its panorama equal to the eager one; B1 exactly
   against plain on that size's four octave shapes and B6 on its 1489 x
   2948 canvas beside its bound; B6's cases (phase 7a): both warp models,
   by value exact against plain and the device-parameter entry equal to
   it bit for bit (each entry timed), on the last
   canvases of phases 3 and 7 (recorded, and as affine / projective twins
   timed side by side), a canvas width that is not a multiple of 4, one
   channel, a 1 x 1 canvas and a horizon crossing the canvas; then kernel
   B5 alone on the features of ten 512x384 frames (45 pairs), of four
   1440x1080 frames, and of ten at the extractor's full capacity (9,728
   slots, so the pairs go in several chunks; not held against plain, which
   would take minutes): equal counts twice, the counts of one B4 launch
   per pair, device time beside the bound, and the call's peak memory
   within the scratch budget;
8. the command line (``python -m computervisionimagestich2_tpu_torch.cli
   --timing``, bucketed canvases by default) on the crops of phase 3 as
   1.bmp..4.bmp, in a subprocess that must load neither jax nor any module
   of the JAX package (the port imports none): its stage and total
   seconds, its launches, and its panorama against the in-process
   ``Stitcher`` under the same configuration (and its distance from phase
   4's exact-canvas panorama);
9. the incremental stitch (``planned=False``) against phase 4's planned
   canvas, bucketed canvases (``exact_canvas=False``) beside exact ones, a
   dump and a resume that must be bit-identical, and the incremental
   bucketed canvas against the CPU run of the port on the same features;
10. four crops of mixed shapes, scrambled: graph discovery from B4 per pair
   (B5 must not launch; B4 once per pair and per edge) and the incremental
   stitch, against the CPU run;
11. ``StreamingStitcher`` (BASELINE config 5): 10 frames at 1280x720 and 8
   at 1920x1080 panning by 1/8 of the frame width, per-frame ``push()``
   latency (median and worst after the first two frames, split into sift,
   register and composite + blend; ``sift_extract`` and ``register_edge``
   replay their CUDA graphs, the composite + blend runs eagerly),
   keyframe switches, the canvas (on the bucket grid, at most 4096 wide)
   and the launches per frame (B4 once per registration, B5 never); at
   720p the canvas of the first two frames against the CPU run of the
   port;
   phases 9, 10 and 11 (and 14's registration) run their path eagerly
   under ``disable_graphs()`` and with graphs in one call
   (``eager_and_graphs``: a cold and a warm run of each mode, a traced
   one with graphs): the
   outputs and warm launch counts bit for bit equal, the cold captures
   and the warm replays by program (exact: phase 9 the features program
   per frame, the ordering, ``register_edge`` and the composite + blend
   per edge, the tail; phase 10 the same with one ordering program per
   image pair; phase 11 SIFT per frame and ``register_edge`` per
   registration; phase 14 ``_register_one`` per pair), no warm capture,
   no host-to-device copy inside a replay, the counters equal to the
   trace, and each mode's seconds and stage seconds;
12. ``warp_model="projective"`` (``DEFAULT_CONFIG`` otherwise) on the
   scrambled crops of phases 3 and 7: the chain, B6's projective branch
   once per edge and its bilinear one never, no ``match_overflow`` logged,
   the canvas against the port's CPU run on the features the card dumped
   (SIFT skipped: the model changes nothing before registration); B6's
   projective kernels row from the 512x384 run, with its profile;
13. the rest of A13 at 4 x 512x384, each against the port's CPU run with
   the same checks: ``sift.o_min=-1`` (a whole CPU run; B1 exact on the
   doubled octave, B2 and B3 against plain on it; then the features of the
   four 1440x1080 images, a 2880 x 2160 first octave, with their SIFT
   telemetry), ``gain_mode="luma"`` with gain compensation, and the Van
   Vliet blend (both against a CPU run on the card's features; with the
   time and device launches of one Van Vliet blend beside the FIR one's);
14. batched panoramas (BASELINE config 3, ``parallel/batched.py``): two
   panoramas of four crops in scene order, from two seeds, at 512x384 and
   1440x1080 on the default fixed canvas: launches per batch (B1 once per
   image, B4 and B6 once per edge), each panorama equal to itself stitched
   alone, bit for bit, the batch (one CUDA graph a panorama,
   ``_stitch_one_fixed``) equal to its eager run, one graph launch a
   panorama and no host-to-device copy inside one, no
   ``batched_canvas_overflow``, warm wall, device
   busy and idle share, peak memory, the blend gates the canvas engages; at
   512x384 the canvases against the port's CPU batch and the content
   extents against the chain-ordered ``Stitcher``; then
   ``batched_pairwise_register`` on three neighbouring pairs: B7 once per
   pair, against plain, its device time per call and per batch, the warps
   against the CPU run, the pairs as graphs (one replay a pair) against
   eager;
15. ``match.method="l2pre"`` and ``match.distance="l2"`` at 4 x 512x384
   (B4 and B5 bypassed, as in the JAX package): the chain, the canvas
   against the CPU run, the ratio-test decisions that differ from exact
   L1 on the edges and the graph counts, and the device time of each
   strategy per edge beside B4's;
16. the mesh mode (A18) on virtual meshes of the one card (a list of
   devices that repeats ``cuda:0``; ``parallel/mesh.py``): (a)
   ``sharded_composite`` of phase 7's last edge over 2, 4 and 8 stripes,
   B6 once per stripe, the stripes against ``compose.composite`` (the
   warped ones' differing pixels counted, expected 0), B6's device time
   per call and per stripe beside a stripe's bound; (b)
   ``sharded_blend_two_images`` over 4 stripes against
   ``blend_two_images`` on that edge's canvas and on a synthetic 2304 x
   13312 pair (a 4 x 3840x2160 panorama's canvas), f32 within 2e-3 and
   bf16 within 4.0, time and peak memory of both; (c)
   ``Stitcher(mesh=make_mesh(4, sp=4, ...))`` on phase 7's images with
   bucketed canvases: with the seam band off and f32, the chain, B6 once
   per stripe of every edge and the single-device panorama within
   tests/test_parallel.py's tolerance; cold and warm walls, profile, peak
   memory, also under the default blend settings, with the distance from
   the single-device panorama there recorded (the mesh gate ignores the
   area-gated seam band, as in the JAX package); (d) the mesh Stitcher at
   4 x 512x384 against its CPU run; (e) phase 14's 512x384 batch through
   ``shard_batch`` equal to the unsharded batch, bit for bit; (f) the
   command line with ``--sp`` one more than the cards refused, naming
   the count;
17. BASELINE config 4 (``config4``: ``DEFAULT_CONFIG`` with gain
   compensation) on four scrambled 3840x2160 crops of one scene (58%
   step, phase 7's feature scale): (a) a cold stitch recording every
   kernel call (eagerly): the chain, per image the four SIFT drop counters, per edge
   the matches dropped and ``match_overflow`` (recorded, not failed at
   these capacities), the canvas, the blend gates each edge engaged, the
   stage times, the largest bin the enhance tail equalizes; (b) every
   kernel of the path against its plain version at its 4K calls (B1
   exactly on the four octaves, B2 and B3 on the first octave's call, B4
   on an edge and at the extractor's full 16384 slots, B5 on the call and
   at full capacity in chunks, B6 on the last canvas), with device time,
   bound and share; warm runs: launches (B1 once per image, B2 and B3 once
   per level batch of every octave, B4 and B6 once per edge, B5 once),
   median of three, peak memory, a profile, the panorama of the graphs
   equal to the eager cold one; (c) the last edge's composite
   + blend again on the CPU on the same arguments; (d) the stitch at the
   smallest ``sift.max_keypoints_per_octave``, ``sift.max_keypoints`` and
   ``match.max_matches`` that zero the counters (what no field lowers is
   recorded), with no ``match_overflow``, its wall, profile, peak memory
   and B4 and B5 beside their bounds; (e) the command line with
   ``--gain-compensation`` on the frames as 24.9 MB BMPs (phase 8's
   checks; it must take the native codec), and both codecs timed on them;
18. the programs as CUDA graphs against eager (``graphs_phase``) on the
   scenes of the bench's three panorama cells (4 x 512x384 and 4 x
   1440x1080 under ``DEFAULT_CONFIG``, 4 x 3840x2160 under ``config4``):
   a Stitcher under ``disable_graphs()`` and one with every graph dropped
   first, each a cold, a counted and two timed warm stitches and a
   profile; the graph run's panorama, each frame's features, projection
   and stats, the [E, 23] plan, each edge's composite + blend, the
   enhance tail's output, the ordering's counts and the launch counts
   equal the eager run's bit for bit; the cold run captures the features
   program (into which ``sift_extract_stats`` is inlined), the ordering,
   the plan, the composite + blend once per canvas shape of its edges
   and the enhance tail, a second stitch nothing; the profile shows one
   graph launch per frame, one for the ordering, one for the plan, one
   per edge and one for the tail, and no host-to-device
   copy inside a replay; the reversed edge sequence replays the plan's
   graph with the eager plan's rows (the plan's key holds no edge); in
   each mode's profile every launch counter equals the device kernels
   the trace holds. Each mode's cold wall (with the captures' host
   seconds), warm walls, stage times, peak memory allocated and reserved
   and the private pools (reserved and allocated; more with graphs than
   eager, where every graph was dropped and only what earlier captures
   left stays), device events, host-to-device copies and idle share are
   printed, and fresh scenes of the same frame shape in the warm
   process (three at 512x384 for the spread, one at 1440x1080, two at
   4K: each one's first stitch, with the captures of its new canvas
   shapes, and a second one), with the pools by program after them (at
   4K the composite + blend program then holds its ``MAX_GRAPHS``); at
   512x384 a fresh interpreter names the owner of what stays allocated
   in a private pool after every graph is dropped (``pool_owner_probe``:
   the allocator's history); (d) the benchmark's dataset2 geometry, 18
   crops of 800x600 350 px apart on two seeds, nine more composite + blend
   keys than ``MAX_GRAPHS`` allows (``many_edges_phase``): graphs against
   eager bit for bit, a warm stitch captures nothing, replays
   ``MAX_GRAPHS`` edges and runs the 9 others eagerly, and no pair of
   frames that shares nothing draws the pair threshold's matches;
19. the port's benchmark, ``bench_torch.py --cells pano4_512x384 --runs
   1``, in a fresh interpreter: exit code 0, one JSON line on stdout,
   printed, that says ``correct`` and shows the cold run's captures: the
   features program, the ordering, the plan, three composite + blend
   canvases and the enhance tail.

In phases 4, 5, 8-11 and 12-17 every launch count is set to 0 just before
the path runs and read just after; each path must launch each of its
kernels (B7, the one-direction 2-NN, belongs to the matcher API of phase 6
and to the batched registration of phase 14, and each path runs one of
B6's two branches).

A redesigned kernel is timed beside its earlier design, from an earlier
commit, by ``computervisionimagestich2_tpu_torch/tools/kernel_ab.py``.

The line before the last is the per-kernel JSON summary (B1-B7, B6 as its
two branches; B6's row adds its mesh-mode launches and times, and every
row its 4K launches, device time and calls, ``at_4k``), the last
line ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero; without a CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from computervisionimagestich2_tpu_torch.tools.probes import (
    B6_BRANCH, DEVICE_KERNELS, KERNELS, canvas_vs_cpu, check_chain, dev_us,
    device_events, graph_edges, last_edge_vs_cpu, launches_vs_trace,
    off_branch, profile_call, record_ordering, u8)
from computervisionimagestich2_tpu_torch.tools.scenes import (
    SCRAMBLE, config4, crops, make_scene, scrambled)

ROOT = Path(__file__).resolve().parent

# device work a launcher starts beside its kernels, by profiler key: B1's
# cudaMemsetAsync of the scan's status words. Counted where a wrapper is
# timed alone (``device_ms``); in the profile of a whole stitch other code's
# memsets carry the same key, so ``profile_run`` books the kernels only
BESIDE_KERNELS = {"detect_compact": ("Memset",)}
# B7: the matcher API (phase 6) and the batched registration (phase 14)
OFF_MAIN_PATH = {"l1_two_nearest"}
CHAIN_OFF_PATH = OFF_MAIN_PATH | {"detect_compact", "pair_match_counts"}

# Peak rates of one H100 SXM at its full 700 W (NVIDIA's data sheet):
# device memory 3.35 TB/s; float32 outside the tensor cores 67 TFLOP/s,
# which counts a fused multiply-add as two operations, so 33.5 T of the
# plain subtractions, adds, multiplies and compares these kernels do.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 33.5e12
# float operations per contributing window pixel, counted from the walks'
# arithmetic: B2 offsets, radius, Gaussian weight with its exp, angle bin
# and two weighted bin adds; B3 offsets, rotation, orientation, Gaussian
# window with its exp, 8 spatial and 2 orientation hat weights and up to 8
# weighted bin adds
B2_OPS_PER_PIXEL = 22
B3_OPS_PER_PIXEL = 84
L1_OPS_PER_PAIR = 2 * 128 + 4  # |q - r| + add per feature, 4 top-2 compares


def emit(phase: str, t0: float, **kv) -> dict:
    rec = {"phase": phase, "ok": True,
           "seconds": round(time.perf_counter() - t0, 3), **kv}
    print(json.dumps(rec), flush=True)
    return rec


def pair_inputs(images, trimmed: bool = True):
    """Kernel B5's inputs for ``images``: (desc [N, CAP, 128], valid
    [N, CAP]) of the stacked features and every i<j pair. ``trimmed``: as
    graph ordering hands them over, cut to the live prefix rounded up to
    512 slots; else at the extractor's full capacity."""
    import torch

    from computervisionimagestich2_tpu_torch import DEFAULT_CONFIG
    from computervisionimagestich2_tpu_torch.models.stitcher import Stitcher

    st = Stitcher(DEFAULT_CONFIG, device="cuda")
    st.prepare(images)
    feats = st._matching_feats() if trimmed else st._feats_stacked
    n = len(images)
    pairs = torch.tensor([(i, j) for i in range(n) for j in range(i + 1, n)],
                         dtype=torch.int32, device=feats.desc.device)
    return feats.desc.contiguous(), feats.valid.contiguous(), pairs


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean time of one call between CUDA events around ``reps`` calls in
    a row, after one warm-up: the device time of the call plus whatever
    the host makes the device wait between launches."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, name: str, reps: int = 10, keys=None,
              launches: int | None = None,
              windows: int = 5) -> float | None:
    """Mean device time per call of ``fn`` spent in the device work of
    wrapper ``name`` (``DEVICE_KERNELS`` and ``BESIDE_KERNELS``, or the
    profiler keys ``keys``), from ``torch.profiler`` over ``reps`` calls
    after one warm-up: the device work alone, without the host's gaps
    between launches. The profiler now and then drops part of a short
    window, so a window counts only if it holds a whole number of matching
    device events per call, at least one (exactly ``launches`` a call,
    where given); after ``windows`` windows without one, None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if keys is None:
        keys = DEVICE_KERNELS[name] + BESIDE_KERNELS.get(name, ())
    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in device_events(prof)
                if any(k in e.key for k in keys)]
        count = sum(e.count for e in hits)
        if (count == launches * reps if launches
                else count >= reps and count % reps == 0):
            return sum(dev_us(e) for e in hits) / 1e3 / reps
    return None


def queued_ms(fn, reps: int = 20) -> float | None:
    """Device time per call of ``fn`` from CUDA events, with the stream
    held behind a sleep kernel until every call is queued: the launches'
    device time back to back (with the card's own gaps between them, not
    the host's). None if the sleep ran out before the host had queued
    them all."""
    import torch

    fn()
    torch.cuda.synchronize()
    held = torch.cuda.Event()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25-30 ms at the H100's clocks
    held.record()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    queued_in_time = not held.query()
    end.synchronize()
    return start.elapsed_time(end) / reps if queued_in_time else None


def kernel_ms(fn, name: str) -> dict:
    """``ms``: the kernels' device time per call (``device_ms``), or the
    CUDA-event time where the profiler sees no device time; ``ms_events``:
    the CUDA-event time of calls in a row (``cuda_ms``)."""
    dev, ev = device_ms(fn, name), cuda_ms(fn)
    return {"ms": dev if dev is not None else ev, "ms_events": ev,
            "ms_source": "torch.profiler" if dev is not None
            else "CUDA events"}


class Recorder:
    """Wraps each kernel wrapper at the module attribute the main path
    calls it through, and keeps the positional arguments of every call
    (``calls``) and of the first (``args``). ``names``: the wrappers to
    record (by default those of the default stitch path: all but B7). The
    matchers' strategy keywords pass through unrecorded: exact L1, the
    only one the kernels run, is the wrappers' default. While open, the
    programs run eagerly (``disable_graphs``): a replayed graph calls no
    wrapper."""

    def __init__(self, names=None):
        from computervisionimagestich2_tpu_torch.models import compose
        from computervisionimagestich2_tpu_torch.ops import (_native, detect,
                                                             distance,
                                                             sift_walks)

        self.sites = {
            "detect_compact": (detect, "detect_compact_octaves"),
            "sift_orientation_hist": (sift_walks, "orientation_hist"),
            "sift_descriptors": (sift_walks, "descriptors"),
            "l1_two_nearest_bidir": (distance, "two_nearest_bidir"),
            "pair_match_counts": (distance, "pair_match_counts"),
            "warp_image": (compose, "warp_image"),
            "l1_two_nearest": (distance, "two_nearest"),
            "separable_blur": (_native, "separable_blur")}
        if names is None:  # the default path's wrappers
            names = [n for n in self.sites if n not in OFF_MAIN_PATH]
        self.sites = {n: self.sites[n] for n in names}
        self.args: dict[str, tuple] = {}
        self.calls: dict[str, list] = {name: [] for name in self.sites}
        self._orig = {}

    def __enter__(self):
        from computervisionimagestich2_tpu_torch.core import programs

        # recorded inputs must be tensors of an eager run: a graph's
        # capture allocates in its pool, which every replay overwrites
        self._eager = programs.disable_graphs()
        self._eager.__enter__()
        for name, (mod, attr) in self.sites.items():
            fn = getattr(mod, attr)
            self._orig[name] = fn

            def wrapped(*args, _fn=fn, _name=name, **kw):
                self.args.setdefault(_name, args)
                self.calls[_name].append(args)
                return _fn(*args, **kw)
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for name, (mod, attr) in self.sites.items():
            setattr(mod, attr, self._orig[name])
        self._eager.__exit__(*exc)


@contextlib.contextmanager
def telemetry():
    """While open, record what a stitch reports: the SIFT drop counters
    of each image (candidates, refined keypoints, descriptors, final
    capacity) and its live keypoints before the final capacity, the
    matches each edge dropped (the plan's column 22), the warnings, each
    blend's canvas with the precision and seam-band gates it engaged and
    the last blend's arguments, and the histogram the enhance tail
    equalizes (its largest bin: the JAX package counts in float32, exact
    below 2^24 a bin) with the luma it counts (``luma``)."""
    import torch

    from computervisionimagestich2_tpu_torch.models import stitcher as stm
    from computervisionimagestich2_tpu_torch.models.blender import (
        resolve_dtype, seam_auto_engaged)
    from computervisionimagestich2_tpu_torch.ops.color import rgb_to_ycbcr
    from computervisionimagestich2_tpu_torch.utils import obs

    from computervisionimagestich2_tpu_torch.parallel import batched

    tel = {"sift_dropped": [], "sift_live": [], "match_dropped": None,
           "warnings": [], "blends": [], "last_blend": None,
           "equalize": None}
    orig = (batched._project_and_extract_one, stm.plan_edges_with_rows,
            obs.warn, stm.blend_edge, stm.equalize_and_mix)
    features, plan, warn, blend, equalize = orig

    def features_rec(*a):  # the per-image features program
        f, p, s = features(*a)
        tel["sift_dropped"].append(s.tolist())
        tel["sift_live"].append(int(f.valid.sum()) + int(s[3]))
        return f, p, s

    def plan_rec(*a):
        p, rows = plan(*a)
        tel["match_dropped"] = p[:, 22].astype(int).tolist()
        return p, rows

    def warn_rec(stage, **kv):
        tel["warnings"].append({"stage": stage, **kv})
        warn(stage, **kv)

    def blend_rec(a, b, bcfg, *rest):
        h, w = int(a.shape[0]), int(a.shape[1])
        tel["blends"].append({
            "canvas": [h, w], "mpx": h * w / 1e6,
            "dtype": resolve_dtype(bcfg.dtype, h, w, bcfg.bf16_auto_area),
            "seam_band_with_rgb_gain": seam_auto_engaged(bcfg, h, w)})
        tel["last_blend"] = (a, b, bcfg, *rest)
        return blend(a, b, bcfg, *rest)

    def equalize_rec(result, *a):
        y = rgb_to_ycbcr(result, compat_luma=a[0] if a else True,
                         to_u8=True)[..., 0]
        hist = torch.bincount(y.reshape(-1).long(), minlength=256)
        tel["luma"] = y  # for histogram_cost; popped by its caller
        tel["equalize"] = {"pixels": int(y.numel()),
                           "largest_bin": int(hist.max()),
                           "largest_bin_level": int(hist.argmax()),
                           "largest_bin_below_2_24": int(hist.max()) < 2 ** 24}
        return equalize(result, *a)

    (batched._project_and_extract_one, stm.plan_edges_with_rows, obs.warn,
     stm.blend_edge, stm.equalize_and_mix) = (features_rec, plan_rec,
                                              warn_rec, blend_rec,
                                              equalize_rec)
    try:
        yield tel
    finally:
        (batched._project_and_extract_one, stm.plan_edges_with_rows,
         obs.warn, stm.blend_edge, stm.equalize_and_mix) = orig


@contextlib.contextmanager
def recorded_warnings():
    """While open, keep the warnings a run prints (``obs.warn``), and
    nothing else: unlike ``telemetry`` it reads no tensor, so it may stay
    open while a program is captured."""
    from computervisionimagestich2_tpu_torch.utils import obs

    got, warn = [], obs.warn

    def warn_rec(stage, **kv):
        got.append({"stage": stage, **kv})
        warn(stage, **kv)

    obs.warn = warn_rec
    try:
        yield got
    finally:
        obs.warn = warn


def histogram_cost(y) -> dict:
    """The enhance tail's 256-bin histogram of luma ``y`` [H, W] on the
    card (``equalization._histogram``: a ``scatter_add_`` of ones into a
    row of bins per image row, graph-safe) beside ``torch.bincount``,
    which reads the input's largest value back to the host: equal
    counts, and the time of each
    call between CUDA events over calls in a row (``cuda_ms``; each call's
    device work is 0.3-6 ms, far above its few launches), and its device
    time from the profiler where a whole window was traced (``device_ms``
    over every device event, else None: a call's memsets now and then
    miss the trace)."""
    import torch

    from computervisionimagestich2_tpu_torch.models import equalization

    idx = y.reshape(-1).long()
    calls = {
        "rows_scatter_add": lambda: equalization._histogram(y),
        "bincount": lambda: torch.bincount(idx, minlength=256)}
    ref = calls["bincount"]()
    out = {"shape": list(y.shape)}
    for name, fn in calls.items():
        assert torch.equal(fn(), ref), name
        out[f"{name}_ms_events"] = cuda_ms(fn)
        out[f"{name}_device_ms"] = device_ms(fn, name, keys=("",))
    return out


def near_ratio(desc, valid, pairs, ratio: float) -> list:
    """Per pair and direction, the valid queries whose plain d1 / d2 lies
    within 1e-5 of the ratio: the only ones whose decision a different
    summation order may flip."""
    from computervisionimagestich2_tpu_torch.ops import distance

    near = []
    for i, j in pairs.tolist():
        row = []
        for q, r in ((j, i), (i, j)):
            d1, d2, _ = distance.two_nearest_plain(desc[q], desc[r],
                                                   valid[q], valid[r])
            row.append(int((valid[q] & ((d1 / d2 - ratio).abs() < 1e-5))
                           .sum()))
        near.append(row)
    return near


def check_b5(a: tuple, plain: bool = True):
    """Kernel B5 on inputs ``a`` (desc, valid, pairs[, ratio]): equal counts
    in two runs; exactly the ratio counts of one B4 launch per pair; with
    ``plain``, the plain version's counts, short of the queries within 1e-5
    of the ratio. Returns (counts, largest difference from plain, those
    queries per pair if any count differs), the last two None without
    ``plain``."""
    import torch

    from computervisionimagestich2_tpu_torch.ops import distance

    pk = distance.pair_match_counts(*a)
    assert torch.equal(pk, distance.pair_match_counts(*a)), \
        "B5 is not deterministic"
    desc, valid, pairs = a[:3]
    ratio = a[3] if len(a) > 3 else 0.5
    for p, (i, j) in enumerate(pairs.tolist()):
        okq, _, okr, _ = distance.ratio_match_bidir(desc[j], desc[i],
                                                    valid[j], valid[i], ratio)
        b4 = [int(okq.sum()), int(okr.sum())]
        assert b4 == pk[p].tolist(), ("B5 != B4 counts", i, j, b4,
                                      pk[p].tolist())
    if not plain:
        return pk, None, None
    pp = distance.pair_match_counts_plain(*a)
    diff = (pk - pp).abs()
    near = None
    if not torch.equal(pk, pp):
        near = near_ratio(desc, valid, pairs, ratio)
        print(json.dumps({"b5_differs": {"kernel": pk.tolist(),
                                         "plain": pp.tolist(),
                                         "near_ratio": near}}), flush=True)
        assert (diff.cpu() <= torch.tensor(near)).all(), "B5 disagrees"
    return pk, float(diff.max()), near


def b5_at(images, plain: bool = True, trimmed: bool = True) -> dict:
    """Kernel B5 on the features of ``images`` (``pair_inputs``), as
    ``b5_on``."""
    from computervisionimagestich2_tpu_torch import DEFAULT_CONFIG

    return b5_on((*pair_inputs(images, trimmed),
                  DEFAULT_CONFIG.match.ratio_threshold), plain)


def b5_on(a: tuple, plain: bool = True, within_budget: bool = True) -> dict:
    """Kernel B5 on inputs ``a`` (desc, valid, pairs, ratio): ``check_b5``,
    its device time beside its bound, and the device memory the call takes
    at its peak (scratch and result), which must stay within the budget
    (``within_budget``; else it is recorded: a pair whose scratch alone
    exceeds the budget goes in a chunk of its own)."""
    import torch

    from computervisionimagestich2_tpu_torch.ops import distance

    pk, diff, near = check_b5(a, plain)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    distance.pair_match_counts(*a)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    chunk = distance.pair_chunk(a[0].shape[1], a[2].shape[0],
                                distance.PAIR_SCRATCH_BYTES)
    row = {"images": int(a[0].shape[0]), "slots": int(a[0].shape[1]),
           "live": a[1].sum(dim=1).tolist(), "pairs": int(a[2].shape[0]),
           "chunk": chunk, "chunks": -(-int(a[2].shape[0]) // chunk),
           "scratch_budget_bytes": distance.PAIR_SCRATCH_BYTES,
           "peak_call_bytes": int(peak), "max_abs_err": diff,
           "near_ratio": near, "equals_b4_counts": True,
           "counts_sum": int(pk.sum()),
           **kernel_ms(lambda: distance.pair_match_counts(*a),
                       "pair_match_counts"),
           **kernel_bound("pair_match_counts", a)}
    assert not within_budget or (
        peak <= distance.PAIR_SCRATCH_BYTES + (1 << 20)), row
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    return row


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take for work that moves ``nbytes``
    (each input read once, each output written once) and does ``ops``
    float operations: the larger of the two times at the peak rates."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_us": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": int(nbytes), "bound_ops": int(ops)}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def b2_windows(mod, ang, x, y, sigma, n_valid, radius, *_) -> tuple:
    """The window pixels of the live keypoints that kernel B2 adds to a
    bin: |dx|, |dy| <= wr = max(floor(4.5 sigma), 1), r^2 < wr^2 + 0.6,
    inside the image (csrc/sift_walks.cu). Returns (selected [n, R, R],
    their rows [n, R], columns [n, R], image width)."""
    import torch

    h, w = mod.shape
    n = int(n_valid[0])
    x, y, sigma = x[:n], y[:n], sigma[:n]
    xi, yi = torch.floor(x + 0.5), torch.floor(y + 0.5)
    ok = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
    off = torch.arange(-radius, radius + 1, device=x.device,
                       dtype=torch.float32)
    wr = torch.clamp(torch.floor(3.0 * (1.5 * sigma)), min=1.0)[:, None]
    px, py = xi[:, None] + off, yi[:, None] + off
    inx = (px >= 0) & (px <= w - 1) & (off.abs() <= wr)
    iny = (py >= 0) & (py <= h - 1) & (off.abs() <= wr)
    dx, dy = px - x[:, None], py - y[:, None]
    r2 = dy[:, :, None] ** 2 + dx[:, None, :] ** 2
    sel = (iny[:, :, None] & inx[:, None, :]
           & (r2 < (wr * wr + 0.6)[:, :, None]) & ok[:, None, None])
    return sel, py, px, w


def b3_windows(mod, ang, x, y, sigma, angle, n_valid, radius, magnif,
               *_) -> tuple:
    """The window pixels of the live keypoints that kernel B3 adds to a
    bin: inside the loop bounds of vl/sift.c:1352-1357 and inside the
    +-2.5 support of the spatial hats after the rotation. Returns as
    ``b2_windows``."""
    import torch

    h, w = mod.shape
    n = int(n_valid[0])
    x, y, sigma, angle = x[:n], y[:n], sigma[:n], angle[:n]
    xi, yi = torch.floor(x + 0.5), torch.floor(y + 0.5)
    ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h - 1)
    sbp = (magnif * sigma + 2.220446049250313e-16)[:, None]
    wr = torch.floor(2 ** 0.5 * sbp * 5.0 / 2.0 + 0.5)
    off = torch.arange(-radius, radius + 1, device=x.device,
                       dtype=torch.float32)
    xf, yf = xi[:, None], yi[:, None]
    inx = (off >= torch.maximum(-wr, 1 - xf)) & (
        off <= torch.minimum(wr, w - xf - 2))
    iny = (off >= torch.maximum(-wr, 1 - yf)) & (
        off <= torch.minimum(wr, h - yf - 2))
    dx = (xf + off - x[:, None])[:, None, :]
    dy = (yf + off - y[:, None])[:, :, None]
    ct, st = torch.cos(angle)[:, None, None], torch.sin(angle)[:, None, None]
    nx = (ct * dx + st * dy) / sbp[:, :, None]
    ny = (-st * dx + ct * dy) / sbp[:, :, None]
    sel = (iny[:, :, None] & inx[:, None, :] & (nx.abs() < 2.5)
           & (ny.abs() < 2.5) & ok[:, None, None])
    return sel, yf + off, xf + off, w


def b2_pixels(*a) -> int:
    """Window pixels (keypoint x pixel) kernel B2 adds to a bin."""
    return int(b2_windows(*a)[0].sum())


def b3_pixels(*a) -> int:
    """Window pixels (keypoint x pixel) kernel B3 adds to a bin."""
    return int(b3_windows(*a)[0].sum())


def read_pixels(sel, rows, cols, w: int) -> int:
    """The distinct image pixels that windows ``sel`` (from ``b2_windows``
    or ``b3_windows``) cover: what a walk must read, each pixel once."""
    import torch

    idx = rows[:, :, None] * w + cols[:, None, :]
    return int(torch.unique(idx[sel].long()).numel())


def kernel_bound(name: str, a: tuple) -> dict:
    """``bound`` of one call of kernel ``name`` with arguments ``a``,
    counted from what these inputs need: live rows and contributing
    window pixels, not capacities."""
    if name == "detect_compact":  # dogs [s_out + 2, h, w], gate, capacities
        dogs, caps = a[0], a[2]
        # gate + 26 neighbour compares per interior voxel
        ops = sum(27 * (d.shape[0] - 2) * max(d.shape[1] - 2, 0)
                  * max(d.shape[2] - 2, 0) for d in dogs)
        return bound(_nbytes(*dogs) + sum(caps) * (3 * 8 + 1) + 4 * len(dogs),
                     ops)
    if name in ("sift_orientation_hist", "sift_descriptors"):
        # the modulus and angle (f32 each) of the pixels the windows
        # cover, the live keypoints' inputs, the count, the outputs
        b2 = name == "sift_orientation_hist"
        sel, rows, cols, w = (b2_windows if b2 else b3_windows)(*a)
        n = int(a[5][0] if b2 else a[6][0])
        return bound(read_pixels(sel, rows, cols, w) * 8
                     + (3 if b2 else 4) * 4 * n + 4
                     + a[2].shape[0] * (36 if b2 else 128) * 4,
                     (B2_OPS_PER_PIXEL if b2 else B3_OPS_PER_PIXEL)
                     * int(sel.sum()))
    if name in ("l1_two_nearest_bidir", "l1_two_nearest"):
        q, r, qv, rv = a
        nq, nr = int(qv.sum()), int(rv.sum())
        outs = (q.shape[0] + r.shape[0]) if name == "l1_two_nearest_bidir" \
            else q.shape[0]
        return bound((nq + nr) * 128 * 4 + _nbytes(qv, rv) + outs * 12,
                     L1_OPS_PER_PAIR * nq * nr)
    if name == "pair_match_counts":  # one distance pass serves both ways
        desc, valid, pairs = a[:3]
        live = valid.sum(dim=1).tolist()
        ops = sum(L1_OPS_PER_PAIR * live[i] * live[j]
                  for i, j in pairs.tolist())
        return bound(sum(live) * 128 * 4 + _nbytes(valid, pairs)
                     + pairs.shape[0] * 8, ops)
    if name in B6_BRANCH.values():  # src, coeffs, ox, oy, (h, w), model
        src, (ho, wo) = a[0], a[4]
        model = a[5] if len(a) > 5 else "bilinear"
        c = src.shape[2] if src.dim() == 3 else 1
        # per canvas pixel: the offsets (2), the model (bilinear 14;
        # projective 21 with its guard and two divisions), truncation (2)
        # and the bounds test (4); the 44-48 bytes of parameters (by value,
        # or read from device memory)
        ops = (22 if model == "bilinear" else 29) * ho * wo
        return bound(b6_read_pixels(a) * c * 4 + 48 + ho * wo * c * 4, ops)
    if name == "separable_blur":  # x, taps, axis
        x, taps = a[0], a[1]
        # the input read once, the output written once, the taps; k
        # products and k - 1 sums an output
        return bound(2 * _nbytes(x) + _nbytes(taps),
                     (2 * taps.shape[0] - 1) * x.numel())
    raise KeyError(name)


def b6_read_pixels(a: tuple) -> int:
    """The source pixels that one B6 call ``a`` (src, coeffs, ox, oy,
    canvas, model) copies onto its canvas: what it must read, each pixel
    once. A canvas pixel copies one source pixel or none, so B6's plain
    version on an image of pixel ids (1-based, exact in float32) names
    them; a canvas stripe reads only the rows that map into it."""
    import torch

    src = a[0]
    hs, ws = int(src.shape[0]), int(src.shape[1])
    assert hs * ws < 2 ** 24, (hs, ws)
    ids = torch.arange(1, hs * ws + 1, dtype=torch.float32,
                       device=src.device).view(hs, ws, 1)
    got = b6_plain(ids, *a[1:]).flatten().long()
    seen = torch.zeros(hs * ws + 1, dtype=torch.bool, device=src.device)
    seen[got] = True
    return int(seen[1:].sum())


def panorama_bound(name: str, calls: list) -> dict:
    """The bounds of every call of one panorama, summed."""
    per = [kernel_bound(name, a) for a in calls]
    by = {"bytes": 0.0, "operations": 0.0}
    for b in per:
        by[b["bound_by"]] += b["bound_ms"]
    return {"bound_ms_per_panorama": sum(b["bound_ms"] for b in per),
            "bound_by_calls": {k: v for k, v in by.items() if v}}


def l1_library(q, r, both: bool):
    """PyTorch's own calls for the L1 2-NN, as a yardstick (``library_ms``;
    never called by the port): ``torch.cdist(p=1)`` then ``topk(2,
    largest=False)`` per direction."""
    import torch

    d = torch.cdist(q, r, p=1)
    fwd = torch.topk(d, 2, dim=1, largest=False)
    return (fwd, torch.topk(d, 2, dim=0, largest=False)) if both else fwd


def b8_plain(x, taps, axis):
    """B8's plain version: the shift-and-add of ``ops/gaussian.py``."""
    from computervisionimagestich2_tpu_torch.ops import gaussian

    return gaussian._shift_and_add(x, taps, axis)


def b8_kind(a: tuple) -> str:
    """The pass a B8 call ``a`` (x, taps, axis) makes: the scale space's
    along W or H ([H, W] levels) or the blend's ([H, W, 7] canvases)."""
    x, _, axis = a
    along_w = axis % x.dim() == (1 if x.dim() == 3 else x.dim() - 1)
    return ("blend_" if x.dim() == 3 else "sift_") + ("w" if along_w else "h")


def check_b8(calls: list) -> dict:
    """Kernel B8 against its plain version on every recorded call, on the
    card: equal bit for bit, or it raises. Returns the calls by pass
    (``b8_kind``) with their shapes, dtypes, radii and whether the input
    was strided (an octave's decimated base, a resized blend level)."""
    import torch

    from computervisionimagestich2_tpu_torch.ops import _native

    kinds: dict = {}
    for a in calls:
        kind = b8_kind(a)
        assert torch.equal(_native.separable_blur(*a), b8_plain(*a)), (
            "B8 != plain", kind, tuple(a[0].shape), a[0].dtype, a[2])
        k = kinds.setdefault(kind, {"calls": 0, "shapes": set(),
                                    "dtypes": set(), "radii": set(),
                                    "strided_inputs": 0})
        k["calls"] += 1
        k["shapes"].add(tuple(a[0].shape))
        k["dtypes"].add(str(a[0].dtype).removeprefix("torch."))
        k["radii"].add((a[1].shape[0] - 1) // 2)
        k["strided_inputs"] += not a[0].is_contiguous()
    return {"max_abs_err": 0.0, "calls_equal_plain": len(calls),
            "calls_by_pass": {n: {**k, **{f: sorted(k[f]) for f in (
                "shapes", "dtypes", "radii")}} for n, k in kinds.items()}}


def b8_by_pass(calls: list) -> dict:
    """B8 alone on the largest call of each pass (the first octave's
    plane, the blend's level 0; the most taps among equals): device time,
    bound and share, and the plain version's time."""
    from computervisionimagestich2_tpu_torch.ops import _native

    largest: dict = {}
    for a in calls:
        kind = b8_kind(a)
        if kind not in largest or (a[0].numel(), a[1].shape[0]) > (
                largest[kind][0].numel(), largest[kind][1].shape[0]):
            largest[kind] = a
    return {kind: timed_kernel(
        "separable_blur", a, lambda a=a: _native.separable_blur(*a),
        lambda a=a: b8_plain(*a), shape=list(a[0].shape),
        dtype=str(a[0].dtype).removeprefix("torch."),
        taps=int(a[1].shape[0]), axis=a[2])
        for kind, a in sorted(largest.items())}


def check_b1(a: tuple) -> dict:
    """Kernel B1 on the arguments ``a`` of one call (the DoG stacks of an
    image's octaves, threshold, capacities): every octave's coords, valid
    and n_total exactly the plain version's, and the same bits in a second
    run. Returns the largest difference of a coordinate, the octaves'
    shapes, capacities, kept and uncapped counts."""
    import torch

    from computervisionimagestich2_tpu_torch.ops import detect

    dogs, tp, caps = a
    got = detect.detect_compact_octaves(*a)
    again = detect.detect_compact_octaves(*a)
    kept, totals, err = [], [], 0
    for dog, cap, (ck, vk, nk), (ca, va, na) in zip(dogs, caps, got, again):
        cp, vp, np_ = detect.detect_compact_plain(dog, tp, cap)
        err = max(err, int((ck - cp).abs().max()))
        assert torch.equal(ck, cp) and torch.equal(vk, vp), \
            ("B1 must be exact", tuple(dog.shape))
        assert int(nk) == int(np_), (int(nk), int(np_))
        assert torch.equal(ck, ca) and torch.equal(vk, va) \
            and int(nk) == int(na), "B1 is not deterministic"
        kept.append(int(vk.sum()))
        totals.append(int(nk))
    return {"max_abs_err": err, "dogs": [list(d.shape) for d in dogs],
            "capacities": list(caps), "candidates": kept, "n_total": totals}


def b6_plain(src, coeffs, ox, oy, canvas, model="bilinear"):
    """B6's plain version on the arguments of a call (host coefficients
    become a tensor on the source's device; device ones stay there)."""
    import torch

    from computervisionimagestich2_tpu_torch.ops import warp

    c = (coeffs.to(src.device) if isinstance(coeffs, torch.Tensor) else
         torch.as_tensor(np.asarray(coeffs, np.float32), device=src.device))
    return warp.warp_image_plain(src, c, ox, oy, canvas, model)


def b6_forms(a: tuple) -> tuple:
    """One B6 call ``a`` (src, coeffs, ox, oy, canvas, model), whether its
    model and offsets are host floats or device tensors (the programs
    hand over the plan's rows), in both forms of the wrapper: (host floats,
    which take the by-value entry ``cvs_warp_image``; float32 tensors on
    the source's card, which take the device-parameter entry
    ``cvs_warp_image_dev``), with the same float32 values."""
    import torch

    src, c, ox, oy = a[:4]
    c = np.asarray(c.cpu().numpy() if isinstance(c, torch.Tensor) else c,
                   np.float32)
    ox, oy = float(np.float32(float(ox))), float(np.float32(float(oy)))
    host = (src, c.tolist(), ox, oy, *a[4:])
    dev = (src, torch.as_tensor(c, device=src.device),
           *(torch.tensor(v, dtype=torch.float32, device=src.device)
             for v in (ox, oy)), *a[4:])
    return host, dev


def b6_at(a: tuple) -> dict:
    """Kernel B6 on the arguments ``a`` (src, coeffs, ox, oy, canvas,
    model) of one call, through both entries (``b6_forms``): by value
    exact against plain, the device-parameter entry bit for bit equal to
    it; each entry's device time beside the bound (``ms`` by value,
    ``device_params_ms`` from device memory)."""
    import torch

    from computervisionimagestich2_tpu_torch.ops import warp

    host, dev = b6_forms(a)
    got = warp.warp_image(*host)
    assert torch.equal(got, b6_plain(*host)), ("B6 must be exact", a[4],
                                               a[5])
    assert torch.equal(warp.warp_image(*dev), got), \
        "B6: the device-parameter entry and the by-value one differ"
    name = B6_BRANCH[a[5]]
    row = {"model": a[5], "src": list(a[0].shape), "canvas": list(a[4]),
           "covered_share": float((got != 0).any(dim=2).float().mean()),
           **kernel_ms(lambda: warp.warp_image(*host), name),
           **kernel_bound(name, a), "device_params_equal_by_value": True}
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    dp = kernel_ms(lambda: warp.warp_image(*dev), name)
    row.update(device_params_ms=dp["ms"],
               device_params_ms_events=dp["ms_events"],
               device_params_ms_source=dp["ms_source"],
               device_params_share_of_bound=row["bound_ms"] / dp["ms"])
    return row


# a homography whose denominator 1 - x / 500 crosses 0 inside a canvas
# wider than 500 px: the canvas holds finite, infinite and NaN source
# coordinates, and only the finite in-bounds ones may gather
B6_HORIZON = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, -0.002, 0.0, 1.0]


def b6_twins(a: tuple) -> tuple:
    """An affine bilinear call and its projective twin from a recorded
    bilinear call ``a``: the xy terms dropped, the same map written as a
    homography, so both branches move the same bytes on the same canvas."""
    c = [float(v) for v in a[1]]
    affine = [c[0], c[1], 0.0, c[3], c[4], c[5], 0.0, c[7]]
    homography = [c[0], c[1], c[3], c[4], c[5], c[7], 0.0, 0.0, 1.0]
    return ((a[0], affine, *a[2:5], "bilinear"),
            (a[0], homography, *a[2:5], "projective"))


def b6_checks(main_last: tuple, big_last: tuple) -> dict:
    """B6's cases on the card, both models, each by value exact against
    plain and the device-parameter entry equal to it (``b6_at``): the main
    path's last
    canvas (530 x 1046 at 4 x 512x384) and the 1440x1080 path's (1489 x
    2948) as recorded and as affine / projective twins, timed side by side
    (the projective branch's cost over the bilinear one's on the same
    canvas and bytes); a canvas width that is not a multiple of 4, one
    channel, a 1 x 1 canvas, and a horizon crossing the canvas."""
    rows = {}
    for label, a in (("main_last", main_last), ("at_1440x1080_last", big_last)):
        bil, proj = b6_twins(a)
        rows[f"{label}_recorded"] = b6_at(a)
        rows[f"{label}_affine"] = b6_at(bil)
        rows[f"{label}_projective"] = b6_at(proj)
        rows[f"{label}_projective_over_bilinear"] = (
            rows[f"{label}_projective"]["ms"] / rows[f"{label}_affine"]["ms"])
    src, (h, w) = main_last[0], main_last[4]
    bil, proj = b6_twins(main_last)
    for model, a in (("bilinear", bil), ("projective", proj)):
        rows[f"{model}_w_not_4"] = b6_at((*a[:4], (h, 4 * (w // 4) - 3),
                                          model))
        rows[f"{model}_c1"] = b6_at((src[..., :1].contiguous(), *a[1:]))
        rows[f"{model}_1x1"] = b6_at((*a[:4], (1, 1), model))
    rows["projective_horizon"] = b6_at(
        (src, B6_HORIZON, 0.0, 0.0, (h, w), "projective"))
    assert 0 < rows["projective_horizon"]["covered_share"] < 0.5, rows
    assert rows["projective_w_not_4"]["canvas"][1] % 4, rows
    return rows


def kernel_row(name: str, calls: list, err, kern, plain, library=None,
               **extra) -> dict:
    """The kernels-line row of wrapper ``name``: its error against plain,
    the times of the kernel, of its plain version and of the library call
    (where one exists) on the first recorded call, that call's bound and
    the panorama's (``calls``: every call of one stitch). Printed as a
    ``kernel_check`` line."""
    kid, route, source, replaces = KERNELS[name]
    row = {"name": name, "id": kid, "route": route, "source": source,
           "replaces": replaces, "max_abs_err": float(err),
           **kernel_ms(kern, name), "plain_ms": cuda_ms(plain),
           "library_ms": cuda_ms(library) if library else None,
           **kernel_bound(name, calls[0]), **panorama_bound(name, calls),
           "calls_per_panorama": len(calls), **extra}
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    print(json.dumps({"kernel_check": row}), flush=True)
    return row


def b4_plain(a: tuple):
    """B4's plain version on a call ``a`` (qry, ref, qry_valid, ref_valid):
    the one-direction plain 2-NN each way."""
    from computervisionimagestich2_tpu_torch.ops import distance

    q, r, qv, rv = a
    return (distance.two_nearest_plain(q, r, qv, rv),
            distance.two_nearest_plain(r, q, rv, qv))


def check_b4(a: tuple, lib=None) -> dict:
    """Kernel B4 on one call ``a`` against its plain version, both
    directions: d1 / d2 rtol 1e-5, i1 equal where the 2-NN gap exceeds
    1e-4 d1; the same bits twice and the bits of B7 run each way; with
    ``lib`` (``l1_library`` on the live rows), d1 within 1e-4 of PyTorch's
    own call. Returns the largest d1 error, the live counts and the share
    of equal i1 per side."""
    import torch

    from computervisionimagestich2_tpu_torch.ops import distance

    q, r, qv, rv = a
    got = distance.two_nearest_bidir(*a)
    again = distance.two_nearest_bidir(*a)
    one_way = (distance.two_nearest(q, r, qv, rv),
               distance.two_nearest(r, q, rv, qv))
    plain = b4_plain(a)
    err, i1_equal = 0.0, []
    for side, ok in ((0, qv), (1, rv)):
        (k1, k2, ki), (p1, p2, pi) = got[side], plain[side]
        torch.testing.assert_close(k1[ok], p1[ok], rtol=1e-5, atol=0)
        torch.testing.assert_close(k2[ok], p2[ok], rtol=1e-5, atol=0)
        clear = ok & ((p2 - p1) > 1e-4 * p1)
        assert torch.equal(ki[clear], pi[clear])
        assert all(torch.equal(x, y)
                   for x, y in zip(got[side], again[side])), \
            "B4 is not deterministic"
        assert all(torch.equal(x, y)
                   for x, y in zip(got[side], one_way[side])), \
            "B4 and B7 disagree on the bits"
        if lib is not None:
            torch.testing.assert_close(lib[side].values[:, 0] if side == 0
                                       else lib[side].values[0], k1[ok],
                                       rtol=1e-4, atol=0)
        err = max(err, float((k1[ok] - p1[ok]).abs().max()))
        i1_equal.append(float((ki[ok] == pi[ok]).float().mean()))
    return {"max_abs_err": err, "queries": int(qv.sum()),
            "references": int(rv.sum()), "slots": [int(q.shape[0]),
                                                   int(r.shape[0])],
            "i1_equal_frac": i1_equal}


def check_kernels(rec: Recorder) -> list[dict]:
    """Each kernel against its plain version on the recorded main-path
    inputs of its first call, both on the card. Tolerances: B1 exact
    (coords, valid, n_total of every octave of the call); B2 raw histograms rtol 1e-5 (atol 1e-5 x
    max), B3 atol 2e-6, B4 d1/d2 rtol 1e-5 with i1 equal where the 2-NN gap
    exceeds 1e-4 d1, in both directions; B5 exact counts, short of the
    queries within 1e-5 of the ratio; B6 exact. B1-B5 give the
    same bits twice; B4 the bits of B7 each way; B5 the ratio counts of one B4
    launch per pair, exactly. Each row carries the bound of the first call
    and the bounds of the panorama's calls summed."""
    import torch

    from computervisionimagestich2_tpu_torch.ops import (_native, detect,
                                                         distance, sift_walks,
                                                         warp)

    args = rec.args
    rows = []

    def add(name, err, kern, plain, library=None, **extra):
        rows.append(kernel_row(name, rec.calls[name], err, kern, plain,
                               library, **extra))

    no_library = "no PyTorch call computes it"
    a = args["detect_compact"]
    assert len(a[0]) == 4, "the four octaves of an image in one call"
    tiny = [torch.zeros((3, 1, 8), device=a[0][0].device)] * len(a[0])
    b1 = check_b1(a)
    memset_ms = device_ms(lambda: detect.detect_compact_octaves(*a),
                          "detect_compact",
                          keys=BESIDE_KERNELS["detect_compact"])
    assert memset_ms, "B1's memset of the status words was not profiled"
    add("detect_compact", b1.pop("max_abs_err"),
        lambda: detect.detect_compact_octaves(*a),
        lambda: [detect.detect_compact_plain(d, a[1], c)
                 for d, c in zip(a[0], a[2])], library_note=no_library,
        **b1, memset_ms=memset_ms,
        launch_alone_ms=device_ms(
            lambda: detect.detect_compact_octaves(tiny, a[1], [1] * len(tiny)),
            "detect_compact"),
        launch_alone="the same number of stacks, one row each, capacity 1: "
                     "a block per stack that finds nothing",
        beside_the_kernel="ms, at_1440x1080 and launch_alone_ms hold the "
                          "launcher's memset of the scan's status words "
                          "(memset_ms); the profiles of whole stitches "
                          "hold the kernel only")

    a = args["sift_orientation_hist"]
    hk, okk = sift_walks.orientation_hist(*a)
    hk2, _ = sift_walks.orientation_hist(*a)
    hp, okp = sift_walks.orientation_hist_plain(*a)
    torch.testing.assert_close(hk, hp, rtol=1e-5,
                               atol=1e-5 * float(hp.abs().max()))
    assert torch.equal(okk, okp)
    assert torch.equal(hk, hk2), "B2 is not deterministic"
    add("sift_orientation_hist", (hk - hp).abs().max(),
        lambda: sift_walks.orientation_hist(*a),
        lambda: sift_walks.orientation_hist_plain(*a),
        library_note=no_library, keypoints=int(a[5][0]),
        slots=int(a[2].shape[0]), radius=a[6],
        window_pixels=b2_pixels(*a),
        no_keypoint_launch_ms=device_ms(
            lambda: sift_walks.orientation_hist(
                *a[:5], torch.zeros_like(a[5]), a[6]),
            "sift_orientation_hist"),
        no_keypoint_launch="the same call with n_valid = 0: the same grid, "
                           "every warp writes its zero row and exits")

    a = args["sift_descriptors"]
    dk, okk = sift_walks.descriptors(*a)
    dk2, _ = sift_walks.descriptors(*a)
    dp, okp = sift_walks.descriptors_plain(*a)
    torch.testing.assert_close(dk, dp, rtol=0, atol=2e-6)
    assert torch.equal(okk, okp)
    assert torch.equal(dk, dk2), "B3 is not deterministic"
    add("sift_descriptors", (dk - dp).abs().max(),
        lambda: sift_walks.descriptors(*a),
        lambda: sift_walks.descriptors_plain(*a), library_note=no_library,
        keypoints=int(a[6][0]), slots=int(a[2].shape[0]), radius=a[7],
        window_pixels=b3_pixels(*a))

    a = args["l1_two_nearest_bidir"]
    q, r, qv, rv = a
    lib_q, lib_r = q[qv].contiguous(), r[rv].contiguous()
    b4 = check_b4(a, l1_library(lib_q, lib_r, both=True))
    add("l1_two_nearest_bidir", b4.pop("max_abs_err"),
        lambda: distance.two_nearest_bidir(*a), lambda: b4_plain(a),
        library=lambda: l1_library(lib_q, lib_r, both=True),
        library_note="three calls: torch.cdist(p=1), then topk(2, "
                     "largest=False) along each side", **b4)

    a = args["pair_match_counts"]
    pk, diff, near = check_b5(a)
    add("pair_match_counts", diff,
        lambda: distance.pair_match_counts(*a),
        lambda: distance.pair_match_counts_plain(*a),
        library_note=no_library, images=int(a[0].shape[0]),
        slots=int(a[0].shape[1]), live=a[1].sum(dim=1).tolist(),
        pairs=a[2].tolist(), counts=pk.tolist(), near_ratio=near,
        equals_b4_counts=True)

    a = args["warp_image"]
    assert a[5] == "bilinear", a[5]
    add("warp_image", b6_err(a), lambda: warp.warp_image(*a),
        lambda: b6_plain(*a), **b6_extra(rec.calls["warp_image"]))

    calls = rec.calls["separable_blur"]
    a = calls[0]
    b8 = check_b8(calls)
    add("separable_blur", b8.pop("max_abs_err"),
        lambda: _native.separable_blur(*a), lambda: b8_plain(*a),
        library_note=no_library + " in tap order with each product and "
                                  "sum rounded", **b8,
        by_pass=b8_by_pass(calls))
    return rows


def b6_launch_floor(row: dict) -> dict:
    """B6 per panorama beside the floor its launches set: ``launches``
    times the device time of a launch alone, and the share of the bound
    the panorama could reach at that launch count, bound / (bound +
    floor)."""
    if row["launch_alone_ms"] is None:  # the profiler kept no window
        return {"launch_floor_ms_per_panorama": None,
                "share_ceiling_at_this_launch_count": None}
    floor = row["launches_per_panorama"] * row["launch_alone_ms"]
    bound_ms = row["bound_ms_per_panorama"]
    return {"launch_floor_ms_per_panorama": floor,
            "share_ceiling_at_this_launch_count": bound_ms / (bound_ms + floor)}


def b6_err(a: tuple) -> float:
    """B6 against its plain version on one call: exact, or it raises."""
    import torch

    from computervisionimagestich2_tpu_torch.ops import warp

    wk, wp = warp.warp_image(*a), b6_plain(*a)
    assert torch.equal(wk, wp), "B6 must be exact"
    return float((wk - wp).abs().max())


def b6_extra(calls: list) -> dict:
    """The fields of B6's kernels row beside its first call's: the
    panorama's last (largest) canvas (``b6_at``), and the device time of a
    launch on a 1 x 1 canvas (what a launch alone costs)."""
    from computervisionimagestich2_tpu_torch.ops import warp

    last = calls[-1]
    host, _ = b6_forms(calls[0])
    return {"library_note": "no PyTorch call computes it",
            "model": last[5], "canvas": list(calls[0][4]),
            "entry": "cvs_warp_image_dev (the model and offsets in device "
                     "memory, the plan's rows) on the main path; "
                     "by_value_ms: cvs_warp_image on the same call",
            "by_value_ms": device_ms(lambda: warp.warp_image(*host),
                                     B6_BRANCH[last[5]]),
            "at_last_canvas": b6_at(last),
            "launch_alone_ms": device_ms(
                lambda: warp.warp_image(*last[:4], (1, 1), last[5]),
                B6_BRANCH[last[5]], windows=10),
            "launch_alone": "the last call's arguments with a 1 x 1 canvas"}


def profile_run(stitcher, images) -> dict:
    """One warm stitch under ``torch.profiler`` (``profile_call``)."""
    return profile_call(lambda: stitcher.stitch(images),
                        OFF_MAIN_PATH | off_branch(stitcher.config.warp_model))


def check_matcher(feats_a, feats_b) -> dict:
    """Phase 6: kernel B7 through the matcher API. Returns its kernels
    row (launches = the l1_two_nearest launches of match_features +
    match_count; no B4 launch there)."""
    import torch

    from computervisionimagestich2_tpu_torch.models import matcher
    from computervisionimagestich2_tpu_torch.ops import _native, distance

    _native.reset_launch_counts()
    pairs = matcher.match_features(feats_a, feats_b)
    n = matcher.match_count(feats_a, feats_b)
    torch.cuda.synchronize()
    counts = _native.launch_counts()
    launches = counts["l1_two_nearest"]
    assert launches == 2 and counts["l1_two_nearest_bidir"] == 0, counts
    ab, _ = matcher.match_features_bidir(feats_a, feats_b)
    assert all(torch.equal(x, y) for x, y in zip(pairs, ab)), \
        "match_features(a, b) != match_features_bidir(a, b)[0]"
    assert int(n) == int(pairs.n_raw) > 20, (int(n), int(pairs.n_raw))

    # the repaired fault: a hole in the reference mask inside the live
    # prefix, and invalid queries inside the query prefix
    qry, ref = feats_b.desc, feats_a.desc
    qv, rv = feats_b.valid.clone(), feats_a.valid.clone()
    rv[10:30] = False
    qv[5:9] = False
    a = (qry, ref, qv, rv)
    d1k, d2k, i1k = distance.two_nearest(*a)
    d1p, d2p, i1p = distance.two_nearest_plain(*a)
    torch.testing.assert_close(d1k[qv], d1p[qv], rtol=1e-5, atol=0)
    torch.testing.assert_close(d2k[qv], d2p[qv], rtol=1e-5, atol=0)
    clear = qv & ((d2p - d1p) > 1e-4 * d1p)
    assert torch.equal(i1k[clear], i1p[clear])
    assert not ((i1k >= 10) & (i1k < 30) & qv).any(), "masked row won"
    assert (d1k[~qv] > 1e37).all() and (d2k[~qv] > 1e37).all()
    kid, route, source, replaces = KERNELS["l1_two_nearest"]
    m = (feats_b.desc, feats_a.desc, feats_b.valid, feats_a.valid)
    lib_q = feats_b.desc[feats_b.valid].contiguous()
    lib_r = feats_a.desc[feats_a.valid].contiguous()
    row = {"name": "l1_two_nearest", "id": kid,
           "route": route, "source": source, "replaces": replaces,
           "launches": launches,
           "max_abs_err": float((d1k[qv] - d1p[qv]).abs().max()),
           **kernel_ms(lambda: distance.two_nearest(*m), "l1_two_nearest"),
           "plain_ms": cuda_ms(lambda: distance.two_nearest_plain(*m)),
           "library_ms": cuda_ms(lambda: l1_library(lib_q, lib_r, False)),
           "library_note": "two calls: torch.cdist(p=1), then topk(2, "
                           "largest=False)",
           **kernel_bound("l1_two_nearest", m),
           "launches_per_panorama": 0, "device_ms_per_panorama": None,
           "queries": int(feats_b.valid.sum()),
           "references": int(feats_a.valid.sum()),
           "masked_references": int((~rv[:int(feats_a.valid.sum())]).sum()),
           "matches": int(pairs.n_raw),
           "i1_equal_frac": float((i1k[qv] == i1p[qv]).float().mean())}
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    print(json.dumps({"kernel_check": row}), flush=True)
    return row


def run(stitcher, images, **kw):
    t = time.perf_counter()
    out = stitcher.stitch(images, **kw)
    return out, time.perf_counter() - t


def check_launches(launches: dict, off_path=(), b4=None,
                   model: str = "bilinear") -> dict:
    """Every kernel of the path launched; none off it (B7 is off every
    stitch path, and B6's branch of the other warp model); with ``b4``,
    B4 launched that many times (once per edge, and once per image pair
    where B4 gives the graph counts)."""
    off_path = set(off_path) | OFF_MAIN_PATH | off_branch(model)
    wrong = {n: c for n, c in launches.items()
             if (c == 0) != (n in off_path)}
    assert not wrong, f"launches {launches}, off the path: {sorted(off_path)}"
    assert b4 is None or launches["l1_two_nearest_bidir"] == b4, (b4,
                                                                  launches)
    return launches


def counted_run(stitcher, images, **kw):
    """One run with the launch counts set to 0 just before it; returns
    (panorama, seconds, launches of the run)."""
    from computervisionimagestich2_tpu_torch.ops import _native

    _native.reset_launch_counts()
    out, secs = run(stitcher, images, **kw)
    return out, secs, _native.launch_counts()


def one_step(out_a, out_b) -> dict:
    """tests/test_integration.py:151-154: equal shape, isolated one-step
    u8 differences only."""
    assert out_a.shape == out_b.shape, (out_a.shape, out_b.shape)
    diff = np.abs(out_a.astype(int) - out_b.astype(int))
    frac = float((diff > 0).mean())
    assert diff.max() <= 1 and frac < 1e-3, (int(diff.max()), frac)
    return {"max_diff": int(diff.max()), "diff_frac": frac}


def mean_diff(out_a, out_b) -> float:
    """Mean |diff| in u8 levels between two canvases of one shape."""
    assert out_a.shape == out_b.shape, (out_a.shape, out_b.shape)
    return float(np.abs(out_a.astype(int) - out_b.astype(int)).mean())


def cli_phase(images, out_exact, flags=()) -> tuple[dict, np.ndarray]:
    """Phase 8: the command line in a fresh interpreter on 1.bmp..4.bmp,
    with ``flags`` beside ``--timing``, held against the in-process
    ``Stitcher`` under the configuration its flags give (by default
    ``DEFAULT_CONFIG`` with bucketed canvases). ``-X importtime`` lists
    every module the process imported; the BMP codec it took (its log
    line) must be the native one. Returns the report and the in-process
    canvas."""
    import tempfile

    from computervisionimagestich2_tpu_torch import cli
    from computervisionimagestich2_tpu_torch.models.stitcher import Stitcher
    from computervisionimagestich2_tpu_torch.utils import (load_image,
                                                           save_image)

    with tempfile.TemporaryDirectory() as d:
        for k, img in enumerate(images):
            save_image(f"{d}/{k + 1}.bmp", img)
        argv = ["--input", d, "--output", f"{d}/out.bmp", "--timing",
                *flags]
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-X", "importtime", "-m",
             "computervisionimagestich2_tpu_torch.cli"] + argv,
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t
        assert proc.returncode == 0, proc.stderr[-4000:]
        out = load_image(f"{d}/out.bmp")
        cfg = cli.build_config(cli.make_parser().parse_args(argv))
    assert not cfg.exact_canvas
    imported = [line.rsplit("|", 1)[-1].strip()
                for line in proc.stderr.splitlines()
                if line.startswith("import time:")]
    assert len(imported) > 100, proc.stderr[-2000:]
    jax_mods = [m for m in imported if m.split(".")[0] in ("jax", "jaxlib")]
    assert not jax_mods, jax_mods
    jax_pkg = [m for m in imported if m == "computervisionimagestich2_tpu"
               or m.startswith("computervisionimagestich2_tpu.")]
    assert not jax_pkg, jax_pkg
    codec = [line for line in proc.stderr.splitlines() if " codec=" in line]
    assert len(codec) == 1 and " codec=native " in codec[0], codec
    stages, launches, total = {}, None, None
    for line in proc.stdout.splitlines():
        if line.startswith("kernel launches:"):
            launches = json.loads(line.split(":", 1)[1])
        elif line.startswith("total time:"):
            total = float(line.split(":")[1].split()[0])
        elif line.endswith(" s") and ":" in line:
            name, secs = line.split(":")
            stages[name] = float(secs.split()[0])
    assert total is not None and launches is not None, proc.stdout
    check_launches(launches, b4=3)
    st = Stitcher(cfg, device="cuda")
    _, cold_s = run(st, images)
    out_b, warm_s, launches_b = counted_run(st, images)
    check_launches(launches_b, b4=3)
    return {"argv_flags": list(flags), "canvas": list(out.shape),
            "total_s": total, "stage_s": stages, "codec": codec[0],
            "subprocess_wall_s": wall, "launches": launches,
            "modules_imported": len(imported), "jax_modules": len(jax_mods),
            "jax_package_modules": len(jax_pkg),
            "mad_vs_stitcher": canvas_vs_cpu(out, out_b),
            "equals_stitcher": bool(np.array_equal(out, out_b)),
            "stitcher_cold_s": cold_s, "stitcher_warm_s": warm_s,
            "stitcher_launches": launches_b,
            "stitcher_stage_s": dict(st.stage_times),
            "mean_diff_vs_exact": mean_diff(out_exact, out)}, out_b


def eager_and_graphs(call, equal, off, replays) -> tuple[dict, object]:
    """Phases 9-11 and 14: the programs on one path against their eager
    run. ``call()`` runs the path once (synchronised) and returns (its
    output, its stage seconds). Under ``disable_graphs()`` a cold and a
    warm run, then with every graph dropped first a cold, a warm and a
    traced run (``torch.profiler``) with graphs. The five outputs are
    equal bit for bit (``equal(a, b)``) and so are the warm runs' launch
    counts; each mode reports its runs' seconds, stage seconds, launches,
    captures and replays by program. With graphs the warm and traced runs
    capture nothing and replay each program as ``replays`` says (by
    program, exact), the traced run launches that many graphs with no
    host-to-device copy inside one and every launch counter equals the
    device kernels of its trace; eager makes no capture and no replay (a
    trace of the eager path is phase 18's). ``replays`` may also be a
    function of the eager cold run's output that gives them. Returns
    (report, the warm graph run's output)."""
    import torch

    from computervisionimagestich2_tpu_torch.core import programs
    from computervisionimagestich2_tpu_torch.ops import _native

    modes, outs = {}, {}
    for mode in ("eager", "graphs"):
        with (programs.disable_graphs() if mode == "eager"
              else contextlib.nullcontext()):
            programs.clear_graphs()
            rep = {}
            runs = (("cold", "warm", "traced") if mode == "graphs"
                    else ("cold", "warm"))
            for run_ in runs:
                c = programs.capture_stats()
                _native.reset_launch_counts()
                t = time.perf_counter()
                if run_ == "traced":
                    got = []
                    prof = profile_call(lambda: got.append(call()), off)
                    out = got[0][0]
                else:
                    out, stages = call()
                secs = time.perf_counter() - t
                d = programs.captures_since(c)
                outs[(mode, run_)] = out
                rep[run_] = {"s": secs, "launches": _native.launch_counts(),
                             "captures": d["captures"],
                             "capture_s": d["capture_s"],
                             "captures_by_program": d["by_program"],
                             "replays_by_program": d["replays_by_program"],
                             "overflows": d["overflows"]}
                if run_ != "traced":
                    rep[run_]["stage_s"] = stages
            modes[mode] = rep
    wrong = launches_vs_trace(prof["kernels"])
    assert not wrong, ("launch counters != the trace", wrong)
    ref = outs[("eager", "cold")]
    for key, out in outs.items():
        assert equal(out, ref), ("graphs != eager", key)
    if callable(replays):
        replays = replays(ref)
    eager, graphs = modes["eager"], modes["graphs"]
    assert eager["warm"]["launches"] == graphs["warm"]["launches"], (
        eager["warm"]["launches"], graphs["warm"]["launches"])
    for run_ in ("cold", "warm"):
        assert eager[run_]["captures"] == 0, eager[run_]
        assert not eager[run_]["replays_by_program"], eager[run_]
    for run_ in ("warm", "traced"):
        assert graphs[run_]["captures"] == 0, graphs[run_]
        assert graphs[run_]["replays_by_program"] == replays, (
            graphs[run_], replays)
        assert graphs[run_]["overflows"] == 0, graphs[run_]
    assert set(graphs["cold"]["captures_by_program"]) == set(replays), \
        graphs["cold"]
    graphs["profile"] = {k: prof[k] for k in PROFILE_KEYS}
    graphs["launches_vs_trace"] = {
        n: [k["counted_launches"], k["device_launches"]]
        for n, k in prof["kernels"].items()}
    assert prof["graph_launches"] == sum(replays.values()), prof
    assert prof["memcpy_htod_in_replays"] == 0, prof
    return ({"equal": {"outputs": True, "launches": True},
             "eager": eager, "graphs": graphs,
             "warm_ratio": graphs["warm"]["s"] / eager["warm"]["s"]},
            outs[("graphs", "warm")])


def stitch_call(st, images):
    """``eager_and_graphs``'s call for a Stitcher: a stitch and its stage
    seconds."""
    return lambda: (st.stitch(images), dict(st.stage_times))


def incremental_phase(images, out_planned, out_bucketed, config) -> dict:
    """Phase 9 on the crops of phase 3: the incremental stitch with its
    programs as graphs against eager (``eager_and_graphs``: the features
    program, the ordering, ``register_edge`` once per edge, the composite
    + blend, the tail), and against the planned canvas; bucketed against
    exact canvases (enhanced, and the
    blend alone: the padded canvas changes the pyramid's depth, so the two
    differ everywhere a little, in the JAX package too; the gate is the
    CPU comparison below); a dump and a resume; the incremental bucketed
    canvas against the CPU run of the port on the dumped features."""
    import dataclasses
    import shutil
    import tempfile

    from computervisionimagestich2_tpu_torch.models.stitcher import Stitcher

    rep = {}
    inc = dataclasses.replace(config, planned=False)
    st = Stitcher(inc, device="cuda")
    n = len(images)
    # the frames, the ordering's counts, each edge's registration and
    # composite + blend, the enhance tail
    rep["graphs_vs_eager"], out_i = eager_and_graphs(
        stitch_call(st, images), np.array_equal,
        OFF_MAIN_PATH | off_branch(inc.warp_model), {
            "project_and_extract": n, "all_pairs_match_counts": 1,
            "register_edge": n - 1, "composite_and_blend": n - 1,
            "equalize_and_mix": 1})
    warm = rep["graphs_vs_eager"]["graphs"]["warm"]
    rep["incremental_launches"] = check_launches(warm["launches"], b4=n - 1)
    rep["incremental_vs_planned"] = one_step(out_planned, out_i)

    rep["bucketed_vs_exact_mean_diff"] = mean_diff(out_planned, out_bucketed)
    off = dataclasses.replace(config.enhance, enabled=False)
    raw = [Stitcher(dataclasses.replace(config, enhance=off, exact_canvas=e),
                    device="cuda").stitch(images) for e in (True, False)]
    rep["bucketed_vs_exact_blend_mean_diff"] = mean_diff(*raw)

    both = dataclasses.replace(config, planned=False, exact_canvas=False)
    with tempfile.TemporaryDirectory() as d:
        out_d, rep["dump_s"] = run(
            Stitcher(both, device="cuda", artifact_dir=f"{d}/card"), images)
        st = Stitcher(both, device="cuda", artifact_dir=f"{d}/card")
        st.prepare = None  # a resume must not run SIFT
        out_r, rep["resume_s"], rep["resume_launches"] = counted_run(
            st, images, resume=True)
        assert np.array_equal(out_d, out_r), "resume is not bit-identical"
        check_launches(rep["resume_launches"], {
            "detect_compact", "sift_orientation_hist", "sift_descriptors"},
            b4=3)
        rep["resume_stage_s"] = dict(st.stage_times)
        shutil.copytree(f"{d}/card", f"{d}/cpu")
        st = Stitcher(both, device="cpu", artifact_dir=f"{d}/cpu")
        st.prepare = None
        t = time.perf_counter()
        out_c = st.stitch(images, resume=True)
        rep["cpu_resumed_s"] = time.perf_counter() - t
    rep["mad_vs_cpu"] = canvas_vs_cpu(out_d, out_c)
    rep["canvas"] = list(out_d.shape)
    return rep


def stitch_phase(images, config, cpu: str | None = "full", record=(),
                 off_path=(), chain: bool = True, mesh_sp: int = 0) -> tuple:
    """One configuration's stitch of scrambled crops on the card: graph
    discovery finds the scene's chain (with ``chain``; else the edges it
    finds are recorded, beside the CPU run's); a cold run (recording the
    calls of the wrappers ``record``, the SIFT telemetry and the last
    blend's arguments) and a warm run with its launch counts (every kernel
    of the path, none of ``off_path``, B4 unless off the path and B6's
    branch of ``config.warp_model`` once per stitched image); no
    ``match_overflow`` is logged; the canvas against the port's CPU run
    (``cpu="full"``: from the images; ``"resumed"``: on the features the
    card's run dumped, SIFT skipped; None: no CPU run). With ``mesh_sp``,
    both runs are mesh Stitchers of that many stripes on a virtual mesh
    (the card's, the CPU's), and B6 launches once per stripe of each edge. Returns (report,
    recorder, stitcher, the last blend's arguments: None where every edge
    took the sharded path, which calls no ``blend_edge``)."""
    import shutil
    import tempfile

    from computervisionimagestich2_tpu_torch.models import stitcher as stm
    from computervisionimagestich2_tpu_torch.parallel import make_mesh

    def mesh(device):
        return (make_mesh(mesh_sp, sp=mesh_sp, devices=[device] * mesh_sp)
                if mesh_sp else None)

    rep = {}
    with tempfile.TemporaryDirectory() as d:
        art = f"{d}/card" if cpu == "resumed" else None
        st = stm.Stitcher(config, device="cuda", artifact_dir=art,
                          mesh=mesh("cuda:0"))
        seen = record_ordering(st)
        with telemetry() as tel, Recorder(record) as rec:
            _, rep["cold_s"] = run(st, images)
        rep["stage_s_cold"] = dict(st.stage_times)
        out, rep["warm_s"], launches = counted_run(st, images)
        warned = [w["stage"] for w in tel["warnings"]]
        rep["edges"] = check_chain(seen) if chain else graph_edges(seen)
        rep["start"] = seen["start"]
        n_stitched = len(images) - 1  # a spanning tree ("skip" revisits)
        check_launches(launches, off_path, model=config.warp_model,
                       b4=None if "l1_two_nearest_bidir" in off_path
                       else n_stitched)
        assert launches[B6_BRANCH[config.warp_model]] == n_stitched * max(
            mesh_sp, 1), launches
        assert "match_overflow" not in warned, warned
        rep.update(canvas=list(out.shape),
                   stage_s_warm=dict(st.stage_times), launches=launches,
                   warnings=sorted(set(warned)),
                   sift_dropped=tel["sift_dropped"])
        assert out.mean() > 20, "empty canvas"
        if cpu is None:
            return rep, rec, st, tel["last_blend"]
        t = time.perf_counter()
        if cpu == "resumed":
            shutil.copytree(f"{d}/card", f"{d}/cpu")
            st_cpu = stm.Stitcher(config, device="cpu",
                                  artifact_dir=f"{d}/cpu", mesh=mesh("cpu"))
            st_cpu.prepare = None  # a resume must not run SIFT
        else:
            st_cpu = stm.Stitcher(config, device="cpu", mesh=mesh("cpu"))
        seen_cpu = record_ordering(st_cpu)
        out_cpu = st_cpu.stitch(images, resume=cpu == "resumed")
        rep["cpu_s"] = time.perf_counter() - t
        rep["cpu_edges"] = graph_edges(seen_cpu)
    rep.update(cpu_canvas=list(out_cpu.shape), cpu_run=cpu,
               mad_vs_cpu=canvas_vs_cpu(out, out_cpu))
    return rep, rec, st, tel["last_blend"]


def check_walks(rec: "Recorder") -> dict:
    """B1 exact on every octave of the first recorded call (``check_b1``),
    and B2 (rtol 1e-5, atol 1e-5 x max) and B3 (atol 2e-6) against their
    plain versions on the first recorded call (the first octave's first
    level), as ``check_kernels`` holds them."""
    import torch

    from computervisionimagestich2_tpu_torch.ops import sift_walks

    rep = {"detect_compact": check_b1(rec.args["detect_compact"])}
    a = rec.args["sift_orientation_hist"]
    hk, okk = sift_walks.orientation_hist(*a)
    hp, okp = sift_walks.orientation_hist_plain(*a)
    torch.testing.assert_close(hk, hp, rtol=1e-5,
                               atol=1e-5 * float(hp.abs().max()))
    assert torch.equal(okk, okp)
    a = rec.args["sift_descriptors"]
    dk, okk = sift_walks.descriptors(*a)
    dp, okp = sift_walks.descriptors_plain(*a)
    torch.testing.assert_close(dk, dp, rtol=0, atol=2e-6)
    assert torch.equal(okk, okp)
    rep["walks"] = {"hist_max_abs_err": float((hk - hp).abs().max()),
                    "desc_max_abs_err": float((dk - dp).abs().max()),
                    "radius_hist": rec.args["sift_orientation_hist"][6],
                    "radius_desc": a[7],
                    "mod_shape": list(a[0].shape)}
    return rep


def blend_cost(args: tuple) -> dict:
    """One blend (``blend_edge``) on the card on recorded arguments: its
    time between CUDA events, its device kernels per call from
    ``torch.profiler``, and the same for the FIR blur on the same
    canvases."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from computervisionimagestich2_tpu_torch.models.blender import blend_edge

    a, b, bcfg = args[:3]
    out = {"canvas": list(a.shape)}
    for impl in ("vanvliet", "fir"):
        cfg = dataclasses.replace(bcfg, blur_impl=impl)
        fn = (lambda c=cfg: blend_edge(a, b, c, *args[3:]))
        ms = cuda_ms(fn, reps=3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = device_events(prof)
        out[impl] = {"ms": ms, "device_launches": sum(e.count for e in dev),
                     "device_ms": sum(dev_us(e) for e in dev) / 1e3}
    return out


MIXED_SHAPES = [(512, 384), (500, 384), (512, 360), (480, 384)]


def mixed_phase(scene_order, config) -> dict:
    """Phase 10: the crops of phase 3 cut to four shapes, scrambled; the
    programs as graphs against eager (``eager_and_graphs``: the features
    program per frame, the ordering's pair program per pair, then as in
    phase 9)."""
    from computervisionimagestich2_tpu_torch.models.stitcher import Stitcher

    images = scrambled([np.ascontiguousarray(img[:h, :w]) for img, (h, w)
                        in zip(scene_order, MIXED_SHAPES)])
    st = Stitcher(config, device="cuda")
    seen = record_ordering(st)
    n = len(images)
    pairs = n * (n - 1) // 2
    # the frames, one ordering program per pair, each edge's registration
    # and composite + blend, the enhance tail
    rep, out = eager_and_graphs(
        stitch_call(st, images), np.array_equal,
        OFF_MAIN_PATH | {"pair_match_counts"} | off_branch(config.warp_model),
        {"project_and_extract": n, "mixed_pair_counts": pairs,
         "register_edge": n - 1, "composite_and_blend": n - 1,
         "equalize_and_mix": 1})
    edges = check_chain(seen)
    assert st._feats_stacked is None
    launches = check_launches(rep["graphs"]["warm"]["launches"],
                              {"pair_match_counts"}, b4=pairs + len(edges))
    t = time.perf_counter()
    out_cpu = Stitcher(config, device="cpu").stitch(images)
    cpu_s = time.perf_counter() - t
    return {"images": [list(i.shape) for i in images], "edges": edges,
            "start": seen["start"], "canvas": list(out.shape),
            "launches": launches, "graphs_vs_eager": rep,
            "cpu_canvas": list(out_cpu.shape), "cpu_s": cpu_s,
            "mad_vs_cpu": canvas_vs_cpu(out, out_cpu)}


def stream_phase(config, h: int, w: int, n_frames: int, scale: int,
                 seed: int, cpu_check: bool) -> dict:
    """Phase 11 at one frame size: ``n_frames`` crops of one scene panning
    by w / 8, pushed one by one, a whole stream a run of
    ``eager_and_graphs`` (the SIFT program every push, ``register_edge``
    on every registration, a keyframe switch's again; the composite +
    blend eager in both modes); the per-push figures are the warm graph
    stream's, beside the warm eager one's; with ``cpu_check``, the first
    two frames again through the CPU run of the port, whose canvas the
    card's must match."""
    import torch

    from computervisionimagestich2_tpu_torch.models import compose
    from computervisionimagestich2_tpu_torch.models.streaming import (
        StreamingStitcher)
    from computervisionimagestich2_tpu_torch.ops import _native

    pan = w // 8
    scene = make_scene(np.random.default_rng(seed), h,
                       w + (n_frames - 1) * pan, scale)
    frames = [np.ascontiguousarray(scene[:, i * pan:i * pan + w])
              for i in range(n_frames)]

    def stream(device):
        return StreamingStitcher(config, max_width=4096, project=True,
                                 anchor="keyframe", device=device)

    def stat(vals):
        return {"median": statistics.median(vals), "worst": max(vals)}

    per_frame = {}

    def one_stream():
        ss = stream("cuda")
        per = []
        before = _native.launch_counts()
        for f in frames:
            t = time.perf_counter()
            hw = ss.push(f)
            secs = time.perf_counter() - t
            now = _native.launch_counts()
            per.append({"push_s": secs, "stage_s": dict(ss.stage_times),
                        "canvas": list(hw),
                        "launches": {k: now[k] - before[k] for k in now}})
            before = now
        per_frame["last"] = per
        steady = per[2:]
        return (ss.n_keyframe_switches, ss.canvas()), {
            "first_push_s": per[0]["push_s"],
            "push_s": stat([p["push_s"] for p in steady]),
            **{f"{k}_s": stat([p["stage_s"][k] for p in steady])
               for k in ("sift", "register", "composite")}}

    # the registrations: one a push after the first, one more a keyframe
    # switch (the eager stream's switches)
    rep, (n_switches, canvas) = eager_and_graphs(
        one_stream, lambda a, b: a[0] == b[0] and np.array_equal(a[1], b[1]),
        OFF_MAIN_PATH | {"pair_match_counts"} | off_branch(config.warp_model),
        lambda out: {"sift_extract_stats": n_frames,
                     "register_edge": n_frames - 1 + out[0]})
    n_reg = n_frames - 1 + n_switches
    per = per_frame["last"]  # the warm graph stream's
    launches = rep["graphs"]["warm"]["launches"]
    check_launches(launches, {"pair_match_counts"}, b4=n_reg)
    assert canvas.dtype == np.uint8 and canvas.shape[2] == 3
    # every canvas after the first frame lies on the bucket grid, the
    # rolling window holds the width at max_width
    for p in per[1:]:
        ch, cw = p["canvas"]
        assert ch == compose.bucket_size(ch, config.canvas_bucket), p
        assert cw <= 4096, p
    content = canvas[:h].max(axis=2) > 0

    two, two_s, mad = {}, {}, None
    for device in ("cuda", "cpu") if cpu_check else ():
        two[device] = stream(device)
        t = time.perf_counter()
        for f in frames[:2]:
            two[device].push(f)
        two_s[device] = time.perf_counter() - t
    if cpu_check:
        mad = canvas_vs_cpu(two["cuda"].canvas(), two["cpu"].canvas())
    warm = rep["graphs"]["warm"]["stage_s"]
    return {"frames": n_frames, "frame": [h, w], "pan": pan,
            **warm, "eager_warm": rep["eager"]["warm"]["stage_s"],
            "keyframe_switches": n_switches, "registrations": n_reg,
            "canvas": list(canvas.shape),
            "canvas_keys": len({tuple(p["canvas"]) for p in per}),
            "content_cols_top_rows": int(content.any(axis=0).sum()),
            "launches": launches, "per_frame": per,
            "graphs_vs_eager": rep,
            "two_frames_mad_vs_cpu": mad, "two_frames_s": two_s,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


BATCH_SEEDS = (0, 3)  # the batch's two panoramas: "Input/" and "Input2/"


def batched_phase(h: int, w: int, step: int, scale: int,
                  cpu_check: bool) -> dict:
    """Phase 14 at one frame size: ``batched_stitch_chain`` (BASELINE
    config 3) on B = 2 panoramas of four crops in scene order, one from
    each of ``BATCH_SEEDS``, on the default fixed canvas. A cold batch,
    then a warm one with its launch counts (B1 once per image, B4 and B6
    once per edge, B5 and B7 never); the median wall of three warm batches,
    one under ``torch.profiler`` (busy, idle; one graph launch a panorama,
    ``_stitch_one_fixed``'s, and no host-to-device copy inside it), the
    peak memory of one; each panorama equal to ``_stitch_one_fixed`` on it
    alone, bit for bit, and the batch equal to its eager run
    (``disable_graphs``), canvases and plans; no
    ``batched_canvas_overflow``; which blend gates the canvas engages.
    With ``cpu_check``: each canvas against the CPU batch of the port
    (MAD <= 3 u8 levels), and each content extent equal to the canvas of
    the chain-ordered ``Stitcher`` (exact canvas, no enhancement) on the
    same images."""
    import dataclasses

    import torch

    from computervisionimagestich2_tpu_torch import DEFAULT_CONFIG
    from computervisionimagestich2_tpu_torch.core import programs
    from computervisionimagestich2_tpu_torch.models import blender
    from computervisionimagestich2_tpu_torch.models import stitcher as stm
    from computervisionimagestich2_tpu_torch.ops import _native
    from computervisionimagestich2_tpu_torch.parallel import batched

    cfg = DEFAULT_CONFIG
    pans = np.stack([np.stack(crops(h, w, step, scale, seed=sd))
                     for sd in BATCH_SEEDS])
    n_pan, k = pans.shape[:2]
    canvas = batched.default_canvas(h, w, k, cfg)

    def run_batch():
        t = time.perf_counter()
        out, plans = batched.batched_stitch_chain(pans, cfg, device="cuda")
        torch.cuda.synchronize()
        return out, plans, time.perf_counter() - t

    c0 = programs.capture_stats()
    with recorded_warnings() as warnings:
        _, _, cold_s = run_batch()
    captures = programs.capture_stats()["captures"] - c0["captures"]
    warned = [w["stage"] for w in warnings]
    _native.reset_launch_counts()
    out, plans, t1 = run_batch()
    launches = _native.launch_counts()
    warm = [t1] + [run_batch()[2] for _ in range(2)]
    n_edges = n_pan * (k - 1)
    check_launches(launches, {"pair_match_counts"}, b4=n_edges)
    assert launches["detect_compact"] == n_pan * k, launches
    assert launches["warp_image"] == n_edges, launches
    assert "batched_canvas_overflow" not in warned, warned
    assert tuple(out.shape) == (n_pan, *canvas, 3), out.shape
    seq = batched.chain_edge_seq(k)
    for i in range(n_pan):
        one, plan = batched._stitch_one_fixed(
            torch.as_tensor(pans[i], device="cuda"), cfg, canvas, seq)
        assert torch.equal(out[i], one), ("batch != one at a time", i)
        assert np.array_equal(plans[i], plan.cpu().numpy()), (
            "plans differ", i)
    with programs.disable_graphs():
        out_e, plans_e, eager_s = run_batch()
    assert torch.equal(out, out_e), "batch graphs != eager"
    assert np.array_equal(plans, plans_e, equal_nan=True), "plans != eager"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run_batch()
    peak = torch.cuda.max_memory_allocated()
    prof = profile_call(run_batch, OFF_MAIN_PATH | {"pair_match_counts"}
                        | off_branch(cfg.warp_model))
    assert prof["graph_launches"] == n_pan, prof["graph_launches"]
    assert prof["memcpy_htod_in_replays"] == 0, prof
    assert not launches_vs_trace(prof["kernels"]), prof["kernels"]
    rep = {"panoramas": int(n_pan), "images_per_panorama": int(k),
           "frame": [h, w], "seeds": list(BATCH_SEEDS),
           "canvas": list(canvas), "canvas_mpx": canvas[0] * canvas[1] / 1e6,
           "blend_bf16": blender.resolve_dtype(
               cfg.blend.dtype, *canvas, cfg.blend.bf16_auto_area) == "bf16",
           "blend_seam_band": blender.seam_auto_engaged(cfg.blend, *canvas),
           "content_wh": plans[:, -1, 20:22].astype(int).tolist(),
           "match_dropped": plans[:, :, 22].astype(int).tolist(),
           "cold_s": cold_s, "captures": captures,
           "warm_median_s": statistics.median(warm),
           "warm_s": warm, "eager_s": eager_s, "launches": launches,
           "equals_one_at_a_time": True, "equals_eager": True,
           "warnings": sorted(set(warned)),
           "peak_mem_gib": peak / 2 ** 30, "profile": prof,
           "b4_per_edge": b4_capacity(pans, cfg)}
    if cpu_check:
        chain = dataclasses.replace(cfg, ordering="chain")
        for i in range(n_pan):
            ex = stm.Stitcher(dataclasses.replace(
                chain, enhance=dataclasses.replace(cfg.enhance,
                                                   enabled=False)),
                device="cuda").stitch(list(pans[i]))
            assert plans[i, -1, 20] == ex.shape[1], (plans[i, -1], ex.shape)
            assert plans[i, -1, 21] == ex.shape[0], (plans[i, -1], ex.shape)
        t = time.perf_counter()
        ref, ref_plans = batched.batched_stitch_chain(pans, cfg, device="cpu")
        rep["cpu_s"] = time.perf_counter() - t
        rep["mad_vs_cpu"] = [canvas_vs_cpu(u8(out[i]), u8(ref[i]))
                             for i in range(n_pan)]
        rep["cpu_content_wh"] = ref_plans[:, -1, 20:22].astype(int).tolist()
        rep["content_equals_chain_stitcher"] = True
    return rep


def b4_capacity(pans, cfg) -> dict:
    """B4 as the batch's plan calls it: ``_stitch_one_fixed`` reads no
    live count back inside its program, so its plan matches on the
    features' whole capacity, where the eager plan before it matched on
    ``live_prefix`` (the same bits: tests/test_torch_batched.py::
    test_plan_on_full_capacity_equals_live_prefix). Member 0's first
    edge at both: the slots and B4's device time per edge."""
    import torch

    from computervisionimagestich2_tpu_torch.core import programs
    from computervisionimagestich2_tpu_torch.models.stitcher import (
        live_prefix)
    from computervisionimagestich2_tpu_torch.ops import distance
    from computervisionimagestich2_tpu_torch.parallel import batched

    with programs.disable_graphs():
        feats, _, _ = batched._project_and_extract(
            torch.as_tensor(pans[0], device="cuda"), cfg)
    src, dst, _ = batched.chain_edge_seq(pans.shape[1])[0]
    out = {"live": int(feats.valid.sum(dim=1).max())}
    for label, f in (("full_capacity", feats),
                     ("live_prefix", live_prefix(feats))):
        a = (f.desc[src], f.desc[dst], f.valid[src], f.valid[dst])
        out[label] = {"slots": int(f.desc.shape[1]), "device_ms": device_ms(
            lambda: distance.two_nearest_bidir(*a), "l1_two_nearest_bidir")}
    return out


def register_phase(scene_order, b7: dict) -> dict:
    """Phase 14's registration: ``batched_pairwise_register`` on the B = 3
    neighbouring pairs of the 512x384 crops (luma, unprojected). A cold
    call, then one recorded (eager) with its launch counts (B7 once per
    pair, B1 once per image, B4, B5 and B6 never); the pairs as graphs
    against eager (``eager_and_graphs``: ``_register_one`` replayed once
    a pair, the same launches, coefficients and inliers equal to the
    recorded call's); B7 against its plain version on each of
    its calls (d1 / d2 rtol 1e-5, i1 equal where the 2-NN gap is clear);
    its device time per call (``kernel_ms``) and per batch (their sum); the
    warps and inlier counts against the port's CPU run at
    tests/test_parallel.py's tolerances (an 8 x 8 grid within 2 px, counts
    within 10% + 2). Fills B7's kernels row with the batch's numbers."""
    import torch

    from computervisionimagestich2_tpu_torch import DEFAULT_CONFIG
    from computervisionimagestich2_tpu_torch.ops import _native, distance
    from computervisionimagestich2_tpu_torch.ops.color import to_gray
    from computervisionimagestich2_tpu_torch.ops.warp import warp_points
    from computervisionimagestich2_tpu_torch.parallel import batched

    cfg = DEFAULT_CONFIG
    gray = [to_gray(torch.as_tensor(c, device="cuda").float())
            for c in scene_order]
    ga, gb = torch.stack(gray[:-1]), torch.stack(gray[1:])
    n = ga.shape[0]

    def register():
        out = batched.batched_pairwise_register(ga, gb, cfg, "cuda")
        torch.cuda.synchronize()
        return out

    register()
    _native.reset_launch_counts()
    with Recorder(("l1_two_nearest",)) as rec:
        t = time.perf_counter()
        coeffs, inliers = register()
        secs = time.perf_counter() - t
    launches = _native.launch_counts()
    on_path = {"detect_compact", "sift_orientation_hist", "sift_descriptors",
               "l1_two_nearest", "separable_blur"}

    def timed_register():
        t = time.perf_counter()
        out = register()
        return out, {"register_s": time.perf_counter() - t}
    graphs_rep, (coeffs_g, inliers_g) = eager_and_graphs(
        timed_register, lambda a, b: all(map(torch.equal, a, b)),
        set(KERNELS) - on_path, {"register_one": n})
    assert torch.equal(coeffs_g, coeffs) and torch.equal(inliers_g, inliers)
    for counts in (launches, graphs_rep["graphs"]["warm"]["launches"]):
        assert all((c > 0) == (k in on_path) for k, c in counts.items()), \
            counts
        assert counts["l1_two_nearest"] == n, counts
        assert counts["detect_compact"] == 2 * n, counts
    calls = rec.calls["l1_two_nearest"]
    err = 0.0
    for a in calls:
        k, p = distance.two_nearest(*a), distance.two_nearest_plain(*a)
        ok = a[2]
        torch.testing.assert_close(k[0][ok], p[0][ok], rtol=1e-5, atol=0)
        torch.testing.assert_close(k[1][ok], p[1][ok], rtol=1e-5, atol=0)
        clear = ok & ((p[1] - p[0]) > 1e-4 * p[0])
        assert torch.equal(k[2][clear], p[2][clear])
        err = max(err, float((k[0][ok] - p[0][ok]).abs().max()))
    per_call = [kernel_ms(lambda a=a: distance.two_nearest(*a),
                          "l1_two_nearest") for a in calls]
    t = time.perf_counter()
    ref, ref_n = batched.batched_pairwise_register(ga.cpu(), gb.cpu(), cfg,
                                                   "cpu")
    cpu_s = time.perf_counter() - t
    w, h = ga.shape[2], ga.shape[1]
    px, py = (g.ravel() for g in torch.meshgrid(
        torch.linspace(4, w - 4, 8), torch.linspace(4, h - 4, 8),
        indexing="xy"))
    dev_px = []
    for i in range(n):
        xk, yk = warp_points(coeffs[i].cpu(), px, py)
        xr, yr = warp_points(ref[i], px, py)
        dev_px.append(float(torch.hypot(xk - xr, yk - yr).max()))
    assert max(dev_px) < 2.0, dev_px
    assert int((inliers.cpu() - ref_n).abs().max()) <= \
        0.1 * int(ref_n.max()) + 2, (inliers, ref_n)
    b7_batch_ms = sum(c["ms"] for c in per_call)
    b7.update(launches=launches["l1_two_nearest"],
              launches_per_batch=launches["l1_two_nearest"],
              device_ms_per_batch=b7_batch_ms,
              bound_ms_per_batch=sum(kernel_bound("l1_two_nearest", a)[
                  "bound_ms"] for a in calls),
              batch_max_abs_err=err,
              launches_note="batched_pairwise_register, 3 pairs at "
                            "512x384 (phase 14)")
    b7["share_of_bound_per_batch"] = (b7["bound_ms_per_batch"] / b7_batch_ms
                                      if b7_batch_ms else None)
    return {"pairs": int(n), "frame": list(ga.shape[1:]),
            "register_s": secs, "launches": launches,
            "graphs_vs_eager": graphs_rep,
            "b7_max_abs_err": err, "b7_per_call": per_call,
            "b7_queries_refs": [[int(a[2].sum()), int(a[3].sum())]
                                for a in calls],
            "b7_device_ms_per_batch": b7_batch_ms,
            "inliers": inliers.tolist(), "cpu_inliers": ref_n.tolist(),
            "warp_vs_cpu_px": dev_px, "cpu_s": cpu_s}


def decision_diffs(feats, pairs, distance_: str, method: str,
                   m: int) -> dict:
    """Ratio-test decisions of (distance_, method, m) against exact L1 on
    the card (B7) for every (query image, reference image) of ``pairs``:
    the decisions that differ and, among queries both keep, the nearest
    indices that differ."""
    from computervisionimagestich2_tpu_torch import DEFAULT_CONFIG
    from computervisionimagestich2_tpu_torch.ops import distance

    ratio = DEFAULT_CONFIG.match.ratio_threshold
    out = {"decisions": 0, "nearest": 0, "queries": 0, "exact_matches": 0}
    for q, r in pairs:
        a = (feats.desc[q], feats.desc[r], feats.valid[q], feats.valid[r])
        ok_e, i_e = distance.ratio_match(*a, ratio)
        ok_s, i_s = distance.ratio_match(*a, ratio, distance_, method, m)
        out["decisions"] += int((ok_e != ok_s).sum())
        out["nearest"] += int((ok_e & ok_s & (i_e != i_s)).sum())
        out["queries"] += int(a[2].sum())
        out["exact_matches"] += int(ok_e.sum())
    return out


def match_strategy_phase(images) -> dict:
    """Phase 15: ``match.method="l2pre"`` and ``match.distance="l2"`` at
    4 x 512x384 on the scrambled crops (``stitch_phase``: B4 and B5
    bypassed, as in the JAX package; l2pre must find the chain, l2's graph
    is recorded beside the CPU run's; the canvas against the port's CPU
    run on the card's features); each strategy's decision diffs
    against exact L1 over the chain's 3 edges x 2 directions (``l2pre_m``)
    and the 12 directed count pairs (``l2pre_m_counts``); and per edge,
    both directions on the stitch's descriptors, the strategy's device
    time (every device kernel it runs, ``torch.profiler``) beside B4's."""
    import dataclasses

    from computervisionimagestich2_tpu_torch import DEFAULT_CONFIG
    from computervisionimagestich2_tpu_torch.ops import distance

    mcfg = DEFAULT_CONFIG.match
    # the scene's chain: images whose crops neighbour in the scene
    edges = [(i, j) for i in range(len(images)) for j in range(i + 1,
             len(images)) if abs(SCRAMBLE[i] - SCRAMBLE[j]) == 1]
    rep = {}
    for label, change in (("l2pre", dict(method="l2pre")),
                          ("l2", dict(distance="l2"))):
        t = time.perf_counter()
        cfg = dataclasses.replace(DEFAULT_CONFIG, match=dataclasses.replace(
            mcfg, **change))
        # squared L2 under the L1 ratio of 0.5 (0.71 on distances) passes
        # 20 matches between crops that do not overlap, in the JAX package
        # too: graph discovery finds more than the chain
        r, _, st, _ = stitch_phase(images, cfg, cpu="resumed", off_path={
            "l1_two_nearest_bidir", "pair_match_counts"},
            chain=label == "l2pre")
        feats = st._matching_feats()
        n = feats.desc.shape[0]
        dist, meth = cfg.match.distance, cfg.match.method
        r["diffs_edges"] = decision_diffs(
            feats, [p for i, j in edges for p in ((i, j), (j, i))], dist,
            meth, cfg.match.l2pre_m)
        r["diffs_counts"] = decision_diffs(
            feats, [(i, j) for i in range(n) for j in range(n) if i != j],
            dist, meth, cfg.match.l2pre_m_counts)
        per_edge = []
        for i, j in edges:
            a = (feats.desc[j], feats.desc[i], feats.valid[j], feats.valid[i])
            per_edge.append({
                "edge": [i, j], "live": [int(a[2].sum()), int(a[3].sum())],
                "b4_ms": device_ms(lambda a=a: distance.two_nearest_bidir(*a),
                                   "l1_two_nearest_bidir"),
                "b4_ms_events": cuda_ms(
                    lambda a=a: distance.two_nearest_bidir(*a)),
                f"{label}_ms": device_ms(
                    lambda a=a: distance.two_nearest_bidir(
                        *a, dist, meth, cfg.match.l2pre_m), "", keys=("",)),
                f"{label}_ms_events": cuda_ms(
                    lambda a=a: distance.two_nearest_bidir(
                        *a, dist, meth, cfg.match.l2pre_m))})
        r["per_edge_both_directions"] = per_edge
        r["strategy_s"] = time.perf_counter() - t
        rep[label] = r
    return rep


MESH_SPS = (2, 4, 8)  # the virtual meshes of phase 16a
MESH_SP = 4  # phase 16b-d: four stripes on the one card
# 16b's synthetic pair: the canvas of a 4 x 3840x2160 panorama (~30.7
# Mpx); 2304 rows = 2 * 4 * 2^5 * 9, so six pyramid levels shard over 4
BIG_PAIR_HW = (2304, 13312)


def record_edges(images, config) -> list:
    """The arguments of every composite + blend of one planned stitch of
    ``images`` on the card (``stitcher._composite_and_blend``), with the
    model and offsets it takes on the device read back as the mesh path
    takes them: the projected image, the previous result, the backward
    model (numpy), min_x, min_y (floats), the working canvas, ..."""
    from computervisionimagestich2_tpu_torch.models import stitcher as stm

    calls, fn = [], stm._composite_and_blend

    def rec(src, res, bwd, offsets, *rest):
        min_x, min_y = offsets.tolist()
        calls.append((src, res, bwd.cpu().numpy(), min_x, min_y, *rest))
        return fn(src, res, bwd, offsets, *rest)

    stm._composite_and_blend = rec
    try:
        stm.Stitcher(config, device="cuda").stitch(images)
    finally:
        stm._composite_and_blend = fn
    return calls


def mesh_composite_phase(edges) -> dict:
    """Phase 16a: ``sharded_composite`` of the recorded edges of one
    stitch on virtual meshes of ``MESH_SPS`` stripes on the card, each
    canvas's rows rounded up to a multiple of 2 * max(MESH_SPS)
    (``Stitcher._mesh_comp_hw`` at the largest mesh). B6 launches once
    per stripe and nothing else; the shifted stripes equal the
    single-device ``compose.composite``'s exactly, and the warped
    stripes' differing pixels are counted on every edge (the stripe
    offset is min_y + idx * m in float32, as in the JAX package, so y +
    that sum may round apart from (y + idx * m) + min_y: expected 0). On
    the last edge, B6's device time per call and per stripe, beside the
    bound of a stripe (the whole source read once, the stripe's rows
    written)."""
    import torch

    from computervisionimagestich2_tpu_torch.models import compose
    from computervisionimagestich2_tpu_torch.ops import _native, warp
    from computervisionimagestich2_tpu_torch.parallel import (
        blend as pblend, make_mesh, sharded_composite)
    from computervisionimagestich2_tpu_torch.parallel.mesh import gather_rows

    step = 2 * max(MESH_SPS)
    rep = {"edges": []}
    for e, edge in enumerate(edges):
        src, res, bwd, min_x, min_y, (h, w) = edge[:6]
        canvas = (-(-h // step) * step, w)
        a_e, b_e = compose.composite(src, res, bwd, min_x, min_y, canvas)
        row = {"edge_canvas": [h, w], "canvas": list(canvas),
               "min_xy": [min_x, min_y]}
        for sp in MESH_SPS:
            mesh = make_mesh(sp, sp=sp, devices=["cuda:0"] * sp)
            _native.reset_launch_counts()
            a_s, b_s = sharded_composite(src, res, bwd, min_x, min_y, canvas,
                                         mesh)
            torch.cuda.synchronize()
            launches = _native.launch_counts()
            assert launches["warp_image"] == sp == sum(launches.values()), \
                launches
            assert torch.equal(gather_rows(b_s, "cuda:0"), b_e), (e, sp)
            diff = (gather_rows(a_s, "cuda:0") != a_e).any(dim=2)
            row[f"sp{sp}_differing_pixels"] = int(diff.sum())
            row[f"sp{sp}_differing_rows"] = diff.any(dim=1).nonzero(
            ).flatten().tolist()[:20]
        rep["edges"].append(row)
    one = (src, bwd, min_x, min_y, canvas, "bilinear")
    rep["last_edge_single_device"] = {
        **kernel_ms(lambda: warp.warp_image(*one), "warp_image"),
        **kernel_bound("warp_image", one)}
    for sp in MESH_SPS:
        mesh = make_mesh(sp, sp=sp, devices=["cuda:0"] * sp)
        stripes, fn = [], pblend.warp_image

        def rec(*a):
            stripes.append(a)
            return fn(*a)

        pblend.warp_image = rec
        try:
            sharded_composite(src, res, bwd, min_x, min_y, canvas, mesh)
        finally:
            pblend.warp_image = fn
        assert len(stripes) == sp, len(stripes)

        def call(stripes=stripes):
            for a in stripes:
                warp.warp_image(*a)
        bounds = [kernel_bound("warp_image", a) for a in stripes]
        bound_ms = sum(b["bound_ms"] for b in bounds)
        dev = device_ms(call, "warp_image", reps=20, launches=sp, windows=10)
        queued = queued_ms(call)
        ms = dev if dev is not None else queued
        rep[f"sp{sp}"] = {
            "launches_per_call": sp, "ms_per_call": ms,
            "ms_source": "torch.profiler" if dev is not None else
            "CUDA events behind a queued sleep (profiler: no whole window)"
            if queued is not None else "not measured",
            "ms_per_call_queued_events": queued,
            "ms_per_stripe": None if ms is None else ms / sp,
            "bound_ms_stripes": [b["bound_ms"] for b in bounds],
            "bound_bytes_stripes": [b["bound_bytes"] for b in bounds],
            "bound_ms_per_call": bound_ms,
            "bound_by": sorted({b["bound_by"] for b in bounds}),
            "share_of_bound_per_call": None if ms is None else bound_ms / ms,
            "wall_ms_events_per_call": cuda_ms(
                lambda mesh=mesh: sharded_composite(
                    src, res, bwd, min_x, min_y, canvas, mesh))}
    return rep


def mesh_blend_phase(a, b, content_h, label: str) -> dict:
    """Phase 16b on one canvas pair: ``sharded_blend_two_images`` over a
    virtual mesh of ``MESH_SP`` stripes against ``blend_two_images``, in
    f32 (atol 2e-3) and bf16 (max abs < 4.0), the tolerances of
    tests/test_parallel.py; the time of each (CUDA events around calls in
    a row), the peak memory of one call and one profiled call (device busy
    time against the wall: how far the host holds the card back)."""
    import torch

    from computervisionimagestich2_tpu_torch.models.blender import (
        blend_two_images, n_levels)
    from computervisionimagestich2_tpu_torch.parallel import (
        make_mesh, sharded_blend_two_images)
    from computervisionimagestich2_tpu_torch.parallel.blend import (
        plan_shard_levels)
    from computervisionimagestich2_tpu_torch.parallel.mesh import gather_rows

    mesh = make_mesh(MESH_SP, sp=MESH_SP, devices=["cuda:0"] * MESH_SP)
    h, w = int(a.shape[0]), int(a.shape[1])
    levels = n_levels(h, w)
    rep = {"canvas": [h, w], "canvas_mpx": h * w / 1e6, "sp": MESH_SP,
           "levels": levels,
           "sharded_levels": plan_shard_levels(h, levels, MESH_SP, 2.0)}
    for dtype in ("f32", "bf16"):
        fns = {"single": lambda: blend_two_images(
                   a, b, content_h=content_h, dtype=dtype),
               "sharded": lambda: gather_rows(sharded_blend_two_images(
                   a, b, mesh, content_h=content_h, dtype=dtype), "cuda:0")}
        outs, r = {}, {}
        for name, fn in fns.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            outs[name] = fn()
            torch.cuda.synchronize()
            r[f"{name}_peak_gib"] = (torch.cuda.max_memory_allocated()
                                     - base) / 2 ** 30
            r[f"{name}_ms"] = cuda_ms(fn, reps=3)
            prof = profile_call(lambda fn=fn: (fn(), torch.cuda.synchronize()),
                                set(DEVICE_KERNELS))
            r[f"{name}_profile"] = {k: prof[k] for k in (
                "wall_s", "device_busy_ms", "idle_share", "device_events",
                "memcpy_htod_events")}
        err = float((outs["sharded"] - outs["single"]).abs().max())
        assert err <= (2e-3 if dtype == "f32" else 4.0), (label, dtype, err)
        r["max_abs_err"] = err
        rep[dtype] = r
        del outs
    print(json.dumps({"mesh_blend": label, **rep}), flush=True)
    return rep


def big_pair(h: int, w: int, seed: int = 0):
    """A synthetic canvas pair of a stitch edge, made on the card: a fills
    the left 2/3 and b the right 2/3 of [h, w, 3] with u8-valued noise,
    with zero borders (tests/test_parallel.py:46-52's layout)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def fill(rows, cols):
        n = (len(range(h)[rows]), len(range(w)[cols]), 3)
        return torch.floor(torch.rand(n, generator=g, device="cuda") * 240
                           + 10)
    a = torch.zeros((h, w, 3), device="cuda")
    b = torch.zeros((h, w, 3), device="cuda")
    a[8:-8, :2 * w // 3] = fill(slice(8, -8), slice(0, 2 * w // 3))
    b[4:-12, w // 3:] = fill(slice(4, -12), slice(w // 3, None))
    return a, b


def mesh_stitch_phase(images, b6: dict) -> dict:
    """Phase 16c: ``Stitcher(mesh=make_mesh(4, sp=4, devices=[cuda:0] *
    4))`` on the scrambled 1440x1080 images, bucketed canvases. With
    ``blend.seam_auto_area=0`` and ``blend.dtype="f32"``: graph discovery
    finds the chain, B6 launches once per stripe of every edge (so no edge
    fell back), every kernel of the path launched, and the panorama
    equals the single-device Stitcher's of that config within
    tests/test_parallel.py:310-313 ((|diff| > 1) share < 1e-3, max <= 16).
    Cold and warm walls (median of 3), one profiled run (device busy and
    idle share), peak memory; the same under the default blend settings
    (``dtype="auto"``, seam band above 2 Mpx), where the mesh gate, like
    the JAX package's, ignores the area-gated seam band: its distance from
    the single-device panorama of that config is recorded, not checked
    (ROADMAP §C). B6's mesh numbers go into its kernels row."""
    import dataclasses

    import torch

    from computervisionimagestich2_tpu_torch import DEFAULT_CONFIG
    from computervisionimagestich2_tpu_torch.models import stitcher as stm
    from computervisionimagestich2_tpu_torch.parallel import make_mesh

    mesh = make_mesh(MESH_SP, sp=MESH_SP, devices=["cuda:0"] * MESH_SP)
    auto = dataclasses.replace(DEFAULT_CONFIG, exact_canvas=False)
    f32 = dataclasses.replace(auto, blend=dataclasses.replace(
        auto.blend, seam_auto_area=0, dtype="f32"))
    rep = {"sp": MESH_SP}
    for label, cfg in (("f32_no_seam_auto", f32), ("default_blend", auto)):
        st = stm.Stitcher(cfg, device="cuda", mesh=mesh)
        seen = record_ordering(st)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out, cold_s = run(st, images)
        peak = torch.cuda.max_memory_allocated()
        edges = check_chain(seen)
        out_w, t1, launches = counted_run(st, images)
        warm = [t1] + [run(st, images)[1] for _ in range(2)]
        check_launches(launches, b4=len(edges))
        assert launches["warp_image"] == len(edges) * MESH_SP, launches
        prof = profile_run(st, images)
        st1 = stm.Stitcher(cfg, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        single = st1.stitch(images)
        peak_single = torch.cuda.max_memory_allocated()
        single_warm = [run(st1, images)[1] for _ in range(3)]
        assert single.shape == out.shape, (single.shape, out.shape)
        diff = np.abs(out.astype(np.int32) - single.astype(np.int32))
        r = {"edges": edges, "canvas": list(out.shape), "cold_s": cold_s,
             "warm_median_s": statistics.median(warm), "warm_s": warm,
             "warm_equals_cold": bool(np.array_equal(out, out_w)),
             "stage_s_warm": dict(st.stage_times), "launches": launches,
             "peak_mem_gib": peak / 2 ** 30,
             "single_device_peak_mem_gib": peak_single / 2 ** 30,
             "single_device_warm_median_s": statistics.median(single_warm),
             "vs_single_device": {"mean": float(diff.mean()),
                                  "share_gt_1": float((diff > 1).mean()),
                                  "max": int(diff.max())},
             "profile": prof}
        if cfg is f32:
            assert r["vs_single_device"]["share_gt_1"] < 1e-3, r
            assert r["vs_single_device"]["max"] <= 16, r
            b6["mesh"] = {"sp": MESH_SP, "edges": len(edges),
                          "launches_per_panorama": launches["warp_image"],
                          "device_ms_per_panorama":
                              prof["kernels"]["warp_image"]["ms"]}
        rep[label] = r
    return rep


def mesh_batch_phase(h: int, w: int, step: int, scale: int) -> dict:
    """Phase 16e: phase 14's batch at one frame size through
    ``shard_batch`` over ``make_mesh(2, sp=1, devices=[cuda:0] * 2)``:
    ``batched_stitch_chain`` on the sharded batch equals the unsharded
    call bit for bit (canvases and plans), with B1 once per image and B4
    and B6 once per edge."""
    import torch

    from computervisionimagestich2_tpu_torch import DEFAULT_CONFIG
    from computervisionimagestich2_tpu_torch.ops import _native
    from computervisionimagestich2_tpu_torch.parallel import (
        batched, make_mesh, shard_batch)

    pans = np.stack([np.stack(crops(h, w, step, scale, seed=sd))
                     for sd in BATCH_SEEDS])
    n_pan, k = pans.shape[:2]
    (sharded,) = shard_batch(make_mesh(2, sp=1, devices=["cuda:0"] * 2),
                             pans)
    _native.reset_launch_counts()
    t = time.perf_counter()
    out_sh, plans_sh = batched.batched_stitch_chain(sharded, DEFAULT_CONFIG)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = _native.launch_counts()
    check_launches(launches, {"pair_match_counts"}, b4=n_pan * (k - 1))
    assert launches["warp_image"] == n_pan * (k - 1), launches
    assert launches["detect_compact"] == n_pan * k, launches
    out, plans = batched.batched_stitch_chain(pans, DEFAULT_CONFIG,
                                              device="cuda")
    assert torch.equal(out_sh, out), "sharded batch != unsharded"
    assert np.array_equal(plans_sh, plans), "sharded plans != unsharded"
    return {"chunks": [list(c.shape) for c in sharded.chunks],
            "sharded_wall_s": wall, "launches": launches,
            "equals_unsharded": True}


def cli_sp_phase(images) -> dict:
    """Phase 16f: the command line of phase 8 with ``--sp`` one more than
    the visible cards is a usage error (exit 2) that names the count, and
    writes nothing."""
    import tempfile

    import torch

    from computervisionimagestich2_tpu_torch.utils import save_image

    n = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as d:
        for k, img in enumerate(images[:2]):
            save_image(f"{d}/{k + 1}.bmp", img)
        proc = subprocess.run(
            [sys.executable, "-m", "computervisionimagestich2_tpu_torch.cli",
             "--input", d, "--output", f"{d}/out.bmp", "--sp", str(n + 1)],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        wrote = Path(f"{d}/out.bmp").exists()
    err = proc.stderr.strip().splitlines()[-1] if proc.stderr else ""
    assert proc.returncode == 2 and f"have {n}" in err and not wrote, (
        proc.returncode, proc.stderr[-2000:])
    return {"argv_sp": n + 1, "returncode": proc.returncode, "error": err}


# phase 17: BASELINE config 4 (4K frames, gain compensation) on the card
UHD_HW = (2160, 3840)  # UHD frames, height x width
UHD_STEP = 2240  # the 58% step of phase 7's crops(1440, 1080, 630, ...)
UHD_SCALE = 6  # phase 7's feature scale: the same keypoints per pixel


def timed_kernel(name: str, a: tuple, kern, plain=None, reps: int = 3,
                 **extra) -> dict:
    """One call ``a`` of kernel ``name``: device time (``kernel_ms``), the
    bound from these inputs and the share; with ``plain``, its plain
    version's time (CUDA events over ``reps`` calls)."""
    row = {**extra, **kernel_ms(kern, name), **kernel_bound(name, a)}
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    if plain is not None:
        row["plain_ms"] = cuda_ms(plain, reps=reps)
    return row


def uhd_kernels(rec: Recorder, feats, edge: list) -> dict:
    """Phase 17b: every kernel of the path against its plain version on
    its 4K calls, with device time, bound and share: B1 exactly on the
    four octaves of the first image; B2 and B3 on the first octave's
    first call (``check_walks``' tolerances); B4 on the first edge's call
    (``check_b4``) and on the edge ``edge`` at the extractor's full
    capacity; B5 on the recorded call (against plain) and on the four
    images at full capacity (chunked within its scratch budget); B6 exact
    on the last and largest canvas; B8 exact on every call (the scale
    space in float32, the seam band's blend in bfloat16) and timed on the
    largest of each pass (``b8_by_pass``)."""
    import torch

    from computervisionimagestich2_tpu_torch.ops import (detect, distance,
                                                         sift_walks)

    walks = check_walks(rec)
    rows = {}
    a = rec.args["detect_compact"]
    rows["detect_compact"] = timed_kernel(
        "detect_compact", a, lambda: detect.detect_compact_octaves(*a),
        **walks["detect_compact"])
    a = rec.args["sift_orientation_hist"]
    rows["sift_orientation_hist"] = timed_kernel(
        "sift_orientation_hist", a, lambda: sift_walks.orientation_hist(*a),
        lambda: sift_walks.orientation_hist_plain(*a),
        max_abs_err=walks["walks"]["hist_max_abs_err"],
        keypoints=int(a[5][0]), slots=int(a[2].shape[0]),
        mod_shape=list(a[0].shape), window_pixels=b2_pixels(*a))
    b = rec.args["sift_descriptors"]
    rows["sift_descriptors"] = timed_kernel(
        "sift_descriptors", b, lambda: sift_walks.descriptors(*b),
        lambda: sift_walks.descriptors_plain(*b),
        max_abs_err=walks["walks"]["desc_max_abs_err"],
        keypoints=int(b[6][0]), slots=int(b[2].shape[0]),
        window_pixels=b3_pixels(*b))
    c = rec.args["l1_two_nearest_bidir"]
    q, r = c[0][c[2]].contiguous(), c[1][c[3]].contiguous()
    b4 = timed_kernel("l1_two_nearest_bidir", c,
                      lambda: distance.two_nearest_bidir(*c),
                      lambda: b4_plain(c), **check_b4(c))
    b4["library_ms"] = cuda_ms(lambda: l1_library(q, r, both=True), reps=3)
    i, j = edge
    full = (feats.desc[i], feats.desc[j], feats.valid[i], feats.valid[j])
    b4["at_full_capacity"] = timed_kernel(
        "l1_two_nearest_bidir", full,
        lambda: distance.two_nearest_bidir(*full), edge=edge,
        slots=int(feats.desc.shape[1]),
        live=[int(full[2].sum()), int(full[3].sum())])
    rows["l1_two_nearest_bidir"] = b4
    d = rec.args["pair_match_counts"]
    pairs = torch.tensor([(i, j) for i in range(feats.desc.shape[0])
                          for j in range(i + 1, feats.desc.shape[0])],
                         dtype=torch.int32, device=feats.desc.device)
    rows["pair_match_counts"] = {
        **b5_on(d), "plain_ms": cuda_ms(
            lambda: distance.pair_match_counts_plain(*d), reps=3),
        "at_full_capacity": b5_on((feats.desc.contiguous(),
                                   feats.valid.contiguous(), pairs, d[3]),
                                  plain=False)}
    e = rec.calls["warp_image"][-1]
    rows["warp_image"] = {**b6_at(e), "plain_ms": cuda_ms(
        lambda: b6_plain(*e), reps=3), "max_abs_err": b6_err(e)}
    calls = rec.calls["separable_blur"]
    rows["separable_blur"] = {**check_b8(calls),
                              "by_pass": b8_by_pass(calls)}
    return rows


def uhd_warm(st, images, edges: list, n_octaves: int) -> dict:
    """Phase 17a's warm runs: the launches of one run (B1 once per image,
    B2 and B3 once per level batch of every octave of every image, B4 and
    B6 once per edge, B5 one call), the median of three, the stage times,
    the peak device memory over them and one ``torch.profiler`` pass."""
    import torch

    cfg = st.config
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, t1, launches = counted_run(st, images)
    warm = [t1] + [run(st, images)[1] for _ in range(2)]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check_launches(launches, b4=len(edges), model=cfg.warp_model)
    walks = len(images) * n_octaves * cfg.sift.n_levels
    assert launches["detect_compact"] == len(images), launches
    assert launches["sift_orientation_hist"] == walks, (walks, launches)
    assert launches["sift_descriptors"] == walks, (walks, launches)
    assert launches["pair_match_counts"] == 1, launches
    assert launches[B6_BRANCH[cfg.warp_model]] == len(edges), launches
    return out, {"warm_median_s": statistics.median(warm), "warm_s": warm,
                 "stage_s_warm": dict(st.stage_times), "launches": launches,
                 "peak_mem_gib": peak / 2 ** 30,
                 "held_before_gib": base / 2 ** 30,
                 "profile": profile_run(st, images)}


def sift_counters(images, cfg) -> tuple[list, list]:
    """The SIFT of ``images`` alone (``Stitcher.prepare``) under ``cfg``:
    per image the four drop counters and the live keypoints before the
    final capacity (``telemetry``)."""
    from computervisionimagestich2_tpu_torch.core import programs
    from computervisionimagestich2_tpu_torch.models import stitcher as stm

    # a probe of one capacity: eager, a graph of each would be kept
    with programs.disable_graphs(), telemetry() as tel:
        stm.Stitcher(cfg, device="cuda").prepare(images)
    return tel["sift_dropped"], tel["sift_live"]


def smallest_caps(images, cfg, match_dropped: list) -> tuple:
    """Phase 17d's capacities: the smallest ``sift.max_keypoints_per_octave``
    (a multiple of 128, by bisection between 128 and the first octave's
    area / 128, past which the field changes nothing),
    ``sift.max_keypoints`` (the most live keypoints of an image) and
    ``match.max_matches`` (the most matches of an edge, from
    ``match_dropped`` of a run at these SIFT capacities) at which the
    counters read what no field can lower; a field whose counter reads
    that at its default keeps it. No field raises the candidate capacity
    (area / 128, at most 32768), B1's 128 hits a row or an octave's own
    area / 128 keypoints, so the candidates' and refined keypoints'
    counters may keep a floor: it is recorded. Returns the config, the
    floor and a report of the passes."""
    import dataclasses

    from computervisionimagestich2_tpu_torch.core import programs
    from computervisionimagestich2_tpu_torch.models import stitcher as stm

    R = dataclasses.replace
    passes = []

    def with_octave(cap):
        c = R(cfg, sift=R(cfg.sift, max_keypoints_per_octave=cap))
        stats, live = sift_counters(images, c)
        passes.append({"max_keypoints_per_octave": cap, "sift_dropped": stats})
        return stats, live

    h, w = images[0].shape[:2]
    top = -(-(h * w // 128) // 128) * 128
    floor = [s[:3] for s in with_octave(top)[0]]

    def binds(stats):
        return [s[:3] for s in stats] != floor

    octave = cfg.sift.max_keypoints_per_octave
    stats, live = with_octave(octave)
    if binds(stats):
        lo, hi = 128, top
        while hi - lo > 128:
            mid = (lo + hi) // 256 * 128
            if binds(with_octave(mid)[0]):
                lo = mid
            else:
                hi = mid
        octave = hi
        stats, live = with_octave(octave)
    final = max(live) if any(s[3] for s in stats) else cfg.sift.max_keypoints
    raised = R(cfg, sift=R(cfg.sift, max_keypoints_per_octave=octave,
                           max_keypoints=final))
    if raised.sift != cfg.sift:
        with programs.disable_graphs(), telemetry() as tel:
            stm.Stitcher(raised, device="cuda").stitch(images)
        match_dropped = tel["match_dropped"]
    if any(match_dropped):
        raised = R(raised, match=R(raised.match, max_matches=(
            cfg.match.max_matches + max(match_dropped))))
    return raised, floor, {
        "max_keypoints_per_octave": octave, "max_keypoints": final,
        "max_matches": raised.match.max_matches,
        "defaults": [cfg.sift.max_keypoints_per_octave,
                     cfg.sift.max_keypoints, cfg.match.max_matches],
        "octave_field_past_which_nothing_changes": top,
        "floor_no_field_lowers": floor,
        "live_keypoints_before_final_cap": live,
        "match_dropped_at_raised_sift": match_dropped,
        "sift_passes": passes}


def raised_caps_phase(images, cfg, match_dropped: list) -> dict:
    """Phase 17d: the stitch at ``smallest_caps`` (``stitch_phase``: the
    chain, every kernel launched, no ``match_overflow``; every SIFT counter
    at its floor, 0 where a field reaches it); its warm wall, profile and
    peak memory (``uhd_warm``); B4 and B5 on its calls beside their
    bounds, B5's chunks and what its call allocates (a pair's scratch
    alone passes the budget near 49k slots)."""
    from computervisionimagestich2_tpu_torch.ops import distance

    raised, floor, caps = smallest_caps(images, cfg, match_dropped)
    rep, rec, st, last_blend = stitch_phase(
        images, raised, cpu=None,
        record=("detect_compact", "l1_two_nearest_bidir",
                "pair_match_counts"))
    del last_blend  # its canvases must not count in the peak below
    assert [s[:3] for s in rep["sift_dropped"]] == floor, rep["sift_dropped"]
    assert not any(s[3] for s in rep["sift_dropped"]), rep["sift_dropped"]
    n_octaves = len(rec.args["detect_compact"][0])
    a = rec.args["l1_two_nearest_bidir"]
    b4 = timed_kernel("l1_two_nearest_bidir", a,
                      lambda: distance.two_nearest_bidir(*a),
                      queries=int(a[2].sum()), references=int(a[3].sum()),
                      slots=[int(a[0].shape[0]), int(a[1].shape[0])])
    b5 = b5_on(rec.args["pair_match_counts"], plain=False,
               within_budget=False)
    del rec, a
    _, warm = uhd_warm(st, images, rep["edges"], n_octaves)
    return {"caps": caps, **rep, **warm, "l1_two_nearest_bidir": b4,
            "pair_match_counts": b5}


def codec_phase(images) -> dict:
    """Phase 17e, the host's BMP I/O at 4K: the four frames written by the
    native codec, then read by it (``read_bmp`` each, and ``load_batch``)
    and by the numpy codec, equal pixels; the seconds of each."""
    import tempfile

    from computervisionimagestich2_tpu_torch.native import codec
    from computervisionimagestich2_tpu_torch.utils import bmp

    rep = {}
    with tempfile.TemporaryDirectory() as d:
        paths = [f"{d}/{k + 1}.bmp" for k in range(len(images))]
        for name, write in (("numpy", bmp.write_bmp),
                            ("native", codec.write_bmp)):
            t = time.perf_counter()
            for p, img in zip(paths, images):
                write(p, img)
            rep[f"write_s_{name}"] = time.perf_counter() - t
        rep["file_bytes"] = [Path(p).stat().st_size for p in paths]
        for name, read in (("numpy", bmp.read_bmp),
                           ("native", codec.read_bmp),
                           ("numpy_again", bmp.read_bmp),
                           ("native_again", codec.read_bmp)):
            t = time.perf_counter()
            got = [read(p) for p in paths]
            rep[f"load_s_{name}"] = time.perf_counter() - t
            assert all(np.array_equal(g, i) for g, i in zip(got, images))
        t = time.perf_counter()
        batch = codec.load_batch(paths)
        rep["load_batch_s_native"] = time.perf_counter() - t
        assert np.array_equal(batch, np.stack(images))
    return rep


def config4_phase(images, kernels: list) -> None:
    """Phase 17, BASELINE config 4 (``config4``) on four scrambled frames:
    (a) a cold stitch recording every kernel call and the telemetry, the
    chain; (b) each kernel against its plain version on its 4K calls
    (``uhd_kernels``); warm runs with launches, walls, peak memory and
    profile (``uhd_warm``); (c) the last edge's composite + blend against
    the CPU (``last_edge_vs_cpu``); (d) the stitch at the smallest
    capacities that zero the counters (``raised_caps_phase``); (e) the
    command line with ``--gain-compensation`` and the BMP codecs
    (``cli_phase``, ``codec_phase``). Adds each kernel's 4K launches,
    device time and calls to its kernels row (``at_4k``)."""
    import torch

    from computervisionimagestich2_tpu_torch.core import programs
    from computervisionimagestich2_tpu_torch.models import stitcher as stm

    programs.clear_graphs()  # the earlier phases' graphs hold their memory
    torch.cuda.empty_cache()
    t = time.perf_counter()
    cfg4 = config4()
    st = stm.Stitcher(cfg4, device="cuda")
    seen = record_ordering(st)
    with telemetry() as tel, Recorder() as rec:
        out_4k, cold_s = run(st, images)
    edges = check_chain(seen)
    assert out_4k.mean() > 20, "empty canvas"
    emit("config4_4k_cold", t, images=[list(i.shape) for i in images],
         scramble=SCRAMBLE, edges=edges, start=seen["start"],
         canvas=list(out_4k.shape),
         canvas_mpx=out_4k.shape[0] * out_4k.shape[1] / 1e6, cold_s=cold_s,
         stage_s_cold=dict(st.stage_times), match_overflow=[
             w for w in tel["warnings"] if w["stage"] == "match_overflow"],
         **{k: v for k, v in tel.items() if k not in ("last_blend", "luma")})
    del tel["last_blend"]  # its canvases must not count in the peaks below
    t = time.perf_counter()
    emit("config4_4k_histogram", t, **histogram_cost(tel.pop("luma")))
    t = time.perf_counter()
    n_octaves = len(rec.args["detect_compact"][0])
    uhd = uhd_kernels(rec, st._feats_stacked, edges[0])
    del rec  # the recorded inputs must not count in the peak below
    emit("config4_4k_kernels_vs_plain", t, **uhd)
    t = time.perf_counter()
    out, warm = uhd_warm(st, images, edges, n_octaves)
    # the cold run was eager (recorded), the warm ones replay the graphs
    assert np.array_equal(out, out_4k), "graph run != eager run at 4K"
    emit("config4_4k_warm", t, warm_equals_cold=True, **warm)
    t = time.perf_counter()
    rep = last_edge_vs_cpu(st, images)
    assert max(rep["shape_diff"]) <= 3 and rep["mad_vs_cpu"] <= 3.0, rep
    emit("config4_4k_last_edge_vs_cpu", t, **rep)
    del st
    t = time.perf_counter()
    raised = raised_caps_phase(images, cfg4, tel["match_dropped"])
    emit("config4_4k_raised_caps", t, **raised)
    t = time.perf_counter()
    rep, _ = cli_phase(images, out_4k, flags=("--gain-compensation",))
    emit("config4_4k_cli", t, **rep, **codec_phase(images))
    for k in kernels:
        name = k["name"]
        k["at_4k"] = {
            "launches": warm["launches"][name],
            "device_ms_per_panorama": warm["profile"]["kernels"][name]["ms"],
            "raised_caps_launches": raised["launches"][name],
            "raised_caps_device_ms_per_panorama":
                raised["profile"]["kernels"][name]["ms"],
            **uhd.get(name, {})}
        if name in ("l1_two_nearest_bidir", "pair_match_counts"):
            k["at_4k"]["raised_caps"] = raised[name]


def bench_cell(name: str, **change) -> tuple:
    """The bench's panorama cell ``name`` (``tools/bench.py::
    run_panorama``: cold stitch, plan parity, three timed warm runs, the
    CPU check, one profile; ``change`` replaces fields of the cell) on the
    card: its line is printed and must say ``correct``. Returns (the
    stitcher, the last timed panorama, the line)."""
    import torch

    from computervisionimagestich2_tpu_torch.tools.bench import (
        CELLS, run_panorama)

    keep = {}
    cell = dataclasses.replace(CELLS[name], **change)
    line = {"cell": name, **run_panorama(cell, torch.device("cuda"), 3, 0,
                                         keep)}
    print(json.dumps(line), flush=True)
    assert line["correct"], line["checks"]
    return keep["stitcher"], keep["out"], line


# phase 18d: the benchmark's dataset2 geometry (18 crops of 800 x 600, 350 px
# apart, feature scale 2), more composite + blend keys than a program keeps
MANY_FRAMES, MANY_HW, MANY_STEP, MANY_SCALE = 18, (800, 600), 350, 2
MANY_SEEDS = (7, 8)

PROFILE_KEYS = ("wall_s", "device_busy_ms", "idle_share", "device_events",
                "memcpy_htod_events", "graph_launches", "graph_device_events",
                "memcpy_htod_in_replays", "graph_launch_host_ms",
                "profiler_lead_kept")


@contextlib.contextmanager
def program_outputs():
    """While open, keep what the stitcher's programs return: each frame's
    (Features, projection, stats) from the features program, the
    ordering's [N, N] counts, the plan's arguments and [E, 23] rows, each
    edge's canvas from the composite + blend with the program's key, and
    the enhance tail's output."""
    from computervisionimagestich2_tpu_torch.models import stitcher as stm
    from computervisionimagestich2_tpu_torch.parallel import batched

    got = {"features": [], "edges": [], "edge_keys": [], "enhanced": [],
           "ordering": []}
    orig = (batched._project_and_extract_one, stm.plan_edges_with_rows,
            stm._composite_and_blend, stm.equalize_and_mix,
            stm.all_pairs_match_counts)
    features, plan, edge, enhance, ordering = orig

    def features_rec(*a):
        out = features(*a)
        got["features"].append(out)
        return out

    def ordering_rec(*a):
        got["ordering"].append(ordering(*a))
        return got["ordering"][-1]

    def plan_rec(*a):
        got["plan_args"] = a
        got["plan"], rows = plan(*a)
        return got["plan"], rows

    def edge_rec(*a):
        got["edge_keys"].append(edge.key(*a)[0])
        got["edges"].append(edge(*a))
        return got["edges"][-1]

    def enhance_rec(*a):
        got["enhanced"].append(enhance(*a))
        return got["enhanced"][-1]

    (batched._project_and_extract_one, stm.plan_edges_with_rows,
     stm._composite_and_blend, stm.equalize_and_mix,
     stm.all_pairs_match_counts) = (
        features_rec, plan_rec, edge_rec, enhance_rec, ordering_rec)
    try:
        yield got
    finally:
        (batched._project_and_extract_one, stm.plan_edges_with_rows,
         stm._composite_and_blend, stm.equalize_and_mix,
         stm.all_pairs_match_counts) = orig


def program_mode(images, cfg, eager: bool, fresh: list) -> tuple:
    """One mode of phase 18: a Stitcher's cold stitch, a warm one with its
    launch counts and program outputs (``program_outputs``), two more
    timed, and one profiled; eager under ``disable_graphs()``, else with
    every program's graphs dropped first, so the cold run captures. Then
    each fresh scene of the same frame shape in ``fresh``, in turn, in
    the warm process: its first stitch, with the captures it made (new
    canvas shapes under ``exact_canvas``), and a second one; and the
    memory after them. Returns (report, warm panorama, program outputs,
    launches)."""
    import torch

    from computervisionimagestich2_tpu_torch.core import programs
    from computervisionimagestich2_tpu_torch.models import stitcher as stm

    with (programs.disable_graphs() if eager else contextlib.nullcontext()):
        programs.clear_graphs()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        st = stm.Stitcher(cfg, device="cuda")
        c0 = programs.capture_stats()
        out_cold, cold_s = run(st, images)
        cold = programs.captures_since(c0)
        c1 = programs.capture_stats()
        with program_outputs() as got:
            out, t1, launches = counted_run(st, images)
        warm_captures = programs.captures_since(c1)["captures"]
        walls = [t1] + [run(st, images)[1] for _ in range(2)]
        stages = dict(st.stage_times)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        memory = {"peak_reserved_gib": torch.cuda.max_memory_reserved()
                  / 2 ** 30, **programs.graph_memory("cuda")}
        prof = profile_run(st, images)
        fresh_rep = []
        for scene in fresh:
            c3 = programs.capture_stats()
            first = run(st, scene)[1]
            made = programs.captures_since(c3)
            fresh_rep.append({
                "first_s": first, "second_s": run(st, scene)[1],
                **{k: made[k] for k in ("captures", "capture_s",
                                        "evictions")},
                "captures_by_program": made["by_program"]})
        torch.cuda.synchronize()
        after_fresh = {"peak_reserved_gib": torch.cuda.max_memory_reserved()
                       / 2 ** 30, **programs.graph_memory("cuda")}
    assert np.array_equal(out, out_cold), "warm != cold"
    wrong = launches_vs_trace(prof["kernels"])
    assert not wrong, ("launch counters != the trace", wrong)
    rep = {"cold_s": cold_s, "captures": cold["captures"],
           "capture_s": cold["capture_s"],
           "captures_by_program": cold["by_program"],
           "warm_captures": warm_captures,
           "warm_s": walls, "warm_median_s": statistics.median(walls),
           "stage_s": stages, "launches": launches,
           "peak_mem_gib": peak / 2 ** 30, "held_before_gib": held / 2 ** 30,
           "memory": memory,
           "launches_vs_trace": {n: [k["counted_launches"],
                                     k["device_launches"]]
                                 for n, k in prof["kernels"].items()},
           "profile": {k: prof[k] for k in PROFILE_KEYS},
           "fresh_scenes": fresh_rep, "memory_after_fresh": after_fresh}
    return rep, out, got, launches


def many_edges_phase(seeds=MANY_SEEDS, n: int = MANY_FRAMES) -> dict:
    """Phase 18d: the benchmark's dataset2 geometry, ``n`` crops of
    ``MANY_HW`` (h, w) ``MANY_STEP`` px apart, of the scene of each seed in
    a seeded order: ``n - 1`` edges, each growing the canvas, more
    composite + blend keys than the program keeps (``MAX_GRAPHS``). The
    same Stitcher stitches eagerly (``disable_graphs``) and with graphs,
    cold then three warm. The panoramas and launch counts equal the eager
    ones bit for bit; a warm stitch captures and drops nothing: it replays
    the first ``MAX_GRAPHS`` edges' graphs and runs the others eagerly
    (``overflows``), call after call (one scope a stitch,
    ``core/programs.py::scope``), beside the frames', the ordering's, the
    plan's and the tail's graphs. Every pair of frames that shares nothing
    (two or more steps apart in the scene) draws fewer chance matches than
    the pair threshold, so the ordering finds the scene's chain."""
    from computervisionimagestich2_tpu_torch import DEFAULT_CONFIG
    from computervisionimagestich2_tpu_torch.core import programs
    from computervisionimagestich2_tpu_torch.models import stitcher as stm

    edge = stm._composite_and_blend
    threshold = DEFAULT_CONFIG.match.pair_threshold
    out = {"frames": n, "hw": list(MANY_HW), "step": MANY_STEP,
           "max_graphs": edge.max_graphs, "scenes": []}
    for seed in seeds:
        scene = crops(*MANY_HW, MANY_STEP, MANY_SCALE, seed=seed, n=n)
        order = np.random.default_rng(seed).permutation(n).tolist()
        images = [scene[k] for k in order]
        programs.clear_graphs()
        st = stm.Stitcher(DEFAULT_CONFIG, device="cuda")
        with programs.disable_graphs():
            out_e, cold_e = run(st, images)
            with program_outputs() as got:
                _, t_e, launches_e = counted_run(st, images)
            eager_s = [t_e] + [run(st, images)[1] for _ in range(2)]
        counts = got["ordering"][-1].cpu().numpy()
        apart = [max(int(counts[i, j]), int(counts[j, i]))
                 for i in range(n) for j in range(i + 1, n)
                 if abs(order[i] - order[j]) >= 2]
        assert max(apart) < threshold, (seed, max(apart))
        c0 = programs.capture_stats()
        out_c, cold_g = run(st, images)
        cold = programs.captures_since(c0)
        warm, walls = [], []
        for i in range(3):
            c = programs.capture_stats()
            if i == 0:
                out_w, t, launches_g = counted_run(st, images)
            else:
                out_w, t = run(st, images)
            walls.append(t)
            warm.append(programs.captures_since(c))
        assert np.array_equal(out_c, out_e) and np.array_equal(out_w, out_e), \
            "many-edge graph panorama != eager"
        assert launches_g == launches_e, (launches_g, launches_e)
        keys = cold["by_program"]["composite_and_blend"] + cold["overflows"]
        assert keys == n - 1 > edge.max_graphs, cold
        for d in warm:
            assert d["captures"] == 0 and d["evictions"] == 0, d
            assert d["overflows"] == n - 1 - edge.max_graphs, d
            assert d["replays_by_program"]["composite_and_blend"] == \
                edge.max_graphs, d
            # frames, the ordering, the plan, the kept edges, the tail
            assert d["replays"] == n + 1 + 1 + edge.max_graphs + 1, d
        out["scenes"].append({
            "seed": seed, "order": order, "canvas": list(out_e.shape),
            "composite_keys": keys, "most_chance_matches": max(apart),
            "cold": {"graphs_s": cold_g, "eager_s": cold_e, **cold},
            "warm": warm[0], "warm_s": walls, "eager_warm_s": eager_s,
            "warm_median_ratio": (statistics.median(walls)
                                  / statistics.median(eager_s)),
            "stage_s": dict(st.stage_times),
            "memory": programs.graph_memory("cuda")})
    out["equal"] = {"panorama": True, "launches": True}
    return out


def bench_phase() -> dict:
    """Phase 19: ``bench_torch.py`` on its headline cell with one warm
    run, in a fresh interpreter (its ``main``, the kernels' build step,
    stdout holding only the JSON line, the exit code); its line is printed
    and must say ``correct`` on the card."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "bench_torch.py"), "--cells",
         "pano4_512x384", "--runs", "1"], cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-3000:])
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, lines
    line = json.loads(lines[0])
    print(json.dumps(line), flush=True)
    assert line["cell"] == "pano4_512x384", line
    assert line["device"] == "cuda" and line["correct"] is True, line
    # the features program, the ordering, the plan, the three edges'
    # canvases (under exact_canvas every edge grows the canvas) and the
    # enhance tail
    assert line["setup"]["graphs"]["by_program"] == {
        "project_and_extract": 1, "all_pairs_match_counts": 1,
        "plan_edges": 1, "composite_and_blend": 3, "equalize_and_mix": 1}, \
        line["setup"]
    return {"correct": line["correct"], "panorama_ms": line["panorama_ms"],
            "cold_ms": line["cold_ms"], "graphs": line["setup"]["graphs"],
            "reprojection_parity_px": line["checks"][
                "reprojection_parity_px"]["value"],
            "mad_vs_cpu": line["checks"]["canvas_vs_cpu"]["mad"],
            "bench_seconds": line["elapsed_s"]}


def pool_owner_probe() -> dict:
    """What stays allocated in a CUDA graph's private pool after every
    graph is dropped: a cold default stitch at 4 x 512x384 with the
    allocator's history on (Python and C++ frames), then
    ``programs.clear_graphs()``; each block still allocated in a private
    pool, with its size, stream and innermost frames. Meant for a fresh
    interpreter (``graphs_phase`` runs it in one): the history must be on
    before the process's first capture."""
    import gc

    import torch

    from computervisionimagestich2_tpu_torch import DEFAULT_CONFIG
    from computervisionimagestich2_tpu_torch.core import programs
    from computervisionimagestich2_tpu_torch.models import stitcher as stm

    # the state of live blocks with their allocation's frames, no trace
    torch.cuda.memory._record_memory_history(
        enabled="state", context="alloc", stacks="all")
    images = scrambled(crops(512, 384, 224, 2, seed=0))
    stm.Stitcher(DEFAULT_CONFIG, device="cuda").stitch(images)
    with_graphs = programs.graph_memory("cuda")
    programs.clear_graphs()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    owners = []
    for seg in snap["segments"]:
        if tuple(seg["segment_pool_id"]) == (0, 0):
            continue
        for blk in seg["blocks"]:
            if blk["state"] != "active_allocated":
                continue
            frames = [f"{f['filename'].split('/')[-1]}:{f['line']} "
                      f"{f['name']}"[:160] for f in blk.get("frames", [])]
            owners.append({"bytes": blk["size"], "stream": seg["stream"],
                           "pool": list(seg["segment_pool_id"]),
                           "frames": frames[:40]})
    return {"graph_memory_with_graphs": with_graphs,
            "graph_memory_after_clear": programs.graph_memory("cuda"),
            "owners": owners}


def graphs_phase(images, cfg, fresh, owner_probe: bool = False) -> dict:
    """Phase 18 on one scene: the stitch with its programs eager
    (``disable_graphs``), then as users get it, the features program, the
    plan, each edge's composite + blend and the enhance tail as CUDA
    graphs (``program_mode``). The graph run's panorama, each frame's
    features, projection and stats, the [E, 23] plan, each edge's canvas
    and the enhanced canvas equal the eager run's bit for bit, and so do
    the launch counts; the cold run captures each program once (the
    composite + blend once per distinct key of its edges), a second
    stitch nothing; every frame, the plan, every edge and the tail
    replay a graph, and no host-to-device copy runs inside a replay.
    Then another edge sequence of the same length (each edge reversed)
    replays the plan's graph, with the eager plan's rows. Both modes
    also time fresh scenes of the frame shape (``fresh``, a list) in the
    warm process: what the captures of new canvas shapes cost a new
    scene. With ``owner_probe``, ``pool_owner_probe`` in a fresh
    interpreter."""
    import torch

    from computervisionimagestich2_tpu_torch.core import programs
    from computervisionimagestich2_tpu_torch.models import registration

    eager, out_e, got_e, launches_e = program_mode(images, cfg, True, fresh)
    graph, out_g, got_g, launches_g = program_mode(images, cfg, False,
                                                   fresh)
    assert np.array_equal(out_e, out_g), "graph panorama != eager"
    assert launches_e == launches_g, (launches_e, launches_g)
    assert len(got_e["features"]) == len(got_g["features"]) == len(images)
    for fe, fg in zip(got_e["features"], got_g["features"]):
        (feats_e, proj_e, stats_e), (feats_g, proj_g, stats_g) = fe, fg
        for a, b in zip((*feats_e, proj_e, stats_e),
                        (*feats_g, proj_g, stats_g)):
            assert torch.equal(a, b), "graph features != eager"
    assert len(got_e["ordering"]) == len(got_g["ordering"]) == 1
    assert torch.equal(got_e["ordering"][0], got_g["ordering"][0]), \
        "graph ordering counts != eager"
    assert np.array_equal(got_e["plan"], got_g["plan"]), "graph plan != eager"
    n_edges = len(got_g["plan"])
    assert len(got_e["edges"]) == len(got_g["edges"]) == n_edges
    for a, b in zip(got_e["edges"], got_g["edges"]):
        assert torch.equal(a, b), "graph composite + blend != eager"
    assert len(got_e["enhanced"]) == len(got_g["enhanced"]) == 1
    assert torch.equal(got_e["enhanced"][0], got_g["enhanced"][0]), \
        "graph enhance tail != eager"
    edge_keys = len(set(got_g["edge_keys"]))
    assert graph["captures_by_program"] == {
        "project_and_extract": 1, "all_pairs_match_counts": 1,
        "plan_edges": 1, "composite_and_blend": edge_keys,
        "equalize_and_mix": 1}, graph
    assert graph["warm_captures"] == 0, graph
    assert eager["captures"] == 0, eager
    assert all(f["captures"] == 0 for f in eager["fresh_scenes"]), eager
    # with every graph dropped, the private pools still hold what a tensor
    # made in an earlier capture keeps; the graphs' own pools come on top
    assert (graph["memory"]["graph_pools_reserved_gib"]
            > eager["memory"]["graph_pools_reserved_gib"]), (graph["memory"],
                                                             eager["memory"])
    prof = graph["profile"]
    # frames, the ordering, the plan, the edges, the enhance tail
    assert prof["graph_launches"] == len(images) + 1 + 1 + n_edges + 1, prof
    assert prof["memcpy_htod_in_replays"] == 0, prof

    feats, edges, img_hw, start_hw, pcfg = got_g["plan_args"]
    other = [(dst, src, pre) for src, dst, pre in edges]
    n0 = registration.plan_rows.captures
    rows = registration.plan_edges(feats, other, img_hw, start_hw, pcfg)
    with programs.disable_graphs():
        ref = registration.plan_edges(feats, other, img_hw, start_hw, pcfg)
    assert registration.plan_rows.captures == n0, "the plan key held edges"
    assert np.array_equal(rows, ref, equal_nan=True)
    assert not np.array_equal(rows, got_g["plan"], equal_nan=True)
    owner = None
    if owner_probe:
        proc = subprocess.run(
            [sys.executable, "-c", "import json, chip_smoke; print(json."
             "dumps(chip_smoke.pool_owner_probe()))"], cwd=ROOT,
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        owner = json.loads(proc.stdout.strip().splitlines()[-1])
    return {"pool_owner": owner, "edges": [list(e) for e in edges],
            "other_edges_replayed": [list(e) for e in other],
            "edge_canvases": [list(e.shape) for e in got_g["edges"]],
            "composite_keys": edge_keys,
            "equal": {"panorama": True, "features": True, "ordering": True,
                      "plan": True, "edges": True, "enhanced": True,
                      "launches": True},
            "fresh_scene_first_ratios": [
                g["first_s"] / e["first_s"]
                for g, e in zip(graph["fresh_scenes"],
                                eager["fresh_scenes"])],
            "canvas": list(out_g.shape), "graphs": graph, "eager": eager,
            "warm_median_ratio": (graph["warm_median_s"]
                                  / eager["warm_median_s"])}


def main() -> int:
    t0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from computervisionimagestich2_tpu_torch import (DEFAULT_CONFIG,
                                                     SLICE_CONFIG)
    from computervisionimagestich2_tpu_torch.core.types import Features
    from computervisionimagestich2_tpu_torch.models import stitcher as stm
    from computervisionimagestich2_tpu_torch.ops import _native, detect

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    gpu = torch.cuda.get_device_name(0)
    emit("environment", t0, gpu=gpu, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t = time.perf_counter()
    lib = _native.build()
    from computervisionimagestich2_tpu_torch.native import codec
    from computervisionimagestich2_tpu_torch.utils import io as image_io

    assert image_io.codec() is codec, codec.unavailable_reason()
    emit("build", t, library=str(lib.relative_to(ROOT)),
         bmp_codec=str(codec.library_path().relative_to(ROOT)))

    # -- 3. cold default path at 4 x 512x384, scrambled, recording inputs
    t = time.perf_counter()
    scene_order = crops(512, 384, 224, 2, seed=0)
    images = images_512 = scrambled(scene_order)
    st = stm.Stitcher(DEFAULT_CONFIG, device="cuda")
    seen = record_ordering(st)
    with Recorder() as rec:
        out_cold, cold_s = run(st, images)
    assert set(rec.args) == set(rec.sites), sorted(rec.args)
    edges = check_chain(seen)
    emit("default_512x384_cold", t, cold_s=cold_s, scramble=SCRAMBLE,
         edges=edges, start=seen["start"], canvas=list(out_cold.shape))
    t = time.perf_counter()
    kernels = check_kernels(rec)
    main_last = rec.calls["warp_image"][-1]  # the panorama's full canvas
    del rec
    emit("kernels_vs_plain", t, checked=[k["name"] for k in kernels])

    # -- 4. warm default path: the bench's headline cell (its line
    # printed), the launch counts of one run, graph against phase 3's
    # eager cold run
    t = time.perf_counter()
    st, out, line = bench_cell("pano4_512x384")
    launches, prof = line["launches"], line["profile"]
    check_launches(launches, b4=len(edges))
    assert launches["detect_compact"] == len(images), launches
    assert line["stage_ms"]["ordering"] > 0, line["stage_ms"]
    assert 700 <= out.shape[1] <= 1400 and out.shape[0] <= 700, out.shape
    assert np.array_equal(out, out_cold), "graph run != eager run"
    emit("default_512x384_warm", t, images=[list(i.shape) for i in images],
         canvas=list(out.shape), panorama_ms=line["panorama_ms"],
         cold_ms=line["cold_ms"], graphs=line["setup"]["graphs"],
         stage_ms=line["stage_ms"], launches=launches,
         warm_equals_eager_cold=True, checks=line["checks"],
         profile={k: v for k, v in prof.items() if k != "kernels"})
    for k in kernels:
        k["launches"] = k["launches_per_panorama"] = launches[k["name"]]
        k["device_ms_per_panorama"] = prof["kernels"][k["name"]]["device_ms"]
        k["share_of_bound_per_panorama"] = (
            k["bound_ms_per_panorama"] / k["device_ms_per_panorama"]
            if k["device_ms_per_panorama"] else None)
    b6 = next(k for k in kernels if k["name"] == "warp_image")
    b6.update(b6_launch_floor(b6))
    feats = st._matching_feats()

    # -- 5. the chain slice (SLICE_CONFIG), scene order
    t = time.perf_counter()
    st_chain = stm.Stitcher(SLICE_CONFIG, device="cuda")
    out_chain, chain_cold_s = run(st_chain, scene_order)
    _native.reset_launch_counts()
    out_chain, chain_warm_s = run(st_chain, scene_order)
    chain_launches = _native.launch_counts()
    check_launches(chain_launches, CHAIN_OFF_PATH, b4=3)
    out_chain_cpu = stm.Stitcher(SLICE_CONFIG, device="cpu").stitch(
        scene_order)
    chain_mad = canvas_vs_cpu(out_chain, out_chain_cpu)
    emit("chain_512x384", t, canvas=list(out_chain.shape),
         cold_s=chain_cold_s, warm_s=chain_warm_s,
         stage_s=dict(st_chain.stage_times), launches=chain_launches,
         mad_vs_cpu=chain_mad)

    # -- 6. matcher API (B7) on two neighbouring crops of phase 4
    t = time.perf_counter()
    a, b = SCRAMBLE.index(0), SCRAMBLE.index(1)
    kernels.append(check_matcher(
        Features(*(x[a] for x in feats)), Features(*(x[b] for x in feats))))
    emit("matcher_api", t, images=[a, b])

    # -- 7. north-star size 4 x 1440x1080, scrambled, default path
    t = time.perf_counter()
    images = images_big = scrambled(crops(1440, 1080, 630, 6, seed=1))
    torch.cuda.reset_peak_memory_stats()
    st = stm.Stitcher(DEFAULT_CONFIG, device="cuda")
    seen = record_ordering(st)
    with telemetry() as tel, Recorder(("detect_compact",
                                       "warp_image")) as rec:
        out_big, cold_s = run(st, images)
    del tel["last_blend"]  # its canvases must not count in the peak below
    b1 = next(k for k in kernels if k["name"] == "detect_compact")
    a = rec.args["detect_compact"]
    b1["at_1440x1080"] = {
        **check_b1(a), **kernel_bound("detect_compact", a),
        **kernel_ms(lambda: detect.detect_compact_octaves(*a),
                    "detect_compact")}
    b1["at_1440x1080"]["share_of_bound"] = (
        b1["at_1440x1080"]["bound_ms"] / b1["at_1440x1080"]["ms"])
    big_last = rec.calls["warp_image"][-1]
    b6["at_1440x1080_last_canvas"] = b6_at(big_last)
    assert b6["at_1440x1080_last_canvas"]["canvas"] == list(
        out_big.shape[:2]), b6["at_1440x1080_last_canvas"]
    del rec, a  # the recorded stacks must not count in the peak below
    edges = check_chain(seen)
    stages_big = dict(st.stage_times)
    # the warm runs: the bench's north-star cell, its last edge against
    # the CPU (the whole CPU run takes a minute)
    _, out_warm, line = bench_cell("pano4_1440x1080", cpu_check="last_edge")
    launches_big = line["launches"]
    check_launches(launches_big, b4=len(edges))
    assert launches_big["detect_compact"] == len(images), launches_big
    assert np.array_equal(out_warm, out_big), "graph run != eager run"
    assert out_big.dtype == np.uint8 and out_big.shape[2] == 3
    assert 2000 <= out_big.shape[1] <= 4000, out_big.shape
    assert out_big.shape[0] <= 2000, out_big.shape
    assert out_big.mean() > 20, "empty canvas"
    emit("default_1440x1080", t, images=[list(i.shape) for i in images],
         scramble=SCRAMBLE, edges=edges, start=seen["start"],
         canvas=list(out_big.shape), cold_s=cold_s,
         panorama_ms=line["panorama_ms"], cold_ms=line["cold_ms"],
         graphs=line["setup"]["graphs"], checks=line["checks"],
         stage_s_cold=stages_big, stage_ms=line["stage_ms"],
         launches_per_run=launches_big, sift_dropped=tel["sift_dropped"],
         match_dropped=tel["match_dropped"],
         peak_mem_gib=line["peak_mem_gib"],
         detect_compact=b1["at_1440x1080"],
         warp_image=b6["at_1440x1080_last_canvas"])

    # -- 7a. B6's cases, both models, on the canvases of phases 3 and 7
    t = time.perf_counter()
    b6["cases"] = b6_checks(main_last, big_last)
    emit("warp_cases", t, **b6["cases"])

    # -- 7b. B5 at ten frames and at the north-star size
    t = time.perf_counter()
    b5 = next(k for k in kernels if k["name"] == "pair_match_counts")
    b5["at_10x512x384"] = b5_at(crops(512, 384, 224, 2, seed=0, n=10))
    b5["at_4x1440x1080"] = b5_at(crops(1440, 1080, 630, 6, seed=1))
    b5["at_10x1440x1080_full_capacity"] = b5_at(
        crops(1440, 1080, 630, 6, seed=1, n=10), plain=False, trimmed=False)
    assert b5["at_10x1440x1080_full_capacity"]["chunk"] < 45
    emit("pair_counts_other_inputs", t,
         **{k: v for k, v in b5.items() if k.startswith("at_")})

    # -- 8. the command line, default flags (bucketed canvases)
    t = time.perf_counter()
    rep, out_bucketed = cli_phase(images_512, out)
    emit("cli_default_512x384", t, **rep)

    # -- 9. incremental, bucketed, dump and resume on phase 3's crops
    t = time.perf_counter()
    emit("incremental_512x384", t, **incremental_phase(
        images_512, out, out_bucketed, DEFAULT_CONFIG))

    # -- 10. mixed shapes, scrambled
    t = time.perf_counter()
    emit("mixed_shapes", t, **mixed_phase(scene_order, DEFAULT_CONFIG))

    # -- 11. streaming, BASELINE config 5 (the CPU check at 720p only: two
    # 1080p frames take ~100 s on the CPU)
    for label, size in (("stream_1280x720", (720, 1280, 10, 4, 2, True)),
                        ("stream_1920x1080", (1080, 1920, 8, 6, 3, False))):
        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        emit(label, t, **stream_phase(DEFAULT_CONFIG, *size))

    # -- 12. warp_model="projective" at 4 x 512x384 and 4 x 1440x1080
    from computervisionimagestich2_tpu_torch.ops import warp

    proj = dataclasses.replace(DEFAULT_CONFIG, warp_model="projective")
    t = time.perf_counter()
    rep, rec, st_proj, _ = stitch_phase(images_512, proj, cpu="resumed",
                                        record=("warp_image",))
    calls = rec.calls["warp_image"]
    a = calls[0]
    row = kernel_row("warp_image_projective", calls, b6_err(a),
                     lambda: warp.warp_image(*a), lambda: b6_plain(*a),
                     **b6_extra(calls))
    prof = profile_run(st_proj, images_512)
    row["launches"] = row["launches_per_panorama"] = rep["launches"][
        "warp_image_projective"]
    row["device_ms_per_panorama"] = prof["kernels"][
        "warp_image_projective"]["ms"]
    row["share_of_bound_per_panorama"] = (
        row["bound_ms_per_panorama"] / row["device_ms_per_panorama"])
    row.update(b6_launch_floor(row))
    kernels.insert([k["name"] for k in kernels].index("warp_image") + 1, row)
    emit("projective_512x384", t, **rep, profile=prof)
    del rec, calls, a
    t = time.perf_counter()
    rep, rec, _, _ = stitch_phase(images_big, proj, cpu="resumed",
                                  record=("warp_image",))
    row["at_1440x1080_last_canvas"] = b6_at(rec.calls["warp_image"][-1])
    del rec
    emit("projective_1440x1080", t, **rep,
         warp_image_projective=row["at_1440x1080_last_canvas"])

    # -- 13. the rest of A13 at 4 x 512x384: o_min=-1, luma gain, Van Vliet
    t = time.perf_counter()
    omin = dataclasses.replace(DEFAULT_CONFIG, sift=dataclasses.replace(
        DEFAULT_CONFIG.sift, o_min=-1))
    rep, rec, _, _ = stitch_phase(images_512, omin, record=(
        "detect_compact", "sift_orientation_hist", "sift_descriptors"))
    rep["kernels_vs_plain"] = check_walks(rec)
    del rec
    emit("o_min_-1_512x384", t, **rep)
    t = time.perf_counter()
    st = stm.Stitcher(omin, device="cuda")
    with telemetry() as tel, Recorder(("detect_compact",)) as rec:
        st.prepare(images_big)
        torch.cuda.synchronize()
    prep_s = time.perf_counter() - t
    emit("o_min_-1_1440x1080_features", t, prepare_s=prep_s,
         sift_dropped=tel["sift_dropped"], first_octave=list(
             rec.args["detect_compact"][0][0].shape[1:]),
         detect_compact=check_b1(rec.args["detect_compact"]),
         live_features=st._feats_stacked.valid.sum(dim=1).tolist())
    del rec, st
    t = time.perf_counter()
    luma = dataclasses.replace(DEFAULT_CONFIG, blend=dataclasses.replace(
        DEFAULT_CONFIG.blend, gain_compensation=True, gain_mode="luma"))
    rep, _, _, _ = stitch_phase(images_512, luma, cpu="resumed")
    emit("luma_gain_512x384", t, **rep)
    t = time.perf_counter()
    vv = dataclasses.replace(DEFAULT_CONFIG, blend=dataclasses.replace(
        DEFAULT_CONFIG.blend, blur_impl="vanvliet"))
    rep, _, _, last_blend = stitch_phase(images_512, vv, cpu="resumed")
    emit("vanvliet_512x384", t, **rep, one_blend=blend_cost(last_blend))

    # -- 14. batched panoramas (BASELINE config 3) and batched registration
    t = time.perf_counter()
    emit("batched_512x384", t, **batched_phase(512, 384, 224, 2, True))
    t = time.perf_counter()
    b7 = next(k for k in kernels if k["name"] == "l1_two_nearest")
    emit("batched_register_512x384", t, **register_phase(scene_order, b7))
    t = time.perf_counter()
    emit("batched_1440x1080", t, **batched_phase(1440, 1080, 630, 6, False))

    # -- 15. match.method="l2pre" and match.distance="l2" at 4 x 512x384
    t = time.perf_counter()
    emit("match_strategies_512x384", t, **match_strategy_phase(images_512))

    # -- 16. mesh mode on virtual meshes of the one card (A18)
    t = time.perf_counter()
    edges_big = record_edges(images_big, DEFAULT_CONFIG)
    rep = mesh_composite_phase(edges_big)
    b6["mesh_composite_last_1440x1080_edge"] = rep["sp4"]
    emit("mesh_composite_1440x1080", t, **rep)
    t = time.perf_counter()
    from computervisionimagestich2_tpu_torch.models import compose

    edge = edges_big[-1]
    rows = -(-edge[5][0] // (2 * MESH_SP)) * 2 * MESH_SP
    a_e, b_e = compose.composite(*edge[:5], (rows, edge[5][1]))
    rep = {"last_1440x1080_edge": mesh_blend_phase(a_e, b_e, edge[5][0],
                                                   "last_1440x1080_edge")}
    del edge, edges_big, a_e, b_e
    a_e, b_e = big_pair(*BIG_PAIR_HW)
    rep["synthetic_4k_panorama"] = mesh_blend_phase(a_e, b_e, None,
                                                    "synthetic_4k_panorama")
    del a_e, b_e
    emit("mesh_blend", t, **rep)
    t = time.perf_counter()
    emit("mesh_stitcher_1440x1080", t, **mesh_stitch_phase(images_big, b6))
    t = time.perf_counter()
    rep, _, _, _ = stitch_phase(images_512, dataclasses.replace(
        DEFAULT_CONFIG, exact_canvas=False), cpu="resumed", mesh_sp=MESH_SP)
    emit("mesh_stitcher_512x384", t, **rep)
    t = time.perf_counter()
    emit("mesh_shard_batch_512x384", t, **mesh_batch_phase(512, 384, 224, 2))
    t = time.perf_counter()
    emit("cli_sp_refused", t, **cli_sp_phase(images_512))

    # -- 17. BASELINE config 4 at 4 x 3840x2160: 4K frames, gain
    # compensation, every canvas above both blend gates
    images_4k = scrambled(crops(*UHD_HW, UHD_STEP, UHD_SCALE, seed=4))
    config4_phase(images_4k, kernels)

    # -- 18. the programs as CUDA graphs against eager, on the scenes of
    # the bench's panorama cells
    for label, imgs, cfg, (h, w, step, scale), seeds in (
            ("512x384", images_512, DEFAULT_CONFIG, (512, 384, 224, 2),
             (3, 5, 6)),
            ("1440x1080", images_big, DEFAULT_CONFIG, (1440, 1080, 630, 6),
             (3,)),
            ("4k_gain", images_4k, config4(),
             (*UHD_HW, UHD_STEP, UHD_SCALE), (5, 6))):
        t = time.perf_counter()
        fresh = [scrambled(crops(h, w, step, scale, seed=sd))
                 for sd in seeds]
        emit(f"graphs_vs_eager_{label}", t, **graphs_phase(
            imgs, cfg, fresh, owner_probe=label == "512x384"))
        del fresh
    del images_4k
    t = time.perf_counter()
    emit(f"graphs_many_edges_{MANY_FRAMES}x{MANY_HW[0]}x{MANY_HW[1]}", t,
         **many_edges_phase())

    # -- 19. the bench's own entry point on its headline cell
    t = time.perf_counter()
    emit("bench_pano4_512x384", t, **bench_phase())

    assert len(kernels) == len(KERNELS), [k["name"] for k in kernels]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
