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
   per source, in parallel);
3. a cold default-path stitch of four synthetic 512x384 portrait crops
   handed over in scrambled order; graph discovery must find the scene's
   chain. It records the inputs of every kernel call, then every kernel
   is held against its plain PyTorch version on the first call's inputs,
   on the card, with the time of each, of PyTorch's own call for the same
   function where one exists (``library_ms``, timed here and used nowhere
   in the port) and of the least time the card could take (the bound,
   from these inputs: see ``bound``). B1 is held exactly on every octave
   of the call (one launch detects an image's four); B1-B5 must give the
   same bits twice; B4 the bits of B7 run each way; B5 the ratio counts of
   B4 on every pair; B1, B2 and B6 are also timed on a call with nothing
   to do (what a launch alone costs), and B6 on the panorama's last and
   largest canvas, with the coefficients by value and as a tensor;
4. warm default-path stitches of the same images: each kernel's launch
   count in one run (all six of the path must have launched, B1 once per
   image, B4 once per edge), the median time of three runs with the stage
   times, agreement with the CPU run of the port (plain versions), and one
   ``torch.profiler`` pass of a warm run: device time per kernel and per
   panorama, all launches and host-to-device copies, the device's busy and
   idle share; B6 per panorama beside the floor its launches set;
5. the chain slice (``SLICE_CONFIG``) on the crops in scene order: one cold
   and one warm run, the CPU-canvas check, and no launch of the fused
   detect (B1) or the pair counts (B5);
6. the matcher API (kernel B7): ``match_features`` and ``match_count`` on
   two feature sets of phase 4, ``match_features`` against the first
   direction of ``match_features_bidir``, and the kernel against its plain
   version on a reference mask with a hole inside the live prefix;
7. the default path on four scrambled 1440x1080 images (the north-star
   size): canvas, discovered edges and start, SIFT and match telemetry,
   cold and warm times, stage times and peak device memory; B1 exactly
   against plain on that size's four octave shapes and B6 on its 1489 x
   2948 canvas beside its bound; B6's cases (phase 7a): both warp models,
   exact against plain and by value equal to the tensor call, on the last
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
   register and composite + blend), keyframe switches, the canvas (on the
   bucket grid, at most 4096 wide) and the launches per frame (B5 never);
   at 720p the canvas of the first two frames against the CPU run of the
   port;
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
   alone, bit for bit, no ``batched_canvas_overflow``, warm wall, device
   busy and idle share, peak memory, the blend gates the canvas engages; at
   512x384 the canvases against the port's CPU batch and the content
   extents against the chain-ordered ``Stitcher``; then
   ``batched_pairwise_register`` on three neighbouring pairs: B7 once per
   pair, against plain, its device time per call and per batch, the warps
   against the CPU run;
15. ``match.method="l2pre"`` and ``match.distance="l2"`` at 4 x 512x384
   (B4 and B5 bypassed, as in the JAX package): the chain, the canvas
   against the CPU run, the ratio-test decisions that differ from exact
   L1 on the edges and the graph counts, and the device time of each
   strategy per edge beside B4's.

In phases 4, 5, 8-11 and 12-15 every launch count is set to 0 just before
the path runs and read just after; each path must launch each of its
kernels (B7, the one-direction 2-NN, belongs to the matcher API of phase 6
and to the batched registration of phase 14, and each path runs one of
B6's two branches).

A redesigned kernel is timed beside its earlier design, from an earlier
commit, by ``computervisionimagestich2_tpu_torch/tools/kernel_ab.py``.

The line before the last is the per-kernel JSON summary (B1-B7, B6 as its
two branches), the last
line ``{"ok": true, "device": {...}}``. Any failure raises and exits
non-zero; without a CUDA device it exits 1 and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

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
}
# the device kernels each wrapper launches (substrings of their names)
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
}
# B6's launch counter for each warp model; a stitch runs one of the two
B6_BRANCH = {"bilinear": "warp_image", "projective": "warp_image_projective"}
# device work a launcher starts beside its kernels, by profiler key: B1's
# cudaMemsetAsync of the scan's status words. Counted where a wrapper is
# timed alone (``device_ms``); in the profile of a whole stitch other code's
# memsets carry the same key, so ``profile_run`` books the kernels only
BESIDE_KERNELS = {"detect_compact": ("Memset",)}
# B7: the matcher API (phase 6) and the batched registration (phase 14)
OFF_MAIN_PATH = {"l1_two_nearest"}
CHAIN_OFF_PATH = OFF_MAIN_PATH | {"detect_compact", "pair_match_counts"}


def off_branch(model: str) -> set:
    """B6's counter of the warp model a path does not run."""
    return {v for k, v in B6_BRANCH.items() if k != model}
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
SCRAMBLE = [2, 0, 3, 1]  # scene position of each image handed over


def emit(phase: str, t0: float, **kv) -> dict:
    rec = {"phase": phase, "ok": True,
           "seconds": round(time.perf_counter() - t0, 3), **kv}
    print(json.dumps(rec), flush=True)
    return rec


def make_scene(rng, h: int, w: int, scale: int) -> np.ndarray:
    """tests/test_integration.py::make_scene at ``scale`` times its feature
    size: box-smoothed noise (made at 1/scale and upsampled bilinearly)
    plus solid discs, at the same density per feature area."""
    import torch

    lh, lw = -(-h // scale), -(-w // scale)
    img = rng.uniform(60, 200, (lh, lw, 3))
    for _ in range(3):
        img = (np.roll(img, 1, 0) + img + np.roll(img, -1, 0)) / 3
        img = (np.roll(img, 1, 1) + img + np.roll(img, -1, 1)) / 3
    t = torch.as_tensor(img).permute(2, 0, 1)[None]
    img = torch.nn.functional.interpolate(
        t, size=(h, w), mode="bilinear", align_corners=False)[0]
    img = img.permute(1, 2, 0).numpy().copy()
    n_blobs = int(25 * lh * lw / (140 * 200))
    for _ in range(n_blobs):
        cy, cx = rng.uniform(10, h - 10), rng.uniform(10, w - 10)
        r = rng.uniform(3, 9) * scale
        col = rng.uniform(0, 255, 3)
        y0, y1 = int(max(cy - r, 0)), int(min(cy + r + 1, h))
        x0, x1 = int(max(cx - r, 0)), int(min(cx + r + 1, w))
        ys, xs = np.mgrid[y0:y1, x0:x1]
        m = (ys - cy) ** 2 + (xs - cx) ** 2 < r * r
        img[y0:y1, x0:x1][m] = col
    return np.clip(img, 0, 255).astype(np.uint8)


def crops(h: int, w: int, step: int, scale: int, seed: int, n: int = 4):
    """``n`` overlapping [h, w, 3] u8 crops of one deterministic scene."""
    scene = make_scene(np.random.default_rng(seed), h, w + (n - 1) * step,
                       scale)
    return [np.ascontiguousarray(scene[:, i * step: i * step + w])
            for i in range(n)]


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


def scrambled(images):
    return [images[k] for k in SCRAMBLE]


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


def _dev_us(e) -> float:
    """Device time (us) of one ``torch.profiler`` key_averages entry."""
    return (getattr(e, "self_device_time_total", 0)
            or getattr(e, "self_cuda_time_total", 0))


def _device_events(prof) -> list:
    return [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and _dev_us(e) > 0]


def device_ms(fn, name: str, reps: int = 10, keys=None) -> float | None:
    """Mean device time per call of ``fn`` spent in the device work of
    wrapper ``name`` (``DEVICE_KERNELS`` and ``BESIDE_KERNELS``, or the
    profiler keys ``keys``), from ``torch.profiler`` over ``reps`` calls
    after one warm-up: the device work alone, without the host's gaps
    between launches. The profiler now and then drops part of a short
    window, so a window counts only if it holds a whole number of matching
    device events per call, at least one; after five windows without one,
    None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if keys is None:
        keys = DEVICE_KERNELS[name] + BESIDE_KERNELS.get(name, ())
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in _device_events(prof)
                if any(k in e.key for k in keys)]
        count = sum(e.count for e in hits)
        if count >= reps and count % reps == 0:
            return sum(_dev_us(e) for e in hits) / 1e3 / reps
    return None


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
    only one the kernels run, is the wrappers' default."""

    def __init__(self, names=None):
        from computervisionimagestich2_tpu_torch.models import compose
        from computervisionimagestich2_tpu_torch.ops import (detect, distance,
                                                             sift_walks)

        self.sites = {
            "detect_compact": (detect, "detect_compact_octaves"),
            "sift_orientation_hist": (sift_walks, "orientation_hist"),
            "sift_descriptors": (sift_walks, "descriptors"),
            "l1_two_nearest_bidir": (distance, "two_nearest_bidir"),
            "pair_match_counts": (distance, "pair_match_counts"),
            "warp_image": (compose, "warp_image"),
            "l1_two_nearest": (distance, "two_nearest")}
        if names is None:  # the default path's wrappers
            names = [n for n in self.sites if n not in OFF_MAIN_PATH]
        self.sites = {n: self.sites[n] for n in names}
        self.args: dict[str, tuple] = {}
        self.calls: dict[str, list] = {name: [] for name in self.sites}
        self._orig = {}

    def __enter__(self):
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


def check_chain(seen: dict) -> list:
    """Graph discovery on the scrambled crops must find the scene's chain:
    three edges, each between crops that neighbour in the scene."""
    edges = graph_edges(seen)
    assert len(edges) == 3, edges
    assert all(abs(SCRAMBLE[i] - SCRAMBLE[j]) == 1 for i, j in edges), edges
    return edges


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
    """Kernel B5 on the features of ``images`` (``pair_inputs``):
    ``check_b5``, its device time beside its bound, and the device memory
    the call takes at its peak (scratch and result), which must stay
    within the budget."""
    import torch

    from computervisionimagestich2_tpu_torch.ops import distance

    from computervisionimagestich2_tpu_torch import DEFAULT_CONFIG

    a = (*pair_inputs(images, trimmed),
         DEFAULT_CONFIG.match.ratio_threshold)
    pk, diff, near = check_b5(a, plain)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    distance.pair_match_counts(*a)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    row = {"images": int(a[0].shape[0]), "slots": int(a[0].shape[1]),
           "live": a[1].sum(dim=1).tolist(), "pairs": int(a[2].shape[0]),
           "chunk": distance.pair_chunk(a[0].shape[1], a[2].shape[0],
                                        distance.PAIR_SCRATCH_BYTES),
           "scratch_budget_bytes": distance.PAIR_SCRATCH_BYTES,
           "peak_call_bytes": int(peak), "max_abs_err": diff,
           "near_ratio": near, "equals_b4_counts": True,
           "counts_sum": int(pk.sum()),
           **kernel_ms(lambda: distance.pair_match_counts(*a),
                       "pair_match_counts"),
           **kernel_bound("pair_match_counts", a)}
    assert peak <= distance.PAIR_SCRATCH_BYTES + (1 << 20), row
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


def b2_pixels(mod, ang, x, y, sigma, n_valid, radius, *_) -> int:
    """Window pixels of the live keypoints that kernel B2 adds to a bin:
    |dx|, |dy| <= wr = max(floor(4.5 sigma), 1), r^2 < wr^2 + 0.6, inside
    the image (csrc/sift_walks.cu)."""
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
    return int(sel.sum())


def b3_pixels(mod, ang, x, y, sigma, angle, n_valid, radius, magnif,
              *_) -> int:
    """Window pixels of the live keypoints that kernel B3 adds to a bin:
    inside the loop bounds of vl/sift.c:1352-1357 and inside the +-2.5
    support of the spatial hats after the rotation."""
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
    return int(sel.sum())


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
    if name == "sift_orientation_hist":
        n = a[2].shape[0]
        return bound(_nbytes(a[0], a[1]) + 3 * 4 * n + 4 + n * 36 * 4,
                     B2_OPS_PER_PIXEL * b2_pixels(*a))
    if name == "sift_descriptors":
        n = a[2].shape[0]
        return bound(_nbytes(a[0], a[1]) + 4 * 4 * n + 4 + n * 128 * 4,
                     B3_OPS_PER_PIXEL * b3_pixels(*a))
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
        # and the bounds test (4); the 48 bytes of parameters by value
        ops = (22 if model == "bilinear" else 29) * ho * wo
        return bound(_nbytes(src) + 48 + ho * wo * c * 4, ops)
    raise KeyError(name)


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
    become a tensor on the source's device)."""
    import torch

    from computervisionimagestich2_tpu_torch.ops import warp

    c = torch.as_tensor(np.asarray(coeffs, np.float32), device=src.device)
    return warp.warp_image_plain(src, c, ox, oy, canvas, model)


def b6_at(a: tuple) -> dict:
    """Kernel B6 on the arguments ``a`` (src, coeffs, ox, oy, canvas,
    model) of one call: exact against plain, the coefficients by value and
    as a device tensor giving the same canvas; its device time beside its
    bound."""
    import torch

    from computervisionimagestich2_tpu_torch.ops import warp

    got = warp.warp_image(*a)
    as_tensor = warp.warp_image(a[0], torch.as_tensor(
        np.asarray(a[1], np.float32), device=a[0].device), *a[2:])
    assert torch.equal(got, b6_plain(*a)), ("B6 must be exact", a[4], a[5])
    assert torch.equal(as_tensor, got), "B6: tensor and by-value differ"
    name = B6_BRANCH[a[5]]
    row = {"model": a[5], "src": list(a[0].shape), "canvas": list(a[4]),
           "covered_share": float((got != 0).any(dim=2).float().mean()),
           **kernel_ms(lambda: warp.warp_image(*a), name),
           **kernel_bound(name, a)}
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
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
    """B6's cases on the card, both models, each exact against plain and
    by value equal to the tensor call (``b6_at``): the main path's last
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

    from computervisionimagestich2_tpu_torch.ops import (detect, distance,
                                                         sift_walks, warp)

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
    got = distance.two_nearest_bidir(*a)
    again = distance.two_nearest_bidir(*a)
    one_way = (distance.two_nearest(q, r, qv, rv),
               distance.two_nearest(r, q, rv, qv))

    def plain_bidir():
        return (distance.two_nearest_plain(q, r, qv, rv),
                distance.two_nearest_plain(r, q, rv, qv))

    plain = plain_bidir()
    lib_q, lib_r = q[qv].contiguous(), r[rv].contiguous()
    lib = l1_library(lib_q, lib_r, both=True)
    err, i1_equal = 0.0, []
    for side, ok in ((0, qv), (1, rv)):
        (k1, k2, ki), (p1, p2, pi) = got[side], plain[side]
        torch.testing.assert_close(k1[ok], p1[ok], rtol=1e-5, atol=0)
        torch.testing.assert_close(k2[ok], p2[ok], rtol=1e-5, atol=0)
        clear = ok & ((p2 - p1) > 1e-4 * p1)
        assert torch.equal(ki[clear], pi[clear])
        assert all(torch.equal(x, y) for x, y in zip(got[side], again[side])), \
            "B4 is not deterministic"
        assert all(torch.equal(x, y)
                   for x, y in zip(got[side], one_way[side])), \
            "B4 and B7 disagree on the bits"
        torch.testing.assert_close(lib[side].values[:, 0] if side == 0
                                   else lib[side].values[0], k1[ok],
                                   rtol=1e-4, atol=0)
        err = max(err, float((k1[ok] - p1[ok]).abs().max()))
        i1_equal.append(float((ki[ok] == pi[ok]).float().mean()))
    add("l1_two_nearest_bidir", err, lambda: distance.two_nearest_bidir(*a),
        plain_bidir, library=lambda: l1_library(lib_q, lib_r, both=True),
        library_note="three calls: torch.cdist(p=1), then topk(2, "
                     "largest=False) along each side",
        queries=int(qv.sum()), references=int(rv.sum()),
        i1_equal_frac=i1_equal)

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
    return rows


def b6_launch_floor(row: dict) -> dict:
    """B6 per panorama beside the floor its launches set: ``launches``
    times the device time of a launch alone, and the share of the bound
    the panorama could reach at that launch count, bound / (bound +
    floor)."""
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
    return {"library_note": "no PyTorch call computes it",
            "model": last[5], "canvas": list(calls[0][4]),
            "at_last_canvas": b6_at(last),
            "launch_alone_ms": device_ms(
                lambda: warp.warp_image(*last[:4], (1, 1), last[5]),
                B6_BRANCH[last[5]]),
            "launch_alone": "the last call's arguments with a 1 x 1 canvas"}


def profile_run(stitcher, images) -> dict:
    """One warm stitch under ``torch.profiler`` (``profile_call``)."""
    return profile_call(lambda: stitcher.stitch(images),
                        OFF_MAIN_PATH | off_branch(stitcher.config.warp_model))


def profile_call(fn, off) -> dict:
    """One warm call of ``fn`` (which synchronises the card) under
    ``torch.profiler``: device time and launches per kernel of the port
    (by ``DEVICE_KERNELS``; every one not in ``off`` must have run), all
    device kernels and the host-to-device copies among them, the device's
    busy time (kernels and copies) against the wall."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        wall = time.perf_counter() - t
    dev = _device_events(prof)
    busy_ms = sum(_dev_us(e) for e in dev) / 1e3
    per = {}
    for name, subs in DEVICE_KERNELS.items():
        hits = [e for e in dev if any(s in e.key for s in subs)]
        per[name] = {"ms": sum(_dev_us(e) for e in hits) / 1e3,
                     "device_launches": sum(e.count for e in hits)}
    out = {"wall_s": wall, "device_busy_ms": busy_ms,
           "idle_share": 1.0 - busy_ms / 1e3 / wall if busy_ms else None,
           "device_events": sum(e.count for e in dev),
           "memcpy_htod_events": sum(e.count for e in dev if "HtoD" in e.key),
           "top": sorted(((e.key[:80], _dev_us(e) / 1e3, e.count)
                          for e in dev), key=lambda x: -x[1])[:12],
           "kernels": per}
    assert busy_ms > 0 and all(per[n]["ms"] > 0 for n in per
                               if n not in off), out
    return out


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


def canvas_vs_cpu(out, out_cpu) -> float:
    """Shape within +-3 px and MAD <= 3 u8 levels over the common canvas
    (the end-to-end gate of tests/test_torch_stitch.py)."""
    assert abs(out.shape[0] - out_cpu.shape[0]) <= 3, (out.shape,
                                                       out_cpu.shape)
    assert abs(out.shape[1] - out_cpu.shape[1]) <= 3, (out.shape,
                                                       out_cpu.shape)
    h = min(out.shape[0], out_cpu.shape[0])
    w = min(out.shape[1], out_cpu.shape[1])
    mad = float(np.abs(out[:h, :w].astype(np.int64)
                       - out_cpu[:h, :w].astype(np.int64)).mean())
    assert mad <= 3.0, mad
    return mad


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


def cli_phase(images, out_exact) -> tuple[dict, np.ndarray]:
    """Phase 8: the command line in a fresh interpreter on 1.bmp..4.bmp,
    held against the in-process ``Stitcher`` under the configuration its
    flags give (``DEFAULT_CONFIG`` with bucketed canvases). ``-X
    importtime`` lists every module the process imported. Returns the
    report and the in-process bucketed canvas."""
    import tempfile

    from computervisionimagestich2_tpu_torch import cli
    from computervisionimagestich2_tpu_torch.models.stitcher import Stitcher
    from computervisionimagestich2_tpu_torch.utils import (load_image,
                                                           save_image)

    with tempfile.TemporaryDirectory() as d:
        for k, img in enumerate(images):
            save_image(f"{d}/{k + 1}.bmp", img)
        argv = ["--input", d, "--output", f"{d}/out.bmp", "--timing"]
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
    return {"canvas": list(out.shape), "total_s": total, "stage_s": stages,
            "subprocess_wall_s": wall, "launches": launches,
            "modules_imported": len(imported), "jax_modules": len(jax_mods),
            "jax_package_modules": len(jax_pkg),
            "mad_vs_stitcher": canvas_vs_cpu(out, out_b),
            "equals_stitcher": bool(np.array_equal(out, out_b)),
            "stitcher_cold_s": cold_s, "stitcher_warm_s": warm_s,
            "stitcher_launches": launches_b,
            "stitcher_stage_s": dict(st.stage_times),
            "mean_diff_vs_exact": mean_diff(out_exact, out)}, out_b


def incremental_phase(images, out_planned, out_bucketed, config) -> dict:
    """Phase 9 on the crops of phase 3: the incremental stitch against
    the planned canvas; bucketed against exact canvases (enhanced, and the
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
    _, rep["incremental_cold_s"] = run(st, images)
    out_i, rep["incremental_warm_s"], rep["incremental_launches"] = \
        counted_run(st, images)
    check_launches(rep["incremental_launches"], b4=3)
    rep["incremental_stage_s"] = dict(st.stage_times)
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


def stitch_phase(images, config, cpu: str = "full", record=(),
                 off_path=(), chain: bool = True) -> tuple:
    """One configuration's stitch of scrambled crops on the card: graph
    discovery finds the scene's chain (with ``chain``; else the edges it
    finds are recorded, beside the CPU run's); a cold run (recording the
    calls of the wrappers ``record``, the SIFT telemetry and the last
    blend's arguments) and a warm run with its launch counts (every kernel
    of the path, none of ``off_path``, B4 unless off the path and B6's
    branch of ``config.warp_model`` once per stitched image); no
    ``match_overflow`` is logged; the canvas against the port's CPU run
    (``cpu="full"``: from the images; ``"resumed"``: on the features the
    card's run dumped, SIFT skipped). Returns (report, recorder, stitcher,
    the last blend's arguments)."""
    import shutil
    import tempfile

    from computervisionimagestich2_tpu_torch.models import stitcher as stm
    from computervisionimagestich2_tpu_torch.utils import obs

    warned, blends, sift_dropped = [], [], []
    warn, blend, sift = obs.warn, stm.blend_edge, stm.sift_extract_stats

    def warn_rec(stage, **kv):
        warned.append(stage)
        warn(stage, **kv)

    def blend_rec(*a):
        blends.append(a)
        return blend(*a)

    def sift_rec(*a):
        f, st = sift(*a)
        sift_dropped.append(st.tolist())
        return f, st

    rep = {}
    with tempfile.TemporaryDirectory() as d:
        art = f"{d}/card" if cpu == "resumed" else None
        st = stm.Stitcher(config, device="cuda", artifact_dir=art)
        seen = record_ordering(st)
        obs.warn, stm.blend_edge, stm.sift_extract_stats = (
            warn_rec, blend_rec, sift_rec)
        try:
            with Recorder(record) as rec:
                _, rep["cold_s"] = run(st, images)
            rep["stage_s_cold"] = dict(st.stage_times)
            out, rep["warm_s"], launches = counted_run(st, images)
        finally:
            obs.warn, stm.blend_edge, stm.sift_extract_stats = (
                warn, blend, sift)
        rep["edges"] = check_chain(seen) if chain else graph_edges(seen)
        rep["start"] = seen["start"]
        n_stitched = len(images) - 1  # a spanning tree ("skip" revisits)
        check_launches(launches, off_path, model=config.warp_model,
                       b4=None if "l1_two_nearest_bidir" in off_path
                       else n_stitched)
        assert launches[B6_BRANCH[config.warp_model]] == n_stitched, launches
        assert "match_overflow" not in warned, warned
        t = time.perf_counter()
        if cpu == "resumed":
            shutil.copytree(f"{d}/card", f"{d}/cpu")
            st_cpu = stm.Stitcher(config, device="cpu",
                                  artifact_dir=f"{d}/cpu")
            st_cpu.prepare = None  # a resume must not run SIFT
        else:
            st_cpu = stm.Stitcher(config, device="cpu")
        seen_cpu = record_ordering(st_cpu)
        out_cpu = st_cpu.stitch(images, resume=cpu == "resumed")
        rep["cpu_s"] = time.perf_counter() - t
        rep["cpu_edges"] = graph_edges(seen_cpu)
    rep.update(canvas=list(out.shape), cpu_canvas=list(out_cpu.shape),
               cpu_run=cpu, mad_vs_cpu=canvas_vs_cpu(out, out_cpu),
               stage_s_warm=dict(st.stage_times), launches=launches,
               warnings=sorted(set(warned)),
               sift_dropped=sift_dropped[:len(images)])
    assert out.mean() > 20, "empty canvas"
    return rep, rec, st, blends[-1]


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
        dev = _device_events(prof)
        out[impl] = {"ms": ms, "device_launches": sum(e.count for e in dev),
                     "device_ms": sum(_dev_us(e) for e in dev) / 1e3}
    return out


MIXED_SHAPES = [(512, 384), (500, 384), (512, 360), (480, 384)]


def mixed_phase(scene_order, config) -> dict:
    """Phase 10: the crops of phase 3 cut to four shapes, scrambled."""
    from computervisionimagestich2_tpu_torch.models.stitcher import Stitcher

    images = scrambled([np.ascontiguousarray(img[:h, :w]) for img, (h, w)
                        in zip(scene_order, MIXED_SHAPES)])
    st = Stitcher(config, device="cuda")
    seen = record_ordering(st)
    _, cold_s = run(st, images)
    edges = check_chain(seen)
    out, warm_s, launches = counted_run(st, images)
    assert st._feats_stacked is None
    check_launches(launches, {"pair_match_counts"}, b4=6 + len(edges))
    t = time.perf_counter()
    out_cpu = Stitcher(config, device="cpu").stitch(images)
    cpu_s = time.perf_counter() - t
    return {"images": [list(i.shape) for i in images], "edges": edges,
            "start": seen["start"], "canvas": list(out.shape),
            "cold_s": cold_s, "warm_s": warm_s,
            "stage_s": dict(st.stage_times), "launches": launches,
            "cpu_canvas": list(out_cpu.shape), "cpu_s": cpu_s,
            "mad_vs_cpu": canvas_vs_cpu(out, out_cpu)}


def stream_phase(config, h: int, w: int, n_frames: int, scale: int,
                 seed: int, cpu_check: bool) -> dict:
    """Phase 11 at one frame size: ``n_frames`` crops of one scene panning
    by w / 8, pushed one by one; with ``cpu_check``, the first two frames
    again through the CPU run of the port, whose canvas the card's must
    match."""
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

    ss = stream("cuda")
    per = []
    _native.reset_launch_counts()
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
    launches = _native.launch_counts()
    check_launches(launches, {"pair_match_counts"})
    canvas = ss.canvas()
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
    steady = per[2:]

    def stat(vals):
        return {"median": statistics.median(vals), "worst": max(vals)}

    return {"frames": n_frames, "frame": [h, w], "pan": pan,
            "first_push_s": per[0]["push_s"],
            "push_s": stat([p["push_s"] for p in steady]),
            **{f"{k}_s": stat([p["stage_s"][k] for p in steady])
               for k in ("sift", "register", "composite")},
            "keyframe_switches": ss.n_keyframe_switches,
            "canvas": list(canvas.shape),
            "content_cols_top_rows": int(content.any(axis=0).sum()),
            "launches": launches, "per_frame": per,
            "two_frames_mad_vs_cpu": mad, "two_frames_s": two_s,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


BATCH_SEEDS = (0, 3)  # the batch's two panoramas: "Input/" and "Input2/"


def u8(t) -> np.ndarray:
    """A u8-valued float canvas (a tensor on any device) as u8 numpy."""
    return t.cpu().numpy().astype(np.uint8)


def batched_phase(h: int, w: int, step: int, scale: int,
                  cpu_check: bool) -> dict:
    """Phase 14 at one frame size: ``batched_stitch_chain`` (BASELINE
    config 3) on B = 2 panoramas of four crops in scene order, one from
    each of ``BATCH_SEEDS``, on the default fixed canvas. A cold batch,
    then a warm one with its launch counts (B1 once per image, B4 and B6
    once per edge, B5 and B7 never); the median wall of three warm batches,
    one under ``torch.profiler`` (busy, idle), the peak memory of one;
    each panorama equal to ``_stitch_one_fixed`` on it alone, bit for bit;
    no ``batched_canvas_overflow``; which blend gates the canvas engages.
    With ``cpu_check``: each canvas against the CPU batch of the port
    (MAD <= 3 u8 levels), and each content extent equal to the canvas of
    the chain-ordered ``Stitcher`` (exact canvas, no enhancement) on the
    same images."""
    import dataclasses

    import torch

    from computervisionimagestich2_tpu_torch import DEFAULT_CONFIG
    from computervisionimagestich2_tpu_torch.models import blender
    from computervisionimagestich2_tpu_torch.models import stitcher as stm
    from computervisionimagestich2_tpu_torch.ops import _native
    from computervisionimagestich2_tpu_torch.parallel import batched
    from computervisionimagestich2_tpu_torch.utils import obs

    cfg = DEFAULT_CONFIG
    pans = np.stack([np.stack(crops(h, w, step, scale, seed=sd))
                     for sd in BATCH_SEEDS])
    n_pan, k = pans.shape[:2]
    canvas = batched.default_canvas(h, w, k, cfg)
    warned, warn = [], obs.warn

    def warn_rec(stage, **kv):
        warned.append(stage)
        warn(stage, **kv)

    def run_batch():
        t = time.perf_counter()
        out, plans = batched.batched_stitch_chain(pans, cfg, device="cuda")
        torch.cuda.synchronize()
        return out, plans, time.perf_counter() - t

    obs.warn = warn_rec
    try:
        _, _, cold_s = run_batch()
        _native.reset_launch_counts()
        out, plans, t1 = run_batch()
        launches = _native.launch_counts()
        warm = [t1] + [run_batch()[2] for _ in range(2)]
    finally:
        obs.warn = warn
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
        assert np.array_equal(plans[i], plan), ("plans differ", i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run_batch()
    peak = torch.cuda.max_memory_allocated()
    prof = profile_call(run_batch, OFF_MAIN_PATH | {"pair_match_counts"}
                        | off_branch(cfg.warp_model))
    rep = {"panoramas": int(n_pan), "images_per_panorama": int(k),
           "frame": [h, w], "seeds": list(BATCH_SEEDS),
           "canvas": list(canvas), "canvas_mpx": canvas[0] * canvas[1] / 1e6,
           "blend_bf16": blender.resolve_dtype(
               cfg.blend.dtype, *canvas, cfg.blend.bf16_auto_area) == "bf16",
           "blend_seam_band": blender.seam_auto_engaged(cfg.blend, *canvas),
           "content_wh": plans[:, -1, 20:22].astype(int).tolist(),
           "match_dropped": plans[:, :, 22].astype(int).tolist(),
           "cold_s": cold_s, "warm_median_s": statistics.median(warm),
           "warm_s": warm, "launches": launches,
           "equals_one_at_a_time": True, "warnings": sorted(set(warned)),
           "peak_mem_gib": peak / 2 ** 30, "profile": prof}
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


def register_phase(scene_order, b7: dict) -> dict:
    """Phase 14's registration: ``batched_pairwise_register`` on the B = 3
    neighbouring pairs of the 512x384 crops (luma, unprojected). A cold
    call, then one with its launch counts (B7 once per pair, B1 once per
    image, B4, B5 and B6 never); B7 against its plain version on each of
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
               "l1_two_nearest"}
    assert all((c > 0) == (k in on_path) for k, c in launches.items()), \
        launches
    assert launches["l1_two_nearest"] == n, launches
    assert launches["detect_compact"] == 2 * n, launches
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
    emit("build", t, library=str(lib.relative_to(ROOT)))

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

    # -- 4. warm default path: launch counts of one run, median of three
    t = time.perf_counter()
    out, t1, launches = counted_run(st, images)
    stages = dict(st.stage_times)
    warm = [t1] + [run(st, images)[1] for _ in range(2)]
    check_launches(launches, b4=len(edges))
    assert launches["detect_compact"] == len(images), launches
    assert stages["ordering"] > 0, stages
    t_cpu = time.perf_counter()
    out_cpu = stm.Stitcher(DEFAULT_CONFIG, device="cpu").stitch(images)
    cpu_s = time.perf_counter() - t_cpu
    mad = canvas_vs_cpu(out, out_cpu)
    assert 700 <= out.shape[1] <= 1400 and out.shape[0] <= 700, out.shape
    emit("default_512x384_warm", t, images=[list(i.shape) for i in images],
         canvas=list(out.shape), warm_median_s=statistics.median(warm),
         warm_s=warm, stage_s=stages, launches=launches,
         warm_equals_cold=bool(np.array_equal(out, out_cold)),
         cpu_canvas=list(out_cpu.shape), cpu_s=cpu_s, mad_vs_cpu=mad)
    t = time.perf_counter()
    prof = profile_run(st, images)
    for k in kernels:
        k["launches"] = k["launches_per_panorama"] = launches[k["name"]]
        k["device_ms_per_panorama"] = prof["kernels"][k["name"]]["ms"]
        k["share_of_bound_per_panorama"] = (
            k["bound_ms_per_panorama"] / k["device_ms_per_panorama"]
            if k["device_ms_per_panorama"] else None)
    b6 = next(k for k in kernels if k["name"] == "warp_image")
    b6.update(b6_launch_floor(b6))
    emit("default_512x384_profile", t, **prof)
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
    telemetry = {}
    sift_fn, plan_fn = stm.sift_extract_stats, stm.plan_edges

    def sift_rec(*a):
        f, s = sift_fn(*a)
        telemetry.setdefault("sift_dropped", []).append(s.tolist())
        return f, s

    def plan_rec(*a):
        plan = plan_fn(*a)
        telemetry["match_dropped"] = plan[:, 22].astype(int).tolist()
        return plan

    torch.cuda.reset_peak_memory_stats()
    stm.sift_extract_stats, stm.plan_edges = sift_rec, plan_rec
    try:
        st = stm.Stitcher(DEFAULT_CONFIG, device="cuda")
        seen = record_ordering(st)
        with Recorder(("detect_compact", "warp_image")) as rec:
            out_big, cold_s = run(st, images)
    finally:
        stm.sift_extract_stats, stm.plan_edges = sift_fn, plan_fn
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
    torch.cuda.reset_peak_memory_stats()
    edges = check_chain(seen)
    stages_big = dict(st.stage_times)
    _native.reset_launch_counts()
    warm = [run(st, images)[1] for _ in range(3)]
    launches_big = {k: c // 3 for k, c in _native.launch_counts().items()}
    assert launches_big["detect_compact"] == len(images), launches_big
    assert out_big.dtype == np.uint8 and out_big.shape[2] == 3
    assert 2000 <= out_big.shape[1] <= 4000, out_big.shape
    assert out_big.shape[0] <= 2000, out_big.shape
    assert out_big.mean() > 20, "empty canvas"
    emit("default_1440x1080", t, images=[list(i.shape) for i in images],
         scramble=SCRAMBLE, edges=edges, start=seen["start"],
         canvas=list(out_big.shape), cold_s=cold_s,
         warm_median_s=statistics.median(warm), warm_s=warm,
         stage_s_cold=stages_big, stage_s_warm=dict(st.stage_times),
         launches_per_run=launches_big, **telemetry,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
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
    import dataclasses

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
    sift_fn, dropped = stm.sift_extract_stats, []

    def sift_rec(*a):
        f, s = sift_fn(*a)
        dropped.append(s.tolist())
        return f, s

    stm.sift_extract_stats = sift_rec
    try:
        with Recorder(("detect_compact",)) as rec:
            st.prepare(images_big)
            torch.cuda.synchronize()
    finally:
        stm.sift_extract_stats = sift_fn
    prep_s = time.perf_counter() - t
    emit("o_min_-1_1440x1080_features", t, prepare_s=prep_s,
         sift_dropped=dropped, first_octave=list(
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

    assert len(kernels) == len(KERNELS), [k["name"] for k in kernels]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
