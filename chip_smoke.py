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
   chain. It records the inputs of each kernel's first call, then every
   kernel is held against its plain PyTorch version on those inputs, on
   the card, with the time of each;
4. warm default-path stitches of the same images: each kernel's launch
   count in one run (all six must have launched), the median time of three
   runs with the stage times, and agreement with the CPU run of the port
   (plain versions);
5. the chain slice (``SLICE_CONFIG``) on the crops in scene order: one cold
   and one warm run, the CPU-canvas check, and no launch of the fused
   detect (B1) or the pair counts (B5);
6. the matcher API (kernel B7): ``match_features`` and ``match_count`` on
   two feature sets of phase 4, ``match_features`` against the first
   direction of ``match_features_bidir``, and the kernel against its plain
   version on a reference mask with a hole inside the live prefix;
7. the default path on four scrambled 1440x1080 images (the north-star
   size): canvas, discovered edges and start, SIFT and match telemetry,
   cold and warm times, stage times and peak device memory;
8. the command line (``python -m computervisionimagestich2_tpu_torch.cli
   --timing``, bucketed canvases by default) on the crops of phase 3 as
   1.bmp..4.bmp, in a subprocess that must load no jax: its stage and total
   seconds, its launches, and its panorama against the in-process
   ``Stitcher`` under the same configuration (and its distance from phase
   4's exact-canvas panorama);
9. the incremental stitch (``planned=False``) against phase 4's planned
   canvas, bucketed canvases (``exact_canvas=False``) beside exact ones, a
   dump and a resume that must be bit-identical, and the incremental
   bucketed canvas against the CPU run of the port on the same features;
10. four crops of mixed shapes, scrambled: graph discovery from B4 per pair
   (B5 must not launch) and the incremental stitch, against the CPU run;
11. ``StreamingStitcher`` (BASELINE config 5): 10 frames at 1280x720 and 8
   at 1920x1080 panning by 1/8 of the frame width, per-frame ``push()``
   latency (median and worst after the first two frames, split into sift,
   register and composite + blend), keyframe switches, the canvas (on the
   bucket grid, at most 4096 wide) and the launches per frame (B5 never);
   at 720p the canvas of the first two frames against the CPU run of the
   port.

In phases 4, 5 and 8-11 every launch count is set to 0 just before the
path runs and read just after; each path must launch each of its kernels.

The line before the last is the per-kernel JSON summary (B1-B7), the last
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
# name -> (id, route, source, replaced Pallas call site)
KERNELS = {
    "detect_compact": (
        "B1", "cuda", CSRC + "detect.cu", TPU_OPS + "pallas_detect.py:168"),
    "sift_orientation_hist": (
        "B2", "cuda", CSRC + "sift_walks.cu", TPU_OPS + "pallas_sift.py:491"),
    "sift_descriptors": (
        "B3", "cuda", CSRC + "sift_walks.cu", TPU_OPS + "pallas_sift.py:356"),
    "l1_two_nearest": (
        "B4", "cuda", CSRC + "l1_2nn.cu", TPU_OPS + "pallas_distance.py:209"),
    "pair_match_counts": (
        "B5", "cuda", CSRC + "pair_counts.cu",
        TPU_OPS + "pallas_distance.py:431"),
    "warp_image": (
        "B6", "cuda", CSRC + "warp.cu", TPU_OPS + "pallas_warp.py:237"),
    "l1_two_nearest_one_direction": (
        "B7", "cuda", CSRC + "l1_2nn.cu", TPU_OPS + "pallas_distance.py:283"),
}
CHAIN_OFF_PATH = {"detect_compact", "pair_match_counts"}
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


def crops(h: int, w: int, step: int, scale: int, seed: int):
    """Four overlapping [h, w, 3] u8 crops of one deterministic scene."""
    scene = make_scene(np.random.default_rng(seed), h, w + 3 * step, scale)
    return [np.ascontiguousarray(scene[:, i * step: i * step + w])
            for i in range(4)]


def scrambled(images):
    return [images[k] for k in SCRAMBLE]


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device time of one call (CUDA events, after one warm-up)."""
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


class Recorder:
    """Wraps each kernel wrapper at the module attribute the main path
    calls it through, and keeps the arguments of its first call."""

    def __init__(self):
        from computervisionimagestich2_tpu_torch.models import compose
        from computervisionimagestich2_tpu_torch.ops import (detect, distance,
                                                             sift_walks)

        self.sites = {
            "detect_compact": (detect, "detect_compact"),
            "sift_orientation_hist": (sift_walks, "orientation_hist"),
            "sift_descriptors": (sift_walks, "descriptors"),
            "l1_two_nearest": (distance, "two_nearest"),
            "pair_match_counts": (distance, "pair_match_counts"),
            "warp_image": (compose, "warp_image")}
        self.args: dict[str, tuple] = {}
        self._orig = {}

    def __enter__(self):
        for name, (mod, attr) in self.sites.items():
            fn = getattr(mod, attr)
            self._orig[name] = fn

            def wrapped(*args, _fn=fn, _name=name):
                self.args.setdefault(_name, args)
                return _fn(*args)
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


def check_chain(seen: dict) -> list:
    """Graph discovery on the scrambled crops must find the scene's chain:
    three edges, each between crops that neighbour in the scene."""
    adj = seen["adj"]
    edges = sorted({tuple(sorted((i, j))) for i, row in enumerate(adj)
                    for j, a in enumerate(row) if a})
    assert len(edges) == 3, edges
    assert all(abs(SCRAMBLE[i] - SCRAMBLE[j]) == 1 for i, j in edges), edges
    return [list(e) for e in edges]


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


def check_kernels(args: dict) -> list[dict]:
    """Each kernel against its plain version on the recorded main-path
    inputs, both on the card. Tolerances: B1 exact (coords, valid,
    n_total); B2 raw histograms rtol 1e-5 (atol 1e-5 x max), B3 atol 2e-6,
    B4 d1/d2 rtol 1e-5 with i1 equal where the 2-NN gap exceeds 1e-4 d1;
    B5 exact counts, short of the queries within 1e-5 of the ratio; B6
    exact."""
    import torch

    from computervisionimagestich2_tpu_torch.ops import (detect, distance,
                                                         sift_walks, warp)

    rows = []

    def add(name, err, kern, plain, **extra):
        kid, route, source, replaces = KERNELS[name]
        rows.append({"name": name, "id": kid, "route": route,
                     "source": source, "replaces": replaces,
                     "max_abs_err": float(err), "ms": cuda_ms(kern),
                     "plain_ms": cuda_ms(plain), **extra})
        print(json.dumps({"kernel_check": rows[-1]}), flush=True)

    a = args["detect_compact"]
    ck, vk, nk = detect.detect_compact(*a)
    cp, vp, np_ = detect.detect_compact_plain(*a)
    assert torch.equal(ck, cp) and torch.equal(vk, vp), "B1 must be exact"
    assert int(nk) == int(np_), (int(nk), int(np_))
    add("detect_compact", (ck - cp).abs().max(),
        lambda: detect.detect_compact(*a),
        lambda: detect.detect_compact_plain(*a),
        dog=list(a[0].shape), capacity=a[2], candidates=int(vk.sum()),
        n_total=int(nk))

    a = args["sift_orientation_hist"]
    hk, okk = sift_walks.orientation_hist(*a)
    hp, okp = sift_walks.orientation_hist_plain(*a)
    torch.testing.assert_close(hk, hp, rtol=1e-5,
                               atol=1e-5 * float(hp.abs().max()))
    assert torch.equal(okk, okp)
    add("sift_orientation_hist", (hk - hp).abs().max(),
        lambda: sift_walks.orientation_hist(*a),
        lambda: sift_walks.orientation_hist_plain(*a),
        keypoints=int(a[5][0]), slots=int(a[2].shape[0]), radius=a[6])

    a = args["sift_descriptors"]
    dk, okk = sift_walks.descriptors(*a)
    dp, okp = sift_walks.descriptors_plain(*a)
    torch.testing.assert_close(dk, dp, rtol=0, atol=2e-6)
    assert torch.equal(okk, okp)
    add("sift_descriptors", (dk - dp).abs().max(),
        lambda: sift_walks.descriptors(*a),
        lambda: sift_walks.descriptors_plain(*a),
        keypoints=int(a[6][0]), slots=int(a[2].shape[0]), radius=a[7])

    a = args["l1_two_nearest"]
    d1k, d2k, i1k = distance.two_nearest(*a)
    d1p, d2p, i1p = distance.two_nearest_plain(*a)
    live = a[2]
    torch.testing.assert_close(d1k[live], d1p[live], rtol=1e-5, atol=0)
    torch.testing.assert_close(d2k[live], d2p[live], rtol=1e-5, atol=0)
    clear = live & ((d2p - d1p) > 1e-4 * d1p)
    assert torch.equal(i1k[clear], i1p[clear])
    add("l1_two_nearest", (d1k[live] - d1p[live]).abs().max(),
        lambda: distance.two_nearest(*a),
        lambda: distance.two_nearest_plain(*a),
        queries=int(live.sum()), references=int(a[3].sum()),
        i1_equal_frac=float((i1k[live] == i1p[live]).float().mean()))

    a = args["pair_match_counts"]
    pk = distance.pair_match_counts(*a)
    pp = distance.pair_match_counts_plain(*a)
    diff = (pk - pp).abs()
    near = None
    if not torch.equal(pk, pp):
        near = near_ratio(*a)
        print(json.dumps({"b5_differs": {"kernel": pk.tolist(),
                                         "plain": pp.tolist(),
                                         "near_ratio": near}}), flush=True)
        assert (diff.cpu() <= torch.tensor(near)).all(), "B5 disagrees"
    add("pair_match_counts", diff.max(),
        lambda: distance.pair_match_counts(*a),
        lambda: distance.pair_match_counts_plain(*a),
        images=int(a[0].shape[0]), slots=int(a[0].shape[1]),
        live=a[1].sum(dim=1).tolist(), pairs=a[2].tolist(),
        counts=pk.tolist(), near_ratio=near)

    a = args["warp_image"]
    wk = warp.warp_image(*a)
    wp = warp.warp_image_plain(*a)
    assert torch.equal(wk, wp), "B6 must be exact"
    add("warp_image", (wk - wp).abs().max(),
        lambda: warp.warp_image(*a), lambda: warp.warp_image_plain(*a),
        canvas=list(a[4]))
    return rows


def check_matcher(feats_a, feats_b) -> dict:
    """Phase 6: kernel B7 through the matcher API. Returns its kernels
    row (launches = the l1_two_nearest launches of match_features +
    match_count)."""
    import torch

    from computervisionimagestich2_tpu_torch.models import matcher
    from computervisionimagestich2_tpu_torch.ops import _native, distance

    _native.reset_launch_counts()
    pairs = matcher.match_features(feats_a, feats_b)
    n = matcher.match_count(feats_a, feats_b)
    torch.cuda.synchronize()
    launches = _native.launch_counts()["l1_two_nearest"]
    assert launches == 2, launches
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
    kid, route, source, replaces = KERNELS["l1_two_nearest_one_direction"]
    m = (feats_b.desc, feats_a.desc, feats_b.valid, feats_a.valid)
    row = {"name": "l1_two_nearest_one_direction", "id": kid,
           "route": route, "source": source, "replaces": replaces,
           "launches": launches,
           "max_abs_err": float((d1k[qv] - d1p[qv]).abs().max()),
           "ms": cuda_ms(lambda: distance.two_nearest(*m)),
           "plain_ms": cuda_ms(lambda: distance.two_nearest_plain(*m)),
           "queries": int(feats_b.valid.sum()),
           "references": int(feats_a.valid.sum()),
           "masked_references": int((~rv[:int(feats_a.valid.sum())]).sum()),
           "matches": int(pairs.n_raw),
           "i1_equal_frac": float((i1k[qv] == i1p[qv]).float().mean())}
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


def check_launches(launches: dict, off_path=()) -> dict:
    """Every kernel of the path launched; none off it."""
    wrong = {n: c for n, c in launches.items()
             if (c == 0) != (n in off_path)}
    assert not wrong, f"launches {launches}, off the path: {sorted(off_path)}"
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
    check_launches(launches)
    st = Stitcher(cfg, device="cuda")
    _, cold_s = run(st, images)
    out_b, warm_s, launches_b = counted_run(st, images)
    check_launches(launches_b)
    return {"canvas": list(out.shape), "total_s": total, "stage_s": stages,
            "subprocess_wall_s": wall, "launches": launches,
            "modules_imported": len(imported), "jax_modules": len(jax_mods),
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
    check_launches(rep["incremental_launches"])
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
            "detect_compact", "sift_orientation_hist", "sift_descriptors"})
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
    check_launches(launches, {"pair_match_counts"})
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
    from computervisionimagestich2_tpu_torch.ops import _native

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
    kernels = check_kernels(rec.args)
    emit("kernels_vs_plain", t, checked=[k["name"] for k in kernels])

    # -- 4. warm default path: launch counts of one run, median of three
    t = time.perf_counter()
    out, t1, launches = counted_run(st, images)
    stages = dict(st.stage_times)
    warm = [t1] + [run(st, images)[1] for _ in range(2)]
    for k in kernels:
        k["launches"] = launches[k["name"]]
    missing = [n for n, c in launches.items() if c == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"
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
    feats = st._matching_feats()

    # -- 5. the chain slice (SLICE_CONFIG), scene order
    t = time.perf_counter()
    st_chain = stm.Stitcher(SLICE_CONFIG, device="cuda")
    out_chain, chain_cold_s = run(st_chain, scene_order)
    _native.reset_launch_counts()
    out_chain, chain_warm_s = run(st_chain, scene_order)
    chain_launches = _native.launch_counts()
    wrong = [n for n, c in chain_launches.items()
             if (c == 0) != (n in CHAIN_OFF_PATH)]
    assert not wrong, f"chain slice launches: {chain_launches}"
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
    images = scrambled(crops(1440, 1080, 630, 6, seed=1))
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
        out_big, cold_s = run(st, images)
    finally:
        stm.sift_extract_stats, stm.plan_edges = sift_fn, plan_fn
    edges = check_chain(seen)
    stages_big = dict(st.stage_times)
    _native.reset_launch_counts()
    warm = [run(st, images)[1] for _ in range(3)]
    launches_big = {k: c // 3 for k, c in _native.launch_counts().items()}
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
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)

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

    assert len(kernels) == len(KERNELS), [k["name"] for k in kernels]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
