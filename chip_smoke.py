#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It drives ``computervisionimagestich2_tpu_torch``'s main path
(``Stitcher(SLICE_CONFIG, device="cuda").stitch``) in phases and prints one
JSON line per phase with its result and seconds:

1. environment: a CUDA device, its name and power limit (nvidia-smi);
2. build: the CUDA kernels, compiled from ``csrc/`` with nvcc;
3. a cold stitch of four synthetic 512x384 portrait images that records
   the inputs of each kernel's first call on the main path; then every
   kernel against its plain PyTorch version on those inputs, on the card,
   with the time of each;
4. warm stitches of the same images: each kernel's launch count in one
   run (every kernel must have launched), the median time of three runs,
   and agreement with the CPU run of the port (plain versions);
5. the same pipeline on four 1440x1080 images (the north-star size,
   where the bf16 blend and the seam-band gates engage).

The line before the last is the per-kernel JSON summary, the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device it exits 1 and prints no result.
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

# name -> (route, source, replaced Pallas call site)
KERNELS = {
    "sift_orientation_hist": (
        "cuda", "computervisionimagestich2_tpu_torch/csrc/sift_walks.cu",
        "computervisionimagestich2_tpu/ops/pallas_sift.py:491"),
    "sift_descriptors": (
        "cuda", "computervisionimagestich2_tpu_torch/csrc/sift_walks.cu",
        "computervisionimagestich2_tpu/ops/pallas_sift.py:356"),
    "l1_two_nearest": (
        "cuda", "computervisionimagestich2_tpu_torch/csrc/l1_2nn.cu",
        "computervisionimagestich2_tpu/ops/pallas_distance.py:209"),
    "warp_image": (
        "cuda", "computervisionimagestich2_tpu_torch/csrc/warp.cu",
        "computervisionimagestich2_tpu/ops/pallas_warp.py:237"),
}


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
        from computervisionimagestich2_tpu_torch.ops import distance
        from computervisionimagestich2_tpu_torch.ops import sift_walks

        self.sites = {"sift_orientation_hist": (sift_walks, "orientation_hist"),
                      "sift_descriptors": (sift_walks, "descriptors"),
                      "l1_two_nearest": (distance, "two_nearest"),
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


def check_kernels(args: dict) -> list[dict]:
    """Each kernel against its plain version on the recorded main-path
    inputs, both on the card. Tolerances: B2 raw histograms rtol 1e-5
    (atol 1e-5 x max), B3 atol 2e-6, B4 d1/d2 rtol 1e-5 with i1 equal
    where the 2-NN gap exceeds 1e-4 d1, B6 exact."""
    import torch

    from computervisionimagestich2_tpu_torch.ops import distance, sift_walks
    from computervisionimagestich2_tpu_torch.ops import warp

    rows = []

    def add(name, err, kern, plain, **extra):
        route, source, replaces = KERNELS[name]
        rows.append({"name": name, "route": route, "source": source,
                     "replaces": replaces, "max_abs_err": float(err),
                     "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain),
                     **extra})
        print(json.dumps({"kernel_check": rows[-1]}), flush=True)

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

    a = args["warp_image"]
    wk = warp.warp_image(*a)
    wp = warp.warp_image_plain(*a)
    assert torch.equal(wk, wp), "B6 must be exact"
    add("warp_image", (wk - wp).abs().max(),
        lambda: warp.warp_image(*a), lambda: warp.warp_image_plain(*a),
        canvas=list(a[4]))
    return rows


def run(stitcher, images):
    t = time.perf_counter()
    out = stitcher.stitch(images)
    return out, time.perf_counter() - t


def main() -> int:
    t0 = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from computervisionimagestich2_tpu_torch import SLICE_CONFIG
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

    # -- 3. cold run at 4 x 512x384, recording the kernels' inputs
    t = time.perf_counter()
    images = crops(512, 384, 224, 2, seed=0)
    st = stm.Stitcher(SLICE_CONFIG, device="cuda")
    with Recorder() as rec:
        out_cold, cold_s = run(st, images)
    assert set(rec.args) == set(KERNELS), sorted(rec.args)
    kernels = check_kernels(rec.args)
    emit("kernels_vs_plain", t, checked=[k["name"] for k in kernels])

    # -- 4. warm runs: launch counts of one run, median of three
    t = time.perf_counter()
    _native.reset_launch_counts()
    out, t1 = run(st, images)
    launches = _native.launch_counts()
    stages = dict(st.stage_times)
    warm = [t1] + [run(st, images)[1] for _ in range(2)]
    for k in kernels:
        k["launches"] = launches[k["name"]]
    missing = [n for n, c in launches.items() if c == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"
    t_cpu = time.perf_counter()
    out_cpu = stm.Stitcher(SLICE_CONFIG, device="cpu").stitch(images)
    cpu_s = time.perf_counter() - t_cpu
    h = min(out.shape[0], out_cpu.shape[0])
    w = min(out.shape[1], out_cpu.shape[1])
    mad = float(np.abs(out[:h, :w].astype(np.int64)
                       - out_cpu[:h, :w].astype(np.int64)).mean())
    assert abs(out.shape[0] - out_cpu.shape[0]) <= 3, (out.shape,
                                                       out_cpu.shape)
    assert abs(out.shape[1] - out_cpu.shape[1]) <= 3, (out.shape,
                                                       out_cpu.shape)
    assert mad <= 3.0, mad
    assert 700 <= out.shape[1] <= 1400 and out.shape[0] <= 700, out.shape
    emit("slice_512x384", t, images=[list(i.shape) for i in images],
         canvas=list(out.shape), cold_s=cold_s, warm_median_s=
         statistics.median(warm), warm_s=warm, stage_s=stages,
         launches=launches, warm_equals_cold=bool(np.array_equal(
             out, out_cold)), cpu_canvas=list(out_cpu.shape), cpu_s=cpu_s,
         mad_vs_cpu=mad)

    # -- 5. north-star size 4 x 1440x1080
    t = time.perf_counter()
    images = crops(1440, 1080, 630, 6, seed=1)
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

    stm.sift_extract_stats, stm.plan_edges = sift_rec, plan_rec
    try:
        st = stm.Stitcher(SLICE_CONFIG, device="cuda")
        out_big, cold_s = run(st, images)
    finally:
        stm.sift_extract_stats, stm.plan_edges = sift_fn, plan_fn
    stages_big = dict(st.stage_times)
    warm = [run(st, images)[1] for _ in range(3)]
    assert out_big.dtype == np.uint8 and out_big.shape[2] == 3
    assert 2000 <= out_big.shape[1] <= 4000, out_big.shape
    assert out_big.shape[0] <= 2000, out_big.shape
    assert out_big.mean() > 20, "empty canvas"
    emit("north_star_1440x1080", t, images=[list(i.shape) for i in images],
         canvas=list(out_big.shape), cold_s=cold_s,
         warm_median_s=statistics.median(warm), warm_s=warm,
         stage_s=stages_big, **telemetry,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
