"""Old against new: the port's kernels beside an earlier commit's, on one
card, in one run.

    python -m computervisionimagestich2_tpu_torch.tools.kernel_ab \\
        --parent DIR [--check] [--out FILE]

DIR holds a checkout of the earlier commit (``git archive <commit>``
unpacked into a directory that ``.gitignore`` lists, such as
``build/parent``). Run from the root of this checkout, on a machine with
one NVIDIA GPU and ``nvcc``. Steps:

1. ``nvcc -Xptxas -v`` on every CUDA source of both trees, with this
   tree's flags (``ops/_native.py``): registers, stack frame, spill stores and loads and
   static shared memory of each kernel;
2. one default-path stitch of this tree on the four scrambled 512x384
   crops of ``chip_smoke.py`` (phase 3), recording the arguments of every
   call of B1 (``detect.detect_compact_octaves``: the DoG stacks of an
   image's octaves), B2 (``sift_walks.orientation_hist``), B3
   (``sift_walks.descriptors``), B4 (``distance.two_nearest_bidir``) and
   B5 (``distance.pair_match_counts``) and B6 (``compose.warp_image``: the
   source, the backward model, the offsets, the canvas and the model); B7's
   arguments (``distance.two_nearest``) in ``match_features`` of two
   neighbouring crops, as ``chip_smoke.py`` phase 6 calls it; B5's
   arguments for ten 512x384 crops of one scene (45 pairs,
   ``pair_match_counts@n10``) and for four 1440x1080 crops
   (``pair_match_counts@1440x1080``); and B6's in a default-path stitch of
   those four 1440x1080 crops (``warp_image@1440x1080``);
3. in turns parent, this tree, this tree, parent (a subprocess each, with
   that tree first on ``sys.path``): each tree's wrappers on the recorded
   calls (a tree without ``detect_compact_octaves`` detects the recorded
   stacks one ``detect_compact`` each), held against the plain versions
   on the card (B1 exact, B2 rtol 1e-5 with atol 1e-5 x max, B3 atol 2e-6,
   B4 and B7 d1 / d2 rtol 1e-5 and i1 where the 2-NN gap exceeds 1e-4 d1,
   B5 exact counts, also against one B4 launch per pair, B6 exact) and
   against a second run (equal bits), with a hash of B1's (coords, valid,
   n_total), B6's canvases and B7's (d1, d2, i1) outputs (B6 takes the
   backward model as host floats where the tree's ``warp_image`` has a
   ``model`` parameter, and as a device tensor in an earlier tree, and
   the offsets as host floats: its by-value entry, which every tree has;
   this tree's programs take the device-parameter entry); then, without
   ``--check``, the time of
   all recorded calls of a kernel in a row, mean of 10 passes after one
   warm-up: the device time of the kernels alone from ``torch.profiler``
   (``device_ms_*``: per panorama for B1, the walks, B5 and B6, per edge
   for B4, per call for B7; B6 also on its last call alone, repeated,
   ``device_ms_last_call``), for B1 also of every device event of the calls
   (``device_ms_all_events``: the launcher's memset beside the kernel), and the
   time between CUDA events around the calls, which adds the host's gaps
   between launches (``ms_all_calls_events``); B2's first call with no
   live keypoint (the cost of its launch alone,
   ``device_ms_no_keypoints``); and five warm default-path stitches of the
   recorded images after one cold one (``stitch_warm_*``, host clock),
   with the live feature count of every image and a hash of the panorama,
   and the device events of one warm stitch under ``torch.profiler``
   (``stitch_device_events``: all, host-to-device copies, concatenation
   kernels, B6's kernels).
   The last step compares between the trees: ``same_features``,
   ``same_panorama``, ``same_b1_outputs``, ``same_b6_outputs``,
   ``same_b7_outputs``.

Prints one JSON object per step and writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

SITES = {"detect_compact": ("detect", "detect_compact_octaves"),
         "sift_orientation_hist": ("sift_walks", "orientation_hist"),
         "sift_descriptors": ("sift_walks", "descriptors"),
         "l1_two_nearest_bidir": ("distance", "two_nearest_bidir"),
         "pair_match_counts": ("distance", "pair_match_counts"),
         "warp_image": ("compose", "warp_image"),
         "l1_two_nearest": ("distance", "two_nearest")}

_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")


def kernel_name(mangled: str) -> str:
    """The ``*_kernel`` identifier inside a mangled name: the one that its
    decimal length prefix delimits exactly."""
    found = [mangled]
    for m in re.finditer(r"\d+", mangled):
        for cut in range(len(m.group())):  # "cf21detect...": try 21 and 1
            n = int(m.group()[cut:])
            ident = mangled[m.end():m.end() + n]
            if ident.endswith("_kernel") and len(ident) == n:
                found.append(ident)
    # a file hash in the name may start with digits that delimit a longer
    # string ending in the identifier: the identifier itself is the shortest
    return min(found, key=len)


def ptxas_report(tree: Path) -> dict:
    """Per kernel of ``tree``'s csrc/: registers, stack, spills, smem."""
    from computervisionimagestich2_tpu_torch.ops import _native

    csrc = tree / "computervisionimagestich2_tpu_torch" / "csrc"
    sources = sorted(p.name for p in csrc.glob("*.cu"))
    with tempfile.TemporaryDirectory() as tmp:
        procs = {src: subprocess.Popen(
            [_native._nvcc(), *_native.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(csrc), "-c", "-o", f"{tmp}/{src}.o", str(csrc / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in sources}
        outs = {src: p.communicate()[0] for src, p in procs.items()}
    report = {}
    for src, text in outs.items():
        if procs[src].returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{text[-4000:]}")
        name = None
        for line in text.splitlines():
            if m := _PTXAS_ENTRY.search(line):
                name = kernel_name(m.group(1))
                report[name] = {"source": src}
            elif name and (m := _PTXAS_FRAME.search(line)):
                report[name].update(stack=int(m.group(1)),
                                    spill_stores=int(m.group(2)),
                                    spill_loads=int(m.group(3)))
            elif name and (m := _PTXAS_USED.search(line)):
                report[name]["registers"] = int(m.group(1))
                if s := _PTXAS_SMEM.search(line):
                    report[name]["smem"] = int(s.group(1))
    return report


def record_inputs(path: Path) -> dict:
    """``_record_inputs`` with the programs eager (``disable_graphs``): a
    replayed CUDA graph calls no wrapper."""
    from computervisionimagestich2_tpu_torch.core.programs import (
        disable_graphs)

    with disable_graphs():
        return _record_inputs(path)


def _record_inputs(path: Path) -> dict:
    """One cold default-path stitch of this tree on the crops of
    ``tools/scenes.py`` (as ``chip_smoke.py`` phase 3 stitches them),
    keeping the arguments of every B1-B6 call (as CPU tensors), B7's in
    ``match_features`` of two neighbouring crops, B5's arguments at ten
    crops and at 1440x1080, and B6's in a stitch at 1440x1080."""
    import numpy as np
    import torch

    import chip_smoke
    from computervisionimagestich2_tpu_torch import DEFAULT_CONFIG
    from computervisionimagestich2_tpu_torch.core.types import Features
    from computervisionimagestich2_tpu_torch.models import compose, matcher
    from computervisionimagestich2_tpu_torch.models.stitcher import Stitcher
    from computervisionimagestich2_tpu_torch.ops import (detect, distance,
                                                         sift_walks)
    from computervisionimagestich2_tpu_torch.tools import scenes

    def to_cpu(a):
        if isinstance(a, torch.Tensor):
            return a.detach().cpu()
        if isinstance(a, np.ndarray):  # B6's backward model, host floats
            return torch.from_numpy(np.array(a, np.float32))
        return [to_cpu(x) for x in a] if isinstance(a, list) else a

    def record(name, args):
        """A call's arguments on the host; B6's offsets as host floats,
        which every tree's ``warp_image`` takes (this tree's programs hand
        it device tensors)."""
        args = tuple(to_cpu(a) for a in args)
        if name.startswith("warp_image"):
            args = (*args[:2], *(float(v) for v in args[2:4]), *args[4:])
        return args

    mods = {"detect": detect, "sift_walks": sift_walks, "distance": distance,
            "compose": compose}
    calls = {name: [] for name in SITES}
    orig = {}
    for name, (mod, attr) in SITES.items():
        fn = orig[name] = getattr(mods[mod], attr)

        def wrapped(*args, _fn=fn, _name=name, **kw):
            calls[_name].append(record(_name, args))
            return _fn(*args, **kw)
        setattr(mods[mod], attr, wrapped)
    images = scenes.scrambled(scenes.crops(512, 384, 224, 2, 0))
    try:
        st = Stitcher(DEFAULT_CONFIG, device="cuda")
        st.stitch(images)
        assert not calls["l1_two_nearest"]  # B7 is off the stitch path
        feats = st._matching_feats()
        a, b = (scenes.SCRAMBLE.index(k) for k in (0, 1))
        matcher.match_features(Features(*(x[a] for x in feats)),
                               Features(*(x[b] for x in feats)))
    finally:
        for name, (mod, attr) in SITES.items():
            setattr(mods[mod], attr, orig[name])
    big = scenes.crops(1440, 1080, 630, 6, 1)
    for label, crops in (
            ("n10", scenes.crops(512, 384, 224, 2, 0, n=10)),
            ("1440x1080", big)):
        calls[f"pair_match_counts@{label}"] = [(
            *(a.cpu() for a in chip_smoke.pair_inputs(crops)),
            DEFAULT_CONFIG.match.ratio_threshold)]
    warps = calls["warp_image@1440x1080"] = []
    warp_fn = compose.warp_image

    def warp_rec(*args):
        warps.append(record("warp_image", args))
        return warp_fn(*args)
    compose.warp_image = warp_rec
    try:
        Stitcher(DEFAULT_CONFIG, device="cuda").stitch(
            scenes.scrambled(big))
    finally:
        compose.warp_image = warp_fn
    counts = {name: len(c) for name, c in calls.items()}
    calls["images"] = [torch.from_numpy(im) for im in images]
    torch.save(calls, path)
    return counts


_CHILD = r"""
import json, sys
tree, inputs, check = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
sys.path.insert(0, tree)
import torch
import hashlib
import inspect
from computervisionimagestich2_tpu_torch.ops import (detect, distance,
                                                     sift_walks, warp,
                                                     _native)
assert _native.__file__.startswith(tree), _native.__file__
# B6 takes its model as host floats where warp_image has a model parameter
B6_BY_VALUE = "model" in inspect.signature(warp.warp_image).parameters
calls = torch.load(inputs)
images = [im.numpy() for im in calls.pop("images")]
dev = torch.device("cuda")


def to_dev(a):
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    return [to_dev(x) for x in a] if isinstance(a, list) else a


calls = {k: [tuple(to_dev(a) for a in c) for c in v]
         for k, v in calls.items()}
for k in calls:
    if k.startswith("warp_image"):  # (src, coeffs, ox, oy, canvas, model)
        calls[k] = [(c[0], c[1].tolist() if B6_BY_VALUE else c[1], *c[2:])
                    for c in calls[k]]
_native.build()
# device kernels of each wrapper, old and new designs (name substrings)
kernels = {"detect_compact": ("detect_rows_kernel", "detect_flatten_kernel",
                              "detect_octaves_kernel"),
           "sift_orientation_hist": ("orientation_hist_kernel",),
           "sift_descriptors": ("descriptors_kernel",),
           "l1_two_nearest_bidir": ("l1_two_nearest_kernel",
                                    "l1_bidir_tile_kernel",
                                    "l1_bidir_merge_kernel"),
           "pair_match_counts": ("pair_counts_kernel", "pair_plan_kernel",
                                 "pair_tile_kernel", "pair_count_kernel"),
           "warp_image": ("warp_image_kernel", "warp_bilinear_kernel",
                          "warp_projective_kernel"),
           "l1_two_nearest": ("l1_two_nearest_kernel",
                              "l1_one_way_tile_kernel",
                              "l1_one_way_merge_kernel")}


def detect_octaves(dogs, tp, caps):
    # all the DoG stacks of an image: one call where the tree has it, else
    # one detect_compact per stack
    if hasattr(detect, "detect_compact_octaves"):
        return detect.detect_compact_octaves(dogs, tp, caps)
    return [detect.detect_compact(d, tp, c) for d, c in zip(dogs, caps)]


def b6(src, coeffs, ox, oy, canvas, model="bilinear"):
    if B6_BY_VALUE:
        return warp.warp_image(src, coeffs, ox, oy, canvas, model)
    assert model == "bilinear", model
    return warp.warp_image(src, coeffs, ox, oy, canvas)


def b6_plain(src, coeffs, ox, oy, canvas, model="bilinear"):
    c = torch.tensor(coeffs, dtype=torch.float32, device=dev) \
        if isinstance(coeffs, list) else coeffs
    if B6_BY_VALUE:
        return warp.warp_image_plain(src, c, ox, oy, canvas, model)
    return warp.warp_image_plain(src, c, ox, oy, canvas)


def digest(h, tensors):
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())


fns = {"detect_compact": (
           detect_octaves,
           lambda dogs, tp, caps: [detect.detect_compact_plain(d, tp, c)
                                   for d, c in zip(dogs, caps)]),
       "l1_two_nearest": (distance.two_nearest, distance.two_nearest_plain),
       "sift_orientation_hist": (sift_walks.orientation_hist,
                                 sift_walks.orientation_hist_plain),
       "sift_descriptors": (sift_walks.descriptors,
                            sift_walks.descriptors_plain),
       "l1_two_nearest_bidir": (
           distance.two_nearest_bidir,
           lambda q, r, qv, rv: (distance.two_nearest_plain(q, r, qv, rv),
                                 distance.two_nearest_plain(r, q, rv, qv))),
       "pair_match_counts": (distance.pair_match_counts,
                             distance.pair_match_counts_plain),
       "warp_image": (b6, b6_plain)}
out = {"tree": tree, "gpu": torch.cuda.get_device_name(0)}


def device_ms(fn, name, reps=10):
    # (the named kernels' device ms, every device event's) per pass
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = every = 0.0
    for e in prof.key_averages():
        t = (getattr(e, "self_device_time_total", 0)
             or getattr(e, "self_cuda_time_total", 0))
        if str(e.device_type).endswith("CUDA"):
            every += t
            if any(k in e.key for k in kernels[name]):
                us += t
    return us / 1e3 / reps, every / 1e3 / reps


for key in calls:
    name = key.split("@")[0]  # "pair_match_counts@n10": another input set
    kern, plain = fns[name]
    err = 0.0
    sha = hashlib.sha256()
    for c in calls[key]:
        a, b = kern(*c), kern(*c)
        p = plain(*c)
        if name == "detect_compact":
            for (ck, vk, nk), (cb, vb, nb_), (cp, vp, np_) in zip(a, b, p):
                assert torch.equal(ck, cp) and torch.equal(vk, vp)
                assert int(nk) == int(np_), (int(nk), int(np_))
                assert torch.equal(ck, cb) and torch.equal(vk, vb)
                assert int(nk) == int(nb_), "not deterministic"
                digest(sha, (ck, vk, nk))
        elif name == "l1_two_nearest":
            ok = c[2]
            assert all(torch.equal(x, y) for x, y in zip(a, b)), \
                "not deterministic"
            torch.testing.assert_close(a[0][ok], p[0][ok], rtol=1e-5, atol=0)
            torch.testing.assert_close(a[1][ok], p[1][ok], rtol=1e-5, atol=0)
            clear = ok & ((p[1] - p[0]) > 1e-4 * p[0])
            assert torch.equal(a[2][clear], p[2][clear])
            err = max(err, float((a[0][ok] - p[0][ok]).abs().max()))
            digest(sha, a)
        elif name == "warp_image":
            assert torch.equal(a, b), "not deterministic"
            assert torch.equal(a, p), "B6 must be exact"
            digest(sha, (a,))
        elif name == "pair_match_counts":
            assert torch.equal(a, b), "not deterministic"
            # a query within rounding of the ratio may fall either way
            err = max(err, float((a - p).abs().max()))
            assert err <= 1, (a.tolist(), p.tolist())
            d, v = c[0], c[1]
            for k, (i, j) in enumerate(c[2].tolist()):
                okq, _, okr, _ = distance.ratio_match_bidir(d[j], d[i], v[j],
                                                            v[i], c[3])
                assert [int(okq.sum()), int(okr.sum())] == a[k].tolist()
        elif name == "l1_two_nearest_bidir":
            for (k1, k2, ki), (b1, b2, bi), (p1, p2, pi), ok in zip(
                    a, b, p, (c[2], c[3])):
                assert all(torch.equal(x, y) for x, y in
                           ((k1, b1), (k2, b2), (ki, bi))), "not deterministic"
                torch.testing.assert_close(k1[ok], p1[ok], rtol=1e-5, atol=0)
                torch.testing.assert_close(k2[ok], p2[ok], rtol=1e-5, atol=0)
                clear = ok & ((p2 - p1) > 1e-4 * p1)
                assert torch.equal(ki[clear], pi[clear])
                err = max(err, float((k1[ok] - p1[ok]).abs().max()))
        else:
            assert torch.equal(a[0], b[0]), "not deterministic"
            assert torch.equal(a[1], p[1])
            if name == "sift_descriptors":
                torch.testing.assert_close(a[0], p[0], rtol=0, atol=2e-6)
            else:
                torch.testing.assert_close(
                    a[0], p[0], rtol=1e-5,
                    atol=1e-5 * float(p[0].abs().max()))
            err = max(err, float((a[0] - p[0]).abs().max()))
    rec = {"calls": len(calls[key]), "max_abs_err": err}
    if name in ("detect_compact", "l1_two_nearest", "warp_image"):
        rec["outputs_sha256"] = sha.hexdigest()[:16]
    if name == "warp_image":
        rec["canvases"] = [list(c[4]) for c in calls[key]]
    if name == "detect_compact":
        rec["octaves"] = sum(len(c[0]) for c in calls[key])
    if name == "pair_match_counts":
        rec["live"] = calls[key][0][1].sum(dim=1).tolist()
        rec["slots"] = calls[key][0][0].shape[1]
        rec["counts"] = kern(*calls[key][0]).tolist()

    if not check:
        def all_calls():
            for c in calls[key]:
                kern(*c)
        all_calls()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            all_calls()
        end.record()
        end.synchronize()
        rec["ms_all_calls_events"] = start.elapsed_time(end) / 10
        rec["device_ms_all_calls"], every = device_ms(all_calls, name)
        rec["device_ms_per_call"] = rec["device_ms_all_calls"] / len(
            calls[key])
        if name == "detect_compact":
            rec["device_ms_all_events"] = every
            c = calls[key][0]
            rec["device_ms_first_call"] = device_ms(lambda: kern(*c), name)[0]
        if name == "warp_image":  # the last call 10 times in a row
            c = calls[key][-1]
            rec["device_ms_last_call"] = device_ms(lambda: kern(*c), name)[0]
        if name == "sift_orientation_hist":
            c = list(calls[key][0])
            rec["device_ms_first_call"] = device_ms(lambda: kern(*c), name)[0]
            c[5] = torch.zeros_like(c[5])  # n_valid = 0: the launch alone
            rec["device_ms_no_keypoints"] = device_ms(lambda: kern(*c),
                                                      name)[0]
    out[key] = rec
if not check:  # the whole default path, warm, on the recorded images
    import statistics, time
    from computervisionimagestich2_tpu_torch import DEFAULT_CONFIG
    from computervisionimagestich2_tpu_torch.models.stitcher import Stitcher
    st = Stitcher(DEFAULT_CONFIG, device="cuda")
    pano = st.stitch(images)
    out["feature_counts"] = st._matching_feats().valid.sum(dim=1).tolist()
    out["panorama"] = [list(pano.shape),
                       hashlib.sha256(pano.tobytes()).hexdigest()[:16]]
    walls = []
    for _ in range(5):
        t = time.perf_counter()
        st.stitch(images)
        walls.append(time.perf_counter() - t)
    out["ordering_stage_s"] = st.stage_times["ordering"]
    out["stitch_warm_s"] = walls
    out["stitch_warm_median_s"] = statistics.median(walls)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st.stitch(images)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if str(e.device_type).endswith("CUDA")
          and (getattr(e, "self_device_time_total", 0)
               or getattr(e, "self_cuda_time_total", 0))]
    def n_ev(*subs):
        return sum(e.count for e in ev if any(k in e.key for k in subs))
    out["stitch_device_events"] = {
        "all": sum(e.count for e in ev), "memcpy_htod": n_ev("HtoD"),
        "cat_kernels": n_ev("CatArray", "cat_"),
        "b6_kernels": n_ev(*kernels["warp_image"])}
print("CHILD " + json.dumps(out), flush=True)
"""


def run_tree(tree: Path, inputs: Path, check: bool) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, str(tree.resolve()), str(inputs),
         "1" if check else "0"], capture_output=True, text=True,
        timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n"
                           f"{proc.stderr[-4000:]}")
    line = [x for x in proc.stdout.splitlines() if x.startswith("CHILD ")]
    return json.loads(line[-1][len("CHILD "):])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--parent", required=True, type=Path,
                   help="checkout of the earlier commit")
    p.add_argument("--check", action="store_true",
                   help="compare with the plain versions only; no timing")
    p.add_argument("--out", type=Path, default=None)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    here = Path.cwd()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    results = [{"nvidia_smi": smi}]
    results.append({"ptxas": {"parent": ptxas_report(args.parent),
                              "this": ptxas_report(here)}})
    print(json.dumps(results[-1]), flush=True)
    (here / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=here / "build") as tmp:
        inputs = Path(tmp) / "calls.pt"
        results.append({"recorded_calls": record_inputs(inputs)})
        print(json.dumps(results[-1]), flush=True)
        order = [args.parent, here] if args.check else [
            args.parent, here, here, args.parent]
        for tree in order:
            label = "parent" if tree == args.parent else "this"
            results.append({"run": label, **run_tree(tree, inputs,
                                                     args.check)})
            print(json.dumps(results[-1]), flush=True)
    if not args.check:
        runs = {r["run"]: r for r in results if "run" in r}
        results.append({"same_features": runs["parent"]["feature_counts"]
                        == runs["this"]["feature_counts"],
                        "same_panorama": runs["parent"]["panorama"]
                        == runs["this"]["panorama"]})
        print(json.dumps(results[-1]), flush=True)
    runs = {r["run"]: r for r in results if "run" in r}
    results.append({f"same_{kid}_outputs": runs["parent"][name][
        "outputs_sha256"] == runs["this"][name]["outputs_sha256"]
        for kid, name in (("b1", "detect_compact"), ("b6", "warp_image"),
                          ("b6_at_1440x1080", "warp_image@1440x1080"),
                          ("b7", "l1_two_nearest"))})
    print(json.dumps(results[-1]), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
