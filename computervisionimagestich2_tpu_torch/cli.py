"""Command-line entry point of the port, ``panorama-torch`` (counterpart of
``computervisionimagestich2_tpu.cli``, ``panorama-tpu``).

Stitches 1.bmp..N.bmp of a directory into one panorama. The flags and
their mapping onto a ``StitchConfig`` (``make_parser``, ``build_config``)
are a copy of the JAX package's, plus ``--device``; the port imports
nothing of that package, and ``tests/test_torch_cli.py`` holds the two
mappings equal. A configuration outside the port is refused with
``check_supported``'s message. ``--sp N`` composites and blends each
edge row-sharded over N devices of ``--device`` (``make_mesh(N, sp=N)``;
``--device cpu`` counts one device), as the JAX package's flag does.

    python -m computervisionimagestich2_tpu_torch.cli --input DIR \\
        --output pano.bmp --timing
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from .config import DEFAULT_CONFIG, check_supported


def build_config(args):
    """Thread parsed CLI flags into a StitchConfig (pure; unit-testable).

    Chain ordering flips the ex6 variant's knobs: 5/6:1/6 luma mix
    (src/ex6/ImageProcess.cpp:270 vs root's 19/20, ImageProcess.cpp:261)
    and min-dim pyramid levels (src/ex6/ImageProcess.cpp:662-665)."""
    cfg = dataclasses.replace(DEFAULT_CONFIG, ordering=args.ordering,
                              warp_model=args.warp_model,
                              exact_canvas=args.exact_canvas,
                              color_transfer=args.color_transfer)
    if args.no_enhance:
        cfg = dataclasses.replace(
            cfg, enhance=dataclasses.replace(cfg.enhance, enabled=False))
    if args.ordering == "chain":
        cfg = dataclasses.replace(
            cfg, enhance=dataclasses.replace(cfg.enhance, mix_weight=5.0 / 6.0),
            blend=dataclasses.replace(cfg.blend, level_mode="min"))
    if args.gain_compensation:
        cfg = dataclasses.replace(
            cfg, blend=dataclasses.replace(cfg.blend, gain_compensation=True))
    if args.gain_mode != "luma":
        cfg = dataclasses.replace(
            cfg, blend=dataclasses.replace(cfg.blend,
                                           gain_mode=args.gain_mode))
    if args.blend_dtype != "auto":
        cfg = dataclasses.replace(
            cfg, blend=dataclasses.replace(cfg.blend, dtype=args.blend_dtype))
    if args.seam_band:
        cfg = dataclasses.replace(
            cfg, blend=dataclasses.replace(cfg.blend,
                                           seam_band=args.seam_band))
    if args.no_seam_auto:
        cfg = dataclasses.replace(
            cfg, blend=dataclasses.replace(cfg.blend, seam_auto_area=0))
    if args.match_method != "auto" or args.l2pre_m:
        mrepl = {"method": args.match_method}
        if args.l2pre_m:
            mrepl["l2pre_m"] = args.l2pre_m
            mrepl["l2pre_m_counts"] = args.l2pre_m
        cfg = dataclasses.replace(
            cfg, match=dataclasses.replace(cfg.match, **mrepl))
    return cfg


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="panorama-torch",
        description="panorama stitcher on PyTorch + CUDA (images named "
                    "1.bmp..N.bmp in a directory)")
    p.add_argument("--input", required=True,
                   help="directory containing 1.bmp..N.bmp")
    p.add_argument("--count", type=int, default=None,
                   help="number of images (default: all i.bmp present)")
    p.add_argument("--output", default="result.bmp")
    p.add_argument("--ordering", choices=["graph", "chain"], default="graph",
                   help="graph = unordered discovery (root variant); "
                        "chain = pre-ordered left-to-right (ex6 variant)")
    p.add_argument("--timing", action="store_true",
                   help="print per-stage and end-to-end seconds "
                        "(the ex6 clock() print) and the kernel launches")
    p.add_argument("--no-enhance", action="store_true",
                   help="skip the equalization/luma-mix tail")
    p.add_argument("--warp-model", choices=["bilinear", "projective"],
                   default="bilinear",
                   help="bilinear = reference-exact; projective = true DLT "
                        "(not ported)")
    p.add_argument("--gain-compensation", action="store_true",
                   help="match overlap color before blending")
    p.add_argument("--gain-mode", choices=["luma", "rgb"], default="luma",
                   help="gain-compensation statistic: one scalar luma gain "
                        "(not ported) or per-channel gains")
    p.add_argument("--blend-dtype", choices=["auto", "f32", "bf16"],
                   default="auto",
                   help="auto (default) = bf16 pyramid blend on canvases "
                        "over ~1.5 Mpx, f32 below; f32 = parity mode; bf16 "
                        "= force reduced precision")
    p.add_argument("--no-seam-auto", action="store_true",
                   help="disable the area-gated automatic seam-band blend "
                        "(BlendConfig.seam_auto_area): full-canvas "
                        "reference blend at every canvas size")
    p.add_argument("--seam-band", type=int, default=0, metavar="PX",
                   help="pyramid-blend only a 4*PX-wide window at each "
                        "seam, copying the rest; 0 = the reference's "
                        "full-canvas blend (default)")
    p.add_argument("--match-method", choices=["auto", "exact", "l2pre"],
                   default="auto",
                   help="L1 2-NN strategy: 'exact' = every pair (parity "
                        "mode, and what 'auto' means here); 'l2pre' = L2 "
                        "candidate prefilter + exact-L1 rescore")
    p.add_argument("--l2pre-m", type=int, default=0, metavar="M",
                   help="candidates rescored per query for l2pre (0 = "
                        "config defaults; sets both when given)")
    p.add_argument("--color-transfer", action="store_true",
                   help="per-edge Reinhard color transfer of each incoming "
                        "image toward its stitch partner (the reference's "
                        "disabled call, ImageProcess.cpp:180)")
    p.add_argument("--exact-canvas", action="store_true",
                   help="composite/blend at the reference's exact canvas "
                        "size per edge (parity mode)")
    p.add_argument("--bucketed-canvas", dest="exact_canvas",
                   action="store_false",
                   help="pad canvases onto a size grid (default; output "
                        "equal outside a thin seam band)")
    p.set_defaults(exact_canvas=False)
    p.add_argument("--sp", type=int, default=0, metavar="N",
                   help="shard canvas composites/blends row-wise over N "
                        "devices of --device (a mesh driven by one "
                        "process, halo rows exchanged between stripes); 0 "
                        "= single device. Requires N devices and "
                        "--bucketed-canvas")
    p.add_argument("--artifacts", default=None,
                   help="directory to dump per-stage npz artifacts")
    p.add_argument("--resume", action="store_true",
                   help="skip SIFT when --artifacts/features.npz exists")
    p.add_argument("--verbose", action="store_true",
                   help="structured stage logging to stderr")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default) runs the CUDA kernels and fails "
                        "without a GPU; cpu runs their plain PyTorch "
                        "versions")
    return p


def main(argv=None):
    p = make_parser()
    args = p.parse_args(argv)

    # pure argument validation happens before any image loads
    if args.resume and not args.artifacts:
        p.error("--resume requires --artifacts")
    mesh = None
    if args.sp:
        import torch

        from .parallel.mesh import make_mesh

        if args.exact_canvas:
            p.error("--sp requires --bucketed-canvas (sharded stripes need "
                    "bucketed canvas rows)")
        have = torch.cuda.device_count() if args.device == "cuda" else 1
        if have < args.sp:
            p.error(f"--sp {args.sp} needs {args.sp} devices, have {have}")
        mesh = make_mesh(args.sp, sp=args.sp,
                         devices=None if args.device == "cuda" else ["cpu"])
    cfg = build_config(args)

    from .models.stitcher import Stitcher
    from .ops import _native
    from .utils import load_image, obs, save_image

    try:
        check_supported(cfg)
    except NotImplementedError as e:
        p.error(str(e))

    count = args.count
    if count is None:
        count = 0
        while os.path.exists(os.path.join(args.input, f"{count + 1}.bmp")):
            count += 1
    if count < 2:
        p.error(f"need at least 2 images, found {count} in {args.input}")

    paths = [os.path.join(args.input, f"{i}.bmp") for i in range(1, count + 1)]
    images = [load_image(pth) for pth in paths]
    if args.verbose:
        obs.set_verbose(True)

    t0 = time.perf_counter()
    try:
        stitcher = Stitcher(cfg, args.device, artifact_dir=args.artifacts,
                            mesh=mesh)
    except RuntimeError as e:  # device="cuda" without a GPU
        p.error(str(e))
    out = stitcher.stitch(images, resume=args.resume)
    elapsed = time.perf_counter() - t0

    save_image(args.output, out)
    if args.timing:
        for stage, secs in stitcher.stage_times.items():
            print(f"{stage}: {secs:.3f} s")
        print(f"total time: {elapsed:.3f} s")
        print(f"kernel launches: {json.dumps(_native.launch_counts())}")
    print(f"wrote {args.output} ({out.shape[1]}x{out.shape[0]})")


if __name__ == "__main__":
    main()
