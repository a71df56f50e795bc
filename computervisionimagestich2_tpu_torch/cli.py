"""Command-line entry point of the port, ``panorama-torch`` (counterpart of
``computervisionimagestich2_tpu.cli``, ``panorama-tpu``).

Stitches 1.bmp..N.bmp of a directory into one panorama. The flags and
their mapping onto a ``StitchConfig`` are the JAX package's own
(``make_parser`` and ``build_config`` import no JAX and are reused, so the
two commands cannot drift), plus ``--device``. A configuration outside the
port is refused with ``check_supported``'s message; ``--sp`` (multi-device
sharding) is not ported.

    python -m computervisionimagestich2_tpu_torch.cli --input DIR \\
        --output pano.bmp --timing
"""
from __future__ import annotations

import json
import os
import time

from computervisionimagestich2_tpu.cli import build_config
from computervisionimagestich2_tpu.cli import make_parser as _jax_parser


def make_parser():
    p = _jax_parser()
    p.prog = "panorama-torch"
    p.description = ("panorama stitcher on PyTorch + CUDA (images named "
                     "1.bmp..N.bmp in a directory)")
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
    if args.sp:
        p.error(f"--sp {args.sp}: sharding canvases over devices is not "
                "ported; see ROADMAP.md A18")
    cfg = build_config(args)

    from .config import check_supported
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
        stitcher = Stitcher(cfg, args.device, artifact_dir=args.artifacts)
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
