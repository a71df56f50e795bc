"""Run one cell of the benchmark of the PyTorch and CUDA port once and
print its result as one JSON line on standard output.

    python3 benchmark/run.py --workload <name> --seed <n> \
        --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s workload) names a configuration and a
traffic mix; ``harness/registry.py`` finds their files by name. Set-up
makes the frames from ``--seed``, builds the program and warms up every
shape the cell uses; then a closed loop of one caller drives the entry
the mix names for ``--seconds`` (``--trace 0``: the end-to-end metrics),
or a few calls run under ``torch.profiler`` (``--trace 1``: the per-layer
metrics, each read by ``metrics/<name>.py``). Once the window has closed
and the peak memory is read, the program's state is freed and the plain
reference (``stitch_reference``) recomputes the sampled outputs from the
same frames; ``harness/check.py`` decides ``correct``. The compared
numbers go last, on standard error and in the line.

Exits non-zero and prints no result without enough CUDA devices, or when
JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "computervisionimagestich2_tpu")


def fixed_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths.
    The port builds its kernels under ``build/torch_kernels`` itself."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fixed_cache_dirs()
    sys.path[:0] = [str(ROOT), str(BENCH)]
    from harness import registry, window

    cell = registry.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"run.py: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = window.run_cell(cell, args.seed, args.seconds, args.trace,
                             "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"run.py: the run loaded {found}", file=sys.stderr)
        return 3
    for name, v in result["reported"].items():
        print(f"reported {name}: {v}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
