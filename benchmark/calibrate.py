"""The control's readings, the upper ones a cell's limits are set from
(``checks/<workload>.json``), on the card at the cell's own sizes: the
reference computed in lower precision (``check.reference_config(
lower=True)``: the SIFT scale space and the blend in bfloat16) in the
program's place, against the reference, on the frame sets one call of
the cell takes.

    python3 benchmark/calibrate.py --workload <name> --seeds 1 2 3 \
        > chiprun_out/<name>.jsonl

One JSON line per seed; the last line holds the least reading of each
number. The program's readings, the lower ones, are those its runs print
(``run.py`` with a short ``--seconds``, one seed a run). The benchmark's
runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH.parent), str(BENCH)]

from run import fixed_cache_dirs  # noqa: E402


def control_readings(cell, seed: int, dev) -> dict:
    from harness import check, traffic

    mix = cell.traffic
    sets = traffic.frame_sets(cell.config["frames"], mix, seed)
    over = cell.config["stitch_config"]
    ref_cfg = check.reference_config(over)
    low_cfg = check.reference_config(over, lower=True)
    readings = []
    for i in traffic.call_sets(mix, len(sets), 0):
        ref = check.reference(mix["entry"], sets[i], ref_cfg, dev)
        low = check.reference(mix["entry"], sets[i], low_cfg, dev)
        readings.append(check.compare(mix["entry"],
                                      check.as_record(mix["entry"], low),
                                      ref, ref_cfg, sets[i]))
    return check.worst(readings)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    fixed_cache_dirs()
    import torch
    from harness import registry

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cell = registry.cell(args.workload)
    least: dict = {}
    for seed in args.seeds:
        t = time.perf_counter()
        values = control_readings(cell, seed, dev)
        for k, v in values.items():
            least[k] = min(least.get(k, v), v)
        print(json.dumps({"seed": seed, "values": values,
                          "seconds": time.perf_counter() - t}), flush=True)
    print(json.dumps({"workload": args.workload,
                      "device": torch.cuda.get_device_name(dev),
                      "control_least": least}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
