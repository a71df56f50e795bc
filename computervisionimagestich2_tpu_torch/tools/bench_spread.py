"""The spread of the bench's end-to-end metrics over several calls of the
same command, and the regression bound each spread gives.

    python -m computervisionimagestich2_tpu_torch.tools.bench_spread \\
        CALL1.jsonl CALL2.jsonl CALL3.jsonl

Each file holds the lines one ``bench_torch.py`` run printed. For
every cell and metric it prints the median of each call, the spread inside
each call (the warm runs' interquartile range over their median) and the
spread across the calls (the largest median over the smallest, less one),
and the bound: the larger of the two spreads, rounded up to the next 5%,
at least 5%. A change whose median moves by less than its cell's bound is
not a regression; ``tools/bench.py::REGRESSION_BOUNDS`` holds the bounds
this gave.
"""
from __future__ import annotations

import json
import math
import sys

# (metric, its field in a line, higher is better)
METRICS = (("panorama_ms", ("panorama_ms",), False),
           ("batch_ms", ("batch_ms",), False),
           ("register_ms", ("register", "register_ms"), False),
           ("cold_ms", ("cold_ms",), False),
           ("peak_mem_gib", ("peak_mem_gib",), False),
           ("sift_kpts_per_s", ("sift_kpts_per_s",), True))


def _get(line: dict, path: tuple):
    for key in path:
        line = line.get(key) if isinstance(line, dict) else None
    return line


def spread(calls: list[list[dict]]) -> dict:
    """Per cell and metric: each call's median and inner spread, the
    spread across calls and the bound (see the module's docstring)."""
    out: dict[str, dict] = {}
    for name in dict.fromkeys(line["cell"] for call in calls for line in call):
        lines = [next(ln for ln in call if ln["cell"] == name)
                 for call in calls]
        cell = out.setdefault(name, {})
        for metric, path, higher in METRICS:
            vals = [_get(ln, path) for ln in lines]
            if any(v is None for v in vals):
                continue
            stats = [v if isinstance(v, dict) else None for v in vals]
            medians = [v["median"] if isinstance(v, dict) else v
                       for v in vals]
            inner = [(s["q3"] - s["q1"]) / s["median"] if s and "q3" in s
                     else 0.0 for s in stats]
            across = max(medians) / min(medians) - 1.0
            bound = max(0.05, math.ceil(max(inner + [across]) * 20 - 1e-9)
                        / 20)
            cell[metric] = {"medians": medians, "inner_spread": inner,
                            "across_calls": across, "bound": bound,
                            "higher_is_better": higher}
    return out


def main(argv=None) -> int:
    paths = sys.argv[1:] if argv is None else argv
    if len(paths) < 2:
        print("usage: bench_spread CALL1.jsonl CALL2.jsonl [...]",
              file=sys.stderr)
        return 2
    calls = [[json.loads(t) for t in open(p) if t.strip()] for p in paths]
    print(json.dumps(spread(calls), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
