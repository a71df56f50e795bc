"""One run of one cell: set-up, the measured or traced window, the peak
memory, then the program freed and the check against the plain
reference. ``run_cell`` returns the result line as a dict, its compared
numbers last."""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from . import check, entries, registry, trace, traffic

class Loop:
    """A closed loop of one caller over ``entry``: call ``k`` takes the
    sets ``traffic.call_sets`` gives it; the calls the check samples (a
    reservoir of ``size`` drawn from the seed) keep their records."""

    def __init__(self, entry, sets, mix, seed: int, size: int):
        self.entry, self.sets, self.mix = entry, sets, mix
        self.calls = 0
        self.rng = np.random.default_rng([int(seed), 7])
        self.size = size
        self.seen = 0  # calls offered to the reservoir
        self.samples: list = []  # (set indices, records)
        self.failed = 0
        self.durations: list[float] = []

    def call(self, sample: bool = False) -> None:
        idx = traffic.call_sets(self.mix, len(self.sets), self.calls)
        self.calls += 1
        keep, slot = False, None
        if sample:
            keep = len(self.samples) < self.size
            if not keep:
                j = int(self.rng.integers(self.seen + 1))
                keep, slot = j < self.size, j
            self.seen += 1
        t = time.perf_counter()
        try:
            rec = self.entry.call([self.sets[i] for i in idx], keep)
        except (RuntimeError, ValueError) as e:
            self.failed += 1
            print(f"run: call {self.calls - 1} failed: {e!r}",
                  file=sys.stderr)
            return
        finally:
            self.durations.append(time.perf_counter() - t)
        if keep:
            if slot is None:
                self.samples.append((idx, rec))
            else:
                self.samples[slot] = (idx, rec)


def run_cell(cell: registry.Cell, seed: int, seconds: float, trace_on: int,
             device: str, t0: float, fault=None) -> dict:
    """One run of ``cell``. ``t0``: the process's start on the host clock
    (set-up counts from there). ``fault``: a test's wrapper of the
    entry's ``call``, to break the timed path underneath."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    mix = cell.traffic

    def mark(what: str) -> None:  # set-up's steps, on standard error
        print(f"run: {what} at {time.perf_counter() - t0:.3f} s",
              file=sys.stderr)

    mark("imports done")
    sets = traffic.frame_sets(cell.config["frames"], mix, seed)
    mark(f"{len(sets)} frame set(s) made")
    entry = entries.ENTRIES[mix["entry"]](
        entries.port_config(cell.config["stitch_config"]), dev, mix)
    if fault is not None:
        entry.call = fault(entry.call)
    per_call = entry.panoramas_per_call(mix)
    loop = Loop(entry, sets, mix, seed, int(mix["check_calls"]))
    # warm-up: the cold call captures the cell's graphs, the second
    # finds them all
    for what in ("cold call (kernels loaded, graphs captured)",
                 "warm call"):
        loop.call()
        mark(what)
    warm_calls = loop.calls
    loop.durations.clear()
    entry.stage_sums.clear()
    if trace_on:
        stage_ms, view = traced_window(loop, entry, mix, per_call)
    else:
        timing = timed_window(loop, seconds, t0, per_call)
    attempted = (loop.calls - warm_calls) * per_call
    peak = torch.cuda.max_memory_reserved(dev) if cuda else 0
    pools = None
    if cuda:
        from computervisionimagestich2_tpu_torch.core import programs
        pools = programs.graph_memory(dev)
    samples = [(idx, [entry.host(r) for r in recs])
               for idx, recs in loop.samples]
    failed = loop.failed
    # the program's state freed before the reference runs
    entry.close()
    del entry, loop
    if cuda:
        programs.clear_graphs()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    values = reference_check(cell, mix, sets, samples, dev)
    correct, checks = check.judge(values, cell.limits["limits"], failed)
    result = {"correct": correct, "attempted": attempted,
              "failed": failed * per_call}
    if trace_on:
        run = {"view": view, "stage_ms": stage_ms, "graph_memory": pools,
               "records": samples, "sets": sets}
        result["metrics"] = per_layer(cell, run)
        result["device"] = dict(device_info(dev, peak),
                                busy_s=view.busy_s(),
                                window_s=view.window_s())
        result["breakdown"] = {"device_ops": view.top_device_ops(10),
                               "idle_gaps": view.idle_gaps(10)}
    else:
        result["metrics"] = end_to_end(cell, timing, peak)
        result["device"] = device_info(dev, peak)
    # numbers read but held to no limit, beside those compared (last)
    result["reported"] = {k: v for k, v in values.items() if k not in checks}
    result["checks"] = checks
    return result


def timed_window(loop: Loop, seconds: float, t0: float,
                 per_call: int) -> dict:
    """The closed loop for ``seconds``: what the end-to-end readers
    take."""
    first = loop.calls
    timing = {"setup_s": time.perf_counter() - t0, "per_call": per_call}
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        loop.call(sample=True)
    timing["window_s"] = time.perf_counter() - start
    timing["panoramas"] = (loop.calls - first - loop.failed) * per_call
    timing["durations"] = loop.durations
    return timing


def traced_window(loop: Loop, entry, mix: dict, per_call: int):
    """``trace_calls`` untraced calls (the stages' host milliseconds),
    then as many under the profiler: (stage ms, the trace's ``View``)."""
    n = int(mix["trace_calls"])
    for _ in range(n):
        loop.call()
    stage_ms = {k: v / n * 1e3 for k, v in entry.stage_sums.items()}

    def calls():
        before = loop.failed
        for _ in range(n):
            loop.call(sample=True)
        return (n - (loop.failed - before)) * per_call

    view, read_s = trace.traced(calls)
    print(f"run: trace read in {read_s:.2f} s", file=sys.stderr)
    return stage_ms, view


def device_info(dev: torch.device, peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": int(peak)}


def end_to_end(cell, timing: dict, peak: int) -> dict:
    out = {}
    for m in cell.end_to_end:
        v = registry.reader("end_to_end", m["name"]).read(timing, peak)
        out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def per_layer(cell, run: dict) -> dict:
    """Each per-layer metric of the cell its reader finds something to
    read for; a reader that returns None leaves its metric out."""
    out = {}
    for m in cell.per_layer:
        v = registry.reader("metrics", m["name"]).read(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def reference_check(cell, mix, sets, samples, dev) -> dict:
    """The compared numbers of the sampled outputs against the plain
    reference, run once per frame set on the same frames (after the
    program is freed)."""
    ref_cfg = check.reference_config(cell.config["stitch_config"])
    cached: dict = {}
    readings = []
    for idx, recs in samples:
        for i, rec in zip(idx, recs):
            if i not in cached:
                cached[i] = check.reference(mix["entry"], sets[i], ref_cfg,
                                            dev)
            readings.append(check.compare(mix["entry"], rec, cached[i],
                                          ref_cfg, sets[i]))
    return check.worst(readings)
