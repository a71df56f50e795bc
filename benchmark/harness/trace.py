"""The traced window's arithmetic: a ``torch.profiler`` trace of a few
calls, written by the profiler's own Chrome exporter and read back as its
complete events, and what the metric readers and the result's ``device``
and ``breakdown`` take from it. The event categories, the idle-gap walk
and the graph-launch reading are copied from the port's
``tools/probes.py``."""
from __future__ import annotations

import json
import os
import tempfile
import time

# Chrome-trace categories of the device's work and of the host's
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW_SPAN = "bench:window"  # the span around the traced calls


class View:
    """The complete events of a traced window, in microseconds: the
    device's, the host's, and the window (start, end) of ``WINDOW_SPAN``;
    ``panoramas`` completed in it."""

    def __init__(self, events: list, panoramas: int):
        self.events = events
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.host = [e for e in events if e.get("cat") in HOST_CATS]
        span = next(e for e in events if e["name"] == WINDOW_SPAN
                    and e.get("cat") == "user_annotation")
        self.window = (span["ts"], span["ts"] + span["dur"])
        self.panoramas = panoramas

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran (the
        union of their intervals)."""
        w0, w1 = self.window
        busy, at = 0.0, w0
        for s, e in sorted((e["ts"], e["ts"] + e["dur"])
                           for e in self.device):
            s, e = max(s, at), min(e, w1)
            if e > s:
                busy += e - s
                at = e
        return busy / 1e6

    def device_ms(self, substrings) -> float:
        """Device milliseconds of the events whose names hold any of
        ``substrings``."""
        return sum(e["dur"] for e in self.device
                   if any(s in e["name"] for s in substrings)) / 1e3

    def host_ms(self, substring: str) -> float:
        """Host milliseconds of the runtime calls whose names hold
        ``substring``."""
        return sum(e["dur"] for e in self.host
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and substring in e["name"]) / 1e3

    def top_device_ops(self, n: int = 10) -> list:
        by_name: dict[str, float] = {}
        for e in self.device:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
        return [[k[:200], v / 1e6] for k, v in
                sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest stretches of the window in which the device
        ran nothing, longest first, each named by the innermost host
        operation that covers its midpoint (``host, no traced op`` when
        none does: Python of the program or the harness)."""
        w0, w1 = self.window
        gaps, at = [], w0
        for s, e in sorted((e["ts"], e["ts"] + e["dur"])
                           for e in self.device):
            if s > at:
                gaps.append((at, min(s, w1)))
            at = max(at, e)
            if at >= w1:
                break
        if at < w1:
            gaps.append((at, w1))
        out = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            mid = (s + e) / 2
            cover = [h for h in self.host if h["ts"] <= mid <= h["ts"] + h["dur"]
                     and h["name"] != WINDOW_SPAN]
            name = (min(cover, key=lambda h: h["dur"])["name"][:200]
                    if cover else "host, no traced op")
            out.append([name, (e - s) / 1e6])
        return out


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return [e for e in json.load(f)["traceEvents"]
                    if e.get("ph") == "X"]
    finally:
        os.unlink(path)


def traced(calls) -> tuple[View, float]:
    """Run ``calls`` (a function that makes the traced calls and returns
    the panoramas they completed) under ``torch.profiler``; the window's
    ``View`` and the seconds its reading took."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            panoramas = calls()
    t = time.perf_counter()
    view = View(_events(prof), panoramas)
    return view, time.perf_counter() - t
