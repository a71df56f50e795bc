"""Logging and stage timing (the port's copy of the helpers of
``computervisionimagestich2_tpu.utils.obs``; its ``trace``, a jax.profiler
hook, has no counterpart here):

- ``log``        -- structured key=value stage logging, on when
  PANORAMA_TPU_LOG is set (not "0") or after ``set_verbose(True)``;
- ``warn``       -- always-on warnings for what must never pass silently
  (static-capacity truncation);
- ``log_sift_overflow`` -- the per-image SIFT truncation report;
- ``StageTimer`` -- wall-clock seconds per stage (``Stitcher.stage_times``,
  the CLI's ``--timing``).
"""
from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np

_VERBOSE = os.environ.get("PANORAMA_TPU_LOG", "") not in ("", "0")


def set_verbose(v: bool) -> None:
    global _VERBOSE
    _VERBOSE = v


def log(stage: str, **kv) -> None:
    if _VERBOSE:
        items = " ".join(f"{k}={v}" for k, v in kv.items())
        print(f"[panorama-torch] {stage} {items}", file=sys.stderr,
              flush=True)


def warn(stage: str, **kv) -> None:
    """Always-on warning for conditions that must never pass silently
    (e.g. static-capacity truncation)."""
    items = " ".join(f"{k}={v}" for k, v in kv.items())
    print(f"[panorama-torch] WARNING {stage} {items}", file=sys.stderr,
          flush=True)


def log_sift_overflow(stats) -> None:
    """Report static-capacity truncation (never silent).

    stats: [N, 4] array or list of [4] int32 rows: dropped [candidates,
    refined keypoints, descriptors, final-capacity keypoints] per image."""
    arr = np.asarray(stats)
    if arr.ndim == 1:
        arr = arr[None]
    for i, row in enumerate(arr):
        if row.sum() > 0:
            warn("sift_overflow", image=i,
                 dropped_candidates=int(row[0]),
                 dropped_keypoints=int(row[1]),
                 dropped_descriptors=int(row[2]),
                 dropped_final=int(row[3]))


class StageTimer:
    def __init__(self):
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = time.perf_counter() - t0
            log(name, seconds=round(self.times[name], 3))
