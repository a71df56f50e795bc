"""Logging, stage timing and traces (the port's copy of
``computervisionimagestich2_tpu.utils.obs``):

- ``log``        -- structured key=value stage logging, on when
  PANORAMA_TPU_LOG is set (not "0") or after ``set_verbose(True)``;
- ``warn``       -- always-on warnings for what must never pass silently
  (static-capacity truncation);
- ``log_codec``  -- the BMP codec ``utils.io`` took, always printed, once
  per process;
- ``log_sift_overflow`` -- the per-image SIFT truncation report, and
  ``log_sift_overflow_async``, the same from a side thread;
- ``StageTimer`` -- wall-clock seconds per stage (``Stitcher.stage_times``,
  the CLI's ``--timing``);
- ``trace``      -- a ``torch.profiler`` trace of a block when
  PANORAMA_TPU_TRACE names a directory (the JAX package's variable; there
  it starts ``jax.profiler``).
"""
from __future__ import annotations

import contextlib
import os
import sys
import threading
import time

import numpy as np
import torch

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


def log_codec(name: str, **kv) -> None:
    """Which BMP codec ``utils.io`` took ("native" or "numpy", with the
    library or the reason the native one is unavailable). ``utils.io``
    calls it once per process, on its first image; always printed, as
    the choice must never pass silently."""
    items = "".join(f" {k}={v}" for k, v in kv.items())
    print(f"[panorama-torch] codec={name}{items}", file=sys.stderr,
          flush=True)


def log_sift_overflow(stats) -> None:
    """Report static-capacity truncation (never silent).

    stats: [N, 4] array, tensor (on any device) or list of [4] int32 rows:
    dropped [candidates, refined keypoints, descriptors, final-capacity
    keypoints] per image."""
    if isinstance(stats, torch.Tensor):
        stats = stats.cpu()
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


def log_sift_overflow_async(stats) -> threading.Thread:
    """``log_sift_overflow`` on a daemon thread: the readback of ``stats``
    waits for the device work that feeds it, which would stall a caller
    that is still queueing work. Best effort (a daemon thread may not
    print if the process exits first). Returns the thread, so a caller can
    join it."""
    t = threading.Thread(target=log_sift_overflow, args=(stats,),
                         daemon=True)
    t.start()
    return t


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


@contextlib.contextmanager
def trace(label: str = "panorama"):
    """A ``torch.profiler`` trace of the block (host activity, and the
    card's when CUDA is available), written as a Chrome trace under
    ``$PANORAMA_TPU_TRACE/<label>`` when that variable is set; otherwise
    nothing. The JAX package's ``trace`` reads the same variable and runs
    ``jax.profiler``."""
    trace_dir = os.environ.get("PANORAMA_TPU_TRACE")
    if not trace_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=
                 tensorboard_trace_handler(os.path.join(trace_dir, label))):
        yield
