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
- ``span``       -- a named interval of the host: its seconds summed into
  the ``StageTimer`` open for the current call and, while a profiler
  records, a ``record_function`` annotation in its trace;
- ``StageTimer`` -- seconds per stage and per span name of one call
  (``Stitcher.stage_times``, the CLI's ``--timing``);
- ``trace``      -- a ``torch.profiler`` trace of a block when
  PANORAMA_TPU_TRACE names a directory (the JAX package's variable; there
  it starts ``jax.profiler``).
"""
from __future__ import annotations

import contextlib
import contextvars
import os
import sys
import threading
import time

import numpy as np
import torch
from torch.autograd.profiler import record_function

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


STAGE_SPAN = "stage:"  # the trace name of a stage: "stage:<name>"
# the timer of the call in progress (``StageTimer.call``), per thread
_OPEN: contextvars.ContextVar = contextvars.ContextVar("open_timer",
                                                      default=None)
_profiling = torch._C._autograd._profiler_enabled


class span:
    """A named interval of the host, a context manager:
    ``with obs.span("replay", "plan"): ...``.

    It always times itself with ``time.perf_counter`` (``seconds``, once
    closed) and adds the seconds to the ``StageTimer`` open for the
    current call (``StageTimer.call``) under ``total`` (by default
    ``name``), summed over every span of that key in the call; with no
    call open it adds nothing.
    Only while a ``torch.profiler`` records does it also enter
    ``record_function("<name>")``, or ``"<name>:<detail>"`` with a
    ``detail``: the span is then a ``user_annotation`` event of the
    trace, nested under its parent, on the profiler's clock. Off the
    profiler a span costs about a microsecond.

    Open spans only on the host side of program calls
    (``core/programs.py``): inside a function that a program captures, a
    span would fire at the capture and never on a replay."""

    __slots__ = ("name", "detail", "total", "seconds", "_t0", "_note")

    def __init__(self, name: str, detail: str | None = None,
                 total: str | None = None):
        self.name, self.detail = name, detail
        self.total = name if total is None else total
        self.seconds = 0.0
        self._note = None

    def __enter__(self):
        if _profiling():
            self._note = record_function(
                self.name if self.detail is None
                else f"{self.name}:{self.detail}")
            self._note.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        if self._note is not None:
            self._note.__exit__(*exc)
            self._note = None
        self._total(self.seconds)
        return False

    def _total(self, seconds: float) -> None:
        timer = _OPEN.get()
        if timer is not None:
            timer.times[self.total] = (timer.times.get(self.total, 0.0)
                                       + seconds)


class _Stage(span):
    """``StageTimer.stage``: the span ``stage:<name>``, its seconds kept
    under ``<name>`` in its own timer, open or not. A stage runs once a
    call, so its seconds replace the key's (``StreamingStitcher``, which
    opens no call, keeps its last push's)."""

    __slots__ = ("timer", "key")

    def __init__(self, timer: "StageTimer", key: str):
        super().__init__(STAGE_SPAN + key)
        self.timer, self.key = timer, key

    def _total(self, seconds: float) -> None:
        self.timer.times[self.key] = seconds
        log(self.key, seconds=round(seconds, 3))


class StageTimer:
    """Seconds of one call by key (``times``): each stage's wall
    (``stage``) and, while the timer is open (``call``), the sum of the
    spans of each name inside the call."""

    def __init__(self):
        self.times: dict[str, float] = {}

    def stage(self, name: str) -> span:
        """The span ``stage:<name>``; its seconds under ``name``."""
        return _Stage(self, name)

    @contextlib.contextmanager
    def call(self, name: str):
        """The span ``name`` around one call, with this timer open inside
        it: its totals start empty and gather every span of the call."""
        self.times = {}
        token = _OPEN.set(self)
        try:
            with span(name) as timed:
                yield timed
        finally:
            _OPEN.reset(token)


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
