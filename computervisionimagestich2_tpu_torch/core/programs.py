"""Per-shape device programs as CUDA graphs (the port's counterpart of
``jax.jit``), and the device constants they read.

The JAX package runs its main path as a few programs, each compiled once
per static key: the per-image features program (``parallel/batched.py::
_project_and_extract_one`` around ``models/sift.py::sift_extract_stats``),
the ordering's match counts (``models/registration.py::
all_pairs_match_counts``; on mixed shapes one program per image pair,
``models/stitcher.py::_pair_counts``), the edge plan
(``models/registration.py::plan_rows``, around ``register_edge``, itself
a program for the incremental loop and the stream), each edge's
composite + blend (``models/stitcher.py::_composite_and_blend``), the
enhance tail (``models/equalization.py::equalize_and_mix``), a batch's
whole panorama (``parallel/batched.py::_stitch_one_fixed``, into which
the features program and the plan are inlined) and a batch's
registration pair (``parallel/batched.py::_register_one``). Run eagerly,
PyTorch pays the host's launch of every kernel of them, one at a time.
``program`` gives a function the JAX execution contract on a CUDA device:

- the key is the function's static arguments (every argument that is not
  a tensor: configs, shapes, counts; they must be hashable) and the shape,
  dtype and device of each tensor argument (tensors may sit in tuples,
  lists, NamedTuples and dicts);
- the first call with a key runs the function once eagerly on a side
  stream (the warm-up fills the constant cache below, cuBLAS's workspace
  and the kernels' one-time attributes), captures it with
  ``torch.cuda.graph`` and replays the graph; every later call with the
  key copies its tensors into the graph's static inputs, replays, and
  clones the outputs out, so calls never share their results;
- a program called inside another's warm-up or capture runs inline, as a
  nested ``jit`` does;
- under ``disable_graphs()`` (``jax.disable_jit``), and on the CPU, every
  call runs the function eagerly;
- a capture that fails raises with the program's name and key; nothing
  falls back to eager;
- the kernel wrappers count their launches (``ops/_native.py::LAUNCHES``)
  while the function is captured; those counts are restored after the
  capture and added again by every replay, so the counters read what ran
  (``tools/probes.py::launches_vs_trace`` holds them against the device
  kernels a profiler trace of the same call saw);
- a capture (its warm-up with it), a replay (copy-in, launch, clone-out),
  the graph's launch within the replay and a call that a full scope runs
  eagerly are each a span (``utils/obs.py::span``): ``capture:<name>``,
  ``replay:<name>``, ``launch:<name>`` and ``overflow:<name>`` in a
  profiler's trace, the totals ``capture``, ``replay``, ``launch`` and
  ``overflow`` of the caller's ``StageTimer`` (``Stitcher.stage_times``);
- each program keeps at most ``max_graphs`` graphs (``MAX_GRAPHS``), the
  least recently replayed dropped first: every graph holds its own memory
  pool (``graph_memory`` reads them), and a process that sees many frame
  shapes or edge counts would otherwise keep one per key for good;
- inside ``scope()`` (one call of an entry point: ``Stitcher.stitch``) a
  graph the scope captured or replayed is not dropped for another key of
  the same scope: a key that finds all of its program's graphs used by
  the scope runs eagerly (``overflows``). A stitch with more edge canvases
  than ``max_graphs`` so replays the same ones call after call, where a
  plain least-recent drop would miss on every edge of a cycle longer than
  the cache and capture each anew.

A graph must not copy from pageable host memory, and a warm call must not
upload anything: ``const`` keeps the device copy of each host constant
(a divisor, filter taps, resize weights, an index) keyed by its values,
dtype and device, uploaded once outside any capture and handed out again
with the same bits. A first upload while a program is being captured
raises, and so does the lookup of a cached tensor that was written in
place: cached tensors are read-only.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import inspect
import itertools

import numpy as np
import torch

from ..ops import _native
from ..utils import obs

_DISABLED = 0  # disable_graphs() depth
_INLINE = 0  # depth of program warm-ups and captures in progress
_CAPTURING = 0  # depth of captures in progress
_SCOPE: int | None = None  # the open scope's id (the outermost one's)
_SCOPE_IDS = itertools.count(1)
_CONSTS: dict[tuple, tuple[torch.Tensor, int]] = {}
_PROGRAMS: list["Program"] = []
# graphs a program keeps: a rig's frame shape, its edge counts and the
# streaming and mixed-shape calls of a few rigs
MAX_GRAPHS = 8


@contextlib.contextmanager
def disable_graphs():
    """While open, every program runs eagerly (``jax.disable_jit()``)."""
    global _DISABLED
    _DISABLED += 1
    try:
        yield
    finally:
        _DISABLED -= 1


@contextlib.contextmanager
def scope():
    """While open, the graphs that calls capture or replay are kept for
    the scope's later calls (see the module's docstring). Nested scopes
    are one: the outermost."""
    global _SCOPE
    outer = _SCOPE
    if outer is None:
        _SCOPE = next(_SCOPE_IDS)
    try:
        yield
    finally:
        _SCOPE = outer


def graphs_enabled() -> bool:
    """False inside ``disable_graphs()``."""
    return not _DISABLED


def const(values, dtype: torch.dtype, device) -> torch.Tensor:
    """The tensor of host constant ``values`` (a Python scalar or
    sequence, or a numpy array) as ``dtype`` on ``device``: built as
    ``torch.as_tensor(values).to(dtype)`` on the host and copied to the
    device on the first call with these values, dtype and device, and the
    same tensor on every later call. Never write into it."""
    arr = np.asarray(values)
    dev = torch.device(device)
    key = (arr.dtype.str, arr.shape, arr.tobytes(), dtype, dev)
    hit = _CONSTS.get(key)
    if hit is not None:
        t, version = hit
        if t._version != version:
            raise RuntimeError(f"a cached constant {tuple(t.shape)} {dtype} "
                               f"on {dev} was written in place")
        return t
    if _CAPTURING:
        raise RuntimeError(f"constant {tuple(arr.shape)} {dtype} on {dev} "
                           "first requested during a capture: its upload "
                           "would be a pageable copy inside the graph")
    t = torch.as_tensor(arr.copy()).to(dtype=dtype).to(dev)
    _CONSTS[key] = (t, t._version)
    return t


# ----------------------------------------------------------------- pytrees
def _flatten(tree, leaves: list):
    """The structure of ``tree`` with its tensors replaced by slots
    (appended to ``leaves``) and every other leaf kept as it is."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return (_Slot,)
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(x, leaves) for x in tree))
    if isinstance(tree, dict):
        return (dict, tuple((k, _flatten(v, leaves))
                            for k, v in tree.items()))
    return (_Static, tree)


def _unflatten(spec, leaves):
    kind = spec[0]
    if kind is _Slot:
        return next(leaves)
    if kind is _Static:
        return spec[1]
    if kind is dict:
        return {k: _unflatten(v, leaves) for k, v in spec[1]}
    items = [_unflatten(x, leaves) for x in spec[1]]
    if kind in (tuple, list):
        return kind(items)
    return kind(*items)  # a NamedTuple


class _Slot:
    """Marks a tensor's place in a flattened tree."""


class _Static:
    """Marks a static leaf in a flattened tree."""


# ----------------------------------------------------------------- programs
class _Graph:
    """One captured key: the graph, its static inputs, the structure and
    static tensors of its outputs, and the kernel launches it replays."""

    def __init__(self, graph, inputs, out_spec, outputs, launches,
                 seconds: float):
        self.graph, self.inputs = graph, inputs
        self.out_spec, self.outputs = out_spec, outputs
        self.launches = launches
        self.seconds = seconds  # host time of the warm-up and the capture
        self.scope: int | None = None  # the scope that used it last


class Program:
    """A function run as one CUDA graph per key (see the module's
    docstring). ``graphs`` maps each captured key to its graph, least
    recently replayed first, at most ``max_graphs`` of them; ``captures``
    counts the captures made (``capture_s`` their host seconds),
    ``replays`` the replays, ``evictions`` the graphs dropped to make
    room and ``overflows`` the calls run eagerly because the open scope
    used every graph kept."""

    def __init__(self, fn, name: str):
        self.fn = fn
        self.name = name
        self.signature = inspect.signature(fn)
        self.graphs: collections.OrderedDict[tuple, _Graph] = (
            collections.OrderedDict())
        self.max_graphs = MAX_GRAPHS
        self.captures = self.replays = self.evictions = self.overflows = 0
        self.capture_s = 0.0
        functools.update_wrapper(self, fn)
        _PROGRAMS.append(self)

    def key(self, *args, **kwargs):
        """(key, tensors, argument structure) of a call: the key holds
        the static arguments and each tensor's shape, dtype and device."""
        bound = self.signature.bind(*args, **kwargs)
        bound.apply_defaults()
        tensors: list[torch.Tensor] = []
        spec = _flatten((bound.args, bound.kwargs), tensors)
        key = (spec, tuple((tuple(t.shape), t.dtype, t.device)
                           for t in tensors))
        try:
            hash(key)
        except TypeError as e:
            raise TypeError(f"program {self.name}: a static argument is "
                            f"not hashable") from e
        return key, tensors, spec

    def __call__(self, *args, **kwargs):
        if _DISABLED or _INLINE:
            return self.fn(*args, **kwargs)
        key, tensors, spec = self.key(*args, **kwargs)
        devices = {t.device for t in tensors}
        if len(devices) != 1 or not _graphable(next(iter(devices))):
            return self.fn(*args, **kwargs)
        entry = self.graphs.get(key)
        if entry is None:
            while len(self.graphs) >= self.max_graphs:
                # the least recently replayed graph the open scope has not
                # used
                stale = next((k for k, g in self.graphs.items()
                              if _SCOPE is None or g.scope != _SCOPE), None)
                if stale is None:
                    self.overflows += 1
                    with obs.span("overflow", self.name):
                        return self.fn(*args, **kwargs)
                del self.graphs[stale]
                self.evictions += 1
            entry = self.graphs[key] = _capture(self, key, tensors, spec)
            self.captures += 1
            self.capture_s += entry.seconds
        self.graphs.move_to_end(key)
        entry.scope = _SCOPE
        out = _replay(self.name, entry, tensors)
        self.replays += 1
        return out

    def clear(self) -> None:
        """Drop every captured graph (and the memory it holds)."""
        self.graphs.clear()


def program(name: str):
    """Decorator: run the function as a ``Program`` called ``name``."""
    return lambda fn: Program(fn, name)


def capture_stats() -> dict:
    """Over every program: the captures made so far (in all, and by
    program name) and the host seconds of their warm-ups and captures,
    the replays run (in all, and by program name), the graphs kept, the
    graphs dropped to make room and the calls a full scope ran
    eagerly."""
    by_program, replays = collections.Counter(), collections.Counter()
    for p in _PROGRAMS:
        by_program[p.name] += p.captures
        replays[p.name] += p.replays
    return {"captures": sum(p.captures for p in _PROGRAMS),
            "by_program": dict(by_program),
            "capture_s": sum(p.capture_s for p in _PROGRAMS),
            "replays": sum(p.replays for p in _PROGRAMS),
            "replays_by_program": dict(replays),
            "graphs": sum(len(p.graphs) for p in _PROGRAMS),
            "evictions": sum(p.evictions for p in _PROGRAMS),
            "overflows": sum(p.overflows for p in _PROGRAMS)}


def captures_since(before: dict) -> dict:
    """What the programs did since ``before`` (a ``capture_stats()``):
    the captures made and the replays run, each in all and by program
    (the programs that made none left out), the captures' host seconds,
    the graphs dropped and the calls run eagerly by a full scope."""
    now = capture_stats()
    delta = {k: now[k] - before[k]
             for k in ("captures", "capture_s", "replays", "evictions",
                       "overflows")}
    for k in ("by_program", "replays_by_program"):
        delta[k] = {name: n - before[k].get(name, 0)
                    for name, n in now[k].items()
                    if n != before[k].get(name, 0)}
    return delta


def graph_memory(device) -> dict:
    """The caching allocator's bytes on CUDA ``device`` (GiB): all it has
    reserved, and the part of it in the private pools that CUDA graphs
    own (reserved, and allocated to tensors), with the reserved part by
    program and graph count (``(none)``: pools no kept graph owns, such
    as a dropped graph's blocks that a live tensor still holds). A replay
    allocates nothing, so ``max_memory_allocated`` does not see the
    pools' blocks that a capture freed back into them; they stay
    reserved."""
    index = torch.cuda._get_device_index(device, optional=True)
    pools = [s for s in torch.cuda.memory_snapshot()
             if s["device"] == index
             and tuple(s["segment_pool_id"]) != (0, 0)]
    owner = {tuple(g.graph.pool()): p.name for p in _PROGRAMS
             for g in p.graphs.values()}
    by_program = collections.defaultdict(float)
    for s in pools:
        name = owner.get(tuple(s["segment_pool_id"]), "(none)")
        by_program[name] += s["total_size"] / 2 ** 30
    graphs = collections.Counter(owner.values())
    return {"reserved_gib": torch.cuda.memory_reserved(device) / 2 ** 30,
            "graph_pools_reserved_gib":
                sum(s["total_size"] for s in pools) / 2 ** 30,
            "graph_pools_allocated_gib":
                sum(s["allocated_size"] for s in pools) / 2 ** 30,
            "graph_pools_by_program": {
                k: {"reserved_gib": v, "graphs": graphs.get(k, 0)}
                for k, v in sorted(by_program.items())}}


def clear_graphs() -> None:
    """Drop the graphs of every program (the constants stay)."""
    for p in _PROGRAMS:
        p.clear()


def _graphable(device: torch.device) -> bool:
    """Whether calls on ``device`` run as graphs: CUDA devices only."""
    return device.type == "cuda"


class _CudaGraphs:
    """What a program needs of CUDA: a warm-up on a side stream, a capture
    into a ``torch.cuda.CUDAGraph`` and its replay, each on ``device``."""

    @staticmethod
    def warm_up(fn, device: torch.device) -> None:
        with torch.cuda.device(device):
            current = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                fn()
            current.wait_stream(side)

    @staticmethod
    def capture(fn, device: torch.device):
        """(graph, fn's output in the graph's memory)."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.graph(
                graph, capture_error_mode="thread_local"):
            out = fn()
        return graph, out

    @staticmethod
    def replay(graph, device: torch.device) -> None:
        with torch.cuda.device(device):
            graph.replay()


_BACKEND = _CudaGraphs


def _capture(prog: Program, key, tensors, spec) -> _Graph:
    """Warm ``prog`` up on a side stream, then capture it on static copies
    of ``tensors``, in the span ``capture:<program>`` (its seconds are
    the graph's). The launches the wrappers count in the capture are the
    graph's; the counters are restored to their values before the
    warm-up."""
    global _INLINE, _CAPTURING
    with obs.span("capture", prog.name) as timed:
        device = tensors[0].device
        counts = dict(_native.LAUNCHES)
        inputs = [t.detach().clone(memory_format=torch.contiguous_format)
                  for t in tensors]
        args, kwargs = _unflatten(spec, iter(inputs))
        _INLINE += 1
        try:
            _BACKEND.warm_up(lambda: prog.fn(*args, **kwargs), device)
            _native.LAUNCHES.update(counts)
            _CAPTURING += 1
            try:
                graph, out = _BACKEND.capture(
                    lambda: prog.fn(*args, **kwargs), device)
            except Exception as e:
                raise RuntimeError(f"program {prog.name}: CUDA graph "
                                   f"capture failed for key {key!r}") from e
            finally:
                _CAPTURING -= 1
        finally:
            _INLINE -= 1
            launches = {k: v - counts[k] for k, v in _native.LAUNCHES.items()
                        if v != counts[k]}
            _native.LAUNCHES.update(counts)
        outputs: list[torch.Tensor] = []
        out_spec = _flatten(out, outputs)
    return _Graph(graph, inputs, out_spec, outputs, launches, timed.seconds)


def _replay(name: str, entry: _Graph, tensors) -> object:
    """Program ``name``'s graph ``entry`` on ``tensors``, in the span
    ``replay:<name>`` (copy-in, launch, clone-out), the graph's launch in
    the span ``launch:<name>``."""
    with obs.span("replay", name):
        for static, t in zip(entry.inputs, tensors):
            static.copy_(t)
        with obs.span("launch", name):
            _BACKEND.replay(entry.graph, entry.inputs[0].device)
        for k, n in entry.launches.items():
            _native.LAUNCHES[k] += n
        return _unflatten(entry.out_spec,
                          iter(o.clone() for o in entry.outputs))
