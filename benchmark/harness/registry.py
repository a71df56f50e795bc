"""Finds what ``BENCHMARK.json`` names, by name, in the benchmark's own
folders: a configuration in ``configs/<name>.json``, a traffic mix in
``traffic/<name>.json``, the limits of a cell's output check in
``checks/<workload>.json``, and the reader of a metric in
``metrics/<name>.py`` (per layer) or ``end_to_end/<name>.py``. A later
change adds a configuration, a mix, a cell or a metric by adding such a
file and an entry; nothing here lists them."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent  # benchmark/
ROOT = BENCH_DIR.parent  # the checkout


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with what it names: its
    configuration and traffic files, the limits of its check, and the
    end-to-end and per-layer metrics it reports."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tuple
    per_layer: tuple


def reports(metric: dict, workload: str) -> bool:
    """Whether a metric entry covers ``workload``: listed there, or
    listing no workloads at all."""
    return "workloads" not in metric or workload in metric["workloads"]


def cell(name: str, bench: dict | None = None,
         bench_dir: Path = BENCH_DIR) -> Cell:
    bench = benchmark() if bench is None else bench
    hits = [w for w in bench["workloads"] if w["name"] == name]
    if not hits:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = hits[0]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(bench_dir.parent / cfg["file"]),
        traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(bench_dir / "checks" / f"{name}.json"),
        end_to_end=tuple(m for m in bench["end_to_end"] if reports(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if reports(m, name)))


def reader(kind: str, name: str, bench_dir: Path = BENCH_DIR):
    """The module of metric ``name`` under ``kind`` ("metrics" or
    "end_to_end"): a file named after the metric, loaded by path (a
    metric's name may hold dots)."""
    path = bench_dir / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
