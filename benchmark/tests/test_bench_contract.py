"""BENCHMARK.json against the shape the benchmark's contract gives it, and
every name in it found in a file of its own."""
from __future__ import annotations

import json
import re

import pytest

from harness import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return registry.benchmark()


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_limits(bench):
    assert set(bench) == KEYS
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024
    # the full check at 24 cells fits its time
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_lines(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert _line(w["why"]) and w["chips"] in (1, 4)


def test_every_cell_reports_what_it_must(bench):
    for w in bench["workloads"]:
        cell = registry.cell(w["name"], bench)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:  # what it moves, the cell reports
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_every_name_has_its_file(bench):
    for m in bench["end_to_end"]:
        assert hasattr(registry.reader("end_to_end", m["name"]), "read")
    for m in bench["per_layer"]:
        mod = registry.reader("metrics", m["name"])
        assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
            m["layer"], m["unit"], m["source"], m["moves"]), m["name"]
    for w in bench["workloads"]:
        cell = registry.cell(w["name"], bench)
        assert cell.config["name"] == w["config"]
        assert cell.config["reduced"] == next(
            c["reduced"] for c in bench["configs"]
            if c["name"] == w["config"])
        assert cell.limits["limits"]
