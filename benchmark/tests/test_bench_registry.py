"""Configurations, traffic mixes, limits and metrics are found by name,
and a new one is added as files of its own, with no edit to a file that
is there; the scenes keep the bits the port's tests pin; a bank of frame
sets depends on the seed alone."""
from __future__ import annotations

import copy
import hashlib
import json
import shutil

import numpy as np
import pytest

from harness import registry, scenes, traffic


def test_cells_find_their_files():
    bench = registry.benchmark()
    for w in bench["workloads"]:
        cell = registry.cell(w["name"], bench)
        assert cell.traffic["entry"] in ("stitch", "batch_chain")
        assert cell.config["frames"]["count"] >= 2


def test_a_cell_a_mix_and_a_metric_added_as_new_files(tmp_path):
    """A later change adds a configuration, a mix, its limits and a
    metric as new files and entries: the registry finds them, and no file
    that was there changed."""
    shutil.copytree(registry.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    bench = copy.deepcopy(registry.benchmark())
    root = tmp_path / "benchmark"
    (root / "configs" / "small_320x240.json").write_text(json.dumps({
        "name": "small_320x240", "reduced": [], "stitch_config": {},
        "frames": {"count": 3, "height": 320, "width": 240, "step": 140,
                   "feature_scale": 1}}))
    (root / "traffic" / "repeat_chain.json").write_text(json.dumps({
        "entry": "stitch", "sets": "same", "order": "chain",
        "trace_calls": 2, "check_calls": 1}))
    (root / "checks" / "small_chain.json").write_text(json.dumps({
        "limits": {"panorama_mad": 0.5}}))
    (root / "metrics" / "frames_per_panorama.py").write_text(
        'LAYER = "orchestrator (models/stitcher.py)"\nUNIT = "frames"\n'
        'SOURCE = "program_counter"\nMOVES = "panorama_ms"\n\n\n'
        'def read(run):\n    return float(len(run["sets"][0]))\n')
    bench["configs"].append({"name": "small_320x240", "source": "x",
                             "file": "benchmark/configs/small_320x240.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "small_chain",
                               "config": "small_320x240",
                               "traffic": "repeat_chain", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "frames_per_panorama",
                               "unit": "frames", "better": "lower",
                               "source": "program_counter",
                               "layer": "orchestrator (models/stitcher.py)",
                               "moves": "panorama_ms",
                               "workloads": ["small_chain"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("panorama_ms", "device_mem_gib", "graph_pool_gib"):
            m["workloads"].append("small_chain")
    cell = registry.cell("small_chain", bench, bench_dir=root)
    assert cell.traffic["order"] == "chain"
    assert cell.config["frames"]["count"] == 3
    assert cell.limits["limits"] == {"panorama_mad": 0.5}
    assert [m["name"] for m in cell.per_layer] == [
        "graph_pool_gib", "frames_per_panorama"]
    sets = traffic.frame_sets(cell.config["frames"], cell.traffic, 5)
    mod = registry.reader("metrics", "frames_per_panorama", bench_dir=root)
    assert mod.read({"sets": sets}) == 3.0
    after = {p: p.read_bytes() for p in before}
    assert after == before


PINNED = "729340e9bb16b5c4aae65e9ec5e6e943378216f88dafbc091f2812e26d19ee99"


def test_scenes_keep_the_bits_the_port_pins():
    """tests/test_torch_bench.py pins the port's scenes to this digest."""
    h = hashlib.sha256()
    for a in scenes.crops(512, 384, 224, 2, seed=0):
        h.update(np.ascontiguousarray(a).tobytes())
    assert h.hexdigest() == PINNED


GEOM = {"count": 4, "height": 96, "width": 72, "step": 40,
        "feature_scale": 1}
BANK = {"sets": "bank", "bank": 5, "batch": 2, "order": "chain"}


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 12345])
def test_the_bank_depends_on_the_seed_alone(seed):
    a = traffic.frame_sets(GEOM, BANK, seed)
    b = traffic.frame_sets(GEOM, BANK, seed)
    c = traffic.frame_sets(GEOM, BANK, seed + 1)
    assert len(a) == 5 and all(x.shape == (4, 96, 72, 3) for x in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not any(np.array_equal(x, y) for x, y in zip(a, c))
    # the sets are distinct scenes
    assert len({x.tobytes() for x in a}) == 5


def test_calls_take_the_bank_in_turn():
    assert [traffic.call_sets(BANK, 5, k) for k in range(3)] == [
        [0, 1], [2, 3], [4, 0]]
    assert traffic.call_sets({"sets": "same"}, 1, 7) == [0]


def test_the_scrambled_order():
    same = {"sets": "same", "order": "scrambled"}
    (s,) = traffic.frame_sets(GEOM, same, 3)
    crops = scenes.crops(96, 72, 40, 1, 3)
    assert all(np.array_equal(s[k], crops[i])
               for k, i in enumerate(scenes.SCRAMBLE))


def test_a_repeat_cell_takes_the_scene_of_its_seed():
    """Every seed, large ones too, gives its own scene; the configuration
    lists none to pick from."""
    same = {"sets": "same", "order": "chain"}
    big = 2 ** 31 + 5
    (a,) = traffic.frame_sets(GEOM, same, big)
    assert np.array_equal(a, np.stack(scenes.crops(96, 72, 40, 1, big)))
    (b,) = traffic.frame_sets(GEOM, same, big + 1)
    assert not np.array_equal(a, b)
    for name in ("dataset1_512x384", "config4_4k_gain"):
        frames = registry.load_json(
            registry.BENCH_DIR / "configs" / f"{name}.json")["frames"]
        assert "scene_seeds" not in frames
