"""Cells, configurations, mixes and metrics are found by name, and a new
one is picked up from files alone; BENCHMARK.json keeps to its contract."""

from __future__ import annotations

import json
import re

import pytest

from perfbench import registry
from perfbench.tests.conftest import copy_benchmark

BENCH = registry.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    c = registry.find_cell(cell)
    assert c.config["options"] and c.traffic["driver"] and c.limits
    assert hasattr(registry.driver(c), "run") and hasattr(registry.driver(c), "calibration")
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(registry.reader(c, m["name"]))


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        registry.find_cell("no_such.cell")


def test_new_cell_and_metric_from_files_only(tmp_path):
    root = copy_benchmark(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "resnet18_kitti_mr.train_mem_pool8",
                               "config": "resnet18_kitti_mr", "traffic": "train_mem_pool8",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "steps.train", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "step",
                               "moves": "train_samples_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((root / "perfbench/traffic/train_mem.json").read_text())
    (root / "perfbench/traffic/train_mem_pool8.json").write_text(json.dumps({**mix, "pool": 8}))
    (root / "perfbench/workloads/resnet18_kitti_mr.train_mem_pool8.json").write_text(
        json.dumps({"limits": {"loss_gap": 1.0}}))
    (root / "perfbench/metrics/steps.train.py").write_text(
        "def read(run):\n    return run.window.items\n")
    cell = registry.find_cell("resnet18_kitti_mr.train_mem_pool8", root)
    assert cell.traffic["pool"] == 8 and cell.limits == {"loss_gap": 1.0}
    assert "steps.train" in [m["name"] for m in cell.per_layer]

    class W:
        items = 7

    class R:
        window = W

    assert registry.reader(cell, "steps.train")(R) == 7
    # the metric without a `workloads` key reaches the cells already there
    assert "steps.train" in [m["name"] for m in
                             registry.find_cell("resnet18_kitti_mr.train_mem", root).per_layer]


def test_benchmark_json_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    names = [c["name"] for c in BENCH["configs"]]
    cells = [w["name"] for w in BENCH["workloads"]]
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (registry.ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/")
        assert c["name"] in {w["config"] for w in BENCH["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= set(cells)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in cells:  # each cell reports setup_s, another end-to-end and a per-layer metric
        c = registry.find_cell(w)
        assert len(c.end_to_end) >= 2 and c.per_layer
    assert len(json.dumps(BENCH)) <= 64 * 1024
