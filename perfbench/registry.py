"""Finds everything by name: the cell in `BENCHMARK.json`, its
configuration file, its traffic mix (`traffic/<mix>.json`), its own file
(`workloads/<cell>.json`: the limits of its comparison), the mix's driver
(`drivers/<driver>.py`) and the readers of its per-layer metrics
(`metrics/<metric>.py`). Nothing here lists a cell, mix or metric."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file: source, options, weights rule
    traffic: dict  # the mix's parameters; "driver" names its driver
    limits: dict  # {compared number: limit}
    end_to_end: list = field(default_factory=list)  # BENCHMARK.json entries
    per_layer: list = field(default_factory=list)
    root: Path = ROOT


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of `root`'s BENCHMARK.json with its files; KeyError
    for a cell it does not declare."""
    bench = load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    own = json.loads((root / "perfbench" / "workloads" / f"{name}.json").read_text())
    return Cell(
        name=name, chips=entry["chips"],
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((root / "perfbench" / "traffic" / f"{entry['traffic']}.json").read_text()),
        limits=own["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        root=root,
    )


def _load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(cell: Cell):
    """The module that drives the cell's mix: `drivers/<driver>.py`."""
    name = cell.traffic["driver"]
    return _load_file(cell.root / "perfbench" / "drivers" / f"{name}.py",
                      f"perfbench_driver_{name}")


def reader(cell: Cell, metric: str):
    """The `read(run)` function of `metrics/<metric>.py`."""
    path = cell.root / "perfbench" / "metrics" / f"{metric}.py"
    return _load_file(path, "perfbench_metric_" + metric.replace(".", "_")).read
