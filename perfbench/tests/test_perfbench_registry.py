"""Cells, configurations, mixes and metrics are found by name, and a new
one is picked up from files alone; BENCHMARK.json keeps to its contract."""

from __future__ import annotations

import json
import re
import subprocess
import sys

import pytest
import torch

from perfbench import registry, weights
from perfbench.reference.config import Config
from perfbench.reference.training import factory
from perfbench.tests.conftest import TINY, copy_benchmark
from perfbench.tests.test_perfbench_program_spans import check_declared

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


# a depth net of its own module file: five stride-2 convs to a ResNet-like
# pyramid, each scaled by a parameter whose rule the module declares
NEW_BACKBONE = """
import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference.models.common import Conv
from perfbench.reference.models.monodepth2 import DepthDecoder


class Stage(nn.Module):
    INIT = {"gain": 0.5}

    def __init__(self, cin, cout, dtype):
        super().__init__()
        self.conv = Conv(cin, cout, 3, 2, 1, dtype=dtype)
        self.gain = nn.Parameter(torch.ones(cout, 1, 1))

    def forward(self, x):
        return F.elu(self.conv(x)) * self.gain.to(x.dtype)


class Encoder(nn.Module):
    num_ch_enc = (8, 8, 16, 16, 32)

    def __init__(self, dtype):
        super().__init__()
        cin = (3,) + self.num_ch_enc[:-1]
        self.stages = nn.ModuleList(Stage(a, b, dtype) for a, b in zip(cin, self.num_ch_enc))

    def forward(self, x):
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        return feats


def build(cfg, scales, dtype):
    encoder = Encoder(dtype)
    return encoder, DepthDecoder(encoder.num_ch_enc, scales, dtype)


BACKBONES = {"StrideNet": build}
"""

# run from the copy's root, so that `perfbench` is the copy's
IN_THE_COPY = """
import importlib, json, types
import torch
import perfbench
from perfbench import registry
from perfbench.reference.training import factory

cell = registry.find_cell("stridenet_kitti_mr.train_mem")
drv = registry.driver(cell)
ctx = types.SimpleNamespace(cell=cell, seed=11, device=torch.device("cpu"))
w = drv.initial_weights(ctx)
out = {"package": perfbench.__file__, "backbones": sorted(factory.backbones()),
       "gains": sorted({x for k, v in w.items() if k.endswith("gain") for x in v.flatten().tolist()}),
       "roles": sorted({k.split(".")[0] for k in w}), "flops": drv.flops_per_item(cell)}
(registry.ROOT / "perfbench/reference/models/twice.py").write_text(
    'BACKBONES = {"StrideNet": None}')
importlib.invalidate_caches()
factory.backbones.cache_clear()
try:
    factory.backbones()
except ValueError as e:
    out["twice"] = str(e)
print(json.dumps(out))
"""


def test_new_backbone_and_cell_from_files_only(tmp_path):
    """A depth net and a training cell join a copy of the benchmark by new
    files and entries alone: the cell's bundle builds, its weights draw
    (the module's own rule included) and its FLOPs count, a second
    declaration of the name raises, and the step spans' metrics must then
    list the cell."""
    root = copy_benchmark(tmp_path)
    (root / "perfbench/reference/models/stridenet.py").write_text(NEW_BACKBONE)
    conf = json.loads((root / "perfbench/configs/resnet18_kitti_mr.json").read_text())
    conf["options"].update(TINY, backbone="StrideNet")
    (root / "perfbench/configs/stridenet_kitti_mr.json").write_text(json.dumps(conf))
    (root / "perfbench/workloads/stridenet_kitti_mr.train_mem.json").write_text(
        (root / "perfbench/workloads/resnet18_kitti_mr.train_mem.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "stridenet_kitti_mr", "source": "a test",
                             "file": "perfbench/configs/stridenet_kitti_mr.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "stridenet_kitti_mr.train_mem",
                               "config": "stridenet_kitti_mr", "traffic": "train_mem",
                               "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    done = subprocess.run([sys.executable, "-c", IN_THE_COPY], cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out["package"].startswith(str(root))
    assert out["backbones"] == ["DHRNet", "LiteMono", "ResNet18", "ResNet50", "StrideNet"]
    assert out["gains"] == [0.5]
    assert {"encoder", "depth", "pose_encoder", "vfi_train"} <= set(out["roles"])
    assert out["flops"] > 0
    assert "StrideNet declared by both" in out["twice"]

    # the step spans' metrics leave the new training cell out: refused; listed: kept
    spans = ("forward_ms.train", "backward_ms.train", "clip_ms.train", "update_ms.train")
    for metric in spans:
        with pytest.raises(AssertionError):
            check_declared(metric, root)
    for m in bench["per_layer"]:
        if m["name"] in spans:
            m["workloads"].append("stridenet_kitti_mr.train_mem")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for metric in spans:
        check_declared(metric, root)


def test_unknown_backbone_names_the_known_ones():
    with pytest.raises(ValueError, match="unknown backbone NoNet; known: DHRNet, LiteMono"):
        factory.build_depth_net(Config(backbone="NoNet"), None)


def test_parameter_without_a_rule_raises():
    class Scaled(torch.nn.Module):
        INIT = {"gain": 1.0}

        def __init__(self):
            super().__init__()
            self.gain = torch.nn.Parameter(torch.ones(2))
            self.bias = torch.nn.Parameter(torch.zeros(2))

    with pytest.raises(TypeError, match="no initialisation rule for bias in Scaled"):
        weights.draw(Scaled(), 1, "cpu")


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
