"""The VFI training cell on a tiny CPU copy (IFRNet `tiny`, 64x96, B=2, the
configuration's bf16): whole runs through `harness.execute`, traced and
untraced, come out correct; the control and both planted faults come out
not correct; each of the cell's ten per-layer readers reads a number,
the device's from a hand-built trace, and `elementwise_ms.train` in every
training cell; the launches a step by kernel and shape that the driver
prints beside the checks."""

from __future__ import annotations

import collections
import json

import pytest

from perfbench import calibrate, compare, harness, registry
from perfbench.spans import Spans
from perfbench.tests.conftest import copy_benchmark
from perfbench.trace import Trace

CELL = "ifrnet_l_kitti.train_vfi"
SEED = 2**31 + 977
# between what the tiny copy's program reads on the CPU (seeds 2**31 + 977,
# 6, 12345, 4000000011: first loss 0, worst leaf's first gradient up to
# 6.9e-7, change up to 3.5e-4) and what the control and the faults read
# (float8: first loss 4.4e-5 and up, gradient 0.052, change 0.026; half
# batch: 7.8e-3, 0.065, 0.041; state unchanged: gradient and change 1.0)
TINY_LIMITS = {"loss_gap_first": 1e-5, "grad_gap": 0.01, "change_gap": 0.01}
METRICS = [m["name"] for m in registry.load_benchmark()["per_layer"]
           if CELL in m.get("workloads", ())]


@pytest.fixture(scope="module")
def vfi_root(tmp_path_factory):
    root = copy_benchmark(tmp_path_factory.mktemp("tiny_vfi"))
    conf = root / "perfbench/configs/ifrnet_l_kitti.json"
    c = json.loads(conf.read_text())
    c["options"].update(height=64, width=96, batch_size=2, vfi_scale="tiny")
    conf.write_text(json.dumps(c))
    mix = root / "perfbench/traffic/train_vfi.json"
    mix.write_text(json.dumps({**json.loads(mix.read_text()), "trace_steps": 1}))
    own = root / f"perfbench/workloads/{CELL}.json"
    own.write_text(json.dumps({"limits": TINY_LIMITS}))
    return root


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_runs_correct(vfi_root, traced, capsys):
    r = harness.execute(CELL, SEED, 1.0, traced, device="cpu", root=vfi_root)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    if traced:
        # the span readers and MFU read on the CPU; the device's find nothing
        assert {"step_call_ms.train", "forward_ms.train_vfi", "backward_ms.train_vfi",
                "mfu_pct.train"} <= set(r["metrics"])
        assert "device_idle_pct.train" not in r["metrics"]
    else:
        assert set(r["metrics"]) == {"train_samples_per_s", "setup_s"}
    json.dumps(r)
    # printed beside the checks; a CPU tensor launches none of the port's kernels
    assert '"_launches_per_step": {}' in capsys.readouterr().err


def test_launches_per_step_by_kernel_and_shape():
    drv = registry.driver(registry.find_cell(CELL))
    before = collections.Counter({("bilinear_sample", (32, 3, 160, 576)): 5})
    after = before + collections.Counter({("bilinear_sample", (32, 3, 160, 576)): 3,
                                          ("bilinear_sample_bwd", (32, 3, 160, 576)): 3,
                                          ("bilinear_sample", (32, 96, 40, 144)): 6})
    assert drv.launches_per_step(before, after, 3) == {
        "bilinear_sample 32x3x160x576": 1.0, "bilinear_sample_bwd 32x3x160x576": 1.0,
        "bilinear_sample 32x96x40x144": 2.0}
    assert drv.launches_per_step(after, after, 3) == {}


def test_control_and_faults_are_not_correct(vfi_root):
    out = calibrate.calibrate(CELL, [SEED], device="cpu", root=vfi_root)["per_seed"][SEED]
    assert set(out) == {"program", "control", "half_batch", "unchanged_state"}
    for side, readings in out.items():
        ok, _ = compare.verdict({k: v for k, v in readings.items() if not k.startswith("_")},
                                TINY_LIMITS)
        assert ok is (side == "program"), side


def trace_of_a_step():
    return Trace(
        items=2, start_us=0.0, end_us=200_000.0,
        device_ops=[("void at::native::vectorized_elementwise_kernel<4>", 0.0, 40_000.0),
                    ("cudnn::implicit_convolve_sgemm", 40_000.0, 90_000.0),
                    ("void (anonymous namespace)::bilinear_sample_kernel(...)",
                     90_000.0, 90_100.0)],
        host_spans=[("train_step.forward", 0.0, 60_000.0),
                    ("train_step.backward", 60_000.0, 100_000.0),
                    ("train_step.clip", 100_000.0, 102_000.0),
                    ("train_step.update", 102_000.0, 110_000.0)],
        launches=[("mv_bilinear_sample", (0, 1, 1, 0, 0, 0, 32, 3, 160, 576, 160, 576, 0, 1))],
        port_kernels={"bilinear_sample_kernel"})


def test_every_metric_reads_a_number():
    assert len(METRICS) == 10
    cell = registry.find_cell(CELL)
    spans = Spans()
    spans.records = [("step_call", 1.0, 1.25), ("step_call", 1.5, 1.75)]
    window = harness.Window(t0=0.0, items=6, timed_items=4, timed_seconds=1.0,
                            trace=trace_of_a_step())
    run = harness.Run(spans, window, 3.557e12)
    got = {m: registry.reader(cell, m)(run) for m in METRICS}
    assert got["step_call_ms.train"] == pytest.approx(250.0)
    assert got["forward_ms.train_vfi"] == pytest.approx(30.0)
    assert got["backward_ms.train_vfi"] == pytest.approx(20.0)
    assert got["clip_ms.train"] == pytest.approx(1.0)
    assert got["update_ms.train"] == pytest.approx(4.0)
    assert got["elementwise_ms.train"] == pytest.approx(20.0)
    assert got["conv_ms.train"] == pytest.approx(25.0)
    assert 0 < got["port_kernels_roofline.train"] < 100
    assert got["device_idle_pct.train"] == pytest.approx(100 * (1 - 0.04505 / 0.25))
    assert got["mfu_pct.train"] == pytest.approx(100 * 3.557e12 * 4 / 989.4e12)


@pytest.mark.parametrize("cell", ["resnet18_kitti_mr.train_mem", "dhrnet_kitti_mr.train_mem",
                                  CELL])
def test_elementwise_ms_in_every_training_cell(cell):
    c = registry.find_cell(cell)
    assert "elementwise_ms.train" in [m["name"] for m in c.per_layer]
    read = registry.reader(c, "elementwise_ms.train")
    window = harness.Window(t0=0.0, items=6, timed_items=4, timed_seconds=1.0,
                            trace=trace_of_a_step())
    assert read(harness.Run(Spans(), window, None)) == pytest.approx(20.0)
    assert read(harness.Run(Spans(), harness.Window(0.0, 6, 4, 1.0, None), None)) is None
