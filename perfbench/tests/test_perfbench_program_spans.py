"""The readers of the port's own spans: host ms per step or frame from a
hand-built trace, and nothing where there is no trace or no such span."""

from __future__ import annotations

import pytest

from perfbench import harness, registry
from perfbench.spans import Spans
from perfbench.trace import Trace

SPAN_OF = {
    "forward_ms.train": "train_step.forward",
    "backward_ms.train": "train_step.backward",
    "clip_ms.train": "train_step.clip",
    "update_ms.train": "train_step.update",
    "mf_flow_ms.video": "multi_frame_disp.flow",
    "mf_fusion_ms.video": "multi_frame_disp.fusion",
}
BENCH = {m["name"]: m for m in registry.load_benchmark()["per_layer"]}


def run_of(trace):
    window = harness.Window(t0=0.0, items=4, timed_items=2, timed_seconds=1.0, trace=trace)
    return harness.Run(Spans(), window, None)


def read(metric, run):
    cell = registry.find_cell(BENCH[metric]["workloads"][0])
    return registry.reader(cell, metric)(run)


@pytest.mark.parametrize("metric", sorted(SPAN_OF))
def test_reads_host_ms_per_item(metric):
    span = SPAN_OF[metric]
    # two items; the span twice (1 ms and 3 ms on the profiler's microsecond
    # clock), inside and beside spans of other names
    tr = Trace(items=2, start_us=0.0, end_us=10_000.0, host_spans=[
        ("step_call", 0.0, 5_000.0), (span, 100.0, 1_100.0), ("frame", 4_000.0, 9_000.0),
        (span, 5_000.0, 8_000.0), (span + ".inner", 5_100.0, 5_200.0), ("other", 0.0, 9_999.0),
    ])
    assert read(metric, run_of(tr)) == pytest.approx(2.0)


@pytest.mark.parametrize("metric", sorted(SPAN_OF))
def test_reads_nothing_without_trace_or_span(metric):
    assert read(metric, run_of(None)) is None
    tr = Trace(items=3, start_us=0.0, end_us=10.0, host_spans=[("step_call", 0.0, 9.0)])
    assert read(metric, run_of(tr)) is None


@pytest.mark.parametrize("metric", sorted(SPAN_OF))
def test_declared_as_program_spans(metric):
    m = BENCH[metric]
    train = metric.endswith(".train")
    assert (m["unit"], m["better"], m["source"]) == ("ms", "lower", "program_span")
    assert m["layer"] == ("step" if train else "entry")
    assert m["moves"] == ("train_samples_per_s" if train else "video_frames_per_s")
    assert m["workloads"] == (
        ["resnet18_kitti_mr.train_mem", "dhrnet_kitti_mr.train_mem"] if train
        else ["resnet18_kitti_mr.video_b1"])
