"""Host-clock spans recorded around the benchmark's calls into the port.

A span is (name, start, end) in `time.perf_counter` seconds, kept in memory.
While a profiler runs (`annotate`), each span is also a
`torch.profiler.record_function` range, so the trace can name what the host
was doing during a gap on the device."""

from __future__ import annotations

import contextlib
import time

import torch


class Spans:
    def __init__(self):
        self.records: list[tuple[str, float, float]] = []
        self.annotate = False

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = torch.profiler.record_function(name) if self.annotate else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            yield
        self.records.append((name, t0, time.perf_counter()))

    def durations(self, name: str, since: float = float("-inf")) -> list[float]:
        return [t1 - t0 for n, t0, t1 in self.records if n == name and t0 >= since]
