"""One run of one cell: the chip check, set-up by phase, the measured
window, the per-layer readers, the comparison, and the result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Standard output ends with one JSON line: `correct`, `attempted`, `failed`,
`metrics`, `device`, with `--trace 1` `breakdown`, and last `checks` (each
compared number with its limit). Standard error ends with the set-up's
phases and the compared numbers. Without a CUDA card, with fewer cards than
the cell asks for, or with JAX or the JAX package loaded once the window
has closed, the run prints no result and exits with a non-zero code.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from dataclasses import dataclass

import torch

from perfbench import compare, registry, trace
from perfbench.spans import Spans

FORBIDDEN = ("jax", "jaxlib", "flax", "mono_vifi_tpu")


class NoResult(Exception):
    """The run cannot give a result; the message says why."""


@dataclass
class Window:
    t0: float
    items: int  # steps or frames in the window, the traced stretch included
    timed_items: int  # before the traced stretch (all of them untraced)
    timed_seconds: float
    trace: trace.Trace | None = None


class Context:
    """What a driver gets: the cell, the run's arguments and device, the
    spans, and the set-up's clock."""

    def __init__(self, cell, seed: int, seconds: float, traced: bool, device,
                 started: float):
        self.cell, self.seed, self.seconds, self.traced = cell, seed, seconds, traced
        self.device = torch.device(device)
        self.spans = Spans()
        self.phases: dict[str, float] = {}
        self._last = self.started = started
        self.setup_s = None
        self.memory_peak = 0

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def phase(self, name: str):
        """End the set-up phase `name` now."""
        now = time.perf_counter()
        self.phases[name] = now - self._last
        self._last = now

    def window(self, item, trace_items: int) -> Window:
        """Run `item()` until `seconds` have passed, between two
        synchronisations; a traced run then profiles `trace_items` more
        items, the window's last."""
        self.sync()
        t0 = time.perf_counter()
        self.setup_s = t0 - self.started
        self.phase("sync")
        n = 0
        while time.perf_counter() - t0 < self.seconds:
            item()
            n += 1
        self.sync()
        timed = time.perf_counter() - t0
        tr = None
        if self.traced:
            def stretch():
                for _ in range(trace_items):
                    item()
                self.sync()
            tr = trace.record(stretch, trace_items, self.spans)
        return Window(t0=t0, items=n + (trace_items if self.traced else 0),
                      timed_items=n, timed_seconds=timed, trace=tr)

    def read_memory_peak(self):
        if self.device.type == "cuda":
            self.memory_peak = torch.cuda.max_memory_allocated(self.device)


@dataclass
class Run:
    """What a per-layer reader reads."""
    spans: Spans
    window: Window
    flops_per_item: float | None

    @property
    def trace(self):
        return self.window.trace


def card(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def per_layer(cell, run: Run) -> dict:
    """Each per-layer metric whose reader finds something to read."""
    out = {}
    for m in cell.per_layer:
        value = registry.reader(cell, m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(workload: str, seed: int, seconds: float, traced: bool, device=None,
            started: float | None = None, root=registry.ROOT) -> dict:
    """One run; -> the result object. `device` None asks for the CUDA cards
    the cell needs; tests pass "cpu"."""
    started = time.perf_counter() if started is None else started
    cell = registry.find_cell(workload, root)
    if device is None:
        if not torch.cuda.is_available():
            raise NoResult("no CUDA device: torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell.chips:
            raise NoResult(f"the cell asks for {cell.chips} cards, "
                           f"{torch.cuda.device_count()} visible")
        device = "cuda"
    ctx = Context(cell, seed, seconds, traced, device, started)
    out = registry.driver(cell).run(ctx)
    closed = time.perf_counter()
    ok, checks = compare.verdict(
        {k: v for k, v in out["readings"].items() if not k.startswith("_")}, cell.limits)
    correct = ok and out["failed"] == 0
    window = out["window"]
    if traced:
        flops = registry.driver(cell).flops_per_item(cell)
        metrics = per_layer(cell, Run(ctx.spans, window, flops))
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": ctx.setup_s, "unit": "s"}
    device_rec = {**card(ctx.device), "memory_peak_bytes": ctx.memory_peak}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_rec}
    if traced:
        tr = window.trace
        device_rec.update(busy_s=tr.busy_seconds(), window_s=tr.seconds)
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    where = power_limit() if ctx.device.type == "cuda" else "cpu"
    print("setup phases (s): " + json.dumps({k: round(v, 4) for k, v in ctx.phases.items()})
          + f"; setup_s {ctx.setup_s}; after the window (comparison and readers) "
          f"{time.perf_counter() - closed + out['check_s']:.2f} s; card {where}",
          file=sys.stderr)
    extra = {k: v for k, v in out["readings"].items() if k.startswith("_")}
    if extra:
        print("beside the checks: " + json.dumps(extra), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return result


def main(argv=None, started: float | None = None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                         started=started)
    except NoResult as e:
        print(f"no result: {e}", file=sys.stderr)
        return 2
    bad = loaded_forbidden()
    if bad:
        print(f"no result: {bad} loaded in the process that would print it", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0
