"""What the profiled stretch of a traced run shows: device operations from
torch.profiler, the harness's spans as the host's annotations, and the
port's kernel launches with their arguments.

The category rules are those of the repository's profile_torch_step.py;
the port's kernels are told apart by the `__global__` functions of the
checkout's kernel sources."""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

KERNEL_NAME = re.compile(r"^(?:void )?\(anonymous namespace\)::(\w+)")
CATEGORIES = (
    ("convolution", ("conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad")),
    ("matmul", ("gemm", "cutlass", "nvjet")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_")),
    ("reduction", ("reduce",)),
    ("gather/scatter/index", ("index", "gather", "scatter")),
    ("elementwise", ("elementwise", "vectorized")),
)


def port_kernel_names() -> set[str]:
    """The `__global__` functions of the port's kernel sources."""
    import mono_vifi_tpu_torch

    csrc = Path(mono_vifi_tpu_torch.__file__).parent / "csrc"
    return set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
        "\n".join(p.read_text() for p in sorted(csrc.glob("*.cu")))))


def category(name: str, port_kernels: set[str]) -> str:
    kernel = KERNEL_NAME.match(name)
    if kernel and kernel.group(1) in port_kernels:
        return "port"
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


@dataclass
class Trace:
    """One profiled stretch of `items` steps or frames, on the profiler's
    clock (microseconds)."""
    items: int
    start_us: float
    end_us: float
    device_ops: list = field(default_factory=list)  # (name, start, end)
    host_spans: list = field(default_factory=list)  # (name, start, end)
    launches: list = field(default_factory=list)  # (C entry point, args)
    port_kernels: set = field(default_factory=set)

    @property
    def seconds(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def busy_seconds(self) -> float:
        return union_us((a, b) for _, a, b in self.device_ops) / 1e6

    def category_seconds(self) -> dict[str, float]:
        out = defaultdict(float)
        for name, a, b in self.device_ops:
            out[category(name, self.port_kernels)] += (b - a) / 1e6
        return dict(out)

    def top_ops(self, n: int = 10) -> list:
        by_name = defaultdict(float)
        for name, a, b in self.device_ops:
            by_name[name] += (b - a) / 1e6
        return sorted(([k[:160], v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest gaps between device operations, each named by the
        innermost harness span the host was in when the gap began."""
        gaps, end = [], self.start_us
        ops = sorted((a, b) for _, a, b in self.device_ops)
        for a, b in ops + [(self.end_us, self.end_us)]:
            if a > end:
                gaps.append((a - end, end))
            end = max(end, b)
        out = []
        for length, at in sorted(gaps, reverse=True)[:n]:
            inside = [(t0, name) for name, t0, t1 in self.host_spans if t0 <= at < t1]
            out.append([max(inside)[1] if inside else "outside the harness spans",
                        length / 1e6])
        return out


def record(stretch, items: int, spans) -> Trace:
    """Profile `stretch()` (which runs `items` items and synchronises) with
    the host's spans annotated and the port's kernel launches recorded."""
    import torch
    from mono_vifi_tpu_torch.ops import cuda

    launches = []
    launch = cuda.launch

    def recording_launch(fn_name, kernel, *args, shape):
        launches.append((fn_name, args))
        return launch(fn_name, kernel, *args, shape=shape)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    cuda.launch = recording_launch
    spans.annotate = True
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("perfbench.stretch"):
                stretch()
    finally:
        cuda.launch = launch
        spans.annotate = False
    device_ops, host_spans, start, end = [], [], None, None
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                device_ops.append((e.name, a, b))
        elif e.name == "perfbench.stretch":
            start, end = a, b
        elif getattr(e, "is_user_annotation", False):
            host_spans.append((e.name, a, b))
    return Trace(items=items, start_us=start, end_us=end, device_ops=device_ops,
                 host_spans=host_spans, launches=launches, port_kernels=port_kernel_names())
