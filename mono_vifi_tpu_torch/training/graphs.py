"""CUDA-graph capture and replay of the eval forwards
(`training/monovifi.py` `single_frame_disp`, `multi_frame_disp`).

At batch 1 an eval forward is hundreds of small launches, and the host's
dispatch of them, not the card, sets the pace. An entry called again with
inputs of the same signature is captured once and replayed from then on.

A call's key is its entry; its inputs' shapes, strides, dtypes and device;
the flags that pick kernels (cuDNN's TF32, autotuner and determinism,
cuBLAS's TF32, PyTorch's deterministic algorithms, and whether the port's
plain versions run); and the modules the entry runs. Under a key the cache
holds the storages of the modules' parameters and buffers: a tensor updated
in place (the optimizer, `load_state_dict`) keeps its storage, and a replay
reads its new values; a replaced tensor drops the graphs, and the key
starts again. Keys are held per bundle, weakly.

The first call with a key runs eager, which makes the models' device
constants (`ops.image.device_constant`) and cuDNN's choices. The second
captures each phase of the forward into its own graph, all in one memory
pool and in the order they replay, and replays them. A later call copies
its inputs into the graphs' static inputs, replays each phase inside its
span and returns a clone of the static output, so a result that the caller
keeps is never overwritten. Inputs off the card, a caller that is itself
capturing, and a call under a dispatch mode (a FLOP count) run eager.

`ENTRY_GRAPHS[(entry, "eager" | "capture" | "replay")]` counts the calls.
A replay adds to `ops.cuda.LAUNCHES` and `LAUNCH_SHAPES` the launches that
its graphs captured, so that they still count what the card ran.
"""

from __future__ import annotations

import collections
import weakref
from typing import Callable, Sequence

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from mono_vifi_tpu_torch.ops import cuda
from mono_vifi_tpu_torch.tracing import span

ENTRY_GRAPHS: collections.Counter = collections.Counter()

# a phase: (span name, fn(inputs, results of the phases before) -> result)
Phase = tuple[str, Callable]

_CACHE: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()  # owner -> {key: _Slot}


class _Slot:
    """One key's graphs: None until its second call."""

    def __init__(self, storages):
        self.storages = storages
        self.graphs = None
        self.static_inputs = None
        self.results = None  # every phase's static output, kept alive
        self.launches = None  # (by kernel, by kernel and shape) of one replay


def _key(entry, modules, inputs):
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic,
             torch.are_deterministic_algorithms_enabled(), cuda._plain)
    sig = tuple((t.shape, t.stride(), t.dtype, t.device) for t in inputs)
    return entry, tuple(map(id, modules)), sig, flags


def _storages(modules) -> list:
    """The data pointers of the modules' parameters and buffers, from a walk
    of the module tree that builds no names (unlike `parameters()`)."""
    ptrs, stack = [], list(modules)
    while stack:
        m = stack.pop()
        for t in m._parameters.values():
            if t is not None:
                ptrs.append(t.data_ptr())
        for t in m._buffers.values():
            if t is not None:
                ptrs.append(t.data_ptr())
        stack.extend(c for c in m._modules.values() if c is not None)
    return ptrs


def _eager(phases, inputs):
    results = []
    for name, fn in phases:
        with span(name):
            results.append(fn(inputs, results))
    return results[-1]


def _capture(slot, phases, inputs):
    """Capture every phase into its own graph in one pool."""
    pool = torch.cuda.graph_pool_handle()
    static = [t.clone() for t in inputs]
    launches, shapes = dict(cuda.LAUNCHES), collections.Counter(cuda.LAUNCH_SHAPES)
    graphs, results = [], []
    for name, fn in phases:
        g = torch.cuda.CUDAGraph()
        with span(name), torch.cuda.graph(g, pool=pool, capture_error_mode="thread_local"):
            results.append(fn(static, results))
        graphs.append(g)
    slot.launches = ({k: v - launches[k] for k, v in cuda.LAUNCHES.items() if v != launches[k]},
                     collections.Counter(cuda.LAUNCH_SHAPES) - shapes)
    slot.graphs, slot.static_inputs, slot.results = graphs, static, results


def _replay(slot, phases):
    for (name, _), g in zip(phases, slot.graphs):
        with span(name):
            g.replay()
    return slot.results[-1].clone()


def run(owner, entry: str, modules: Sequence[torch.nn.Module], phases: Sequence[Phase],
        inputs: Sequence[torch.Tensor]):
    """The last phase's result of `phases` on `inputs`, without gradient:
    eager, or through the graphs of `owner`'s cache (module docstring)."""
    with torch.no_grad():
        x = inputs[0]
        if (x.device.type != "cuda" or torch.cuda.is_current_stream_capturing()
                or _get_current_dispatch_mode() is not None):
            ENTRY_GRAPHS[entry, "eager"] += 1
            return _eager(phases, inputs)
        slots = _CACHE.setdefault(owner, {})
        key = _key(entry, modules, inputs)
        storages = _storages(modules)
        slot = slots.get(key)
        if slot is None or slot.storages != storages:
            slots[key] = _Slot(storages)
            ENTRY_GRAPHS[entry, "eager"] += 1
            return _eager(phases, inputs)
        with torch.cuda.device(x.device):
            if slot.graphs is None:
                _capture(slot, phases, inputs)
                ENTRY_GRAPHS[entry, "capture"] += 1
            else:
                for s, t in zip(slot.static_inputs, inputs):
                    s.copy_(t)
                by_kernel, by_shape = slot.launches
                for k, n in by_kernel.items():
                    cuda.LAUNCHES[k] += n
                cuda.LAUNCH_SHAPES.update(by_shape)
                ENTRY_GRAPHS[entry, "replay"] += 1
            return _replay(slot, phases)
