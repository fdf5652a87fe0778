"""CUDA-graph capture and replay of the eval forwards
(`training/monovifi.py` `single_frame_disp`, `multi_frame_disp`) and of the
training steps (`training/monovifi.py` `MonoViFiStep.make_train_step`,
`training/vfi.py` `make_vfi_train_step`).

At batch 1 an eval forward is hundreds of small launches, and a D-HRNet
training step thousands, and the host's dispatch of them, not the card,
sets the pace. A call repeated with inputs of the same signature is
captured once and replayed from then on.

A call's key is its entry or step; its inputs' names, shapes, strides,
dtypes and device; the flags that pick kernels (cuDNN's TF32, autotuner
and determinism, cuBLAS's TF32, PyTorch's deterministic algorithms, and
whether the port's plain versions run); the modules it runs; and the host
values its phases bake in (a step's clip). Under a key the cache holds the
storages of the modules' parameters and buffers, and for a step those of
the gradients and of the optimizer's state and learning rates: a tensor
updated in place (the optimizer, `load_state_dict` into a module) keeps its
storage, and a replay reads its new values; a replaced tensor (a new
parameter, `optimizer.load_state_dict`, gradients dropped by an eager call)
drops the graphs, and the key starts again. Keys are held per owner (a
bundle, a step's optimizer), weakly.

The first call with a key runs eager, which makes the models' device
constants (`ops.image.device_constant`), cuDNN's choices and, for a step,
the optimizer's state; a step warms up on the stream it is later captured
on, as PyTorch's whole-network capture asks. The second call captures each
phase into its own graph, all in one memory pool and in the order they
replay, and replays them. A later call copies its inputs into the graphs'
static inputs, replays each phase inside its span and returns clones of
the static outputs, so a result that the caller keeps is never overwritten.
Inputs off the card, a caller that is itself capturing, and a call under a
dispatch mode (a FLOP count) run eager; so does a step in a process group,
or one its caller cannot capture (a non-capturable optimizer, a
recomputed encoder).

`ENTRY_GRAPHS[(entry, "eager" | "capture" | "replay")]` and
`STEP_GRAPHS[(step, ...)]` count the calls. A replay counts the port's
launches that its graphs captured through `ops.cuda.account`, so
`ops.cuda.LAUNCHES`, `LAUNCH_SHAPES` and a wrapper on `ops.cuda.launch`
still see what the card ran.
"""

from __future__ import annotations

import collections
import weakref
from typing import Callable, Sequence

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode
from torch.utils._pytree import tree_leaves, tree_map

from mono_vifi_tpu_torch import parallel
from mono_vifi_tpu_torch.ops import cuda
from mono_vifi_tpu_torch.tracing import span

ENTRY_GRAPHS: collections.Counter = collections.Counter()
STEP_GRAPHS: collections.Counter = collections.Counter()

# a phase: (span name, fn(inputs, results of the phases before) -> result)
Phase = tuple[str, Callable]

_CACHE: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()  # owner -> _Owner


class _Owner:
    """One owner's slots by key, and the stream its steps warm up and are
    captured on."""

    def __init__(self):
        self.slots = {}
        self.stream = None


class _Slot:
    """One key's graphs: None until its second call."""

    def __init__(self, storages):
        self.storages = storages
        self.graphs = None
        self.launches = None  # a list a phase: the port's launches it captured
        self.static_inputs = None
        self.outputs = None  # the static outputs, kept alive


def _items(inputs):
    return inputs.items() if isinstance(inputs, dict) else enumerate(inputs)


def _key(name, modules, inputs, baked=()):
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic,
             torch.are_deterministic_algorithms_enabled(), cuda._plain)
    sig = tuple((k, t.shape, t.stride(), t.dtype, t.device) for k, t in _items(inputs))
    return name, tuple(map(id, modules)), sig, flags, baked


def _storages(modules, tensors=()) -> list:
    """The data pointers of the modules' parameters and buffers, from a walk
    of the module tree that builds no names (unlike `parameters()`), then
    those of `tensors` (0 for None)."""
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
    ptrs.extend(0 if t is None else t.data_ptr() for t in tensors)
    return ptrs


def _stays_eager(inputs) -> bool:
    """Inputs off the card, a capturing caller, or a dispatch mode."""
    return (any(not isinstance(t, torch.Tensor) or t.device.type != "cuda"
                for _, t in _items(inputs))
            or torch.cuda.is_current_stream_capturing()
            or _get_current_dispatch_mode() is not None)


def eager(phases: Sequence[Phase], inputs) -> list:
    """Every phase in turn, each in its span; -> their results."""
    results = []
    for name, fn in phases:
        with span(name):
            results.append(fn(inputs, results))
    return results


def _capture(slot, phases, inputs, outputs, stream=None):
    """Capture every phase into its own graph in one pool, on `stream`
    (PyTorch's capture stream if None)."""
    pool = torch.cuda.graph_pool_handle()
    static = tree_map(torch.clone, inputs)
    graphs, launches, results = [], [], []
    for name, fn in phases:
        g = torch.cuda.CUDAGraph()
        with span(name), cuda.recorded_launches() as launched, torch.cuda.graph(
                g, pool=pool, stream=stream, capture_error_mode="thread_local"):
            results.append(fn(static, results))
        graphs.append(g)
        launches.append(launched)
    slot.graphs, slot.launches, slot.static_inputs = graphs, launches, static
    slot.outputs = outputs(results)


def _replay(slot, phases, account: bool = True):
    """Each phase's graph in its span, its launches counted unless the
    capture just counted them; -> clones of the static outputs."""
    for (name, _), g, launched in zip(phases, slot.graphs, slot.launches):
        with span(name):
            if account:
                cuda.account(launched)
            g.replay()
    return tree_map(torch.clone, slot.outputs)


def _copy_in(slot, inputs) -> None:
    for k, t in _items(inputs):
        slot.static_inputs[k].copy_(t)


def run(owner, entry: str, modules: Sequence[torch.nn.Module], phases: Sequence[Phase],
        inputs: Sequence[torch.Tensor]):
    """The last phase's result of `phases` on `inputs`, without gradient:
    eager, or through the graphs of `owner`'s cache (module docstring)."""
    with torch.no_grad():
        if _stays_eager(inputs):
            ENTRY_GRAPHS[entry, "eager"] += 1
            return eager(phases, inputs)[-1]
        slots = _CACHE.setdefault(owner, _Owner()).slots
        key = _key(entry, modules, inputs)
        storages = _storages(modules)
        slot = slots.get(key)
        if slot is None or slot.storages != storages:
            slots[key] = _Slot(storages)
            ENTRY_GRAPHS[entry, "eager"] += 1
            return eager(phases, inputs)[-1]
        with torch.cuda.device(inputs[0].device):
            if slot.graphs is None:
                _capture(slot, phases, inputs, lambda results: results[-1])
                ENTRY_GRAPHS[entry, "capture"] += 1
                return _replay(slot, phases, account=False)
            _copy_in(slot, inputs)
            ENTRY_GRAPHS[entry, "replay"] += 1
            return _replay(slot, phases)


def run_step(owner, step: str, modules: Sequence[torch.nn.Module], phases: Sequence[Phase],
             inputs: dict, outputs: Callable, tensors: Callable[[], list],
             baked: tuple = (), capturable: bool = True):
    """`outputs(results of the phases)` of one training step on `inputs`
    (name -> tensor): eager, or through the graphs of `owner`'s cache
    (module docstring). `tensors()` lists the step's tensors beside the
    modules' (gradients, optimizer state) whose storages the graphs hold;
    `baked` the host values its phases bake in; `capturable` False keeps it
    eager."""
    if not capturable or parallel.active() or _stays_eager(inputs):
        STEP_GRAPHS[step, "eager"] += 1
        return outputs(eager(phases, inputs))
    cache = _CACHE.setdefault(owner, _Owner())
    key = _key(step, modules, inputs, baked)
    slot = cache.slots.get(key)
    device = next(iter(inputs.values())).device
    with torch.cuda.device(device):
        if slot is None or slot.storages != _storages(modules, tensors()):
            cache.slots.pop(key, None)  # its graphs and pool go before the warm-up
            if cache.stream is None:
                cache.stream = torch.cuda.Stream(device)
            current = torch.cuda.current_stream()
            cache.stream.wait_stream(current)
            with torch.cuda.stream(cache.stream):
                out = outputs(eager(phases, inputs))
            current.wait_stream(cache.stream)
            for t in tree_leaves(out):  # made on the warm-up stream, read on this one
                t.record_stream(current)
            cache.slots[key] = _Slot(_storages(modules, tensors()))
            STEP_GRAPHS[step, "eager"] += 1
            return out
        if slot.graphs is None:
            _capture(slot, phases, inputs, outputs, cache.stream)
            slot.storages = _storages(modules, tensors())
            STEP_GRAPHS[step, "capture"] += 1
            return _replay(slot, phases, account=False)
        _copy_in(slot, inputs)
        STEP_GRAPHS[step, "replay"] += 1
        return _replay(slot, phases)
