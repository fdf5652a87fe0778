"""Small utilities of the entry points (counterpart of
mono_vifi_tpu/utils/__init__.py; reference utils.py): file lists, parameter
counts, and a FLOP count for the evaluation report, taken with PyTorch's
FlopCounterMode where the JAX entry points use XLA's cost analysis.
"""

from __future__ import annotations

import torch
import torch.nn as nn


def readlines(filename: str) -> list[str]:
    with open(filename, "r") as f:
        return f.read().splitlines()


def count_params(*modules: nn.Module) -> int:
    """Distinct parameters of the given modules (a shared module counts once)."""
    seen = {id(p): p for m in modules for p in m.parameters()}
    return sum(p.numel() for p in seen.values())


def flops(fn, *args) -> float:
    """FLOPs of one call of `fn(*args)` as counted by
    torch.utils.flop_counter (matrix products and convolutions; the port's
    own kernels are not counted). The call runs under torch.no_grad()."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn(*args)
    return float(counter.get_total_flops())
