"""Small utilities of the entry points (counterpart of
mono_vifi_tpu/utils/__init__.py; reference utils.py): file lists, time
formatting, logging set-up, parameter counts, and a FLOP count for the
evaluation report, taken with PyTorch's FlopCounterMode where the JAX entry
points use XLA's cost analysis.
"""

from __future__ import annotations

import logging
import os
import sys

import torch
import torch.nn as nn


def readlines(filename: str) -> list[str]:
    with open(filename, "r") as f:
        return f.read().splitlines()


def sec_to_hm(t: float) -> tuple[int, int, int]:
    t = int(t)
    s = t % 60
    t //= 60
    m = t % 60
    t //= 60
    return t, m, s


def sec_to_hm_str(t: float) -> str:
    h, m, s = sec_to_hm(t)
    return f"{h:02d}h{m:02d}m{s:02d}s"


def setup_logging(filename: str | None = None, filemode: str = "w", rank: int = 0):
    """INFO logging to the console and an optional per-experiment log file
    on rank 0; the other ranks log warnings to the console only."""
    handlers: list[logging.Handler] = [logging.StreamHandler(sys.stdout)]
    if filename is not None and rank == 0:
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        handlers.append(logging.FileHandler(filename, mode=filemode))
    logging.basicConfig(
        level=logging.INFO if rank == 0 else logging.WARNING,
        format="%(asctime)s %(levelname)s %(message)s",
        handlers=handlers,
        force=True,
    )


def count_params(*modules: nn.Module) -> int:
    """Distinct parameters of the given modules (a shared module counts once)."""
    seen = {id(p): p for m in modules for p in m.parameters()}
    return sum(p.numel() for p in seen.values())


def flops(fn, *args, grad: bool = False) -> float:
    """FLOPs of one call of `fn(*args)` as counted by
    torch.utils.flop_counter (matrix products and convolutions, the
    backward's among them; the port's own kernels are not counted). The
    call runs under torch.no_grad() unless `grad` (a training step)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with torch.set_grad_enabled(grad), counter:
        fn(*args)
    return float(counter.get_total_flops())
