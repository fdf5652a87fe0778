"""The precision the reference computes its convolutions and matrix
products in. "float32" (the default) leaves them in the modules' own compute
dtype, the configuration's. "float8" is the control one precision below a
bfloat16 configuration, as float8 training computes: both operands of every convolution and matrix product rounded to
float8 e4m3 in the forward pass, and the gradient arriving at each product's
output rounded to float8 e5m2 in the backward pass, each with a per-tensor
scale."""

from __future__ import annotations

import contextlib

import torch

_MODE = {"operands": "float32"}
_FORMATS = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2, 57344.0)}


@contextlib.contextmanager
def operands(mode: str):
    """Compute the reference's convolutions and matrix products in `mode`
    ("float32" or "float8") inside the context."""
    if mode not in ("float32", "float8"):
        raise ValueError(f"unknown operand precision {mode!r}")
    prev, _MODE["operands"] = _MODE["operands"], mode
    try:
        yield
    finally:
        _MODE["operands"] = prev


def _round(t: torch.Tensor, fmt: str) -> torch.Tensor:
    dtype, top = _FORMATS[fmt]
    scale = t.detach().abs().amax().clamp_min(1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _GradE5M2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, "e5m2")


def operand(t: torch.Tensor) -> torch.Tensor:
    """An operand as the current mode rounds it, back in its own dtype; its
    gradient passes unchanged (straight through)."""
    if _MODE["operands"] == "float32":
        return t
    return t + (_round(t, "e4m3") - t).detach()


def output(y: torch.Tensor) -> torch.Tensor:
    """A product's output, whose gradient the current mode rounds."""
    if _MODE["operands"] == "float32" or not y.requires_grad:
        return y
    return _GradE5M2.apply(y)
