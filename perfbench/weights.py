"""Weights drawn from the run's seed, the benchmark's input to both the
port and the reference.

The rule is PyTorch's default initialisation, drawn in one call on the
device: every convolution, transposed convolution and linear layer has its
weight and bias uniform in +-1/sqrt(fan_in) (kaiming_uniform with
a = sqrt(5), and the matching bias bound); BatchNorm and LayerNorm weights
1 and biases 0. Any other parameter takes the constant that the class of
the module owning it declares in `INIT`, {parameter name: value}: PReLU
slopes 0.25, a layer scale its initial value. The names and shapes come
from the reference's own modules, so the reference describes what is
drawn."""

from __future__ import annotations

import math

import torch
import torch.nn as nn

_AFFINE = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)
_NORMS = (nn.BatchNorm2d, nn.LayerNorm)


def _leaves(module: nn.Module):
    """-> [(parameter name, shape, kind, bound)], each parameter once, in
    `named_parameters` order; kind is "uniform" or "const"."""
    owner = {}
    for mname, m in module.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            owner.setdefault(id(p), (m, pname))
    out = []
    for name, p in module.named_parameters():
        m, pname = owner[id(p)]
        if isinstance(m, _AFFINE):
            fan_in, _ = nn.init._calculate_fan_in_and_fan_out(m.weight)
            out.append((name, tuple(p.shape), "uniform", 1.0 / math.sqrt(fan_in)))
        elif isinstance(m, _NORMS):
            out.append((name, tuple(p.shape), "const", 1.0 if pname == "weight" else 0.0))
        elif pname in getattr(type(m), "INIT", {}):
            out.append((name, tuple(p.shape), "const", type(m).INIT[pname]))
        else:
            raise TypeError(f"no initialisation rule for {name} in {type(m).__name__}")
    return out


def draw(module: nn.Module, seed: int, device) -> dict[str, torch.Tensor]:
    """{parameter name: f32 tensor on `device`} for every parameter of
    `module` (any device, `meta` included), from `seed`."""
    leaves = _leaves(module)
    total = sum(math.prod(s) for _, s, kind, _ in leaves if kind == "uniform")
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for name, shape, kind, value in leaves:
        n = math.prod(shape)
        if kind == "uniform":
            out[name] = u[at:at + n].view(shape).mul(value)
            at += n
        else:
            out[name] = torch.full(shape, value, device=device)
    return out


def load(module: nn.Module, params: dict[str, torch.Tensor]) -> None:
    """Copy `params` into `module`'s parameters; every parameter must be
    named, and nothing else may be: buffers keep their constructed values."""
    own = dict(module.named_parameters())
    if set(own) != set(params):
        missing, extra = sorted(set(own) - set(params)), sorted(set(params) - set(own))
        raise KeyError(f"parameters differ: missing {missing[:5]}, unexpected {extra[:5]}")
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(params[name])
