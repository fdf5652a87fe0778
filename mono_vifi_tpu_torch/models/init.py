"""The JAX package's random initialization, applied to the port's modules.

Every Flax conv and dense layer of mono_vifi_tpu takes Flax's defaults: a
`lecun_normal` kernel (a normal truncated at 2 standard deviations and
rescaled to a std of sqrt(1/fan_in)) and a zero bias. Its
`ConvTranspose4x4` draws `variance_scaling(1/3, "fan_in", "uniform")` over
its HWIO kernel, uniform in +-sqrt(1/fan_in) with fan_in = 16 * cin, and a
zero bias. The normalization layers, PReLU and LiteMono's constants keep the
values their constructors give them, which are the JAX package's too.
torch's own defaults differ: kaiming-uniform(a=sqrt(5)) kernels (0.58x the
std) and uniform biases, and a transposed conv's fan_in taken from its
output channels.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

# the std of a standard normal truncated to [-2, 2]; Flax's truncated-normal
# variance scaling divides by it (jax.nn.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978
_ERF_2 = math.erf(2.0 / math.sqrt(2.0))  # the mass of N(0, 1) inside +-2, as erf


def _truncated_normal_(w: torch.Tensor, std: float) -> None:
    """N(0, std^2) truncated to +-2 std, by the inverse CDF of a uniform
    draw, as jax.random.truncated_normal draws it (one pass, where torch's
    own trunc_normal_ rejects and redraws)."""
    w.uniform_(-_ERF_2, _ERF_2).erfinv_().mul_(math.sqrt(2.0) * std)
    w.clamp_(-2.0 * std, 2.0 * std)


@torch.no_grad()
def init_like_jax_(module: nn.Module) -> nn.Module:
    """Re-draw, in place and from torch's current RNG, every conv, linear
    and transposed-conv parameter of `module`'s tree by the JAX package's
    rule (see the module docstring); other parameters and buffers are left
    as they are. -> `module`."""
    for m in module.modules():
        if isinstance(m, nn.ConvTranspose2d):
            # torch's (cin, cout/groups, kh, kw): fan_in from the input channels
            fan_in = m.weight.shape[0] * m.weight[0, 0].numel()
            bound = math.sqrt(1.0 / fan_in)
            m.weight.uniform_(-bound, bound)
        elif isinstance(m, (nn.Conv2d, nn.Linear)):
            # (cout, cin/groups, kh, kw) or (out, in): fan_in is one row's size
            _truncated_normal_(m.weight, math.sqrt(1.0 / m.weight[0].numel()) / _TRUNC_STD)
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()
    return module
