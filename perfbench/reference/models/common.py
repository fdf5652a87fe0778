"""Shared building blocks (counterpart of mono_vifi_tpu/models/common.py).

Modules are NCHW and use the reference PyTorch state_dict keys. Each takes
a compute `dtype`: parameters stay f32 and are cast with the input at every
convolution, as Flax's `dtype` does, so a bf16 module keeps f32 master
weights and gives bf16 activations.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference.ops.image import reflect_pad_2d
from perfbench.reference.precision import operand, output


class Conv(nn.Conv2d):
    """nn.Conv2d computing in `dtype` with f32 parameters."""

    def __init__(self, cin, cout, kernel_size, stride=1, padding=0, dilation=1,
                 groups=1, bias=True, dtype=torch.float32):
        super().__init__(cin, cout, kernel_size, stride, padding, dilation,
                         groups, bias)
        self.compute_dtype = dtype

    def forward(self, x):
        cd = self.compute_dtype
        b = None if self.bias is None else self.bias.to(cd)
        return output(F.conv2d(operand(x.to(cd)), operand(self.weight.to(cd)), b,
                               self.stride, self.padding, self.dilation, self.groups))


class Conv3x3(nn.Module):
    """Reflection-padded 3x3 conv (reference layers.py:121-138)."""

    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(cin, cout, 3, dtype=dtype)

    def forward(self, x):
        return self.conv(reflect_pad_2d(x, 1))


class ConvBlock(nn.Module):
    """Conv3x3 + ELU (reference layers.py:106-118)."""

    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__()
        self.conv = Conv3x3(cin, cout, dtype)

    def forward(self, x):
        return F.elu(self.conv(x))


class Conv1x1(nn.Module):
    """Holds a biased 1x1 conv under the reference key `conv` (layers.py
    Conv1x1)."""

    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(cin, cout, 1, dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class ConvBlock1x1(nn.Module):
    """1x1 conv + ELU (reference layers.py:141-165; counterpart of
    mono_vifi_tpu/models/common.py ConvBlock1x1)."""

    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__()
        self.conv = Conv1x1(cin, cout, dtype)

    def forward(self, x):
        return F.elu(self.conv(x))


class Linear(nn.Linear):
    """nn.Linear computing in `dtype` with f32 parameters (flax Dense)."""

    def __init__(self, cin, cout, bias=True, dtype=torch.float32):
        super().__init__(cin, cout, bias)
        self.compute_dtype = dtype

    def forward(self, x):
        cd = self.compute_dtype
        b = None if self.bias is None else self.bias.to(cd)
        return output(F.linear(operand(x.to(cd)), operand(self.weight.to(cd)), b))


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis, normalized in f32 and returned in
    `dtype`, as flax's LayerNorm computes its statistics and the affine map
    in f32 and casts the result."""

    def __init__(self, channels: int, eps: float = 1e-6, dtype=torch.float32):
        super().__init__(channels, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(self.compute_dtype)


class PReLU(nn.Module):
    """Per-channel PReLU, alpha cast to the input dtype."""

    INIT = {"weight": 0.25}

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), self.INIT["weight"]))

    def forward(self, x):
        return F.prelu(x, self.weight.to(x.dtype))


class ConvPReLU(nn.Sequential):
    """Conv + PReLU (reference networks/IFRNet.py:121-125 convrelu)."""

    def __init__(self, cin, cout, kernel_size=3, stride=1, padding=1,
                 dtype=torch.float32):
        super().__init__(
            Conv(cin, cout, kernel_size, stride, padding, dtype=dtype),
            PReLU(cout),
        )


class ConvTranspose4x4(nn.ConvTranspose2d):
    """ConvTranspose2d(k=4, s=2, p=1), the exact 2x upsampler, in `dtype`."""

    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__(cin, cout, 4, 2, 1)
        self.compute_dtype = dtype

    def forward(self, x):
        cd = self.compute_dtype
        return output(F.conv_transpose2d(operand(x.to(cd)), operand(self.weight.to(cd)),
                                         self.bias.to(cd), stride=2, padding=1))


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with the JAX package's rule (Flax, momentum 0.9): training
    normalizes with the batch statistics and moves the running statistics
    toward the batch mean and the BIASED batch variance, both taken in f32
    over the whole batch of the call. (torch's own rule would feed the
    unbiased variance into running_var.) The output is in the input dtype."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(0.9).add_(0.1 * mean)
            self.running_var.mul_(0.9).add_(0.1 * var)
            self.num_batches_tracked.add_(1)
        return y
