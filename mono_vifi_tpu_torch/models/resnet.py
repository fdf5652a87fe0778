"""ResNet18 feature trunk with torchvision's state_dict keys (counterpart of
mono_vifi_tpu/models/resnet.py with plain convolutions)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from mono_vifi_tpu_torch.models.common import BatchNorm2d, Conv

_LAYER_COUNTS = {18: (2, 2, 2, 2)}


def num_ch_enc(num_layers: int = 18) -> tuple[int, ...]:
    if num_layers not in _LAYER_COUNTS:
        raise ValueError(f"only ResNet{tuple(_LAYER_COUNTS)} is ported")
    return (64, 64, 128, 256, 512)


class BasicBlock(nn.Module):
    def __init__(self, inplanes, planes, stride=1, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv(inplanes, planes, 3, stride, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv(planes, planes, 3, 1, 1, bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                Conv(inplanes, planes, 1, stride, bias=False, dtype=dtype),
                BatchNorm2d(planes),
            )

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        idt = x if self.downsample is None else self.downsample(x)
        return F.relu(y + idt)


class ResNet(nn.Module):
    """Trunk returning the 5-scale pyramid, with the reference's input
    normalization (x - 0.45) / 0.225 (networks/monodepth2.py:35)."""

    def __init__(self, num_layers: int = 18, in_ch: int = 3, dtype=torch.float32):
        super().__init__()
        num_ch_enc(num_layers)
        self.conv1 = Conv(in_ch, 64, 7, 2, 3, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512),
                                             _LAYER_COUNTS[num_layers]), start=1):
            blocks = []
            for bi in range(n):
                s = (1 if li == 1 else 2) if bi == 0 else 1
                blocks.append(BasicBlock(inplanes, planes, s, dtype))
                inplanes = planes
            setattr(self, f"layer{li}", nn.Sequential(*blocks))

    def forward(self, x):
        x = (x - 0.45) / 0.225
        f0 = F.relu(self.bn1(self.conv1(x)))
        feats = [f0]
        x = F.max_pool2d(f0, 3, 2, 1)
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
            feats.append(x)
        return feats
