"""ResNet feature trunk with torchvision's state_dict keys (counterpart of
mono_vifi_tpu/models/resnet.py with plain convolutions)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference.models.common import BatchNorm2d, Conv


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv(inplanes, planes, 3, stride, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv(planes, planes, 3, 1, 1, bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = _downsample(inplanes, planes, stride, dtype)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        idt = x if self.downsample is None else self.downsample(x)
        return F.relu(y + idt)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 x4 (JAX models/resnet.py:50-87)."""

    expansion = 4

    def __init__(self, inplanes, planes, stride=1, dtype=torch.float32):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv(inplanes, planes, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = Conv(planes, planes, 3, stride, 1, bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = Conv(planes, out, 1, bias=False, dtype=dtype)
        self.bn3 = BatchNorm2d(out)
        self.downsample = _downsample(inplanes, out, stride, dtype)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        idt = x if self.downsample is None else self.downsample(x)
        return F.relu(y + idt)


def _downsample(inplanes, out, stride, dtype):
    """The identity branch's 1x1 conv + BatchNorm, where shapes change."""
    if stride == 1 and inplanes == out:
        return None
    return nn.Sequential(Conv(inplanes, out, 1, stride, bias=False, dtype=dtype),
                         BatchNorm2d(out))


# block and blocks per layer (JAX models/resnet.py:90-95)
_LAYER_SPECS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


def num_ch_enc(num_layers: int = 18) -> tuple[int, ...]:
    """Channels of the 5 feature maps."""
    if num_layers not in _LAYER_SPECS:
        raise ValueError(f"no ResNet{num_layers}; one of {tuple(_LAYER_SPECS)}")
    e = _LAYER_SPECS[num_layers][0].expansion
    return (64, 64 * e, 128 * e, 256 * e, 512 * e)


class ResNet(nn.Module):
    """Trunk returning the 5-scale pyramid, with the reference's input
    normalization (x - 0.45) / 0.225 (networks/monodepth2.py:35)."""

    def __init__(self, num_layers: int = 18, in_ch: int = 3, dtype=torch.float32):
        super().__init__()
        num_ch_enc(num_layers)
        block, counts = _LAYER_SPECS[num_layers]
        self.conv1 = Conv(in_ch, 64, 7, 2, 3, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for li, (planes, n) in enumerate(zip((64, 128, 256, 512), counts), start=1):
            blocks = []
            for bi in range(n):
                s = (1 if li == 1 else 2) if bi == 0 else 1
                blocks.append(block(inplanes, planes, s, dtype))
                inplanes = planes * block.expansion
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
