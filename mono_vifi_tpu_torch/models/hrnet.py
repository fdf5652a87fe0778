"""HRNet backbone (counterpart of mono_vifi_tpu/models/hrnet.py; reference
networks/hrnet_encoder.py + hrnet_config.py), NCHW, plain convolutions,
with the reference state_dict keys.

HighResolutionNet: two 3x3/s2 conv stems (features at 1/2 and 1/4), a
Bottleneck stage 1, then three multi-branch stages that exchange information
through fuse layers (1x1 conv + BatchNorm + bilinear align_corners=True
upsample from a lower to a higher resolution, chains of stride-2 3x3 conv +
BatchNorm (+ ReLU) from a higher to a lower one). Returns 5 features: the
1/2-resolution stem (64 channels) and the branch outputs at 1/4 .. 1/32
(18, 36, 72, 144 for hrnet18).

The JAX package folds samples into channels and blocks rows on the TPU
(`_branch_fb`, `_branch_fy`, ops/blockconv.py); those are exact rewrites of
these convolutions and are not ported. Its folded BatchNorm takes the
variance as E[x^2] - E[x]^2 where this one takes two passes, so the two
differ by rounding only.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mono_vifi_tpu_torch.models.common import BatchNorm2d, Conv
from mono_vifi_tpu_torch.models.resnet import BasicBlock, Bottleneck
from mono_vifi_tpu_torch.ops.image import resize_bilinear

# stage specs: (num_modules, num_branches, blocks_per_branch, channels, block)
HRNET_CONFIGS = {
    "hrnet18": dict(
        stage1=(1, 1, (4,), (64,), "bottleneck"),
        stage2=(1, 2, (4, 4), (18, 36), "basic"),
        stage3=(4, 3, (4, 4, 4), (18, 36, 72), "basic"),
        stage4=(3, 4, (4, 4, 4, 4), (18, 36, 72, 144), "basic"),
    ),
    "hrnet32": dict(
        stage1=(1, 1, (4,), (64,), "bottleneck"),
        stage2=(1, 2, (4, 4), (32, 64), "basic"),
        stage3=(4, 3, (4, 4, 4), (32, 64, 128), "basic"),
        stage4=(3, 4, (4, 4, 4, 4), (32, 64, 128, 256), "basic"),
    ),
    "hrnet48": dict(
        stage1=(1, 1, (4,), (64,), "bottleneck"),
        stage2=(1, 2, (4, 4), (48, 96), "basic"),
        stage3=(4, 3, (4, 4, 4), (48, 96, 192), "basic"),
        stage4=(3, 4, (4, 4, 4, 4), (48, 96, 192, 384), "basic"),
    ),
    "hrnet64": dict(
        stage1=(1, 1, (4,), (64,), "bottleneck"),
        stage2=(1, 2, (4, 4), (64, 128), "basic"),
        stage3=(4, 3, (4, 4, 4), (64, 128, 256), "basic"),
        stage4=(3, 4, (4, 4, 4, 4), (64, 128, 256, 512), "basic"),
    ),
}


def _conv_bn(cin, cout, kernel, stride, relu, dtype) -> nn.Sequential:
    """Conv (no bias) + BatchNorm (+ ReLU): keys .0 and .1 as the
    reference's Sequentials."""
    mods = [Conv(cin, cout, kernel, stride, kernel // 2, bias=False, dtype=dtype),
            BatchNorm2d(cout)]
    if relu:
        mods.append(nn.ReLU())
    return nn.Sequential(*mods)


class HRModule(nn.Module):
    """One HighResolutionModule: a BasicBlock run per branch, then the
    all-to-all fusion (reference hrnet_encoder.py:138-285)."""

    def __init__(self, channels: Sequence[int], num_blocks: Sequence[int],
                 dtype=torch.float32):
        super().__init__()
        n = len(channels)
        self.branches = nn.ModuleList([
            nn.Sequential(*[BasicBlock(c, c, 1, dtype) for _ in range(k)])
            for c, k in zip(channels, num_blocks)
        ])
        self.fuse_layers = None
        if n == 1:
            return
        rows = []
        for i in range(n):
            row = []
            for j in range(n):
                if j > i:
                    row.append(_conv_bn(channels[j], channels[i], 1, 1, False, dtype))
                elif j == i:
                    row.append(None)
                else:
                    row.append(nn.Sequential(*[
                        _conv_bn(channels[j], channels[i] if k == i - j - 1 else channels[j],
                                 3, 2, k != i - j - 1, dtype)
                        for k in range(i - j)
                    ]))
            rows.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(rows)

    def forward(self, xs):
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return ys
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, layer in enumerate(row):
                if j == i:
                    t = ys[j]
                elif j > i:
                    t = resize_bilinear(layer(ys[j]), ys[i].shape[2:], align_corners=True)
                else:
                    t = layer(ys[j])
                acc = t if acc is None else acc + t
            fused.append(F.relu(acc))
        return fused


class HighResolutionNet(nn.Module):
    """Returns [stem at 1/2, branch 0 at 1/4, 1 at 1/8, 2 at 1/16, 3 at
    1/32] (reference hrnet_encoder.py:294-498)."""

    def __init__(self, arch: str = "hrnet18", dtype=torch.float32):
        super().__init__()
        cfg = HRNET_CONFIGS[arch]
        self.num_ch_enc = (64,) + tuple(cfg["stage4"][3])
        self.conv1 = Conv(3, 64, 3, 2, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(64)
        self.conv2 = Conv(64, 64, 3, 2, 1, bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(64)
        _, _, (n_blocks,), (planes,), _ = cfg["stage1"]
        self.layer1 = nn.Sequential(*[
            Bottleneck(64 if k == 0 else planes * Bottleneck.expansion, planes, 1, dtype)
            for k in range(n_blocks)
        ])
        prev = [planes * Bottleneck.expansion]
        for s in (2, 3, 4):
            num_modules, n_br, num_blocks, channels, _ = cfg[f"stage{s}"]
            trans = []
            for i in range(n_br):
                if i < len(prev):
                    trans.append(_conv_bn(prev[i], channels[i], 3, 1, True, dtype)
                                 if prev[i] != channels[i] else None)
                else:  # a new branch: stride-2 convs from the lowest resolution
                    trans.append(nn.Sequential(*[
                        _conv_bn(prev[-1], channels[i] if j == i - len(prev) else prev[-1],
                                 3, 2, True, dtype)
                        for j in range(i + 1 - len(prev))
                    ]))
            setattr(self, f"transition{s - 1}", nn.ModuleList(trans))
            setattr(self, f"stage{s}", nn.Sequential(*[
                HRModule(channels, num_blocks, dtype) for _ in range(num_modules)
            ]))
            prev = list(channels)

    def forward(self, x):
        f_stem = F.relu(self.bn1(self.conv1(x)))
        ys = [self.layer1(F.relu(self.bn2(self.conv2(f_stem))))]
        for s in (2, 3, 4):
            xs = []
            for i, t in enumerate(getattr(self, f"transition{s - 1}")):
                src = ys[i] if i < len(ys) else ys[-1]
                xs.append(src if t is None else t(src))
            ys = getattr(self, f"stage{s}")(xs)
        return [f_stem] + ys
