"""D-HRNet depth network (counterpart of mono_vifi_tpu/models/dhrnet.py;
reference networks/DHRNet.py): the HRNet18 encoder and a progressive
multi-scale-fusion decoder (a reflect-conv block per level, coarser levels
nearest-upsampled, 1x1-fused and summed into the finer ones, one
full-resolution sigmoid disparity head), NCHW, with the reference
state_dict keys."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from mono_vifi_tpu_torch.models.common import Conv3x3, ConvBlock, ConvBlock1x1
from mono_vifi_tpu_torch.models.hrnet import HighResolutionNet
from mono_vifi_tpu_torch.ops.image import upsample_nearest


class DepthEncoder(nn.Module):
    """HRNet under the key prefix `encoder.`, with the reference's input
    normalization (reference DHRNet.py:9-24)."""

    def __init__(self, arch: str = "hrnet18", dtype=torch.float32):
        super().__init__()
        self.encoder = HighResolutionNet(arch, dtype)
        self.num_ch_enc = self.encoder.num_ch_enc

    def forward(self, x):
        return self.encoder((x - 0.45) / 0.225)


# the decoder's ModuleList order: the reference's OrderedDict insertions
# (DHRNet.py:36-68); conv1x1_<round>_<source level><target level>
DECODER_ORDER = (
    "parallel_0_1", "parallel_0_2", "parallel_0_3", "parallel_0_4",
    "conv1x1_0_21", "conv1x1_0_32", "conv1x1_0_31",
    "conv1x1_0_43", "conv1x1_0_42", "conv1x1_0_41",
    "parallel_1_1", "parallel_1_2", "parallel_1_3",
    "conv1x1_1_21", "conv1x1_1_32", "conv1x1_1_31",
    "parallel_2_1", "parallel_2_2", "conv1x1_2_21",
    "parallel_3_0", "parallel_3_1", "conv1x1_3_10",
    "parallel_4_0", "parallel_5_0", "dispconv_0",
)


class DepthDecoder(nn.Module):
    """Multi-scale-fusion decoder (reference DHRNet.py:27-146), the JAX
    package's plain path (its space-to-depth full-resolution tail is a TPU
    layout rewrite of the same parameters). Rounds 0-2 collapse the four
    HRNet branches, round 3 merges the stem feature, rounds 4-5 go up to
    full resolution; returns {0: disp} only."""

    def __init__(self, num_ch_enc: Sequence[int] = (64, 18, 36, 72, 144),
                 scales: Sequence[int] = (0,), dtype=torch.float32):
        super().__init__()
        ch = tuple(int(c) for c in num_ch_enc)
        mods = []
        for name in DECODER_ORDER:
            if name == "parallel_4_0":
                mods.append(ConvBlock(ch[0], 32, dtype))
            elif name == "parallel_5_0":
                mods.append(ConvBlock(32, 16, dtype))
            elif name == "dispconv_0":
                mods.append(Conv3x3(16, 1, dtype))
            elif name.startswith("parallel"):
                level = int(name[-1])
                mods.append(ConvBlock(ch[level], ch[level], dtype))
            else:  # conv1x1_<round>_<source><target>
                mods.append(ConvBlock1x1(ch[int(name[-2])], ch[int(name[-1])], dtype))
        self.decoder = nn.ModuleList(mods)
        self._index = {name: i for i, name in enumerate(DECODER_ORDER)}

    def _m(self, name):
        return self.decoder[self._index[name]]

    def _fuse(self, rnd, src, dst, x, factor):
        return self._m(f"conv1x1_{rnd}_{src}{dst}")(upsample_nearest(x, factor))

    def forward(self, feats):
        e0, e1, e2, e3, e4 = feats
        fuse = self._fuse
        # round 0: levels 1-4
        d = {i: self._m(f"parallel_0_{i}")(f) for i, f in ((1, e1), (2, e2), (3, e3), (4, e4))}
        d1 = d[1] + fuse(0, 2, 1, d[2], 2) + fuse(0, 3, 1, d[3], 4) + fuse(0, 4, 1, d[4], 8)
        d2 = d[2] + fuse(0, 3, 2, d[3], 2) + fuse(0, 4, 2, d[4], 4)
        d3 = d[3] + fuse(0, 4, 3, d[4], 2)
        # round 1: levels 1-3
        d1, d2, d3 = (self._m(f"parallel_1_{i}")(x) for i, x in ((1, d1), (2, d2), (3, d3)))
        d1 = d1 + fuse(1, 2, 1, d2, 2) + fuse(1, 3, 1, d3, 4)
        d2 = d2 + fuse(1, 3, 2, d3, 2)
        # round 2: levels 1-2
        d1, d2 = self._m("parallel_2_1")(d1), self._m("parallel_2_2")(d2)
        d1 = d1 + fuse(2, 2, 1, d2, 2)
        # round 3: the stem level
        d0 = self._m("parallel_3_0")(e0)
        d1 = self._m("parallel_3_1")(d1)
        d0 = d0 + fuse(3, 1, 0, d1, 2)
        # rounds 4-5: up to full resolution
        d5 = self._m("parallel_5_0")(upsample_nearest(self._m("parallel_4_0")(d0), 2))
        return {0: torch.sigmoid(self._m("dispconv_0")(d5))}
