"""PoseNet: ResNet18 over channel-concatenated frame pairs plus the pose
decoder (counterpart of mono_vifi_tpu/models/posenet.py; reference
networks/posenet.py)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference.models.common import Conv
from perfbench.reference.models.resnet import ResNet, num_ch_enc


class PoseEncoder(nn.Module):
    def __init__(self, num_layers: int = 18, dtype=torch.float32):
        super().__init__()
        self.num_ch_enc = num_ch_enc(num_layers)
        self.encoder = ResNet(num_layers, 6, dtype)

    def forward(self, x):
        return self.encoder(x)


class PoseDecoder(nn.Module):
    """(axisangle, translation), each (B, 2, 1, 3), from the last feature
    map; `net` = squeeze, pose_0, pose_1, pose_2 (reference key order)."""

    def __init__(self, ch_last: int = 512, num_frames: int = 2, dtype=torch.float32):
        super().__init__()
        self.num_frames = num_frames
        self.net = nn.ModuleList([
            Conv(ch_last, 256, 1, dtype=dtype),
            Conv(256, 256, 3, 1, 1, dtype=dtype),
            Conv(256, 256, 3, 1, 1, dtype=dtype),
            Conv(256, 6 * num_frames, 1, dtype=dtype),
        ])

    def forward(self, last_feature):
        x = F.relu(self.net[0](last_feature))
        x = F.relu(self.net[1](x))
        x = F.relu(self.net[2](x))
        out = self.net[3](x).mean(dim=(2, 3))
        out = 0.01 * out.reshape(-1, self.num_frames, 1, 6)
        return out[..., :3], out[..., 3:]
