"""Monodepth2-style depth network: ResNet encoder and U-Net disparity
decoder (counterpart of mono_vifi_tpu/models/monodepth2.py, plain convs;
reference networks/monodepth2.py)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from mono_vifi_tpu_torch.models.common import Conv3x3, ConvBlock
from mono_vifi_tpu_torch.models.resnet import ResNet, num_ch_enc
from mono_vifi_tpu_torch.ops.image import upsample_nearest


class DepthEncoder(nn.Module):
    def __init__(self, num_layers: int = 18, dtype=torch.float32):
        super().__init__()
        self.num_ch_enc = num_ch_enc(num_layers)
        self.encoder = ResNet(num_layers, 3, dtype)

    def forward(self, x):
        return self.encoder(x)


class DepthDecoder(nn.Module):
    """Returns {scale: disp}, disp in (0, 1) of shape (B, 1, H/2^s, W/2^s).

    `decoder` holds upconv(4,0), upconv(4,1), ..., upconv(0,1), then the
    dispconvs, the reference's ModuleList order."""

    def __init__(self, num_ch_enc: Sequence[int] = (64, 64, 128, 256, 512),
                 scales: Sequence[int] = (0,), dtype=torch.float32):
        super().__init__()
        self.scales = tuple(scales)
        ch_dec = (16, 32, 64, 128, 256)
        mods = []
        for i in range(4, -1, -1):
            cin = num_ch_enc[-1] if i == 4 else ch_dec[i + 1]
            mods.append(ConvBlock(cin, ch_dec[i], dtype))
            cin = ch_dec[i] + (num_ch_enc[i - 1] if i > 0 else 0)
            mods.append(ConvBlock(cin, ch_dec[i], dtype))
        for s in self.scales:
            mods.append(Conv3x3(ch_dec[s], 1, dtype))
        self.decoder = nn.ModuleList(mods)

    def forward(self, feats):
        out = {}
        x = feats[-1]
        disp_convs = {s: self.decoder[10 + k] for k, s in enumerate(self.scales)}
        for k, i in enumerate(range(4, -1, -1)):
            x = upsample_nearest(self.decoder[2 * k](x))
            if i > 0:
                x = torch.cat([x, feats[i - 1]], dim=1)
            x = self.decoder[2 * k + 1](x)
            if i in disp_convs:
                out[i] = torch.sigmoid(disp_convs[i](x))
        return out
