"""Flow-guided multi-frame feature fusion (counterpart of
mono_vifi_tpu/models/fusion.py; reference networks/fusion_module.py).

The +/-1-frame encoder pyramids are warped to frame 0 by the frozen VFI
flows, the per-level flows are embedded with NeRF-style sin/cos encoding
(10 octaves, 2 -> 42 channels), the two warped neighbours are mask-blended,
and each level is fused with the centre features by a 1x1 conv + ELU.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from mono_vifi_tpu_torch.models.common import Conv1x1
from mono_vifi_tpu_torch.ops.cuda.splat import grid_sample_frozen_grid
from mono_vifi_tpu_torch.ops.image import device_constant, resize_bilinear
from mono_vifi_tpu_torch.ops.sampling import flow_to_grid, warp_planar


def embed_flow(x, num_freqs: int = 10):
    """(B, n, H, W) -> (B, n + 4K, H, W): [x, then per octave k:
    sin(2^k x), cos(2^k x)], as one phase-shifted sine (cos t = sin(t+pi/2))."""
    n = x.shape[1]
    K = num_freqs
    freqs = device_constant(
        ("embed_freqs", n, K), x.dtype, x.device,
        lambda: torch.tensor([2.0**k for k in range(K) for _ in range(2 * n)],
                             dtype=x.dtype).view(1, -1, 1, 1))
    phase = device_constant(
        ("embed_phase", n, K), x.dtype, x.device,
        lambda: torch.tensor(([0.0] * n + [math.pi / 2] * n) * K,
                             dtype=x.dtype).view(1, -1, 1, 1))
    out = torch.sin(x.repeat(1, 2 * K, 1, 1) * freqs + phase)
    return torch.cat([x, out], dim=1)


class SplitFuse1x1(nn.Module):
    """elu(conv1x1(cat[feat0, emb0, mask*[fn1|en1] + (1-mask)*[fp1|ep1]]))
    as a sum of convs with the sliced kernel, in the JAX package's order
    (fusion.py:205-223), so the concat tensors are never built. Keys:
    conv.conv.{weight,bias} (reference ConvBlock1x1)."""

    def __init__(self, cf: int, ce: int, dtype=torch.float32):
        super().__init__()
        self.cf, self.ce = cf, ce
        self.dtype = dtype
        self.conv = Conv1x1(2 * (cf + ce), cf, dtype)  # its kernel, in slices

    def forward(self, feat0, emb0, fn1, en1, fp1, ep1, mask):
        cf, ce, cd = self.cf, self.ce, self.dtype
        k = self.conv.conv.weight.to(cd)
        b = self.conv.conv.bias.to(cd)
        mask = mask.to(cd)
        bfeat = mask * fn1.to(cd) + (1 - mask) * fp1.to(cd)
        bemb = mask * en1.to(cd) + (1 - mask) * ep1.to(cd)
        y = (
            F.conv2d(feat0.to(cd), k[:, :cf])
            + F.conv2d(emb0.to(cd), k[:, cf:cf + ce])
            + F.conv2d(bfeat, k[:, cf + ce:2 * cf + ce])
            + F.conv2d(bemb, k[:, 2 * cf + ce:])
            + b.view(1, -1, 1, 1)
        )
        return F.elu(y)


class FusionModule(nn.Module):
    """Fuse [feats_n1, feats_0, feats_p1] into frame-0 features.

    `fusion_conv` is built from level L-1 down to 0, the reference's order.
    `backbone` "LiteMono" halves the flow once more at level 0, whose
    pyramid starts at 1/4 resolution (reference fusion_module.py:71-74)."""

    def __init__(self, num_ch_enc: Sequence[int] = (64, 64, 128, 256, 512),
                 backbone: str = "ResNet18", embed_multires: int = 10,
                 dtype=torch.float32):
        super().__init__()
        self.num_ch_enc = tuple(num_ch_enc)
        self.backbone = backbone
        self.embed_multires = embed_multires
        self.dtype = dtype
        ce = 2 + 4 * embed_multires
        L = len(self.num_ch_enc)
        self.fusion_conv = nn.ModuleList(
            [SplitFuse1x1(self.num_ch_enc[i], ce, dtype) for i in range(L - 1, -1, -1)]
        )

    def _embedding_pyramid(self, flow):
        """Halved, value-rescaled flow embeddings per level, computed in f32
        (bf16 cannot hold the high octaves' phases) and cast to the module
        dtype."""
        oups, x = [], flow
        for i in range(len(self.num_ch_enc)):
            h, w = x.shape[2] // 2, x.shape[3] // 2
            x = resize_bilinear(x, (h, w)) * 0.5
            if i == 0 and self.backbone == "LiteMono":
                x = resize_bilinear(x, (h // 2, w // 2)) * 0.5
            oups.append(embed_flow(x, self.embed_multires).to(self.dtype))
        return oups

    @staticmethod
    def _level_flow(flow, H, W):
        fh, fw = flow.shape[2:]
        scale = device_constant((W / fw, H / fh), flow.dtype, flow.device).view(1, 2, 1, 1)
        return resize_bilinear(flow, (H, W)) * scale

    def forward(self, features, flows, merge_mask, warp_table=None):
        """`features` = [feats_n1, feats_0, feats_p1] pyramids (NCHW lists),
        `flows` = (flow_0_n1, flow_0_p1), (B, 2, H, W) f32, `merge_mask`
        (B, 1, H, W).

        `warp_table` = (unique pyramid, ids): the training path, and the
        multi-frame inference path (under torch.no_grad(), where the
        pyramid is the encoder's 3B stack itself). Each level of the unique
        pyramid holds the U distinct source maps, and warp use k (first B:
        previous frames, next B: next frames) reads unique[ids[k]] through
        the frozen-grid Function: its forward is the table-sample kernel,
        its backward (the splat kernel) sums each unique map's uses.
        `features[0]` and `features[2]` are then unused. Values equal those
        of the plain path."""
        feats_n1, feats_0, feats_p1 = features
        flow_n1, flow_p1 = flows
        B = flow_n1.shape[0]
        flow_both = torch.cat([flow_n1, flow_p1], 0)
        if warp_table is not None:
            unique, ids = warp_table
            both = []
            for feat in unique:
                gx, gy = flow_to_grid(self._level_flow(flow_both, *feat.shape[2:]))
                both.append(grid_sample_frozen_grid(feat, gx, gy, "border", ids))
        else:
            both = [
                warp_planar(torch.cat([a, b], 0),
                            self._level_flow(flow_both, *a.shape[2:]))
                for a, b in zip(feats_n1, feats_p1)
            ]
        emb_0 = self._embedding_pyramid(torch.zeros_like(flow_n1[:1]))
        emb_np = self._embedding_pyramid(flow_both)
        fused = []
        for i, conv in enumerate(reversed(self.fusion_conv)):
            H, W = feats_0[i].shape[2:]
            mask = resize_bilinear(merge_mask, (H, W))
            fused.append(conv(
                feats_0[i], emb_0[i], both[i][:B], emb_np[i][:B],
                both[i][B:], emb_np[i][B:], mask,
            ))
        return fused
