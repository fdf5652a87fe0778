"""IFRNet video-frame interpolation network (counterpart of
mono_vifi_tpu/models/ifrnet.py; reference networks/IFRNet.py:128-441).

A 4-level conv pyramid encodes both frames; four decoders refine the
bidirectional flows coarse to fine, warping the encoder features of both
frames by the current flows. The full-resolution head gives two flows and a
merge mask. The feature warps use the plain differentiable warp; the two
full-resolution image warps go through the `bilinear_sample` kernel, whose
grid gradient (`bilinear_sample_bwd`) trains the flows in VFI training.
Sampling grids are built in f32 whatever the compute dtype. Given the middle
frame `imgt`, the forward also returns the VFI training loss (Charbonnier
L1 + ternary census + 0.01 * geometry; reference :436-438).

While a profiler runs, the forward names its four parts (`tracing.span`):
`ifrnet.encoder`, `ifrnet.decoders`, `ifrnet.image_warp` and, given
`imgt`, `ifrnet.loss`.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from mono_vifi_tpu_torch.models.common import Conv, ConvPReLU, ConvTranspose4x4, PReLU
from mono_vifi_tpu_torch.ops.image import device_constant, resize_bilinear
from mono_vifi_tpu_torch.ops.losses import charbonnier_l1, geometry_loss, ternary_loss
from mono_vifi_tpu_torch.ops.sampling import flow_to_grid, sample_planar, warp_planar
from mono_vifi_tpu_torch.tracing import span

PYRAMID_CHANNELS = {
    "large": (64, 96, 144, 192),
    "small": (24, 36, 54, 72),
    "tiny": (8, 12, 18, 24),  # not a reference variant: tests and dry runs
}
SIDE_CHANNELS = {"large": 64, "small": 24, "tiny": 8}


def resolve_scale_factor(H: int, W: int) -> tuple[float, float]:
    """Input downscale of the flow network (reference :373-376)."""
    if H == 320 and W == 1024:
        return (0.6, 0.3125)
    return (1.0, 0.5)


class ResBlock(nn.Module):
    def __init__(self, c: int, side: int, dtype=torch.float32):
        super().__init__()
        self.side = side
        self.conv1 = ConvPReLU(c, c, dtype=dtype)
        self.conv2 = ConvPReLU(side, side, dtype=dtype)
        self.conv3 = ConvPReLU(c, c, dtype=dtype)
        self.conv4 = ConvPReLU(side, side, dtype=dtype)
        self.conv5 = Conv(c, c, 3, 1, 1, dtype=dtype)
        self.prelu = PReLU(c)

    def forward(self, x):
        s = self.side
        out = self.conv1(x)
        out = torch.cat([out[:, :-s], self.conv2(out[:, -s:])], 1)
        out = self.conv3(out)
        out = torch.cat([out[:, :-s], self.conv4(out[:, -s:])], 1)
        return self.prelu(x + self.conv5(out))


class _Encoder(nn.Module):
    def __init__(self, channels, first_kernel: int, dtype):
        super().__init__()
        cin = 3
        for i, c in enumerate(channels):
            k = first_kernel if i == 0 else 3
            setattr(self, f"pyramid{i + 1}", nn.Sequential(
                ConvPReLU(cin, c, k, 2, k // 2, dtype=dtype),
                ConvPReLU(c, c, 3, 1, 1, dtype=dtype),
            ))
            cin = c

    def forward(self, img):
        feats, x = [], img
        for i in range(1, 5):
            x = getattr(self, f"pyramid{i}")(x)
            feats.append(x)
        return feats


class _Decoder(nn.Module):
    def __init__(self, cin, mid, cout, side, dtype):
        super().__init__()
        self.convblock = nn.Sequential(
            ConvPReLU(cin, mid, dtype=dtype),
            ResBlock(mid, side, dtype),
            ConvTranspose4x4(mid, cout, dtype),
        )

    def forward(self, x):
        return self.convblock(x)


class IFRNet(nn.Module):
    """forward(img0, img1, embt, imgt=None, only_flow=False) on NCHW images
    returns {"flow0", "flow1", "mask"} (+ "imgt_pred" unless only_flow, +
    "loss" given `imgt`); flows are (B, 2, H, W) pixel displacements in the
    compute dtype, the mask (B, 1, H, W)."""

    def __init__(self, scale: str = "large", dtype=torch.float32):
        super().__init__()
        c1, c2, c3, c4 = PYRAMID_CHANNELS[scale]
        side = SIDE_CHANNELS[scale]
        self.dtype = dtype
        self.encoder = _Encoder((c1, c2, c3, c4), 7 if scale == "large" else 3, dtype)
        self.decoder4 = _Decoder(2 * c4 + 1, 2 * c4, 4 + c3, side, dtype)
        self.decoder3 = _Decoder(3 * c3 + 4, 3 * c3, 4 + c2, side, dtype)
        self.decoder2 = _Decoder(3 * c2 + 4, 3 * c2, 4 + c1, side, dtype)
        self.decoder1 = _Decoder(3 * c1 + 4, 3 * c1, 8, side, dtype)

    def forward(self, img0, img1, embt, imgt=None, only_flow: bool = False):
        B, _, H, W = img0.shape
        sf = resolve_scale_factor(H, W)
        with span("ifrnet.encoder"):
            mean_ = 0.5 * (img0.mean(dim=(1, 2, 3), keepdim=True)
                           + img1.mean(dim=(1, 2, 3), keepdim=True))
            img0 = img0 - mean_
            img1 = img1 - mean_
            fh, fw = int(H * sf[0]), int(W * sf[1])
            # every frame through the (normalization-free) encoder in one pass
            frames = [img0, img1]
            if imgt is not None and not only_flow:
                imgt_sub = imgt - mean_
                frames.append(imgt_sub)
            feats = self.encoder(resize_bilinear(torch.cat(frames, 0), (fh, fw)))
            f0 = [f[:B] for f in feats]
            f1 = [f[B:2 * B] for f in feats]

        with span("ifrnet.decoders"):
            embt_map = embt.reshape(B, 1, 1, 1).to(f0[3].dtype).expand(
                B, 1, *f0[3].shape[2:]
            )
            out = self.decoder4(torch.cat([f0[3], f1[3], embt_map], 1))
            flow0, flow1, ft_ = out[:, 0:2], out[:, 2:4], out[:, 4:]
            fts = [ft_]  # the decoders' feature outputs, coarse to fine
            for dec, lvl in ((self.decoder3, 2), (self.decoder2, 1), (self.decoder1, 0)):
                fw_ = warp_planar(
                    torch.cat([f0[lvl], f1[lvl]], 0), torch.cat([flow0, flow1], 0)
                )
                out = dec(torch.cat([ft_, fw_[:B], fw_[B:], flow0, flow1], 1))
                up0 = 2.0 * resize_bilinear(flow0, out.shape[2:])
                up1 = 2.0 * resize_bilinear(flow1, out.shape[2:])
                flow0 = out[:, 0:2] + up0
                flow1 = out[:, 2:4] + up1
                ft_ = out[:, 4:]
                fts.append(ft_)

        with span("ifrnet.image_warp"):
            mask = torch.sigmoid(ft_[:, 0:1])
            scale = device_constant((1.0 / sf[1], 1.0 / sf[0]), flow0.dtype,
                                    flow0.device).view(1, 2, 1, 1)
            flow0_full = resize_bilinear(flow0, (H, W)) * scale
            flow1_full = resize_bilinear(flow1, (H, W)) * scale
            mask_full = resize_bilinear(mask, (H, W))
            res = {"flow0": flow0_full, "flow1": flow1_full, "mask": mask_full}
            if only_flow:
                return res

            # both frame warps in one kernel launch; bf16 taps in the bf16 path
            gx, gy = flow_to_grid(torch.cat([flow0_full, flow1_full], 0))
            tap_dtype = self.dtype if self.dtype != torch.float32 else None
            w2 = sample_planar(torch.cat([img0, img1], 0), gx, gy, "border",
                               tap_dtype=tap_dtype)
            merge = mask_full * w2[:B] + (1 - mask_full) * w2[B:]
            res["imgt_pred"] = torch.clamp(merge + mean_, 0.0, 1.0)
        if imgt is not None:
            # on the merge before the clamp; the middle frame's features
            # against the decoders' at levels 1-3 (reference :430-438)
            with span("ifrnet.loss"):
                ft = [f[2 * B:] for f in feats]
                res["loss"] = (
                    charbonnier_l1(merge - imgt_sub) + ternary_loss(merge, imgt_sub)
                    + 0.01 * (geometry_loss(fts[2], ft[0]) + geometry_loss(fts[1], ft[1])
                              + geometry_loss(fts[0], ft[2]))
                )
        return res
