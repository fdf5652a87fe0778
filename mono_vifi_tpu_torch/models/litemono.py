"""Lite-Mono depth network (counterpart of mono_vifi_tpu/models/litemono.py;
reference networks/LiteMono.py), NCHW, with the reference state_dict keys.

The encoder is a CNN + transformer hybrid: a conv stem (1/2, then 1/4
resolution), two more stride-2 stages (1/8, 1/16), each stage a run of
dilated depthwise-conv blocks (CDC: depthwise dilated conv + BatchNorm +
an inverted-bottleneck MLP with layer scale and stochastic depth) capped by
one LGFI block (Fourier position features on stage 0, LayerNorm,
cross-covariance attention over channels -- d x d per head, linear in the
pixels -- then the same MLP). Average-pooled copies of the input are
concatenated into each downsample. The decoder is a 3-stage bilinear U-Net
with an extra bilinear x2 on the disparity head, so scale 0 is full
resolution.

Stochastic depth takes its per-sample keep masks from the caller (one row
per block, see `DepthEncoder.draw_drop_masks`), drawn from an explicit
generator, never the global RNG. The keep rates and the position features
are device constants (`ops.image.device_constant`), so neither drawing the
masks nor a forward copies from the host.

Spans (mono_vifi_tpu_torch.tracing): litemono.stem (the stem and the
downsamples), litemono.cdc (a CDC block's dilated depthwise conv and
BatchNorm), litemono.xca (LGFI's position features, LayerNorm, attention
and layer scale), litemono.mlp (a block's MLP, layer scale and drop path),
litemono.decoder (`DepthDecoder.forward`).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mono_vifi_tpu_torch.models.common import (
    BatchNorm2d, Conv, Conv3x3, ConvBlock, LayerNorm, Linear,
)
from mono_vifi_tpu_torch.ops.image import device_constant, resize_bilinear
from mono_vifi_tpu_torch.tracing import span

_MODELS = {
    "lite-mono": dict(dims=(48, 80, 128), depth=(4, 4, 10)),
    "lite-mono-small": dict(dims=(48, 80, 128), depth=(4, 4, 7)),
    "lite-mono-tiny": dict(dims=(32, 64, 128), depth=(4, 4, 7)),
    "lite-mono-8m": dict(dims=(64, 128, 224), depth=(4, 4, 10)),
}


def _dilation_schedule(model: str, height: int, width: int):
    """Per-stage dilations of the CDC blocks (reference :311-341); the
    320x1024 input takes wider ones."""
    big = _MODELS[model]["depth"][2] == 10
    hr = height == 320 and width == 1024 and model != "lite-mono-8m"
    a, b = (5, 10) if hr else (3, 6)
    stage3 = [1, 2, a, 1, 2, a, 2, 4, b] if big else [1, 2, a, 2, 4, b]
    return [[1, 2, a], [1, 2, a], stage3]


def fourier_pos_embedding(height: int, width: int, hidden_dim: int = 32,
                          temperature: float = 10000.0) -> np.ndarray:
    """(2 * hidden_dim, H, W) sin/cos position features of an all-ones mask
    (reference PositionalEncodingFourier :13-48): a function of the shape
    alone, computed in f64 and returned as f32."""
    scale = 2 * math.pi
    eps = 1e-6
    y = np.arange(1, height + 1, dtype=np.float64) / (height + eps) * scale
    x = np.arange(1, width + 1, dtype=np.float64) / (width + eps) * scale
    dim_t = np.arange(hidden_dim, dtype=np.float64)
    dim_t = temperature ** (2 * (dim_t // 2) / hidden_dim)

    def interleave(p):  # (n, D): sin of the even columns, cos of the odd
        return np.stack([np.sin(p[:, 0::2]), np.cos(p[:, 1::2])], 2).reshape(p.shape[0], -1)

    ex = interleave(x[:, None] / dim_t).T[:, None, :]  # (D, 1, W)
    ey = interleave(y[:, None] / dim_t).T[:, :, None]  # (D, H, 1)
    pe = np.concatenate([np.broadcast_to(ey, (hidden_dim, height, width)),
                         np.broadcast_to(ex, (hidden_dim, height, width))], 0)
    return pe.astype(np.float32)


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm DropPath): in training, sample k
    keeps its branch scaled by 1 / keep where mask[k], else drops it."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, mask=None):
        if not self.training or self.rate == 0.0:
            return x
        if mask is None:
            raise ValueError("DropPath in training needs its per-sample keep mask")
        keep = 1.0 - self.rate
        return torch.where(mask.view(-1, *(1,) * (x.dim() - 1)), x / keep,
                           torch.zeros((), dtype=x.dtype, device=x.device))


class _BNGELU(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.bn = BatchNorm2d(channels)

    def forward(self, x):
        return F.gelu(self.bn(x))


class ConvBNAct(nn.Module):
    """Conv (+ BatchNorm + exact GELU) (reference Conv / BNGELU :116-148)."""

    def __init__(self, cin, cout, kernel=3, stride=1, padding=1, bn_act=False,
                 dtype=torch.float32):
        super().__init__()
        self.conv = Conv(cin, cout, kernel, stride, padding, bias=False, dtype=dtype)
        self.bn_gelu = _BNGELU(cout) if bn_act else None

    def forward(self, x):
        x = self.conv(x)
        return x if self.bn_gelu is None else self.bn_gelu(x)


class XCA(nn.Module):
    """Cross-covariance (channel) attention (reference :51-86) on (B, N, C)
    tokens. q and k are normalized over the pixels and the d x d softmax is
    taken in the compute dtype, as the JAX package does."""

    def __init__(self, dim: int, num_heads: int = 8, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x):
        B, N, C = x.shape
        h = self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, h, C // h).permute(2, 0, 3, 4, 1)  # (3,B,h,d,N)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
        k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-12)
        attn = torch.matmul(q, k.transpose(-2, -1)) * self.temperature.to(q.dtype)
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn, v)  # (B, h, d, N)
        return self.proj(out.permute(0, 3, 1, 2).reshape(B, N, C))


def _add_mlp(block: nn.Module, dim: int, expan_ratio: int, dtype) -> None:
    """The block's LayerNorm -> Linear(expand) -> GELU -> Linear -> layer
    scale over the last axis (the JAX package's _MLP); the reference keeps
    its keys on the block itself (norm, pwconv1, pwconv2, gamma)."""
    block.norm = LayerNorm(dim, dtype=dtype)
    block.pwconv1 = Linear(dim, expan_ratio * dim, dtype=dtype)
    block.pwconv2 = Linear(expan_ratio * dim, dim, dtype=dtype)
    block.gamma = nn.Parameter(torch.full((dim,), 1e-6))


def _mlp(block: nn.Module, x):
    y = block.pwconv2(F.gelu(block.pwconv1(block.norm(x))))
    return y * block.gamma.to(y.dtype)


class _DepthwiseConv(nn.Module):
    def __init__(self, dim: int, dilation: int, dtype):
        super().__init__()
        self.conv = Conv(dim, dim, 3, 1, dilation, dilation, groups=dim, bias=False,
                         dtype=dtype)


class DilatedConvBlock(nn.Module):
    """One CDC block (reference DilatedConv :179-223)."""

    def __init__(self, dim: int, dilation: int = 1, drop_path: float = 0.0,
                 expan_ratio: int = 6, dtype=torch.float32):
        super().__init__()
        self.ddwconv = _DepthwiseConv(dim, dilation, dtype)
        self.bn1 = BatchNorm2d(dim)
        _add_mlp(self, dim, expan_ratio, dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, mask=None):
        with span("litemono.cdc"):
            y = self.bn1(self.ddwconv.conv(x)).permute(0, 2, 3, 1)
        with span("litemono.mlp"):
            y = _mlp(self, y).permute(0, 3, 1, 2)
            return x + self.drop_path(y, mask)


class _PosEmbedding(nn.Module):
    def __init__(self, dim: int, dtype):
        super().__init__()
        self.token_projection = Conv(64, dim, 1, dtype=dtype)


class LGFIBlock(nn.Module):
    """Local-Global Features Interaction (reference LGFI :226-279)."""

    def __init__(self, dim: int, drop_path: float = 0.0, expan_ratio: int = 6,
                 use_pos_emb: bool = True, num_heads: int = 8, dtype=torch.float32):
        super().__init__()
        self.pos_embd = _PosEmbedding(dim, dtype) if use_pos_emb else None
        self.norm_xca = LayerNorm(dim, dtype=dtype)
        self.gamma_xca = nn.Parameter(torch.full((dim,), 1e-6))
        self.xca = XCA(dim, num_heads, dtype)
        _add_mlp(self, dim, expan_ratio, dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, mask=None):
        B, C, H, W = x.shape
        with span("litemono.xca"):
            t = x.flatten(2).transpose(1, 2)  # (B, HW, C)
            if self.pos_embd is not None:
                pe = device_constant(
                    ("litemono.position_features", H, W), x.dtype, x.device,
                    make=lambda: torch.from_numpy(fourier_pos_embedding(H, W)))
                pe = self.pos_embd.token_projection(pe[None])  # (1, C, H, W)
                t = t + pe.flatten(2).transpose(1, 2)
            t = t + self.gamma_xca.to(t.dtype) * self.xca(self.norm_xca(t))
        with span("litemono.mlp"):
            y = _mlp(self, t.reshape(B, H, W, C)).permute(0, 3, 1, 2)
            return x + self.drop_path(y, mask)


class DepthEncoder(nn.Module):
    """Lite-Mono encoder -> 3-scale pyramid [1/4, 1/8, 1/16]."""

    def __init__(self, model: str = "lite-mono", height: int = 192, width: int = 640,
                 drop_path_rate: float = 0.2, expan_ratio: int = 6, dtype=torch.float32):
        super().__init__()
        spec = _MODELS[model]
        dims, depth = spec["dims"], spec["depth"]
        self.num_ch_enc = tuple(dims)
        dilation = _dilation_schedule(model, height, width)
        heads = (8, 8, 8)
        use_pos = (True, False, False)
        self.drop_rates = np.linspace(0.0, drop_path_rate, sum(depth)).tolist()

        stem1 = nn.Sequential(
            ConvBNAct(3, dims[0], 3, 2, 1, True, dtype),
            ConvBNAct(dims[0], dims[0], 3, 1, 1, True, dtype),
            ConvBNAct(dims[0], dims[0], 3, 1, 1, True, dtype),
        )
        self.stem2 = nn.Sequential(ConvBNAct(dims[0] + 3, dims[0], 3, 2, 1, False, dtype))
        self.downsample_layers = nn.ModuleList([stem1] + [
            nn.Sequential(ConvBNAct(dims[i] * 2 + 3, dims[i + 1], 3, 2, 1, False, dtype))
            for i in range(2)
        ])
        self.stages = nn.ModuleList()
        cur = 0
        for i in range(3):
            blocks = []
            for j in range(depth[i]):
                rate = self.drop_rates[cur + j]
                if j == depth[i] - 1:
                    blocks.append(LGFIBlock(dims[i], rate, expan_ratio, use_pos[i],
                                            heads[i], dtype))
                else:
                    blocks.append(DilatedConvBlock(dims[i], dilation[i][j], rate,
                                                   expan_ratio, dtype))
            self.stages.append(nn.Sequential(*blocks))
            cur += depth[i]

    @property
    def num_drop_paths(self) -> int:
        return len(self.drop_rates)

    def draw_drop_masks(self, batch: int, generator=None, device=None) -> torch.Tensor:
        """Per-sample keep masks of every block, (blocks, batch) bool: row i
        keeps with probability 1 - rate_i, from `generator`. The keep rates
        are a device constant: no host copy, no wait for the device."""
        rates = tuple(self.drop_rates)
        keep = device_constant(("litemono.keep_rates", rates), torch.float32, device,
                               make=lambda: 1.0 - torch.tensor(rates).view(-1, 1))
        u = torch.rand((self.num_drop_paths, batch), generator=generator, device=device)
        return u < keep

    def forward(self, x, drop_masks=None):
        """`drop_masks` (blocks, B) bool: the stochastic-depth keep masks,
        needed in training (see `draw_drop_masks`)."""
        with span("litemono.stem"):
            x = (x - 0.45) / 0.225
            x_down, d = [], x
            for _ in range(4):
                d = F.avg_pool2d(d, 3, 2, 1, count_include_pad=True)
                x_down.append(d)
            y = self.downsample_layers[0](x)
            y = self.stem2(torch.cat([y, x_down[0]], 1))
        features, tmp, cur = [], [y], 0
        for i, stage in enumerate(self.stages):
            if i > 0:
                with span("litemono.stem"):
                    tmp.append(x_down[i])
                    y = self.downsample_layers[i](torch.cat(tmp, 1))
            stage_in = y
            for block in stage:
                y = block(y, None if drop_masks is None else drop_masks[cur])
                cur += 1
            tmp = [stage_in, y]
            features.append(y)
        return features


class DepthDecoder(nn.Module):
    """3-stage bilinear U-Net decoder (reference LiteMono.DepthDecoder
    :447-505), the JAX package's plain path (its space-to-depth level-0 tail
    is a TPU layout rewrite of the same parameters). `decoder` holds
    upconv(2,0), upconv(2,1), ..., upconv(0,1), then the dispconvs."""

    def __init__(self, num_ch_enc: Sequence[int] = (48, 80, 128),
                 scales: Sequence[int] = (0,), dtype=torch.float32):
        super().__init__()
        self.scales = tuple(scales)
        dec = tuple(int(c) // 2 for c in num_ch_enc)
        mods = []
        for i in range(2, -1, -1):
            cin = num_ch_enc[-1] if i == 2 else dec[i + 1]
            mods.append(ConvBlock(cin, dec[i], dtype))
            mods.append(ConvBlock(dec[i] + (num_ch_enc[i - 1] if i > 0 else 0), dec[i], dtype))
        for s in self.scales:
            mods.append(Conv3x3(dec[s], 1, dtype))
        self.decoder = nn.ModuleList(mods)

    def forward(self, feats):
        with span("litemono.decoder"):
            out = {}
            x = feats[-1]
            disp_convs = {s: self.decoder[6 + k] for k, s in enumerate(self.scales)}
            for k, i in enumerate(range(2, -1, -1)):
                x = self.decoder[2 * k](x)
                x = resize_bilinear(x, (x.shape[2] * 2, x.shape[3] * 2))
                if i > 0:
                    x = torch.cat([x, feats[i - 1]], 1)
                x = self.decoder[2 * k + 1](x)
                if i in disp_convs:
                    f = disp_convs[i](x)
                    out[i] = torch.sigmoid(resize_bilinear(f, (f.shape[2] * 2, f.shape[3] * 2)))
            return out
