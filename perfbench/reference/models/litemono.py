"""Lite-Mono depth network in plain PyTorch (Zhang et al., "Lite-Mono: A
Lightweight CNN and Transformer Architecture for Self-Supervised Monocular
Depth Estimation", CVPR 2023; networks/LiteMono.py of the Mono-ViFI
repository), the "lite-mono" model: encoder and decoder, NCHW, with the
published state_dict keys.

Encoder: a conv stem to 1/2, then 1/4 resolution, and two stride-2
downsamples to 1/8 and 1/16, each fed the concatenation of the previous
stage's input and output and an average-pooled copy of the image. Stage i
(widths 48/80/128, depths 4/4/10) is a run of CDC blocks (depthwise dilated
3x3 conv, BatchNorm, then LayerNorm -> Linear(6x) -> GELU -> Linear, a layer
scale and per-sample stochastic depth, added to the input) capped by one
LGFI block (Fourier position features on stage 0, LayerNorm and
cross-covariance attention over channels -- d x d per head, 8 heads -- under
a layer scale, then the same MLP). Drop-path rates rise linearly from 0 to
0.2 over the 18 blocks. Decoder: three ConvBlock pairs with bilinear x2
upsampling and skips, and a bilinear x2 after the disparity conv, so scale 0
is full resolution.

Departures from networks/LiteMono.py:
- Stochastic depth takes per-sample keep masks from the caller, one row per
  block (`DepthEncoder.draw_drop_masks`, from an explicit generator before
  the step), where the published DropPath draws a Bernoulli mask inside each
  block from the global generator. A kept branch is multiplied by 1 / keep
  as published.
- Convolutions, linear layers and the attention's two matrix products
  compute in the configuration's dtype with float32 parameters, through
  `reference/precision.py`, as every model of this reference does. LayerNorm
  normalises in float32 and casts back (`common.LayerNorm`), the XCA softmax
  is taken in float32 and cast back, and the drop-path scale is applied in
  float32. The published net computes everything in float32: in a float32
  configuration this file is its arithmetic.
- BatchNorm in training moves its running statistics by the rule of
  `common.BatchNorm2d` (biased variance); it normalises as published.
- The position features are computed in float64 and rounded once to
  float32 (published: float32), and projected once and broadcast over the
  batch (published: B equal copies projected).
- Bilinear x2 is `ops.image.resize_bilinear` (interpolation matrices, the
  half-pixel rule of the published `F.interpolate`).
- Weights are the benchmark's (`perfbench/weights.py`, with the layer
  scales at 1e-6 and the XCA temperatures at 1 as published, from `INIT`),
  not the published truncated-normal `_init_weights`.

The port (`mono_vifi_tpu_torch/models/litemono.py`) differs from this file
in its XCA softmax, which it takes on tensors of the compute dtype (bf16 in a
bf16 configuration), as the JAX package does; in normalising q and k as
q / (|q| + 1e-12) where `F.normalize` takes q / max(|q|, 1e-12), the same
for any norm above ~1e-5 in float32; and in dividing a kept branch by keep.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference.models.common import (
    BatchNorm2d, Conv, Conv3x3, ConvBlock, LayerNorm, Linear,
)
from perfbench.reference.ops.image import resize_bilinear
from perfbench.reference.precision import operand, output

DIMS, DEPTHS, HEADS = (48, 80, 128), (4, 4, 10), 8
EXPANSION, DROP_PATH_RATE, LAYER_SCALE = 6, 0.2, 1e-6


def dilations(height: int, width: int) -> list[list[int]]:
    """The CDC blocks' dilations per stage (published :311-341): wider at
    1024x320."""
    a, b = (5, 10) if (height, width) == (320, 1024) else (3, 6)
    return [[1, 2, a], [1, 2, a], [1, 2, a, 1, 2, a, 2, 4, b]]


def fourier_features(height: int, width: int, device, hidden: int = 32,
                     temperature: float = 10000.0) -> torch.Tensor:
    """(1, 2 * hidden, H, W) sin/cos features of the normalised row and
    column positions (published PositionalEncodingFourier :13-48, an
    all-ones mask): y's features, then x's."""
    scale, eps = 2 * math.pi, 1e-6
    f64 = dict(dtype=torch.float64, device=device)
    y = torch.arange(1, height + 1, **f64) / (height + eps) * scale
    x = torch.arange(1, width + 1, **f64) / (width + eps) * scale
    dim_t = torch.arange(hidden, **f64)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / hidden)

    def sin_cos(p):  # (n, hidden): sin of the even columns, cos of the odd, interleaved
        p = p[:, None] / dim_t
        return torch.stack([p[:, 0::2].sin(), p[:, 1::2].cos()], 2).flatten(1)

    pos_y = sin_cos(y).t()[:, :, None].expand(hidden, height, width)
    pos_x = sin_cos(x).t()[:, None, :].expand(hidden, height, width)
    return torch.cat([pos_y, pos_x], 0)[None].float()


def drop_path(x, mask, rate: float):
    """Per-sample stochastic depth (timm DropPath): sample k's branch times
    mask[k] / keep. No mask: evaluation, the branch as it is."""
    if mask is None or rate == 0.0:
        return x
    scale = mask.float() / (1.0 - rate)
    return (x * scale.view(-1, *(1,) * (x.dim() - 1))).to(x.dtype)


class ConvBNGELU(nn.Module):
    """Bias-free conv, with BatchNorm and exact GELU where `bn_act`
    (published Conv and BNGELU :116-148)."""

    def __init__(self, cin, cout, stride, bn_act, dtype):
        super().__init__()
        self.conv = Conv(cin, cout, 3, stride, 1, bias=False, dtype=dtype)
        if bn_act:
            self.bn_gelu = nn.Module()
            self.bn_gelu.bn = BatchNorm2d(cout)
        self.bn_act = bn_act

    def forward(self, x):
        x = self.conv(x)
        return F.gelu(self.bn_gelu.bn(x)) if self.bn_act else x


class CDilated(nn.Module):
    """Depthwise dilated 3x3 conv, zero padding `dilation` (published
    CDilated)."""

    def __init__(self, dim, dilation, dtype):
        super().__init__()
        self.conv = Conv(dim, dim, 3, 1, dilation, dilation, groups=dim, bias=False,
                         dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class XCA(nn.Module):
    """Cross-covariance attention (published :51-86) on (B, N, C) tokens:
    per head, q and k (d x N) normalised over the pixels, softmax over
    (q k^T) * temperature (d x d), times v."""

    INIT = {"temperature": 1.0}

    def __init__(self, dim, heads, dtype):
        super().__init__()
        self.heads = heads
        self.temperature = nn.Parameter(torch.ones(heads, 1, 1))
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x):
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.heads, C // self.heads).permute(2, 0, 3, 4, 1)
        q, k, v = F.normalize(qkv[0], dim=-1), F.normalize(qkv[1], dim=-1), qkv[2]
        attn = output(torch.matmul(operand(q), operand(k.transpose(-2, -1))))
        attn = torch.softmax(attn.float() * self.temperature, dim=-1).to(v.dtype)
        out = output(torch.matmul(operand(attn), operand(v)))  # (B, heads, d, N)
        return self.proj(out.permute(0, 3, 1, 2).reshape(B, N, C))


def _add_mlp(block: nn.Module, dim: int, dtype) -> None:
    """The inverted bottleneck both block kinds end with, its keys on the
    block as published (norm, pwconv1, pwconv2, gamma)."""
    block.norm = LayerNorm(dim, dtype=dtype)
    block.pwconv1 = Linear(dim, EXPANSION * dim, dtype=dtype)
    block.pwconv2 = Linear(EXPANSION * dim, dim, dtype=dtype)
    block.gamma = nn.Parameter(torch.full((dim,), LAYER_SCALE))


def _mlp(block: nn.Module, x):
    """Channels-last LayerNorm, Linear to 6x, GELU, Linear back, times the
    layer scale."""
    y = block.pwconv2(F.gelu(block.pwconv1(block.norm(x))))
    return y * block.gamma.to(y.dtype)


class DilatedConvBlock(nn.Module):
    """CDC block (published DilatedConv :179-223)."""

    INIT = {"gamma": LAYER_SCALE}

    def __init__(self, dim, dilation, rate, dtype):
        super().__init__()
        self.ddwconv = CDilated(dim, dilation, dtype)
        self.bn1 = BatchNorm2d(dim)
        _add_mlp(self, dim, dtype)
        self.rate = rate

    def forward(self, x, mask=None):
        y = _mlp(self, self.bn1(self.ddwconv(x)).permute(0, 2, 3, 1))
        return x + drop_path(y.permute(0, 3, 1, 2), mask, self.rate)


class LGFIBlock(nn.Module):
    """Local-global features interaction (published LGFI :226-279)."""

    INIT = {"gamma": LAYER_SCALE, "gamma_xca": LAYER_SCALE}

    def __init__(self, dim, rate, use_pos, dtype):
        super().__init__()
        if use_pos:
            self.pos_embd = nn.Module()
            self.pos_embd.token_projection = Conv(64, dim, 1, dtype=dtype)
        self.use_pos = use_pos
        self.norm_xca = LayerNorm(dim, dtype=dtype)
        self.gamma_xca = nn.Parameter(torch.full((dim,), LAYER_SCALE))
        self.xca = XCA(dim, HEADS, dtype)
        _add_mlp(self, dim, dtype)
        self.rate = rate

    def forward(self, x, mask=None):
        B, C, H, W = x.shape
        t = x.reshape(B, C, H * W).permute(0, 2, 1)
        if self.use_pos:
            pos = self.pos_embd.token_projection(fourier_features(H, W, x.device).to(x.dtype))
            t = t + pos.reshape(1, C, H * W).permute(0, 2, 1)
        t = t + self.gamma_xca.to(t.dtype) * self.xca(self.norm_xca(t))
        y = _mlp(self, t.reshape(B, H, W, C)).permute(0, 3, 1, 2)
        return x + drop_path(y, mask, self.rate)


class DepthEncoder(nn.Module):
    """Image (B, 3, H, W) -> features at [1/4, 1/8, 1/16] (published
    LiteMono)."""

    def __init__(self, height: int = 192, width: int = 640, dtype=torch.float32):
        super().__init__()
        self.num_ch_enc = DIMS
        self.drop_rates = [r.item() for r in torch.linspace(
            0, DROP_PATH_RATE, sum(DEPTHS), device="cpu")]
        stem1 = nn.Sequential(
            ConvBNGELU(3, DIMS[0], 2, True, dtype),
            ConvBNGELU(DIMS[0], DIMS[0], 1, True, dtype),
            ConvBNGELU(DIMS[0], DIMS[0], 1, True, dtype),
        )
        self.stem2 = nn.Sequential(ConvBNGELU(DIMS[0] + 3, DIMS[0], 2, False, dtype))
        self.downsample_layers = nn.ModuleList([stem1] + [
            nn.Sequential(ConvBNGELU(DIMS[i] * 2 + 3, DIMS[i + 1], 2, False, dtype))
            for i in range(2)])
        dil = dilations(height, width)
        rates = iter(self.drop_rates)
        self.stages = nn.ModuleList(
            nn.Sequential(*[DilatedConvBlock(DIMS[i], dil[i][j], next(rates), dtype)
                            for j in range(DEPTHS[i] - 1)],
                          LGFIBlock(DIMS[i], next(rates), i == 0, dtype))
            for i in range(3))

    @property
    def num_drop_paths(self) -> int:
        return len(self.drop_rates)

    def draw_drop_masks(self, batch: int, generator=None, device=None) -> torch.Tensor:
        """(blocks, batch) bool keep masks: block i keeps a sample with
        probability 1 - its rate, from one draw of `generator`."""
        keep = 1.0 - torch.tensor(self.drop_rates, device=device).view(-1, 1)
        return torch.rand((self.num_drop_paths, batch), generator=generator,
                          device=device) < keep

    def forward(self, x, drop_masks=None):
        x = (x - 0.45) / 0.225
        x_down, d = [], x
        for _ in range(3):  # AvgPool(i + 1): i + 1 successive 3x3, stride-2 pools
            d = F.avg_pool2d(d, 3, 2, 1)
            x_down.append(d)
        masks = iter([None] * self.num_drop_paths if drop_masks is None else drop_masks)
        y = self.stem2(torch.cat([self.downsample_layers[0](x), x_down[0]], 1))
        features, tmp = [], [y]
        for i, stage in enumerate(self.stages):
            if i > 0:
                y = self.downsample_layers[i](torch.cat(tmp + [x_down[i]], 1))
                tmp = [y]
            for block in stage:
                y = block(y, next(masks))
            tmp.append(y)
            features.append(y)
        return features


class DepthDecoder(nn.Module):
    """Returns {scale: disp}, disp in (0, 1) at 2^-scale of the input
    (published LiteMono DepthDecoder :447-505). `decoder` holds
    upconv(2,0), upconv(2,1), ..., upconv(0,1), then the dispconvs."""

    def __init__(self, num_ch_enc: Sequence[int] = DIMS, scales: Sequence[int] = (0,),
                 dtype=torch.float32):
        super().__init__()
        self.scales = tuple(scales)
        dec = tuple(c // 2 for c in num_ch_enc)
        mods = []
        for i in range(2, -1, -1):
            mods.append(ConvBlock(num_ch_enc[-1] if i == 2 else dec[i + 1], dec[i], dtype))
            mods.append(ConvBlock(dec[i] + (num_ch_enc[i - 1] if i > 0 else 0), dec[i], dtype))
        for s in self.scales:
            mods.append(Conv3x3(dec[s], 1, dtype))
        self.decoder = nn.ModuleList(mods)

    def forward(self, feats):
        out = {}
        x = feats[-1]
        for k, i in enumerate(range(2, -1, -1)):
            x = _up2(self.decoder[2 * k](x))
            if i > 0:
                x = torch.cat([x, feats[i - 1]], 1)
            x = self.decoder[2 * k + 1](x)
            if i in self.scales:
                out[i] = torch.sigmoid(_up2(self.decoder[6 + self.scales.index(i)](x)))
        return out


def _up2(x):
    return resize_bilinear(x, (x.shape[2] * 2, x.shape[3] * 2))


def _build(cfg, scales, dtype):
    encoder = DepthEncoder(cfg.height, cfg.width, dtype)
    return encoder, DepthDecoder(encoder.num_ch_enc, scales, dtype)


BACKBONES = {"LiteMono": _build}
