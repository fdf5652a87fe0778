"""Bilinear grid sampling (counterpart of mono_vifi_tpu/ops/sampling.py).

Semantics are those of `torch.nn.functional.grid_sample` with
mode='bilinear', padding 'border' or 'zeros', either `align_corners`, as the
reference uses it. Every sample is written in one separable form: integer
bases (ly, lx) clamped to [0, H-2] x [0, W-2], the four taps there, and
weights (a0, a1) x (c0, c1) that carry the padding mode (the border clamp,
or the zero-fill masks folded in). The gradient to the grid flows through
the weights; the taps are piecewise constant in the grid.

`grid_sample`, `warp` and `grid_sample_table` take NHWC images and (x, y)
grids like the JAX package; they gather with autograd and are the plain
oracles of the kernels in ops/cuda. The planar helpers below them take
(B, C, H, W) images and (B, Ho, Wo) coordinate planes, which is how the
models and the training step call them.
"""

from __future__ import annotations

import torch

from mono_vifi_tpu_torch.ops.cuda.warp import bilinear_taps, bilinear_taps_plain


def _unnormalize(g, size: int, align_corners: bool):
    if align_corners:
        return (g + 1.0) * 0.5 * (size - 1)
    return ((g + 1.0) * size - 1.0) * 0.5


def border_factors(hw, gx, gy, align_corners: bool = True):
    """Border-mode bases and separable weights for coordinate planes gx, gy
    (normalized to [-1, 1]) -> (ly, lx, a0, a1, c0, c1)."""
    H, W = hw
    x = _unnormalize(gx, W, align_corners).clamp(0.0, W - 1)
    y = _unnormalize(gy, H, align_corners).clamp(0.0, H - 1)
    x0 = torch.floor(x.detach()).clamp(0, W - 2)
    y0 = torch.floor(y.detach()).clamp(0, H - 2)
    wx = x - x0
    wy = y - y0
    ly = y0.to(torch.int32).contiguous()
    lx = x0.to(torch.int32).contiguous()
    return ly, lx, 1.0 - wy, wy, 1.0 - wx, wx


def zeros_factors(hw, gx, gy, align_corners: bool = True):
    """Zeros-mode bases and mask-folded separable weights: out-of-image taps
    weigh 0, and where clamping the base moved the tap pair each weight
    stays with its true row/column (mono_vifi_tpu/ops/pallas/splat.py
    `_zeros_factors`)."""
    H, W = hw
    x = _unnormalize(gx, W, align_corners)
    y = _unnormalize(gy, H, align_corners)
    x0f = torch.floor(x.detach())
    y0f = torch.floor(y.detach())
    wx = x - x0f
    wy = y - y0f
    x0 = x0f.to(torch.int32)
    y0 = y0f.to(torch.int32)
    ly = y0.clamp(0, max(H - 2, 0))
    lx = x0.clamp(0, max(W - 2, 0))

    def m(cond):
        return cond.to(wx.dtype)

    my0, my1 = m((y0 >= 0) & (y0 <= H - 1)), m((y0 + 1 >= 0) & (y0 + 1 <= H - 1))
    mx0, mx1 = m((x0 >= 0) & (x0 <= W - 1)), m((x0 + 1 >= 0) & (x0 + 1 <= W - 1))
    a0 = (1.0 - wy) * my0 * m(y0 == ly) + wy * my1 * m(y0 + 1 == ly)
    a1 = (1.0 - wy) * my0 * m(y0 == ly + 1) + wy * my1 * m(y0 + 1 == ly + 1)
    c0 = (1.0 - wx) * mx0 * m(x0 == lx) + wx * mx1 * m(x0 + 1 == lx)
    c1 = (1.0 - wx) * mx0 * m(x0 == lx + 1) + wx * mx1 * m(x0 + 1 == lx + 1)
    return ly.contiguous(), lx.contiguous(), a0, a1, c0, c1


def factors(hw, gx, gy, padding_mode: str = "border", align_corners: bool = True):
    if padding_mode == "border":
        return border_factors(hw, gx, gy, align_corners)
    if padding_mode == "zeros":
        return zeros_factors(hw, gx, gy, align_corners)
    raise ValueError(f"unsupported padding_mode: {padding_mode}")


def combine_taps(taps, a0, a1, c0, c1):
    """(B, C, 4, Ho, Wo) taps and (B, Ho, Wo) weights -> (B, C, Ho, Wo) f32."""
    t = taps.float()
    a0, a1, c0, c1 = (w.float()[:, None] for w in (a0, a1, c0, c1))
    return a0 * (c0 * t[:, :, 0] + c1 * t[:, :, 1]) + a1 * (
        c0 * t[:, :, 2] + c1 * t[:, :, 3]
    )


def flow_to_grid(flow):
    """Pixel flow (B, 2, H, W), channels (dx, dy) -> f32 coordinate planes
    (gx, gy) for align_corners=True (reference networks/IFRNet.py:7-15)."""
    B, _, H, W = flow.shape
    flow = flow.float()
    sx, sy = (W - 1.0) / 2.0, (H - 1.0) / 2.0
    xs = torch.arange(W, dtype=torch.float32, device=flow.device) / sx - 1.0
    ys = torch.arange(H, dtype=torch.float32, device=flow.device) / sy - 1.0
    gx = xs.view(1, 1, W) + flow[:, 0] / sx
    gy = ys.view(1, H, 1) + flow[:, 1] / sy
    return gx, gy


# ------------------------------------------------- NHWC oracles (autograd)

def grid_sample(img, grid, padding_mode: str = "border", align_corners: bool = True):
    """Bilinear sample NHWC `img` (B, H, W, C) at `grid` (B, Ho, Wo, 2),
    (x, y) order -> (B, Ho, Wo, C). Gradients reach both img and grid."""
    B, H, W, C = img.shape
    f = factors((H, W), grid[..., 0], grid[..., 1], padding_mode, align_corners)
    taps = bilinear_taps_plain(img.permute(0, 3, 1, 2), f[0], f[1])
    return combine_taps(taps, *f[2:]).to(img.dtype).permute(0, 2, 3, 1)


def warp(img, flow):
    """Backward-warp NHWC `img` by the NHWC pixel flow (border mode)."""
    gx, gy = flow_to_grid(flow.permute(0, 3, 1, 2))
    return grid_sample(img, torch.stack([gx, gy], dim=-1))


def grid_sample_table(table, ids, grid):
    """out[k] = grid_sample(table[ids[k]], grid[k]), border mode: N grids
    drawing from U unique NHWC images (U, H, W, C)."""
    ids = torch.as_tensor(ids, dtype=torch.long, device=table.device)
    return grid_sample(table.index_select(0, ids), grid)


# ---------------------------------------------------------- planar helpers

def warp_planar(img, flow):
    """Differentiable border warp of (B, C, H, W) `img` by the (B, 2, H, W)
    pixel flow; taps gathered in PyTorch, combined in f32."""
    B, C, H, W = img.shape
    gx, gy = flow_to_grid(flow)
    f = border_factors((H, W), gx, gy)
    taps = bilinear_taps_plain(img, f[0], f[1])
    return combine_taps(taps, *f[2:]).to(img.dtype)


def sample_planar(img, gx, gy, padding_mode: str = "border",
                  align_corners: bool = True, tap_dtype=None):
    """Sample (B, C, H, W) `img` at the coordinate planes through the
    `bilinear_taps` kernel: taps in `tap_dtype` (None = img dtype), combined
    in f32, returned in the img dtype. The grid gets a gradient; the image
    gets none (callers pass frozen or target images)."""
    B, C, H, W = img.shape
    f = factors((H, W), gx, gy, padding_mode, align_corners)
    taps = bilinear_taps(img.contiguous(), f[0], f[1], tap_dtype)
    return combine_taps(taps, *f[2:]).to(img.dtype)
