"""The plain PyTorch forms of the port's six hand-written kernels, as the
frozen reference computes them: bilinear sampling from coordinate planes
(image frozen, gradient to the grid), the SSIM+L1 photometric map, and the
table sample whose image gradient is the splat adjoint (grid frozen). Each
gradient comes from autograd of the plain forward."""

from __future__ import annotations

import torch

from perfbench.reference.ops.losses import reprojection_loss_planar


def bilinear_taps_plain(img, ly, lx, tap_dtype=None):
    """Gather img[b, c, ly + i, lx + j] for (i, j) in (0,0), (0,1), (1,0),
    (1,1) -> (B, C, 4, Ho, Wo) in `tap_dtype` (None = img dtype). Bases are
    clamped to [0, H-2] x [0, W-2]."""
    B, C, H, W = img.shape
    Ho, Wo = ly.shape[1:]
    y = ly.long().clamp(0, H - 2)
    x = lx.long().clamp(0, W - 2)
    idx = (y * W + x).reshape(B, 1, Ho * Wo).expand(B, C, Ho * Wo)
    flat = img.reshape(B, C, H * W)
    taps = torch.stack(
        [flat.gather(2, idx + d) for d in (0, 1, W, W + 1)], dim=2
    ).reshape(B, C, 4, Ho, Wo)
    return taps.to(tap_dtype or img.dtype)


def bilinear_sample_plain(img, gx, gy, padding_mode="border", align_corners=True,
                          tap_dtype=None):
    """The bases and weights, the four taps in `tap_dtype`, the f32 combine,
    cast to the img dtype. Differentiable in img and the grid."""
    from perfbench.reference.ops.sampling import combine_taps, factors

    f = factors(img.shape[2:], gx, gy, padding_mode, align_corners)
    taps = bilinear_taps_plain(img, f[0], f[1], tap_dtype)
    return combine_taps(taps, *f[2:]).to(img.dtype)


def grid_sample_frozen_image(img, gx, gy, padding_mode="border", align_corners=True,
                             tap_dtype=None):
    """Sample (B, C, H, W) `img` at the f32 coordinate planes; the image gets
    no gradient, the grid gets one."""
    return bilinear_sample_plain(img.detach(), gx, gy, padding_mode, align_corners,
                                 tap_dtype)


def bilinear_sample_table_plain(table, ids, gx, gy, padding_mode="border"):
    """out[k] = bilinear sample of table[ids[k]] (table[k] without ids) at the
    coordinate planes, combined in f32, in the table's dtype."""
    from perfbench.reference.ops.sampling import combine_taps, factors

    ly, lx, a0, a1, c0, c1 = factors(table.shape[2:], gx, gy, padding_mode)
    src = table if ids is None else table.index_select(0, ids.long())
    return combine_taps(bilinear_taps_plain(src, ly, lx), a0, a1, c0, c1).to(table.dtype)


def grid_sample_frozen_grid(img, gx, gy, padding_mode: str = "border", ids=None):
    """Sample (U, C, H, W) `img` at frozen coordinate planes (N, Ho, Wo); with
    `ids` use k samples img[ids[k]]. The gradient reaches the image only."""
    gx, gy = gx.detach().float(), gy.detach().float()
    if ids is None:
        return bilinear_sample_plain(img, gx, gy, padding_mode)
    return bilinear_sample_table_plain(img, ids, gx, gy, padding_mode)


def ssim_l1_map(x, y, use_ssim=True):
    """Photometric map (N, C, H, W) -> (N, H, W) f32, gradient to x only."""
    return reprojection_loss_planar(x, y.detach(), use_ssim)


def ssim_l1_map_nograd(x, y, use_ssim=True):
    with torch.no_grad():
        return reprojection_loss_planar(x, y, use_ssim)
