"""Loss building blocks of the training step (counterpart of the
channel-planar functions of mono_vifi_tpu/ops/losses.py): the SSIM+L1
photometric map, edge-aware smoothness and the SI-log depth consistency.

Planes are (B, C, H, W); disparities and depths (B, 1, H, W) or (B, H, W)
where stated. `reprojection_loss_planar` is the plain version of the
photometric kernels in ops/cuda/photometric.py.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_SSIM_C1 = 0.01**2
_SSIM_C2 = 0.03**2


def _avg_pool_3x3(x):
    """3x3 stride-1 VALID mean pool over the last two dims (rows, then
    columns, as the JAX package's pool sums)."""
    rows = x[..., :-2, :] + x[..., 1:-1, :] + x[..., 2:, :]
    return (rows[..., :-2] + rows[..., 1:-1] + rows[..., 2:]) / 9.0


def _pad(x):
    return F.pad(x, (1, 1, 1, 1), mode="reflect")


def target_moments_planar(y):
    """Target-side SSIM terms (y_pad, mu_y, sigma_y) shared by every
    comparison against the same target."""
    y_pad = _pad(y)
    mu_y = _avg_pool_3x3(y_pad)
    sigma_y = _avg_pool_3x3(y_pad * y_pad) - mu_y * mu_y
    return y_pad, mu_y, sigma_y


def ssim_planar_pre(x, y_pad, mu_y, sigma_y):
    """Clamped (1 - SSIM) / 2 map (B, C, H, W) against precomputed moments."""
    x = _pad(x)
    mu_x = _avg_pool_3x3(x)
    sigma_x = _avg_pool_3x3(x * x) - mu_x * mu_x
    sigma_xy = _avg_pool_3x3(x * y_pad) - mu_x * mu_y
    n = (2 * mu_x * mu_y + _SSIM_C1) * (2 * sigma_xy + _SSIM_C2)
    d = (mu_x * mu_x + mu_y * mu_y + _SSIM_C1) * (sigma_x + sigma_y + _SSIM_C2)
    return torch.clamp((1 - n / d) / 2, 0.0, 1.0)


def reprojection_loss_planar(pred, target, use_ssim: bool = True, moments=None):
    """0.85 * SSIM + 0.15 * L1, channel-averaged: (B, C, H, W) -> (B, H, W)
    (reference train.py:973-985)."""
    l1 = torch.mean(torch.abs(target - pred), dim=1)
    if not use_ssim:
        return l1
    if moments is None:
        moments = target_moments_planar(target)
    s = torch.mean(ssim_planar_pre(pred, *moments), dim=1)
    return 0.85 * s + 0.15 * l1


def smooth_loss_planar(disp, img):
    """Edge-aware smoothness; disp (B, H, W), img (B, C, H, W)."""
    gdx = torch.abs(disp[:, :, :-1] - disp[:, :, 1:])
    gdy = torch.abs(disp[:, :-1, :] - disp[:, 1:, :])
    gix = torch.mean(torch.abs(img[..., :, :-1] - img[..., :, 1:]), dim=1)
    giy = torch.mean(torch.abs(img[..., :-1, :] - img[..., 1:, :]), dim=1)
    return torch.mean(gdx * torch.exp(-gix)) + torch.mean(gdy * torch.exp(-giy))


def smooth_loss_dyn_planar(disp, img, mask_dyn):
    """Dynamic-object-weighted smoothness (reference layers.py:244-258);
    mask_dyn (B, H, W). A zero mask reduces exactly to smooth_loss_planar."""
    M = 100.0 * mask_dyn + (1.0 - mask_dyn)
    img = (1.0 - mask_dyn)[:, None] * img
    gdx = torch.abs(disp[:, :, :-1] - disp[:, :, 1:])
    gdy = torch.abs(disp[:, :-1, :] - disp[:, 1:, :])
    gix = torch.mean(torch.abs(img[..., :, :-1] - img[..., :, 1:]), dim=1)
    giy = torch.mean(torch.abs(img[..., :-1, :] - img[..., 1:, :]), dim=1)
    return torch.mean(gdx * torch.exp(-gix)) + torch.mean(
        gdy * torch.exp(-giy) * M[:, :-1, :]
    )


def to_planar(x):
    """(B, H, W, C) -> contiguous (B, C, H, W)."""
    return x.permute(0, 3, 1, 2).contiguous()


def si_log_depth_loss(pred, target, mask=None, beta: float = 0.5):
    """Scale-invariant log depth loss (reference train.py:924-941);
    pred, target, mask (B, 1, H, W)."""
    m = torch.ones_like(pred[:, 0]) if mask is None else mask[:, 0]
    log_pred = torch.log(pred[:, 0] + 1e-7) * m
    log_tgt = torch.log(target[:, 0] + 1e-7) * m
    diff = log_pred - log_tgt
    valid = torch.sum(m, dim=(1, 2)) + 1e-8
    sq_sum = torch.sum(diff**2, dim=(1, 2))
    sum_sq = torch.sum(diff, dim=(1, 2)) ** 2
    return torch.mean(sq_sum / valid - beta * sum_sq / (valid**2))
