"""Loss building blocks of the training step (counterpart of the
channel-planar functions of mono_vifi_tpu/ops/losses.py): the SSIM+L1
photometric map, edge-aware smoothness and the SI-log depth consistency;
and the IFRNet VFI training losses (Charbonnier, census and geometry).

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


# ------------------------------------------------ IFRNet VFI training losses
# (counterpart of mono_vifi_tpu/ops/losses.py:228-328; reference
# networks/IFRNet.py:18-114), on NCHW tensors


def charbonnier_l1(diff, mask=None):
    """Charbonnier L1 (networks/IFRNet.py:94-103)."""
    val = torch.sqrt(diff**2 + 1e-6)
    if mask is None:
        return torch.mean(val)
    return torch.mean(val * mask) / (torch.mean(mask) + 1e-9)


def charbonnier_ada(diff, weight):
    """Adaptive Charbonnier (networks/IFRNet.py:106-114)."""
    alpha = weight / 2
    epsilon = 10 ** (-(10 * weight - 1) / 3)
    return torch.mean((diff**2 + epsilon**2) ** alpha)


def get_robust_weight(flow_pred, flow_gt, beta: float):
    """exp(-beta * EPE) with the prediction detached (networks/IFRNet.py:
    18-21); flows (B, 2, H, W) -> (B, 1, H, W)."""
    epe = torch.sqrt(torch.sum((flow_pred.detach() - flow_gt) ** 2, dim=1, keepdim=True))
    return torch.exp(-beta * epe)


def _census(x, patch_size: int):
    """Census transform of each channel of (B, C, H, W) `x` -> (B, C * P*P,
    H, W), channel c's P*P neighbour offsets at c*P*P..: the neighbourhood
    by a grouped conv with the identity kernel (zero-padded), minus the
    centre, soft-signed."""
    C = x.shape[1]
    P = patch_size
    kernel = torch.eye(P * P, dtype=x.dtype, device=x.device).reshape(P * P, 1, P, P)
    patches = F.conv2d(x, kernel.repeat(C, 1, 1, 1), padding=P // 2, groups=C)
    loc_diff = patches - x.repeat_interleave(P * P, dim=1)
    return loc_diff / torch.sqrt(0.81 + loc_diff**2)


def _census_distance(tx, ty, pad: int):
    """Mean over the inner window (a border of `pad` left out) of the
    channel-mean soft Hamming distance of two census transforms."""
    diff = tx - ty
    dist = torch.mean(diff**2 / (0.1 + diff**2), dim=1)
    mask = torch.zeros_like(dist)
    mask[:, pad:dist.shape[1] - pad, pad:dist.shape[2] - pad] = 1
    return torch.mean(dist * mask)


def ternary_loss(x, y, patch_size: int = 7):
    """Census-transform distance of the grey images (networks/IFRNet.py:
    24-55); y is detached."""
    tx = _census(torch.mean(x, dim=1, keepdim=True), patch_size)
    ty = _census(torch.mean(y, dim=1, keepdim=True), patch_size).detach()
    return _census_distance(tx, ty, patch_size // 2)


def geometry_loss(x, y, patch_size: int = 3):
    """Feature-geometry census loss over all channels (networks/IFRNet.py:
    58-91): the census of every channel, in the features' dtype, then the
    distance over all C*P*P offsets."""
    return _census_distance(_census(x, patch_size), _census(y, patch_size), patch_size // 2)
