"""Kernels 2 and 3, `ssim_l1_fwd` and `ssim_l1_bwd` (csrc/photometric.cu):
the fused SSIM+L1 photometric map and its gradient with respect to x,
replacing mono_vifi_tpu/ops/pallas/photometric.py. The plain versions are
ops.losses.reprojection_loss_planar and its autograd gradient."""

from __future__ import annotations

import torch

from mono_vifi_tpu_torch.ops import cuda
from mono_vifi_tpu_torch.ops.losses import reprojection_loss_planar


def ssim_l1_fwd_plain(x, y, use_ssim=True):
    return reprojection_loss_planar(x, y, use_ssim)


def ssim_l1_bwd_plain(x, y, ct, use_ssim=True):
    """d/dx of sum(ct * map(x, y)) by autograd of the plain map."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        out = reprojection_loss_planar(xr, y.detach(), use_ssim)
        (dx,) = torch.autograd.grad(out, xr, ct)
    return dx


def _check_planes(x, y):
    dev = x.device
    cuda.check(x, "x", (torch.float32,), 4, dev)
    cuda.check(y, "y", (torch.float32,), 4, dev)
    if x.shape != y.shape:
        raise ValueError(f"x {tuple(x.shape)} and y {tuple(y.shape)} differ")
    N, C, H, W = x.shape
    if H < 2 or W < 2 or N * C > 65535:
        raise ValueError(f"plane shape {tuple(x.shape)} not supported")


def ssim_l1_fwd(x, y, use_ssim=True):
    """(N, C, H, W) f32 x, y -> (N, H, W) f32 map (kernel on CUDA)."""
    if not cuda.use_kernel(x):
        return ssim_l1_fwd_plain(x, y, use_ssim)
    _check_planes(x, y)
    N, C, H, W = x.shape
    out = torch.empty((N, H, W), dtype=torch.float32, device=x.device)
    cuda.launch(
        "mv_ssim_l1_fwd", "ssim_l1_fwd",
        x.data_ptr(), y.data_ptr(), out.data_ptr(), N, C, H, W, int(use_ssim),
        shape=x.shape,
    )
    return out


def ssim_l1_bwd(x, y, ct, use_ssim=True):
    """Gradient of sum(ct * map(x, y)) with respect to x (N, C, H, W), in
    one launch."""
    if not cuda.use_kernel(x):
        return ssim_l1_bwd_plain(x, y, ct, use_ssim)
    _check_planes(x, y)
    cuda.check(ct, "ct", (torch.float32,), 3, x.device)
    N, C, H, W = x.shape
    if ct.shape != (N, H, W):
        raise ValueError(f"ct {tuple(ct.shape)} does not match x {tuple(x.shape)}")
    dx = torch.empty_like(x)
    cuda.launch(
        "mv_ssim_l1_bwd", "ssim_l1_bwd",
        x.data_ptr(), y.data_ptr(), ct.data_ptr(), dx.data_ptr(),
        N, C, H, W, int(use_ssim), shape=x.shape,
    )
    return dx


class _SsimL1Map(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, use_ssim):
        ctx.save_for_backward(x, y)
        ctx.use_ssim = use_ssim
        return ssim_l1_fwd(x, y, use_ssim)

    @staticmethod
    def backward(ctx, ct):
        x, y = ctx.saved_tensors
        return ssim_l1_bwd(x, y, ct.contiguous(), ctx.use_ssim), None, None


def ssim_l1_map(x, y, use_ssim=True):
    """Photometric map (N, C, H, W) -> (N, H, W) f32 with a gradient to x
    only (y is a loss target). == 0.85 * mean_c SSIM + 0.15 * mean_c L1."""
    x = x.contiguous()
    y = y.detach().contiguous()
    if not cuda.use_kernel(x):
        return reprojection_loss_planar(x, y, use_ssim)
    return _SsimL1Map.apply(x, y, use_ssim)


def ssim_l1_map_nograd(x, y, use_ssim=True):
    """Forward-only map, for the automask identity comparisons."""
    with torch.no_grad():
        return ssim_l1_fwd(x.contiguous(), y.contiguous(), use_ssim)
