"""Kernel 1, `bilinear_sample`, and its grid gradient `bilinear_sample_bwd`
(csrc/warp.cu): bilinear sampling of an NCHW image at f32 coordinate planes
in one pass (weights, tap gather, tap rounding, f32 combine), replacing the
TPU tap kernels of mono_vifi_tpu/ops/pallas/warp.py, and the gradient to the
coordinate planes in border mode. `grid_sample_frozen_image` binds both
into a `torch.autograd.Function`: the grid gets a gradient, the image none.
"""

from __future__ import annotations

import torch

from mono_vifi_tpu_torch.ops import cuda

_DTYPES = (torch.float32, torch.bfloat16)
_MODES = {"border": 0, "zeros": 1}


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
    """Plain version: `factors`, the four taps in `tap_dtype`, the f32
    combine, cast to the img dtype. Differentiable in img and the grid."""
    # imported here: ops.sampling imports this module
    from mono_vifi_tpu_torch.ops.sampling import combine_taps, factors

    f = factors(img.shape[2:], gx, gy, padding_mode, align_corners)
    taps = bilinear_taps_plain(img, f[0], f[1], tap_dtype)
    return combine_taps(taps, *f[2:]).to(img.dtype)


def bilinear_sample_grid_bwd_plain(img, gx, gy, ct, align_corners=True, tap_dtype=None):
    """Plain version of the grid gradient: autograd of
    `bilinear_sample_plain` (border mode, image held constant) -> (dgx, dgy)."""
    with torch.enable_grad():
        gxr = gx.detach().requires_grad_(True)
        gyr = gy.detach().requires_grad_(True)
        out = bilinear_sample_plain(img.detach(), gxr, gyr, "border", align_corners,
                                    tap_dtype)
        return torch.autograd.grad(out, (gxr, gyr), ct)


def _check_sample(img, gx, gy, tap_dtype):
    dev = img.device
    cuda.check(img, "img", _DTYPES, 4, dev)
    cuda.check(gx, "gx", (torch.float32,), 3, dev)
    cuda.check(gy, "gy", (torch.float32,), 3, dev)
    if tap_dtype not in _DTYPES:
        raise TypeError(f"tap dtype {tap_dtype} not supported")
    B, C, H, W = img.shape
    if gx.shape != gy.shape or gx.shape[0] != B:
        raise ValueError(f"grid {tuple(gx.shape)} does not match image {tuple(img.shape)}")
    if H < 2 or W < 2 or B > 65535:
        raise ValueError(f"image shape {tuple(img.shape)} not supported")


def bilinear_sample(img, gx, gy, padding_mode="border", align_corners=True,
                    tap_dtype=None):
    """Sample `img` (B, C, H, W) f32 or bf16 at the normalized f32 coordinate
    planes gx, gy (B, Ho, Wo) -> (B, C, Ho, Wo) in the img dtype, taps
    rounded to `tap_dtype` (None = img dtype) and combined in f32; no
    gradient."""
    tap_dtype = tap_dtype or img.dtype
    if not cuda.use_kernel(img):
        with torch.no_grad():
            return bilinear_sample_plain(img, gx, gy, padding_mode, align_corners,
                                         tap_dtype)
    _check_sample(img, gx, gy, tap_dtype)
    if padding_mode not in _MODES:
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    B, C, H, W = img.shape
    Ho, Wo = gx.shape[1:]
    out = torch.empty((B, C, Ho, Wo), dtype=img.dtype, device=img.device)
    cuda.launch(
        "mv_bilinear_sample", "bilinear_sample",
        img.data_ptr(), cuda.DTYPE_CODE[img.dtype], cuda.DTYPE_CODE[tap_dtype],
        gx.data_ptr(), gy.data_ptr(), out.data_ptr(),
        B, C, H, W, Ho, Wo, _MODES[padding_mode], int(align_corners), shape=img.shape,
    )
    return out


def bilinear_sample_bwd(img, gx, gy, ct, align_corners=True, tap_dtype=None):
    """Gradient of sum(ct * bilinear_sample(img, gx, gy, "border")) with
    respect to gx and gy -> (dgx, dgy) f32 (B, Ho, Wo); ct in the img dtype."""
    tap_dtype = tap_dtype or img.dtype
    if not cuda.use_kernel(img):
        return bilinear_sample_grid_bwd_plain(img, gx, gy, ct, align_corners, tap_dtype)
    _check_sample(img, gx, gy, tap_dtype)
    cuda.check(ct, "ct", (img.dtype,), 4, img.device)
    B, C, H, W = img.shape
    Ho, Wo = gx.shape[1:]
    if ct.shape != (B, C, Ho, Wo):
        raise ValueError(f"ct {tuple(ct.shape)} does not match the output {(B, C, Ho, Wo)}")
    dgx = torch.empty_like(gx)
    dgy = torch.empty_like(gy)
    cuda.launch(
        "mv_bilinear_sample_bwd", "bilinear_sample_bwd",
        img.data_ptr(), cuda.DTYPE_CODE[img.dtype], cuda.DTYPE_CODE[tap_dtype],
        gx.data_ptr(), gy.data_ptr(), ct.data_ptr(), dgx.data_ptr(), dgy.data_ptr(),
        B, C, H, W, Ho, Wo, int(align_corners), shape=img.shape,
    )
    return dgx, dgy


class _BilinearSample(torch.autograd.Function):
    """Border-mode sample with a gradient to the grid only: forward kernel 1,
    backward `bilinear_sample_bwd`. Saves img, gx and gy."""

    @staticmethod
    def forward(ctx, img, gx, gy, align_corners, tap_dtype):
        ctx.save_for_backward(img, gx, gy)
        ctx.align_corners = align_corners
        ctx.tap_dtype = tap_dtype
        return bilinear_sample(img, gx, gy, "border", align_corners, tap_dtype)

    @staticmethod
    def backward(ctx, ct):
        img, gx, gy = ctx.saved_tensors
        dgx, dgy = bilinear_sample_bwd(img, gx, gy, ct.contiguous(), ctx.align_corners,
                                       ctx.tap_dtype)
        return None, dgx, dgy, None, None


def grid_sample_frozen_image(img, gx, gy, padding_mode="border", align_corners=True,
                             tap_dtype=None):
    """Sample (B, C, H, W) `img` at the f32 coordinate planes gx, gy (B, Ho,
    Wo) -> (B, C, Ho, Wo) in the img dtype. The image gets no gradient
    (callers pass frozen or target images); the grid gets one in border
    mode. Nothing is saved for a backward unless the grid requires a
    gradient; a zeros-mode grid that requires one raises."""
    img = img.detach().contiguous()
    gx, gy = gx.contiguous(), gy.contiguous()
    if torch.is_grad_enabled() and (gx.requires_grad or gy.requires_grad):
        if padding_mode != "border":
            raise ValueError(f"no grid gradient for padding_mode {padding_mode!r}: "
                             "pass a frozen grid")
        return _BilinearSample.apply(img, gx, gy, align_corners, tap_dtype)
    return bilinear_sample(img, gx, gy, padding_mode, align_corners, tap_dtype)
