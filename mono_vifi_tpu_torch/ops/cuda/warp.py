"""Kernel 1, `bilinear_taps` (csrc/warp.cu): the four bilinear taps of an
NCHW image at integer bases, replacing the TPU tap kernels of
mono_vifi_tpu/ops/pallas/warp.py. The taps carry no gradient; callers
combine them with differentiable weights (ops.sampling.combine_taps)."""

from __future__ import annotations

import torch

from mono_vifi_tpu_torch.ops import cuda

_DTYPES = (torch.float32, torch.bfloat16)


def bilinear_taps_plain(img, ly, lx, tap_dtype=None):
    """Plain version: gather img[b, c, ly + i, lx + j] for (i, j) in
    (0,0), (0,1), (1,0), (1,1) -> (B, C, 4, Ho, Wo) in `tap_dtype`
    (None = img dtype). Bases are clamped to [0, H-2] x [0, W-2]."""
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


def bilinear_taps(img, ly, lx, tap_dtype=None):
    """Taps of `img` (B, C, H, W) at int32 bases `ly`, `lx` (B, Ho, Wo),
    pre-clamped to [0, H-2] x [0, W-2] -> (B, C, 4, Ho, Wo), no gradient."""
    tap_dtype = tap_dtype or img.dtype
    if not cuda.use_kernel(img):
        with torch.no_grad():
            return bilinear_taps_plain(img, ly, lx, tap_dtype)
    dev = img.device
    cuda.check(img, "img", _DTYPES, 4, dev)
    cuda.check(ly, "ly", (torch.int32,), 3, dev)
    cuda.check(lx, "lx", (torch.int32,), 3, dev)
    if tap_dtype not in _DTYPES:
        raise TypeError(f"tap dtype {tap_dtype} not supported")
    B, C, H, W = img.shape
    if ly.shape != lx.shape or ly.shape[0] != B:
        raise ValueError(f"bases {tuple(ly.shape)} do not match image {tuple(img.shape)}")
    if H < 2 or W < 2 or B > 65535:
        raise ValueError(f"image shape {tuple(img.shape)} not supported")
    Ho, Wo = ly.shape[1:]
    out = torch.empty((B, C, 4, Ho, Wo), dtype=tap_dtype, device=dev)
    cuda.launch(
        "mv_bilinear_taps", "bilinear_taps",
        img.data_ptr(), cuda.DTYPE_CODE[img.dtype], ly.data_ptr(),
        lx.data_ptr(), out.data_ptr(), cuda.DTYPE_CODE[tap_dtype],
        B, C, H, W, Ho, Wo,
    )
    return out
