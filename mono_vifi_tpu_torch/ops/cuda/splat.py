"""Kernel 4, `bilinear_splat` (csrc/splat.cu): the image adjoint of
bilinear sampling, replacing the TPU splat kernels of
mono_vifi_tpu/ops/pallas/splat.py, and `grid_sample_frozen_grid`, the
sampling Function whose forward is kernel 5 (with a use -> plane table) or
kernel 1 (without) and whose backward is kernel 4.
"""

from __future__ import annotations

import torch

from mono_vifi_tpu_torch.ops import cuda
from mono_vifi_tpu_torch.ops.cuda.fwarp import bilinear_sample_table
from mono_vifi_tpu_torch.ops.cuda.warp import bilinear_taps
from mono_vifi_tpu_torch.ops.sampling import combine_taps, factors


def bilinear_splat_plain(ct, ly, lx, a0, a1, c0, c1, out_hw, ids=None,
                         num_planes=None):
    """Plain version (scatter_add_ / index_add_, the semantics of the JAX
    package's `_xla_splat`): -> f32 (U, C, H, W) adjoint, U = num_planes
    with ids, else N."""
    N, C, Ho, Wo = ct.shape
    H, W = out_hw
    P = Ho * Wo
    y = ly.long().clamp(0, H - 2)
    x = lx.long().clamp(0, W - 2)
    base = (y * W + x).reshape(N, 1, P).expand(N, C, P)
    v = ct.float().reshape(N, C, P)
    per_use = torch.zeros((N, C, H * W), dtype=torch.float32, device=ct.device)
    for ar, dy in ((a0, 0), (a1, 1)):
        for cc, dx in ((c0, 0), (c1, 1)):
            w = (ar * cc).float().reshape(N, 1, P)
            per_use.scatter_add_(2, base + (dy * W + dx), v * w)
    if ids is None:
        return per_use.reshape(N, C, H, W)
    out = torch.zeros((num_planes, C, H * W), dtype=torch.float32, device=ct.device)
    out.index_add_(0, ids.long(), per_use)
    return out.reshape(num_planes, C, H, W)


def bilinear_splat(ct, ly, lx, a0, a1, c0, c1, out_hw, ids=None,
                   num_planes=None, out_dtype=None):
    """Scatter-add ct (N, C, Ho, Wo) with separable weights at bases (ly, lx)
    into (U, C, H, W) planes; use k goes to plane ids[k] (int32, (N,)) when
    ids is given. Sums run in f32; the result is cast to `out_dtype`."""
    if not cuda.use_kernel(ct):
        out = bilinear_splat_plain(ct, ly, lx, a0, a1, c0, c1, out_hw, ids, num_planes)
        return out.to(out_dtype or torch.float32)
    dev = ct.device
    cuda.check(ct, "ct", (torch.float32, torch.bfloat16), 4, dev)
    for name, t in (("ly", ly), ("lx", lx)):
        cuda.check(t, name, (torch.int32,), 3, dev)
    for name, t in (("a0", a0), ("a1", a1), ("c0", c0), ("c1", c1)):
        cuda.check(t, name, (torch.float32,), 3, dev)
    N, C, Ho, Wo = ct.shape
    H, W = out_hw
    for t in (ly, lx, a0, a1, c0, c1):
        if t.shape != (N, Ho, Wo):
            raise ValueError(f"tap plane {tuple(t.shape)} does not match ct {tuple(ct.shape)}")
    if ids is not None:
        cuda.check(ids, "ids", (torch.int32,), 1, dev)
        if ids.shape[0] != N or not num_planes:
            raise ValueError("ids needs one entry per use and num_planes")
        U = num_planes
    else:
        U = N
    if H < 2 or W < 2 or N > 65535:
        raise ValueError(f"splat shape {tuple(ct.shape)} -> {out_hw} not supported")
    canvas = torch.zeros((U, C, H, W), dtype=torch.float32, device=dev)
    cuda.launch(
        "mv_bilinear_splat", "bilinear_splat",
        ct.data_ptr(), cuda.DTYPE_CODE[ct.dtype], ly.data_ptr(), lx.data_ptr(),
        a0.data_ptr(), a1.data_ptr(), c0.data_ptr(), c1.data_ptr(),
        ids.data_ptr() if ids is not None else None, canvas.data_ptr(),
        N, C, Ho, Wo, U, H, W,
    )
    return canvas.to(out_dtype or torch.float32)


class _FrozenGridSample(torch.autograd.Function):
    """Forward: with a use -> plane table, the table sample (kernel 5);
    without, taps (kernel 1) + combine. Backward: splat (kernel 4) to the
    image only; the grid is frozen."""

    @staticmethod
    def forward(ctx, img, ly, lx, a0, a1, c0, c1, ids):
        if ids is None:
            out = combine_taps(bilinear_taps(img, ly, lx), a0, a1, c0, c1).to(img.dtype)
        else:
            out = bilinear_sample_table(img, ids, ly, lx, a0, a1, c0, c1)
        ctx.save_for_backward(ly, lx, a0, a1, c0, c1, ids)
        ctx.img_shape = img.shape
        ctx.img_dtype = img.dtype
        return out

    @staticmethod
    def backward(ctx, ct):
        ly, lx, a0, a1, c0, c1, ids = ctx.saved_tensors
        U, _, H, W = ctx.img_shape
        grad = bilinear_splat(
            ct.contiguous(), ly, lx, a0, a1, c0, c1, (H, W), ids, U,
            out_dtype=ctx.img_dtype,
        )
        return (grad,) + (None,) * 7


def grid_sample_frozen_grid(img, gx, gy, padding_mode: str = "border", ids=None):
    """Sample (U, C, H, W) `img` at frozen coordinate planes gx, gy (N, Ho,
    Wo) -> (N, C, Ho, Wo) in the img dtype, with a gradient to the image
    only. With `ids` (int32 (N,)), use k samples img[ids[k]] and the
    backward sums each plane's uses."""
    with torch.no_grad():
        ly, lx, a0, a1, c0, c1 = factors(
            img.shape[2:], gx.float(), gy.float(), padding_mode
        )
        a0, a1, c0, c1 = (w.contiguous() for w in (a0, a1, c0, c1))
    return _FrozenGridSample.apply(img.contiguous(), ly, lx, a0, a1, c0, c1, ids)
