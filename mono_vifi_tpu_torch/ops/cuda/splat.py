"""Kernel 4, `bilinear_splat` (csrc/splat.cu): the image adjoint of
bilinear sampling, replacing the TPU splat kernels of
mono_vifi_tpu/ops/pallas/splat.py, and `grid_sample_frozen_grid`, the
sampling Function whose forward is kernel 5 (with a use -> plane table) or
kernel 1, `bilinear_sample` (without), and whose backward is kernel 4.
"""

from __future__ import annotations

import torch

from mono_vifi_tpu_torch.ops import cuda
from mono_vifi_tpu_torch.ops.cuda.fwarp import bilinear_sample_table, bilinear_sample_table_plain
from mono_vifi_tpu_torch.ops.cuda.warp import bilinear_sample
from mono_vifi_tpu_torch.ops import sampling


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


# the binned path's output tile, as csrc/splat.cu fixes it (256 cells)
TILE_H, TILE_W = 8, 32
# blocks a splat launch aims for (about four per SM of an H100)
MIN_BLOCKS = 1024


def splat_tiles(H, W):
    """Output tiles of TILE_H x TILE_W cells that cover an (H, W) plane."""
    return -(-H // TILE_H) * -(-W // TILE_W)


def splat_channel_group(C, H, W, U):
    """Channels a block of a splat launch of U planes (C, H, W) sums: all of
    them, halved (down to 8) while the launch has fewer than MIN_BLOCKS
    blocks, so that the deep levels' few tiles still fill the card. One
    channel takes the direct path: 0."""
    if C == 1:
        return 0
    tiles = splat_tiles(H, W)
    cg = C
    while cg > 8 and tiles * U * -(-C // cg) < MIN_BLOCKS:
        cg = -(-cg // 2)
    return cg


def bilinear_splat(ct, ly, lx, a0, a1, c0, c1, out_hw, ids=None,
                   num_planes=None, out_dtype=None):
    """Scatter-add ct (N, C, Ho, Wo) with separable weights at bases (ly, lx)
    into (U, C, H, W) planes; use k goes to plane ids[k] (int32, (N,)) when
    ids is given. Sums run in f32; the result is in `out_dtype` (f32 or
    bf16; f32 by default)."""
    out_dtype = out_dtype or torch.float32
    if not cuda.use_kernel(ct):
        out = bilinear_splat_plain(ct, ly, lx, a0, a1, c0, c1, out_hw, ids, num_planes)
        return out.to(out_dtype)
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
    if out_dtype not in cuda.DTYPE_CODE:
        raise TypeError(f"out_dtype {out_dtype} not supported")
    cg = splat_channel_group(C, H, W, U)
    list_len = 8 * N * -(-(Ho * Wo) // 2)
    if (H < 2 or W < 2 or N < 1 or U > 65535 or (cg and -(-C // cg) > 65535)
            or list_len >= 2**31 or ct.numel() >= 2**31):
        raise ValueError(f"splat shape {tuple(ct.shape)} -> {out_hw} not supported")
    if cg:  # binned: every cell written in the output dtype
        out = torch.empty((U, C, H, W), dtype=out_dtype, device=dev)
        scratch = torch.empty((3 * U * splat_tiles(H, W) + list_len,), dtype=torch.int32, device=dev)
    else:  # direct: atomics into a zeroed f32 canvas
        out = torch.zeros((U, C, H, W), dtype=torch.float32, device=dev)
        scratch = None
    cuda.launch(
        "mv_bilinear_splat", "bilinear_splat",
        ct.data_ptr(), cuda.DTYPE_CODE[ct.dtype], ly.data_ptr(), lx.data_ptr(),
        a0.data_ptr(), a1.data_ptr(), c0.data_ptr(), c1.data_ptr(),
        ids.data_ptr() if ids is not None else None, out.data_ptr(),
        cuda.DTYPE_CODE[out.dtype], scratch.data_ptr() if cg else None,
        N, C, Ho, Wo, U, H, W, cg, shape=ct.shape,
    )
    return out.to(out_dtype)


class _FrozenGridSample(torch.autograd.Function):
    """Forward: with a use -> plane table, the table sample (kernel 5,
    border mode; other modes only on the CPU, through its plain version);
    without, the fused sample (kernel 1); both from the coordinate planes.
    Backward: the factors of the saved coordinates, then the splat (kernel
    4) to the image only; the grid is frozen."""

    @staticmethod
    def forward(ctx, img, gx, gy, padding_mode, ids):
        if ids is None:
            out = bilinear_sample(img, gx, gy, padding_mode)
        elif padding_mode == "border":
            out = bilinear_sample_table(img, ids, gx, gy)
        else:
            out = bilinear_sample_table_plain(img, ids, gx, gy, padding_mode)
        ctx.save_for_backward(gx, gy, ids)
        ctx.padding_mode = padding_mode
        ctx.img_shape = img.shape
        ctx.img_dtype = img.dtype
        return out

    @staticmethod
    def backward(ctx, ct):
        gx, gy, ids = ctx.saved_tensors
        U, _, H, W = ctx.img_shape
        ly, lx, a0, a1, c0, c1 = (
            f.contiguous() for f in sampling.factors((H, W), gx, gy, ctx.padding_mode))
        grad = bilinear_splat(
            ct.contiguous(), ly, lx, a0, a1, c0, c1, (H, W), ids, U,
            out_dtype=ctx.img_dtype,
        )
        return grad, None, None, None, None


def grid_sample_frozen_grid(img, gx, gy, padding_mode: str = "border", ids=None):
    """Sample (U, C, H, W) `img` at frozen coordinate planes gx, gy (N, Ho,
    Wo) -> (N, C, Ho, Wo) in the img dtype, with a gradient to the image
    only. With `ids` (int32 (N,)), use k samples img[ids[k]] and the
    backward sums each plane's uses; on the card that takes border mode
    (the fusion warp's). The bases and weights are built only in the
    backward, so a call under torch.no_grad() builds none."""
    if ids is not None and padding_mode != "border" and cuda.use_kernel(img):
        raise ValueError(f"the table sample on the card is border-only, not {padding_mode}")
    gx = gx.detach().float().contiguous()
    gy = gy.detach().float().contiguous()
    return _FrozenGridSample.apply(img.contiguous(), gx, gy, padding_mode, ids)
