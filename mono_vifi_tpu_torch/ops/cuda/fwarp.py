"""Kernel 5, `bilinear_sample_table` (csrc/fwarp.cu): border-mode bilinear
sampling of N uses from a table of U unique planes at f32 coordinate planes,
gathered and combined in one pass, replacing the TPU table-gather kernel of
mono_vifi_tpu/ops/pallas/fwarp.py (`grid_sample_table_resident`).

It is the forward of the fusion table warp (ops/cuda/splat.py
`grid_sample_frozen_grid` with `ids`), on the training step and on the
multi-frame inference path. The samples carry no gradient: the table's
gradient is the splat kernel's, and the grid is frozen (every table warp's
flow is the frozen VFI flow, so no path asks for the grid gradient that the
JAX function also provides).
"""

from __future__ import annotations

import torch

from mono_vifi_tpu_torch.ops import cuda
from mono_vifi_tpu_torch.ops.cuda.warp import bilinear_taps_plain
from mono_vifi_tpu_torch.ops.sampling import combine_taps, factors

_DTYPES = (torch.float32, torch.bfloat16)

# a table larger than a third of the H100's 50 MB L2 is walked a plane a
# block, so that a plane's uses follow each other while it is in L2
BY_PLANE_BYTES = 50 * 2**20 // 3


def table_by_plane(nbytes, ids, num_planes):
    """Whether a table launch walks the uses a plane a block rather than a
    use a block: with more uses (ids) than planes, so that some plane is
    read twice, and a table of more than BY_PLANE_BYTES. A small table
    stays in L2 either way, and a block a use gives twice the blocks."""
    return ids is not None and ids.shape[0] > num_planes and nbytes > BY_PLANE_BYTES


def bilinear_sample_table_plain(table, ids, gx, gy, padding_mode="border"):
    """Plain version: the bases and weights (`factors`, align_corners=True),
    gather the used planes, take their four taps, combine them in f32 and
    cast to the table's dtype. `padding_mode` serves the CPU path of
    `grid_sample_frozen_grid`; the kernel is border-only."""
    ly, lx, a0, a1, c0, c1 = factors(table.shape[2:], gx, gy, padding_mode)
    src = table if ids is None else table.index_select(0, ids.long())
    return combine_taps(bilinear_taps_plain(src, ly, lx), a0, a1, c0, c1).to(table.dtype)


def bilinear_sample_table(table, ids, gx, gy):
    """out[k] = bilinear sample (align_corners=True, border padding) of
    table[ids[k]] (U, C, H, W) at the normalized f32 coordinate planes
    gx[k], gy[k] (N, Ho, Wo) -> (N, C, Ho, Wo) in the table's dtype, no
    gradient. ids (N,) int32, or None for N == U (use k reads plane k)."""
    if not cuda.use_kernel(table):
        with torch.no_grad():
            return bilinear_sample_table_plain(table, ids, gx, gy)
    dev = table.device
    cuda.check(table, "table", _DTYPES, 4, dev)
    cuda.check(gx, "gx", (torch.float32,), 3, dev)
    cuda.check(gy, "gy", (torch.float32,), 3, dev)
    U, C, H, W = table.shape
    N, Ho, Wo = gx.shape
    if gy.shape != gx.shape:
        raise ValueError(f"gy {tuple(gy.shape)} does not match gx {tuple(gx.shape)}")
    if ids is not None:
        cuda.check(ids, "ids", (torch.int32,), 1, dev)
        if ids.shape[0] != N:
            raise ValueError(f"ids has {ids.shape[0]} entries for {N} uses")
    elif N != U:
        raise ValueError(f"{N} uses of {U} planes need ids")
    if H < 2 or W < 2 or U > 65535 or N > 65535:
        raise ValueError(f"table shape {tuple(table.shape)} with {N} uses not supported")
    by_plane = table_by_plane(table.numel() * table.element_size(), ids, U)
    out = torch.empty((N, C, Ho, Wo), dtype=table.dtype, device=dev)
    cuda.launch(
        "mv_bilinear_sample_table", "bilinear_sample_table",
        table.data_ptr(), cuda.DTYPE_CODE[table.dtype],
        ids.data_ptr() if ids is not None else None, gx.data_ptr(), gy.data_ptr(),
        out.data_ptr(), N, C, H, W, Ho, Wo, U, int(by_plane), shape=table.shape,
    )
    return out
