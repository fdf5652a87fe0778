"""Kernel 5, `bilinear_sample_table` (csrc/fwarp.cu): border-mode bilinear
sampling of N uses from a table of U unique planes, gathered and combined in
one pass, replacing the TPU table-gather kernel of
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
from mono_vifi_tpu_torch.ops.sampling import combine_taps

_DTYPES = (torch.float32, torch.bfloat16)


def bilinear_sample_table_plain(table, ids, ly, lx, a0, a1, c0, c1):
    """Plain version: gather the used planes, take their four taps, combine
    them in f32 and cast to the table's dtype."""
    src = table if ids is None else table.index_select(0, ids.long())
    return combine_taps(bilinear_taps_plain(src, ly, lx), a0, a1, c0, c1).to(table.dtype)


def bilinear_sample_table(table, ids, ly, lx, a0, a1, c0, c1):
    """out[k] = bilinear sample of table[ids[k]] (U, C, H, W) at the int32
    bases ly, lx (N, Ho, Wo), pre-clamped to [0, H-2] x [0, W-2], with the
    f32 separable weights a0, a1 (rows) and c0, c1 (columns) -> (N, C, Ho,
    Wo) in the table's dtype, no gradient. ids (N,) int32, or None for
    N == U (use k reads plane k)."""
    if not cuda.use_kernel(table):
        with torch.no_grad():
            return bilinear_sample_table_plain(table, ids, ly, lx, a0, a1, c0, c1)
    dev = table.device
    cuda.check(table, "table", _DTYPES, 4, dev)
    for name, t in (("ly", ly), ("lx", lx)):
        cuda.check(t, name, (torch.int32,), 3, dev)
    for name, t in (("a0", a0), ("a1", a1), ("c0", c0), ("c1", c1)):
        cuda.check(t, name, (torch.float32,), 3, dev)
    U, C, H, W = table.shape
    N, Ho, Wo = ly.shape
    for t in (lx, a0, a1, c0, c1):
        if t.shape != ly.shape:
            raise ValueError(f"plane {tuple(t.shape)} does not match bases {tuple(ly.shape)}")
    if ids is not None:
        cuda.check(ids, "ids", (torch.int32,), 1, dev)
        if ids.shape[0] != N:
            raise ValueError(f"ids has {ids.shape[0]} entries for {N} uses")
    elif N != U:
        raise ValueError(f"{N} uses of {U} planes need ids")
    if H < 2 or W < 2 or N > 65535:
        raise ValueError(f"table shape {tuple(table.shape)} with {N} uses not supported")
    out = torch.empty((N, C, Ho, Wo), dtype=table.dtype, device=dev)
    cuda.launch(
        "mv_bilinear_sample_table", "bilinear_sample_table",
        table.data_ptr(), cuda.DTYPE_CODE[table.dtype],
        ids.data_ptr() if ids is not None else None, ly.data_ptr(), lx.data_ptr(),
        a0.data_ptr(), a1.data_ptr(), c0.data_ptr(), c1.data_ptr(), out.data_ptr(),
        N, C, H, W, Ho, Wo, U, shape=table.shape,
    )
    return out
