"""Bytes of one launch of each of the port's six kernels, from its call's
shapes: each input read once and each output written once, whatever the
kernel reads again. The arguments are those the port hands its C entry
point (`ops/cuda/__init__.py` `launch`): pointers, dtype codes (0 f32, 1
bf16) and sizes, in the entry point's order. A launch of an entry point
not known here counts None."""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
_F32 = 4
_SIZE = {0: 4, 1: 2}  # dtype code -> bytes


def bilinear_sample(a):
    # img, dt, tap dt, gx, gy, out, B, C, H, W, Ho, Wo, mode, align
    dt, (B, C, H, W, Ho, Wo) = a[1], a[6:12]
    e = _SIZE[dt]
    return B * C * H * W * e + 2 * B * Ho * Wo * _F32 + B * C * Ho * Wo * e


def bilinear_sample_bwd(a):
    # img, dt, tap dt, gx, gy, ct, dgx, dgy, B, C, H, W, Ho, Wo, align
    dt, (B, C, H, W, Ho, Wo) = a[1], a[8:14]
    e = _SIZE[dt]
    return B * C * H * W * e + B * C * Ho * Wo * e + 4 * B * Ho * Wo * _F32


def ssim_l1_fwd(a):
    # x, y, out, N, C, H, W, use_ssim
    N, C, H, W = a[3:7]
    return 2 * N * C * H * W * _F32 + N * H * W * _F32


def ssim_l1_bwd(a):
    # x, y, ct, dx, N, C, H, W, use_ssim
    N, C, H, W = a[4:8]
    return 3 * N * C * H * W * _F32 + N * H * W * _F32


def bilinear_splat(a):
    # ct, ct dt, ly, lx, a0, a1, c0, c1, ids, out, out dt, scratch,
    # N, C, Ho, Wo, U, H, W, cg
    ct_dt, ids, out_dt = a[1], a[8], a[10]
    N, C, Ho, Wo, U, H, W = a[12:19]
    return (N * C * Ho * Wo * _SIZE[ct_dt] + 6 * N * Ho * Wo * _F32
            + (N * 4 if ids else 0) + U * C * H * W * _SIZE[out_dt])


def bilinear_sample_table(a):
    # table, dt, ids, gx, gy, out, N, C, H, W, Ho, Wo, U, by_plane
    dt, ids = a[1], a[2]
    N, C, H, W, Ho, Wo, U = a[6:13]
    e = _SIZE[dt]
    return (U * C * H * W * e + (N * 4 if ids else 0) + 2 * N * Ho * Wo * _F32
            + N * C * Ho * Wo * e)


BY_ENTRY = {
    "mv_bilinear_sample": bilinear_sample,
    "mv_bilinear_sample_bwd": bilinear_sample_bwd,
    "mv_ssim_l1_fwd": ssim_l1_fwd,
    "mv_ssim_l1_bwd": ssim_l1_bwd,
    "mv_bilinear_splat": bilinear_splat,
    "mv_bilinear_sample_table": bilinear_sample_table,
}


def launch_bytes(entry: str, args) -> int | None:
    count = BY_ENTRY.get(entry)
    return None if count is None else count(args)


def bound_seconds(launches) -> float | None:
    """The least time the launches could take at the card's memory
    bandwidth; None where a launch is of an entry point not known here."""
    total = 0
    for entry, args in launches:
        b = launch_bytes(entry, args)
        if b is None:
            return None
        total += b
    return total / PEAK_BYTES_PER_S
