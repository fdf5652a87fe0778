"""Each hand-written kernel's plain PyTorch version (what the CPU runs, and
what chip_smoke.py holds the kernel against on the card) against the JAX
package's Pallas kernel in interpret mode, as the JAX package's own tests
run it (tests/test_pallas_warp.py, tests/test_pallas_photometric.py,
tests/test_splat.py), and against its exact XLA oracles.

Tolerances (f32): taps exact (both fetch the same values; bf16 taps round
the same way); the fused sample atol 1e-5 against the Pallas path (XLA
combines in its own order) and bit for bit against the unfused arithmetic
it replaced; the grid gradient atol 1e-4 against JAX (sums in another
order, scaled by up to (size - 1) / 2); photometric map atol 2e-6 and its
gradient atol 1e-6, as
the JAX package's kernel tests; splat vs the exact XLA scatter atol 1e-5,
vs the Pallas splat atol 1e-1 / rtol 1e-2 (the TPU kernel rounds its tap
weights to bf16, tests/test_splat.py); image gradients atol 1e-5.

The same kernels on the card, against their plain versions, are in
tests/test_torch_kernels_gpu.py.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mono_vifi_tpu.ops import sampling as JS
from mono_vifi_tpu.ops.pallas import photometric as JPM
from mono_vifi_tpu.ops.pallas import splat as JSP
from mono_vifi_tpu.ops.pallas import warp as JW
from mono_vifi_tpu_torch.ops import cuda
from mono_vifi_tpu_torch.ops import sampling as TS
from mono_vifi_tpu_torch.ops.cuda import photometric as PM
from mono_vifi_tpu_torch.ops.cuda import splat as SP
from mono_vifi_tpu_torch.ops.cuda import warp as WP

RNG = np.random.default_rng(31)


def rand(*shape, lo=0.0, hi=1.0, rng=RNG):
    return (lo + (hi - lo) * rng.random(shape)).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def smooth_grid(B, H, W, dx=30.0, dy=8.0, scale=1.0, rng=RNG):
    """View-synthesis-like (B, H, W, 2) grid: slowly varying displacements."""
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    out = []
    for _ in range(B):
        ph = rng.uniform(0, 2 * np.pi, 4)
        ddx = dx * (0.5 * np.sin(2 * np.pi * ys / H + ph[0]) + 0.5 * np.cos(2 * np.pi * xs / W + ph[1]))
        ddy = dy * (0.5 * np.sin(2 * np.pi * xs / W + ph[2]) + 0.5 * np.cos(2 * np.pi * ys / H + ph[3]))
        out.append(np.stack([(xs + ddx) / (W - 1) * 2 - 1, (ys + ddy) / (H - 1) * 2 - 1], -1))
    return (np.stack(out) * scale).astype(np.float32)


# ----------------------------------------- 1: bilinear_sample (+ its bwd)

@pytest.mark.parametrize("tap_dtype", [None, "bfloat16"])
def test_taps_match_pallas_tap_kernel(tap_dtype):
    """Plain taps == the four taps of `_warp_taps_kernel` (f32) and of the
    pair-packed `_warp_taps_kernel_packed` (bf16), at the same bases."""
    B, H, W, C = 2, 64, 384, 3
    img = rand(B, H, W, C)
    grid = smooth_grid(B, H, W)
    y0, x0 = JW._source_coords(img.shape, jnp.asarray(grid))
    jdt = None if tap_dtype is None else jnp.bfloat16
    ref = JW._windowed_taps4(jnp.asarray(img), y0, x0, (56, 384), jdt, True)
    ref = np.stack([np.asarray(r, np.float32) for r in ref], 2)  # (B, C, 4, H, W)
    tdt = None if tap_dtype is None else torch.bfloat16
    got = WP.bilinear_taps_plain(t(img).permute(0, 3, 1, 2),
                                 t(np.asarray(y0)), t(np.asarray(x0)), tdt)
    np.testing.assert_array_equal(got.float().numpy(), ref)


# the port's sample: the autograd entry (sample_planar -> the Function) and
# the kernel's plain version, held against the JAX package on the same inputs
SAMPLERS = (
    lambda img, gx, gy, mode, td: TS.sample_planar(img, gx, gy, mode, tap_dtype=td),
    lambda img, gx, gy, mode, td: WP.bilinear_sample_plain(img, gx, gy, mode, tap_dtype=td),
)


@pytest.mark.parametrize("tap_dtype", [None, "bfloat16"])
def test_border_sample_matches_windowed_warp(tap_dtype):
    B, H, W, C = 2, 64, 384, 3
    img, grid = rand(B, H, W, C), smooth_grid(B, H, W)
    jdt = None if tap_dtype is None else jnp.bfloat16
    ref = JW.grid_sample_windowed(jnp.asarray(img), jnp.asarray(grid), interpret=True,
                                  tap_dtype=jdt, planar=True)
    for sampler in SAMPLERS:
        got = sampler(t(img).permute(0, 3, 1, 2), t(grid[..., 0]), t(grid[..., 1]),
                      "border", None if jdt is None else torch.bfloat16)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_zeros_sample_matches_windowed_zeros():
    B, H, W, C = 2, 64, 384, 3
    img, grid = rand(B, H, W, C), smooth_grid(B, H, W, scale=1.1)
    for jdt, tdt in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        ref = JW.grid_sample_windowed_zeros(jnp.asarray(img), jnp.asarray(grid),
                                            interpret=True, tap_dtype=jdt)
        for sampler in SAMPLERS:
            got = sampler(t(img).permute(0, 3, 1, 2), t(grid[..., 0]), t(grid[..., 1]),
                          "zeros", tdt)
            np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                                       atol=1e-5)


def _check_grid_gradient(B, H, W, displacement, scale, align, reference, tap_dtype, rng):
    C = 3
    img = rand(B, H, W, C, rng=rng)
    grid = smooth_grid(B, H, W, *displacement, scale=scale, rng=rng)
    ct = rand(B, C, H, W, lo=-1, hi=1, rng=rng)
    if reference == "exact":
        _, vjp = jax.vjp(lambda g: JS.grid_sample(jnp.asarray(img), g, align_corners=align),
                         jnp.asarray(grid))
        (ref,) = vjp(jnp.asarray(np.moveaxis(ct, 1, -1)))
        ref_x, ref_y = np.asarray(ref)[..., 0], np.asarray(ref)[..., 1]
    else:
        def loss(gx, gy):
            out = JW.grid_sample_windowed_planar(jnp.asarray(img), gx, gy, interpret=True,
                                                 planar=True, tap_dtype=tap_dtype)
            return jnp.sum(out * jnp.asarray(ct))

        ref_x, ref_y = jax.grad(loss, argnums=(0, 1))(jnp.asarray(grid[..., 0]),
                                                      jnp.asarray(grid[..., 1]))
    gx = t(grid[..., 0]).requires_grad_(True)
    gy = t(grid[..., 1]).requires_grad_(True)
    out = TS.sample_planar(t(img).permute(0, 3, 1, 2), gx, gy, align_corners=align,
                           tap_dtype=None if tap_dtype is None else torch.bfloat16)
    out.backward(t(ct))
    np.testing.assert_allclose(gx.grad.numpy(), np.asarray(ref_x), atol=1e-4)
    np.testing.assert_allclose(gy.grad.numpy(), np.asarray(ref_y), atol=1e-4)
    return grid, gx.grad.numpy(), gy.grad.numpy()


def test_sample_grid_gradient_matches_exact_sampler():
    """The taps carry no gradient; the grid's gradient through the weights
    (the Function's backward, `bilinear_sample_bwd`'s plain version here)
    equals jax.vjp of the exact sampler (the image's is not asked for), on a
    smooth grid, a ragged shape, a grid a third of which lies past the
    border (where the clamp passes no gradient), align_corners=False, and
    jax.grad through the Pallas tap kernels themselves (interpret mode, f32
    and bf16 taps)."""
    _check_grid_gradient(1, 24, 40, (5.0, 3.0), 1.0, True, "exact", None, RNG)
    # the added cases draw from their own generator, so that every later
    # test of this file keeps its inputs
    rng = np.random.default_rng(95)
    _check_grid_gradient(2, 17, 33, (5.0, 3.0), 1.0, True, "exact", None, rng)
    grid, dgx, dgy = _check_grid_gradient(2, 17, 33, (5.0, 3.0), 1.3, True, "exact",
                                          None, rng)
    outside = np.abs(grid) > 1.0
    assert outside[..., 0].any() and not dgx[outside[..., 0]].any()
    assert outside[..., 1].any() and not dgy[outside[..., 1]].any()
    _check_grid_gradient(2, 17, 33, (5.0, 3.0), 1.05, False, "exact", None, rng)
    for tap_dtype in (None, jnp.bfloat16):
        _check_grid_gradient(1, 64, 384, (30.0, 8.0), 1.0, True, "pallas", tap_dtype, rng)


def _unfused_sample(img, gx, gy, mode, tap_dtype):
    """The arithmetic the fused sample replaced: factors, taps without a
    gradient, the f32 combine, the cast to the img dtype."""
    f = TS.factors(img.shape[2:], gx, gy, mode)
    with torch.no_grad():
        taps = WP.bilinear_taps_plain(img, f[0], f[1], tap_dtype)
    return TS.combine_taps(taps, *f[2:]).to(img.dtype)


@pytest.mark.parametrize("mode", ["border", "zeros"])
@pytest.mark.parametrize("img_dtype,tap_dtype", [
    (torch.float32, None), (torch.float32, torch.bfloat16), (torch.bfloat16, None),
])
def test_sample_function_equals_the_unfused_arithmetic(mode, img_dtype, tap_dtype):
    """On CPU tensors the Function behind sample_planar equals taps + combine
    bit for bit, and its grid gradient equals autograd of that arithmetic
    bit for bit (border mode; zeros mode takes no grid gradient)."""
    B, H, W, C = 2, 17, 33, 3
    rng = np.random.default_rng(17)
    img = t(rand(B, C, H, W, rng=rng)).to(img_dtype)
    grid = smooth_grid(B, H, W, 5.0, 3.0, scale=1.1, rng=rng)
    ct = t(rand(B, C, H, W, lo=-1, hi=1, rng=rng)).to(img_dtype)
    ref = _unfused_sample(img, t(grid[..., 0]), t(grid[..., 1]), mode, tap_dtype)
    for got in (TS.sample_planar(img, t(grid[..., 0]), t(grid[..., 1]), mode, tap_dtype=tap_dtype),
                WP.bilinear_sample(img, t(grid[..., 0]), t(grid[..., 1]), mode,
                                   tap_dtype=tap_dtype)):
        assert got.dtype == img_dtype
        assert torch.equal(got, ref)
    if mode == "zeros":
        return
    grads = []
    for fn in (TS.sample_planar, _unfused_sample):
        gx = t(grid[..., 0]).requires_grad_(True)
        gy = t(grid[..., 1]).requires_grad_(True)
        fn(img, gx, gy, "border", tap_dtype=tap_dtype).backward(ct)
        grads.append((gx.grad, gy.grad))
    assert torch.equal(grads[0][0], grads[1][0]) and torch.equal(grads[0][1], grads[1][1])
    dgx, dgy = WP.bilinear_sample_bwd(img, t(grid[..., 0]), t(grid[..., 1]), ct,
                                      tap_dtype=tap_dtype)
    assert torch.equal(dgx, grads[1][0]) and torch.equal(dgy, grads[1][1])


def test_zeros_sample_refuses_a_grid_that_requires_a_gradient():
    """Zeros mode is forward only: its callers pass frozen angles."""
    img = torch.rand(1, 3, 8, 8)
    gx = (torch.rand(1, 8, 8) * 2 - 1).requires_grad_(True)
    gy = torch.rand(1, 8, 8) * 2 - 1
    with pytest.raises(ValueError, match="frozen grid"):
        TS.sample_planar(img, gx, gy, "zeros")
    with torch.no_grad():
        assert TS.sample_planar(img, gx, gy, "zeros").shape == (1, 3, 8, 8)
    assert not TS.sample_planar(img, gx.detach(), gy, "zeros").requires_grad


# ------------------------------------------------- 2, 3: ssim_l1_fwd / bwd

@pytest.fixture(scope="module")
def planes():
    return rand(3, 3, 24, 256), rand(3, 3, 24, 256)


@pytest.mark.parametrize("use_ssim", [True, False])
def test_photometric_forward_matches_pallas(planes, use_ssim):
    x, y = planes
    ref = JPM.ssim_l1_map(jnp.asarray(x), jnp.asarray(y), use_ssim, True)
    np.testing.assert_allclose(PM.ssim_l1_fwd(t(x), t(y), use_ssim).numpy(),
                               np.asarray(ref), atol=2e-6)
    nograd = PM.ssim_l1_map_nograd(t(x), t(y), use_ssim)
    np.testing.assert_allclose(nograd.numpy(), np.asarray(ref), atol=2e-6)


@pytest.mark.parametrize("use_ssim", [True, False])
def test_photometric_gradient_matches_pallas(planes, use_ssim):
    """dx of the plain version (and of `ssim_l1_map`'s autograd path) ==
    the Pallas `_bwd_kernel`, reached through jax.vjp."""
    x, y = planes
    ct = rand(3, 24, 256, lo=-1, hi=1)
    _, vjp = jax.vjp(lambda a: JPM.ssim_l1_map(a, jnp.asarray(y), use_ssim, True),
                     jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(ct))
    np.testing.assert_allclose(PM.ssim_l1_bwd(t(x), t(y), t(ct), use_ssim).numpy(),
                               np.asarray(ref), atol=1e-6)
    xr = t(x).requires_grad_(True)
    PM.ssim_l1_map(xr, t(y), use_ssim).backward(t(ct))
    np.testing.assert_allclose(xr.grad.numpy(), np.asarray(ref), atol=1e-6)


# ---------------------------------------------------- 4: bilinear_splat

def _splat_inputs(B, H, W, C, mode="border"):
    grid = smooth_grid(B, H, W, 20.0, 3.0, scale=1.0 if mode == "border" else 1.1)
    f = (JSP._border_factors if mode == "border" else JSP._zeros_factors)((H, W), jnp.asarray(grid))
    ct = RNG.standard_normal((B, H, W, C)).astype(np.float32)
    return grid, [np.asarray(v) for v in f], ct


def _port_splat(ct, f, hw, ids=None, U=None):
    ly, lx, a0, a1, c0, c1 = (t(v) for v in f)
    out = SP.bilinear_splat(t(ct).permute(0, 3, 1, 2), ly.int(), lx.int(), a0, a1, c0, c1,
                            hw, None if ids is None else torch.tensor(ids, dtype=torch.int32), U)
    return out.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("C", [5, 1])
def test_splat_matches_xla_and_pallas(C):
    """C > 1 meets `_splat_band_kernel`, C == 1 `_splat_band_kernel1`."""
    B, H, W = 2, 24, 130
    _, f, ct = _splat_inputs(B, H, W, C)
    got = _port_splat(ct, f, (H, W))
    ref = JSP._xla_splat(jnp.asarray(ct), *(jnp.asarray(v) for v in f), (H, W))
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5)
    pal = JSP.bilinear_splat(jnp.asarray(ct), *(jnp.asarray(v) for v in f), (H, W),
                             interpret=True)
    np.testing.assert_allclose(got, np.asarray(pal), atol=1e-1, rtol=1e-2)


def test_splat_with_ids_sums_each_unique_planes_uses():
    """ids send use k into plane ids[k]: equal to per-use splats summed per
    unique, as the JAX package's table-warp backward does."""
    B, H, W, C = 6, 16, 40, 3
    ids = [1, 1, 0, 2, 0, 2]
    _, f, ct = _splat_inputs(B, H, W, C)
    got = _port_splat(ct, f, (H, W), ids, 3)
    args = (jnp.asarray(ct), *(jnp.asarray(v) for v in f), (H, W))
    for per_use, atol, rtol in ((JSP._xla_splat(*args), 1e-5, 0.0),
                                (JSP.bilinear_splat(*args, interpret=True), 1e-1, 1e-2)):
        per_use = np.asarray(per_use)
        ref = np.stack([per_use[[k for k, u in enumerate(ids) if u == p]].sum(0)
                        for p in range(3)])
        np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol)


@pytest.mark.parametrize("C,H,W,U", [
    (64, 96, 320, 30), (64, 48, 160, 30), (128, 24, 80, 30), (256, 12, 40, 30),
    (512, 6, 20, 30),     # the fusion levels, 60 uses onto 30 planes
    (1, 192, 640, 30),    # the SADC restore
    (5, 17, 131, 3),      # ragged
    (3, 2, 2, 2),         # the smallest plane
])
def test_splat_channel_group_fits_the_launch(C, H, W, U):
    """The splat's channel group: no larger than C, halved only while the
    launch of 8 x 32-cell tiles has fewer than MIN_BLOCKS blocks, and never
    below 8 channels. One channel takes the direct path (0)."""
    cg = SP.splat_channel_group(C, H, W, U)
    if C == 1:
        assert cg == 0
        return
    blocks = SP.splat_tiles(H, W) * U * -(-C // cg)
    assert 1 <= cg <= C and (cg >= 8 or cg == C)
    assert cg == C or blocks >= SP.MIN_BLOCKS // 2
    assert blocks >= SP.MIN_BLOCKS or cg <= 8 or cg == C


def test_splat_tile_is_the_kernels():
    """The wrapper sizes the bins' scratch by TILE_H x TILE_W: the tile that
    csrc/splat.cu fixes (log2 sizes kLth, kLtw; a cell a thread of 256)."""
    import re

    src = (Path(SP.__file__).parents[2] / "csrc" / "splat.cu").read_text()
    lth, ltw = map(int, re.search(r"constexpr int kLth = (\d+), kLtw = (\d+);", src).groups())
    assert (SP.TILE_H, SP.TILE_W) == (1 << lth, 1 << ltw)
    assert SP.TILE_H * SP.TILE_W == 256
    assert SP.splat_tiles(96, 320) == 12 * 10 and SP.splat_tiles(6, 20) == 1
    assert SP.splat_tiles(17, 131) == 3 * 5


@pytest.mark.parametrize("U,C,H,W,esize,with_ids,expected", [
    (30, 64, 96, 320, 2, True, True), (30, 64, 48, 160, 2, True, True),
    (30, 128, 24, 80, 2, True, False), (30, 256, 12, 40, 2, True, False),
    (30, 512, 6, 20, 2, True, False),       # the fusion levels (60 uses), bf16
    (12, 64, 96, 320, 4, False, False),     # multi-frame: 8 uses of 12 planes
    (30, 64, 96, 320, 2, None, False),      # no ids: a use a block
])
def test_table_by_plane_follows_uses_and_table_size(U, C, H, W, esize, with_ids, expected):
    """The table launch walks a plane a block only with more uses than
    planes and a table larger than a third of the L2 (the fusion's levels 0
    and 1); the deep levels' small tables, and the multi-frame path, whose
    planes are each read once, take a use a block."""
    from mono_vifi_tpu_torch.ops.cuda import fwarp as FW

    nbytes = U * C * H * W * esize
    ids = None if with_ids is None else torch.zeros(2 * U if with_ids else U - 4,
                                                    dtype=torch.int32)
    assert FW.table_by_plane(nbytes, ids, U) == expected
    assert expected == bool(with_ids and nbytes > FW.BY_PLANE_BYTES)


@pytest.mark.parametrize("out_dtype", [None, torch.bfloat16])
def test_cpu_splat_returns_the_plain_sums_in_the_requested_dtype(out_dtype):
    """On CPU tensors the wrapper returns the plain version's f32 sums, cast
    to out_dtype (f32 by default), as the kernel writes them on the card."""
    B, H, W, C = 6, 16, 40, 3
    ids = torch.tensor([1, 1, 0, 2, 0, 2], dtype=torch.int32)
    rng = np.random.default_rng(5)
    grid = smooth_grid(B, H, W, 20.0, 3.0, rng=rng)
    ly, lx, a0, a1, c0, c1 = (t(v) for v in JSP._border_factors((H, W), jnp.asarray(grid)))
    ct = t(rng.standard_normal((B, C, H, W)).astype(np.float32))
    args = (ct, ly.int(), lx.int(), a0, a1, c0, c1, (H, W), ids, 3)
    got = SP.bilinear_splat(*args, out_dtype=out_dtype)
    ref = SP.bilinear_splat_plain(*args)
    assert got.dtype == (out_dtype or torch.float32) and got.shape == (3, C, H, W)
    assert torch.equal(got, ref.to(got.dtype))


@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_frozen_grid_image_gradient_matches_exact_sampler(mode):
    """grid_sample_frozen_grid (taps forward, splat backward) with a use ->
    plane table: values and image gradient == jax.vjp of the exact sampler
    on the gathered planes."""
    U, H, W, C = 3, 16, 40, 4
    ids = [1, 1, 0, 2, 0, 2]
    table = rand(U, H, W, C)
    grid = smooth_grid(len(ids), H, W, 6.0, 2.0, scale=1.0 if mode == "border" else 1.1)
    ct = rand(len(ids), H, W, C, lo=-1, hi=1)

    def f(tab):
        return JS.grid_sample(tab[jnp.asarray(ids)], jnp.asarray(grid), mode)

    ref, vjp = jax.vjp(f, jnp.asarray(table))
    (dref,) = vjp(jnp.asarray(ct))
    tab = t(table).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    out = SP.grid_sample_frozen_grid(tab, t(grid[..., 0]), t(grid[..., 1]), mode,
                                     torch.tensor(ids, dtype=torch.int32))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(), np.asarray(ref), atol=1e-5)
    out.backward(t(ct).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tab.grad.permute(0, 2, 3, 1).numpy(), np.asarray(dref), atol=1e-5)


# -------------------------------------------------------------- dispatch

def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    cuda.reset_launch_counts()
    img = torch.rand(1, 3, 8, 8)
    ly = torch.zeros(1, 8, 8, dtype=torch.int32)
    WP.bilinear_taps_plain(img, ly, ly)
    g = torch.rand(1, 8, 8) * 2 - 1
    WP.bilinear_sample(img, g, g)
    WP.bilinear_sample(img, g, g, "zeros", tap_dtype=torch.bfloat16)
    WP.bilinear_sample_bwd(img, g, g, torch.rand(1, 3, 8, 8))
    PM.ssim_l1_fwd(img, img)
    PM.ssim_l1_bwd(img, img, torch.rand(1, 8, 8))
    w = torch.rand(1, 8, 8)
    SP.bilinear_splat(img, ly, ly, w, w, w, w, (8, 8))
    assert all(v == 0 for v in cuda.LAUNCHES.values())
