"""Each hand-written kernel's plain PyTorch version (what the CPU runs, and
what chip_smoke.py holds the kernel against on the card) against the JAX
package's Pallas kernel in interpret mode, as the JAX package's own tests
run it (tests/test_pallas_warp.py, tests/test_pallas_photometric.py,
tests/test_splat.py), and against its exact XLA oracles.

Tolerances (f32): taps exact (both fetch the same values; bf16 taps round
the same way); photometric map atol 2e-6 and its gradient atol 1e-6, as
the JAX package's kernel tests; splat vs the exact XLA scatter atol 1e-5,
vs the Pallas splat atol 1e-1 / rtol 1e-2 (the TPU kernel rounds its tap
weights to bf16, tests/test_splat.py); image gradients atol 1e-5.

The same kernels on the card, against their plain versions, are in
tests/test_torch_kernels_gpu.py.
"""

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


def rand(*shape, lo=0.0, hi=1.0):
    return (lo + (hi - lo) * RNG.random(shape)).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def smooth_grid(B, H, W, dx=30.0, dy=8.0, scale=1.0):
    """View-synthesis-like (B, H, W, 2) grid: slowly varying displacements."""
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    out = []
    for _ in range(B):
        ph = RNG.uniform(0, 2 * np.pi, 4)
        ddx = dx * (0.5 * np.sin(2 * np.pi * ys / H + ph[0]) + 0.5 * np.cos(2 * np.pi * xs / W + ph[1]))
        ddy = dy * (0.5 * np.sin(2 * np.pi * xs / W + ph[2]) + 0.5 * np.cos(2 * np.pi * ys / H + ph[3]))
        out.append(np.stack([(xs + ddx) / (W - 1) * 2 - 1, (ys + ddy) / (H - 1) * 2 - 1], -1))
    return (np.stack(out) * scale).astype(np.float32)


# ------------------------------------------------------- 1: bilinear_taps

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
    got = WP.bilinear_taps(t(img).permute(0, 3, 1, 2),
                           t(np.asarray(y0)), t(np.asarray(x0)), tdt)
    np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("tap_dtype", [None, "bfloat16"])
def test_border_sample_matches_windowed_warp(tap_dtype):
    B, H, W, C = 2, 64, 384, 3
    img, grid = rand(B, H, W, C), smooth_grid(B, H, W)
    jdt = None if tap_dtype is None else jnp.bfloat16
    ref = JW.grid_sample_windowed(jnp.asarray(img), jnp.asarray(grid), interpret=True,
                                  tap_dtype=jdt, planar=True)
    got = TS.sample_planar(t(img).permute(0, 3, 1, 2), t(grid[..., 0]), t(grid[..., 1]),
                           "border", tap_dtype=None if jdt is None else torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_zeros_sample_matches_windowed_zeros():
    B, H, W, C = 2, 64, 384, 3
    img, grid = rand(B, H, W, C), smooth_grid(B, H, W, scale=1.1)
    ref = JW.grid_sample_windowed_zeros(jnp.asarray(img), jnp.asarray(grid), interpret=True)
    got = TS.sample_planar(t(img).permute(0, 3, 1, 2), t(grid[..., 0]), t(grid[..., 1]), "zeros")
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-5)


def test_sample_grid_gradient_matches_exact_sampler():
    """The taps carry no gradient; the grid's gradient through the weights
    equals jax.vjp of the exact sampler (the image's is not asked for)."""
    B, H, W, C = 1, 24, 40, 3
    img, grid = rand(B, H, W, C), smooth_grid(B, H, W, 5.0, 3.0)
    ct = rand(B, C, H, W, lo=-1, hi=1)
    _, vjp = jax.vjp(lambda g: JS.grid_sample(jnp.asarray(img), g), jnp.asarray(grid))
    (ref,) = vjp(jnp.asarray(np.moveaxis(ct, 1, -1)))
    gx = t(grid[..., 0]).requires_grad_(True)
    gy = t(grid[..., 1]).requires_grad_(True)
    out = TS.sample_planar(t(img).permute(0, 3, 1, 2), gx, gy)
    out.backward(t(ct))
    np.testing.assert_allclose(gx.grad.numpy(), np.asarray(ref)[..., 0], atol=1e-4)
    np.testing.assert_allclose(gy.grad.numpy(), np.asarray(ref)[..., 1], atol=1e-4)


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
    WP.bilinear_taps(img, ly, ly)
    PM.ssim_l1_fwd(img, img)
    PM.ssim_l1_bwd(img, img, torch.rand(1, 8, 8))
    w = torch.rand(1, 8, 8)
    SP.bilinear_splat(img, ly, ly, w, w, w, w, (8, 8))
    assert all(v == 0 for v in cuda.LAUNCHES.values())
