"""The port's ops (mono_vifi_tpu_torch/ops) against the JAX package's on the
same numpy inputs, on the CPU: geometry, grid sampling (values and both
gradients against jax.vjp), resizes, rotation, crop/place, the photometric
map, the smoothness losses and the SI-log loss.

Tolerance: atol 1e-5 in f32 unless a case says otherwise.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mono_vifi_tpu.ops import geometry as JG
from mono_vifi_tpu.ops import image as JI
from mono_vifi_tpu.ops import losses as JL
from mono_vifi_tpu.ops import sampling as JS
from mono_vifi_tpu_torch.ops import geometry as TG
from mono_vifi_tpu_torch.ops import image as TI
from mono_vifi_tpu_torch.ops import losses as TL
from mono_vifi_tpu_torch.ops import sampling as TS

RNG = np.random.default_rng(21)
ATOL = 1e-5


def rand(*shape, lo=0.0, hi=1.0):
    return (lo + (hi - lo) * RNG.random(shape)).astype(np.float32)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def nchw(x):
    return t(np.moveaxis(x, -1, 1))


def close(got, ref, atol=ATOL, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=rtol)


def intrinsics(B, H, W):
    K = np.zeros((B, 4, 4), np.float32)
    K[:, 0, 0], K[:, 1, 1] = 0.58 * W, 1.92 * H
    K[:, 0, 2], K[:, 1, 2] = 0.5 * W, 0.5 * H
    K[:, 2, 2] = K[:, 3, 3] = 1
    return K, np.linalg.pinv(K).astype(np.float32)


# ---------------------------------------------------------------- geometry

@pytest.mark.parametrize("invert", [False, True])
def test_transformation_from_parameters(invert):
    aa, tr = rand(5, 3, lo=-0.3, hi=0.3), rand(5, 3, lo=-1, hi=1)
    ref = JG.transformation_from_parameters(jnp.asarray(aa), jnp.asarray(tr), invert)
    close(TG.transformation_from_parameters(t(aa), t(tr), invert), ref)


def test_disp_to_depth_and_reprojection_grid():
    B, H, W = 2, 24, 40
    disp = rand(B, H, W, lo=0.05, hi=0.95)
    K, invK = intrinsics(B, H, W)
    T = np.asarray(JG.transformation_from_parameters(
        jnp.asarray(rand(B, 3, lo=-0.05, hi=0.05)), jnp.asarray(rand(B, 3, lo=-0.2, hi=0.2))
    ))
    _, jd = JG.disp_to_depth(jnp.asarray(disp), 0.1, 100.0)
    _, td = TG.disp_to_depth(t(disp), 0.1, 100.0)
    close(td, jd, rtol=1e-6)
    jgx, jgy = JG.reprojection_grid_planar(jd, jnp.asarray(K), jnp.asarray(invK), jnp.asarray(T))
    tgx, tgy = TG.reprojection_grid_planar(td, t(K), t(invK), t(T))
    close(tgx, jgx, atol=1e-4, rtol=1e-5)
    close(tgy, jgy, atol=1e-4, rtol=1e-5)


def test_conjugate_pose():
    pose = np.asarray(JG.transformation_from_parameters(
        jnp.asarray(rand(4, 3, lo=-0.1, hi=0.1)), jnp.asarray(rand(4, 3))
    ))
    c, s = np.cos(0.2), np.sin(0.2)
    Rc = np.tile(np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32), (4, 1, 1))
    close(TG.conjugate_pose(t(pose), t(Rc)), JG.conjugate_pose(jnp.asarray(pose), jnp.asarray(Rc)))


# ---------------------------------------------------------------- sampling

@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample_values_and_gradients(padding_mode, align_corners):
    img = rand(2, 9, 13, 3)
    grid = rand(2, 7, 11, 2, lo=-1.2, hi=1.2)
    ct = rand(2, 7, 11, 3, lo=-1, hi=1)
    ref, vjp = jax.vjp(
        lambda i, g: JS.grid_sample(i, g, padding_mode, align_corners),
        jnp.asarray(img), jnp.asarray(grid),
    )
    d_img, d_grid = vjp(jnp.asarray(ct))
    ti = t(img).requires_grad_(True)
    tg = t(grid).requires_grad_(True)
    out = TS.grid_sample(ti, tg, padding_mode, align_corners)
    close(out, ref)
    out.backward(t(ct))
    close(ti.grad, d_img)
    close(tg.grad, d_grid, atol=1e-4)


def test_warp_and_table_sampling():
    img = rand(3, 12, 16, 4)
    flow = rand(4, 12, 16, 2, lo=-3, hi=3)
    close(TS.warp(t(img[:1]).expand(4, -1, -1, -1), t(flow)),
          JS.warp(jnp.asarray(np.repeat(img[:1], 4, 0)), jnp.asarray(flow)))
    ids = (2, 0, 0, 1)
    gx, gy = TS.flow_to_grid(nchw(flow))
    grid = torch.stack([gx, gy], -1)
    ref = JS.grid_sample_table(jnp.asarray(img), ids, jnp.asarray(grid.numpy()))
    close(TS.grid_sample_table(t(img), ids, grid), ref)


# ---------------------------------------------------------------- image ops

@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("size", [(6, 10), (24, 36)])
def test_resize_bilinear(align_corners, size):
    x = rand(2, 12, 18, 3)
    ref = JI.resize_bilinear(jnp.asarray(x), size, align_corners)
    close(TI.resize_bilinear(nchw(x), size, align_corners), np.moveaxis(np.asarray(ref), -1, 1))


def test_rotate_bilinear_and_rotation_grid():
    img = rand(3, 16, 24, 2)
    angle = np.array([3.0, -4.5, 0.5], np.float32)
    ref = JI.rotate_bilinear(jnp.asarray(img), jnp.asarray(angle))
    close(TI.rotate_bilinear(nchw(img), t(angle)), np.moveaxis(np.asarray(ref), -1, 1))
    # the frozen-grid path (image gradient by the splat) gives the same values
    close(TI.rotate_bilinear(nchw(img), t(angle), grad_via_splat=True),
          np.moveaxis(np.asarray(ref), -1, 1))


@pytest.mark.parametrize("fn", ["batched_crop_resize", "batched_place_resize"])
def test_crop_and_place_resize(fn):
    img = rand(2, 12, 18, 3)
    box = np.array([[2, 1, 12, 8], [-1, 3, 10, 7]], np.float32)
    ref = getattr(JI, fn)(jnp.asarray(img), jnp.asarray(box))
    close(getattr(TI, fn)(nchw(img), t(box)), np.moveaxis(np.asarray(ref), -1, 1))


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize("use_ssim", [True, False])
def test_reprojection_loss_planar(use_ssim):
    x, y = rand(3, 3, 10, 14), rand(3, 3, 10, 14)
    ref = JL.reprojection_loss_planar(jnp.asarray(x), jnp.asarray(y), use_ssim)
    close(TL.reprojection_loss_planar(t(x), t(y), use_ssim), ref)
    moments = TL.target_moments_planar(t(y))
    close(TL.reprojection_loss_planar(t(x), t(y), use_ssim, moments), ref)


def test_smooth_losses():
    disp, img = rand(2, 10, 14), rand(2, 3, 10, 14)
    mask = (rand(2, 10, 14) > 0.7).astype(np.float32)
    close(TL.smooth_loss_planar(t(disp), t(img)),
          JL.smooth_loss_planar(jnp.asarray(disp), jnp.asarray(img)))
    close(TL.smooth_loss_dyn_planar(t(disp), t(img), t(mask)),
          JL.smooth_loss_dyn_planar(jnp.asarray(disp), jnp.asarray(img), jnp.asarray(mask)))


@pytest.mark.parametrize("masked", [False, True])
def test_si_log_depth_loss(masked):
    pred, tgt = rand(3, 10, 14, 1, lo=0.5, hi=50), rand(3, 10, 14, 1, lo=0.5, hi=50)
    mask = (rand(3, 10, 14, 1) > 0.2).astype(np.float32) if masked else None
    ref = JL.si_log_depth_loss(jnp.asarray(pred), jnp.asarray(tgt),
                               None if mask is None else jnp.asarray(mask))
    got = TL.si_log_depth_loss(nchw(pred), nchw(tgt), None if mask is None else nchw(mask))
    close(got, ref, rtol=1e-5)
