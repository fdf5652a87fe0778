"""Each hand-written kernel against its plain PyTorch version on CUDA
tensors, at small shapes (chip_smoke.py repeats this at the training
step's shapes). Needs a card: every test here is marked `gpu` and skips
without one. This file imports neither JAX nor tests/conftest.py's setup,
so it runs on a machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: the fused sample and the table sample exact (the kernels
compute the bases and weights from the coordinates and round each product
and sum of the weights and the combine on their own, in the plain version's
order, then cast the same way); the sample's grid
gradient atol 4 * C * 2^-23 * (largest size - 1) / 2 * max|ct| * max|img|
(its channel sums run in another order than autograd's reductions, and the
unnormalize scales them); splat atol/rtol 1e-5, and 1e-5 of the largest
|value| at the fusion levels' shapes (atomics sum in another order, which
varies from run to run); photometric map exact where its channels take
one pass (C <= 4: it rounds each product and sum in the plain version's
order) and atol 1e-5 otherwise (chunks carry a weighted partial sum through
the output), its gradient atol 1e-5 / rtol 1e-4
at the small shape and 1e-4 of the largest |dx| at the ragged ones (the
one-launch backward pools and folds in another order).
"""

import pytest
import torch

from mono_vifi_tpu_torch.ops import cuda
from mono_vifi_tpu_torch.ops import sampling as TS
from mono_vifi_tpu_torch.ops.cuda import fwarp as FW
from mono_vifi_tpu_torch.ops.cuda import photometric as PM
from mono_vifi_tpu_torch.ops.cuda import splat as SP
from mono_vifi_tpu_torch.ops.cuda import warp as WP


def _grad_tol(img, ct):
    C, H, W = img.shape[1:]
    return (4 * C * 2.0**-23 * (max(H, W) - 1) / 2
            * ct.abs().max().item() * img.float().abs().max().item())


@pytest.mark.gpu
def test_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    img = torch.rand((3, 3, 40, 72), generator=g, device=dev)
    gx = torch.rand((3, 40, 72), generator=g, device=dev) * 2.2 - 1.1
    gy = torch.rand((3, 40, 72), generator=g, device=dev) * 2.2 - 1.1
    cuda.reset_launch_counts()
    assert torch.equal(FW.bilinear_sample_table(img, None, gx, gy),
                       FW.bilinear_sample_table_plain(img, None, gx, gy))
    ct = torch.randn((3, 3, 40, 72), generator=g, device=dev)
    dgx, dgy = WP.bilinear_sample_bwd(img, gx, gy, ct)
    rgx, rgy = WP.bilinear_sample_grid_bwd_plain(img, gx, gy, ct)
    tol = _grad_tol(img, ct)
    torch.testing.assert_close(dgx, rgx, atol=tol, rtol=0)
    torch.testing.assert_close(dgy, rgy, atol=tol, rtol=0)
    for mode in ("border", "zeros"):
        ly, lx, a0, a1, c0, c1 = TS.factors((40, 72), gx, gy, mode)
        for td in (torch.float32, torch.bfloat16):
            assert torch.equal(WP.bilinear_sample(img, gx, gy, mode, tap_dtype=td),
                               WP.bilinear_sample_plain(img, gx, gy, mode, tap_dtype=td))
        ct = torch.randn((3, 3, 40, 72), generator=g, device=dev)
        ids = torch.tensor([1, 0, 1], dtype=torch.int32, device=dev)
        args = (ct, ly, lx, a0.contiguous(), a1.contiguous(), c0.contiguous(),
                c1.contiguous(), (40, 72), ids, 2)
        torch.testing.assert_close(SP.bilinear_splat(*args), SP.bilinear_splat_plain(*args),
                                   atol=1e-5, rtol=1e-5)
    y = torch.rand((3, 3, 40, 72), generator=g, device=dev)
    torch.testing.assert_close(PM.ssim_l1_fwd(img, y), PM.ssim_l1_fwd_plain(img, y),
                               atol=1e-5, rtol=0)
    ct = torch.rand((3, 40, 72), generator=g, device=dev)
    torch.testing.assert_close(PM.ssim_l1_bwd(img, y, ct), PM.ssim_l1_bwd_plain(img, y, ct),
                               atol=1e-5, rtol=1e-4)
    assert all(v > 0 for v in cuda.LAUNCHES.values())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("U,ids,C,H,W", [
    (3, [1, 1, 0, 2, 0, 2], 64, 24, 40),   # a fusion-like table with ids
    (3, [1, 1, 0, 2, 0, 2], 256, 12, 40),  # the deep levels: many channels,
    (3, [1, 1, 0, 2, 0, 2], 512, 6, 20),   # small planes (8-channel slices)
    (12, [0, 1, 2, 3, 8, 9, 10, 11], 64, 24, 40),  # multi-frame: unused planes
    (12, [0, 1, 2, 3, 8, 9, 10, 11], 8, 64, 80),   # large planes: two-channel batches
    (3, [2, 0, 2, 1], 12, 9, 33),          # odd output width: ragged pair stores
    (2, None, 5, 17, 131),                 # no ids, ragged width and channels
])
def test_table_sample_matches_plain_on_the_card(dtype, U, ids, C, H, W):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    N = U if ids is None else len(ids)
    table = torch.randn((U, C, H, W), generator=g, device=dev).to(dtype)
    gx = torch.rand((N, H, W), generator=g, device=dev) * 2.6 - 1.3
    gy = torch.rand((N, H, W), generator=g, device=dev) * 2.6 - 1.3
    ids_t = None if ids is None else torch.tensor(ids, dtype=torch.int32, device=dev)
    cuda.reset_launch_counts()
    got = FW.bilinear_sample_table(table, ids_t, gx, gy)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["bilinear_sample_table"] == 1
    ref = FW.bilinear_sample_table_plain(table, ids_t, gx, gy)
    assert got.dtype == dtype
    assert torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W,kind", [
    (96, 320, "smooth"),   # the fusion's level 0 planes
    (97, 321, "smooth"),   # odd width: ragged pair stores
    (96, 320, "far"),      # up to three plane widths past every border
])
def test_table_sample_by_plane_matches_plain_on_the_card(dtype, H, W, kind):
    """A table of more than FW.BY_PLANE_BYTES is walked a plane a block,
    each plane's uses in turn: 12 uses of 6 planes of 64 channels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import math

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    U, C = 6, 64
    ids = torch.tensor([q * 2 + j for q in (1, 1, 0, 2, 0, 2) for j in range(2)],
                       dtype=torch.int32, device=dev)
    N = len(ids)
    table = torch.randn((U, C, H, W), generator=g, device=dev).to(dtype)
    assert FW.table_by_plane(table.numel() * table.element_size(), ids, U)
    if kind == "smooth":
        ys = torch.linspace(0, 2 * math.pi, H, device=dev).view(1, H, 1)
        xs = torch.linspace(0, 2 * math.pi, W, device=dev).view(1, 1, W)
        ph = torch.rand((2, N, 1, 1), generator=g, device=dev) * 2 * math.pi
        flow = torch.stack([10.0 * torch.sin(ys + ph[0]).expand(N, H, W),
                            4.0 * torch.cos(xs + ph[1]).expand(N, H, W)], 1)
        gx, gy = (t.contiguous() for t in TS.flow_to_grid(flow))
    else:
        gx = torch.rand((N, H, W), generator=g, device=dev) * 8.0 - 4.0
        gy = torch.rand((N, H, W), generator=g, device=dev) * 8.0 - 4.0
    got = FW.bilinear_sample_table(table, ids, gx, gy)
    torch.cuda.synchronize()
    assert torch.equal(got, FW.bilinear_sample_table_plain(table, ids, gx, gy))


@pytest.mark.gpu
def test_table_warp_other_than_border_raises_on_the_card():
    """The table kernel is border-only: a zeros-mode table warp of CUDA
    tensors raises rather than sample in another mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    table = torch.rand((2, 3, 8, 8), device=dev)
    g = torch.rand((2, 8, 8), device=dev) * 2 - 1
    ids = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="border-only"):
        SP.grid_sample_frozen_grid(table, g, g, "zeros", ids)


@pytest.mark.gpu
@pytest.mark.parametrize("img_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tap_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["border", "zeros"])
@pytest.mark.parametrize("align_corners", [True, False])
def test_sample_matches_plain_on_the_card(img_dtype, tap_dtype, mode, align_corners):
    """The fused sample, bit for bit, on a ragged shape (5 channels: two
    channel groups) with an output of its own size and a third of the
    samples past the border."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    img = torch.randn((2, 5, 17, 131), generator=g, device=dev).to(img_dtype)
    gx = torch.rand((2, 9, 70), generator=g, device=dev) * 2.6 - 1.3
    gy = torch.rand((2, 9, 70), generator=g, device=dev) * 2.6 - 1.3
    cuda.reset_launch_counts()
    got = WP.bilinear_sample(img, gx, gy, mode, align_corners, tap_dtype)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["bilinear_sample"] == 1
    ref = WP.bilinear_sample_plain(img, gx, gy, mode, align_corners, tap_dtype)
    assert got.dtype == img_dtype
    assert torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("img_dtype,tap_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16),
])
@pytest.mark.parametrize("align_corners", [True, False])
def test_sample_grid_gradient_matches_plain_on_the_card(img_dtype, tap_dtype, align_corners):
    """The Function's backward against autograd of the plain version, with
    samples past the border (no gradient there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    img = torch.rand((2, 3, 23, 45), generator=g, device=dev).to(img_dtype)
    gx = (torch.rand((2, 23, 45), generator=g, device=dev) * 2.6 - 1.3).requires_grad_(True)
    gy = (torch.rand((2, 23, 45), generator=g, device=dev) * 2.6 - 1.3).requires_grad_(True)
    ct = torch.randn((2, 3, 23, 45), generator=g, device=dev).to(img_dtype)
    cuda.reset_launch_counts()
    TS.sample_planar(img, gx, gy, align_corners=align_corners, tap_dtype=tap_dtype).backward(ct)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["bilinear_sample"] == 1 and cuda.LAUNCHES["bilinear_sample_bwd"] == 1
    rgx, rgy = WP.bilinear_sample_grid_bwd_plain(img, gx, gy, ct, align_corners, tap_dtype)
    tol = _grad_tol(img, ct)
    torch.testing.assert_close(gx.grad, rgx, atol=tol, rtol=0)
    torch.testing.assert_close(gy.grad, rgy, atol=tol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("N,C,H,W", [
    (2, 3, 37, 70),   # ragged: neither side a multiple of the 16x32 tile
    (2, 3, 3, 50),    # H = 3: the reflect fold reaches across the whole edge
    (2, 3, 21, 3),    # W = 3
    (1, 4, 19, 40),   # two channel groups
    (2, 1, 2, 2),     # the smallest plane the reflect pad takes
])
def test_ssim_l1_bwd_matches_plain_on_the_card(N, C, H, W):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.rand((N, C, H, W), generator=g, device=dev)
    y = (x + 0.1 * torch.randn((N, C, H, W), generator=g, device=dev)).clamp(0, 1)
    ct = torch.rand((N, H, W), generator=g, device=dev)
    for use_ssim in (True, False):
        cuda.reset_launch_counts()
        got = PM.ssim_l1_bwd(x, y, ct, use_ssim)
        torch.cuda.synchronize()
        assert cuda.LAUNCHES["ssim_l1_bwd"] == 1
        ref = PM.ssim_l1_bwd_plain(x, y, ct, use_ssim)
        torch.testing.assert_close(got, ref, atol=1e-4 * ref.abs().max().item(), rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("use_ssim", [True, False])
@pytest.mark.parametrize("N,C,H,W", [
    (30, 3, 192, 640),  # the training step's 3B-target stack
    (8, 3, 187, 629),   # ragged: odd width (no float2 loads), partial strips
    (8, 3, 3, 640),     # H = 3
    (8, 3, 192, 3),     # W = 3
    (2, 4, 19, 40),     # one chunk of four channels
    (2, 5, 21, 62),     # five channels: chunks of one through the output
    (2, 1, 2, 2),       # the smallest plane the reflect pad takes
])
def test_ssim_l1_fwd_matches_plain_on_the_card(N, C, H, W, use_ssim):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.rand((N, C, H, W), generator=g, device=dev)
    y = (x + 0.1 * torch.randn((N, C, H, W), generator=g, device=dev)).clamp(0, 1)
    cuda.reset_launch_counts()
    got = PM.ssim_l1_fwd(x, y, use_ssim)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["ssim_l1_fwd"] == 1
    tol = 0.0 if C <= 4 else 1e-5
    torch.testing.assert_close(got, PM.ssim_l1_fwd_plain(x, y, use_ssim), atol=tol, rtol=0)


# the fusion levels of ResNet18 at 640x192: (channels, height, width)
FUSION_LEVELS = [(64, 96, 320), (64, 48, 160), (128, 24, 80), (256, 12, 40), (512, 6, 20)]


def _fusion_ids(dev, b=10):
    uses = (1, 1, 0, 2, 0, 2)
    return torch.tensor([q * b + j for q in uses for j in range(b)],
                        dtype=torch.int32, device=dev), 3 * b


def _check_splat(ct, f, hw, ids=None, planes=None):
    ly, lx, a0, a1, c0, c1 = (t.contiguous() for t in f)
    args = (ct, ly, lx, a0, a1, c0, c1, hw, ids, planes)
    cuda.reset_launch_counts()
    got = SP.bilinear_splat(*args)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["bilinear_splat"] == 1
    ref = SP.bilinear_splat_plain(*args)
    torch.testing.assert_close(got, ref, atol=1e-5 * ref.abs().max().item(), rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_ids", [True, False])
@pytest.mark.parametrize("C,H,W", FUSION_LEVELS)
def test_splat_fusion_levels_match_plain_on_the_card(C, H, W, with_ids, dtype):
    """60 uses of a smooth flow, onto 30 planes through ids or onto 60
    without: the shared-window path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import math

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    ids, planes = _fusion_ids(dev) if with_ids else (None, None)
    N = 60
    ys = torch.linspace(0, 2 * math.pi, H, device=dev).view(1, H, 1)
    xs = torch.linspace(0, 2 * math.pi, W, device=dev).view(1, 1, W)
    ph = torch.rand((2, N, 1, 1), generator=g, device=dev) * 2 * math.pi
    flow = torch.stack([10.0 * W / 320 * torch.sin(ys + ph[0]).expand(N, H, W),
                        4.0 * H / 96 * torch.cos(xs + ph[1]).expand(N, H, W)], 1)
    gx, gy = TS.flow_to_grid(flow)
    ct = torch.randn((N, C, H, W), generator=g, device=dev).to(dtype)
    _check_splat(ct, TS.border_factors((H, W), gx, gy), (H, W), ids, planes)


@pytest.mark.gpu
def test_splat_sadc_restore_matches_plain_on_the_card():
    """C = 1, f32, zeros mode under a rotation of up to 5 degrees."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mono_vifi_tpu_torch.ops.image import rotation_grid

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    angle = (torch.rand((30,), generator=g, device=dev) - 0.5) * 10.0
    gx, gy = rotation_grid(-angle, 192, 640)
    ct = torch.rand((30, 1, 192, 640), generator=g, device=dev)
    _check_splat(ct, TS.zeros_factors((192, 640), gx, gy), (192, 640))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_ids", [True, False])
@pytest.mark.parametrize("N,C,H,W", [(60, 64, 96, 320), (6, 5, 100, 131)])
def test_splat_scattered_grid_matches_plain_on_the_card(N, C, H, W, with_ids, dtype):
    """Uniformly random sample points: a pixel pair's taps spread over
    several output tiles, so most pairs sit in more than one bin and every
    bin holds pairs from all over the cotangent (the second shape also with
    an odd width and channels)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    gx = torch.rand((N, H, W), generator=g, device=dev) * 2.2 - 1.1
    gy = torch.rand((N, H, W), generator=g, device=dev) * 2.2 - 1.1
    ids = torch.arange(N, device=dev, dtype=torch.int32) % (N // 2) if with_ids else None
    ct = torch.randn((N, C, H, W), generator=g, device=dev).to(dtype)
    _check_splat(ct, TS.border_factors((H, W), gx, gy), (H, W), ids,
                 N // 2 if with_ids else None)


@pytest.mark.gpu
@pytest.mark.parametrize("ct_dtype", [torch.bfloat16, torch.float32])
def test_splat_writes_bf16_as_the_cast_of_its_f32_sums(ct_dtype):
    """The Function's backward asks for the image dtype (bf16 on the
    training step): the kernel rounds its f32 sums once, so it is within
    one bf16 ulp of the largest value of the plain version's cast."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import math

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    ids, planes = _fusion_ids(dev)
    gx = torch.rand((60, 48, 160), generator=g, device=dev) * 2.2 - 1.1
    gy = torch.rand((60, 48, 160), generator=g, device=dev) * 2.2 - 1.1
    f = [t.contiguous() for t in TS.border_factors((48, 160), gx, gy)]
    ct = torch.randn((60, 64, 48, 160), generator=g, device=dev).to(ct_dtype)
    args = (ct, *f, (48, 160), ids, planes)
    got = SP.bilinear_splat(*args, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    ref = SP.bilinear_splat_plain(*args)
    ulp = 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)
    torch.testing.assert_close(got.float(), ref.to(torch.bfloat16).float(), atol=ulp, rtol=0)
