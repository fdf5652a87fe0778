"""Each hand-written kernel against its plain PyTorch version on CUDA
tensors, at small shapes (chip_smoke.py repeats this at the training
step's shapes). Needs a card: every test here is marked `gpu` and skips
without one. This file imports neither JAX nor tests/conftest.py's setup,
so it runs on a machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: taps exact; splat atol/rtol 1e-5 (atomics sum in another
order); photometric map atol 1e-5, its gradient atol 1e-5 / rtol 1e-4; the
table sample exact (the kernel rounds each product and sum of the combine
on its own, in the plain version's order, then casts the same way).
"""

import pytest
import torch

from mono_vifi_tpu_torch.ops import cuda
from mono_vifi_tpu_torch.ops import sampling as TS
from mono_vifi_tpu_torch.ops.cuda import fwarp as FW
from mono_vifi_tpu_torch.ops.cuda import photometric as PM
from mono_vifi_tpu_torch.ops.cuda import splat as SP
from mono_vifi_tpu_torch.ops.cuda import warp as WP


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
    ly, lx, a0, a1, c0, c1 = (t.contiguous() for t in TS.factors((40, 72), gx, gy))
    FW.bilinear_sample_table(img, None, ly, lx, a0, a1, c0, c1)
    for mode in ("border", "zeros"):
        ly, lx, a0, a1, c0, c1 = TS.factors((40, 72), gx, gy, mode)
        for td in (torch.float32, torch.bfloat16):
            assert torch.equal(WP.bilinear_taps(img, ly, lx, td),
                               WP.bilinear_taps_plain(img, ly, lx, td))
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
    ly, lx, a0, a1, c0, c1 = (t.contiguous() for t in TS.border_factors((H, W), gx, gy))
    ids_t = None if ids is None else torch.tensor(ids, dtype=torch.int32, device=dev)
    cuda.reset_launch_counts()
    got = FW.bilinear_sample_table(table, ids_t, ly, lx, a0, a1, c0, c1)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["bilinear_sample_table"] == 1
    ref = FW.bilinear_sample_table_plain(table, ids_t, ly, lx, a0, a1, c0, c1)
    assert got.dtype == dtype
    assert torch.equal(got, ref)
