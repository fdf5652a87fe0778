"""Kernel 5, `bilinear_sample_table`: its plain PyTorch version (what the CPU
runs, and what tests/test_torch_kernels_gpu.py holds the kernel against on
the card) against the JAX package's table gather
`grid_sample_table_resident` in interpret mode, on the three cases of tests/test_fwarp.py, and against the XLA
`grid_sample_table`; against the factor composition it is written over
(bit for bit); and the fusion table warp's Function, whose forward it is.

Tolerances. bf16 table: both sides combine bf16 taps in f32 in the same
order and cast to bf16, so the results agree to one bf16 ulp of the value
(XLA may contract the combine into fused multiply-adds, which moves the f32
sum by an ulp and can flip the final rounding). f32 table against the XLA
sampler: atol 1e-5 on unit-variance values (the two combine in another
order). The Function: forward equal bit for bit to the composition
(factors + index_select + taps + combine, the same arithmetic); image gradient atol
1e-6 in f32 (the splat sums each plane's uses in another order than
autograd), one bf16 ulp for a bf16 table (both sums are f32, then cast).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mono_vifi_tpu.ops import sampling as JS
from mono_vifi_tpu.ops.pallas import fwarp as JFW
from mono_vifi_tpu_torch.ops import cuda
from mono_vifi_tpu_torch.ops import sampling as TS
from mono_vifi_tpu_torch.ops.cuda import fwarp as FW
from mono_vifi_tpu_torch.ops.cuda import splat as SP
from mono_vifi_tpu_torch.ops.cuda import warp as WP

RNG = np.random.default_rng(51)


def _grid(N, H, W, kind):
    """tests/test_fwarp.py's grids: smooth flow-like, or uniform far out of
    range (adversarial)."""
    if kind == "smooth":
        ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        g = []
        for _ in range(N):
            ph = RNG.uniform(0, 2 * np.pi, 2)
            dx = 9.0 * np.sin(2 * np.pi * ys / H + ph[0])
            dy = 3.0 * np.cos(2 * np.pi * xs / W + ph[1])
            g.append(np.stack([(xs + dx) / (W - 1) * 2 - 1, (ys + dy) / (H - 1) * 2 - 1], -1))
        return np.stack(g).astype(np.float32)
    return RNG.uniform(-1.3, 1.3, (N, H, W, 2)).astype(np.float32)


def _port(table_nhwc, ids, grid, dtype):
    """The plain table sample on NHWC inputs -> NHWC f32 numpy."""
    tab = torch.from_numpy(np.ascontiguousarray(np.moveaxis(table_nhwc, -1, 1))).to(dtype)
    gx, gy = torch.from_numpy(grid[..., 0].copy()), torch.from_numpy(grid[..., 1].copy())
    ids_t = None if ids is None else torch.tensor(ids, dtype=torch.int32)
    out = FW.bilinear_sample_table(tab, ids_t, gx, gy)
    assert out.dtype == dtype
    return out.float().permute(0, 2, 3, 1).numpy()


def _assert_within_one_bf16_ulp(got, ref):
    mag = np.maximum(np.abs(got), np.abs(ref))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(got - ref) <= ulp), float(np.max(np.abs(got - ref) / ulp))


@pytest.mark.parametrize("U,N,H,W,C,kind,ids", [
    (3, 6, 48, 160, 8, "smooth", "mod"),       # W % 128 != 0
    (2, 4, 24, 80, 8, "adversarial", "mod"),   # far out-of-range coordinates
    (2, 2, 16, 128, 4, "smooth", None),        # ids=None, Wo = 128
])
def test_plain_matches_resident_table_gather(U, N, H, W, C, kind, ids):
    table = RNG.standard_normal((U, H, W, C)).astype(np.float32)
    jtable = jnp.asarray(table, jnp.bfloat16)
    ids = None if ids is None else tuple(int(i) for i in np.arange(N) % U)
    grid = _grid(N, H, W, kind)
    ref = JFW.grid_sample_table_resident(jtable, ids, jnp.asarray(grid[..., 0]),
                                         jnp.asarray(grid[..., 1]), interpret=True)
    got = _port(np.asarray(jtable.astype(jnp.float32)), ids, grid, torch.bfloat16)
    _assert_within_one_bf16_ulp(got, np.asarray(ref, np.float32))


def test_plain_matches_xla_table_sampler_f32():
    U, N, H, W, C = 3, 6, 24, 40, 5
    table = RNG.standard_normal((U, H, W, C)).astype(np.float32)
    ids = (1, 1, 0, 2, 0, 2)
    grid = _grid(N, H, W, "smooth")
    ref = JS.grid_sample_table(jnp.asarray(table), ids, jnp.asarray(grid))
    np.testing.assert_allclose(_port(table, ids, grid, torch.float32), np.asarray(ref),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_frozen_grid_table_warp_unchanged(dtype):
    """grid_sample_frozen_grid with ids (forward: kernel 5's plain version;
    backward: the splat) against the composition it replaced, written with
    autograd: values equal, image gradients within the tolerance above."""
    U, H, W, C = 3, 16, 40, 4
    ids = torch.tensor([1, 1, 0, 2, 0, 2], dtype=torch.int32)
    table = torch.from_numpy(RNG.random((U, C, H, W), np.float32)).to(dtype)
    grid = _grid(len(ids), H, W, "smooth")
    gx, gy = torch.from_numpy(grid[..., 0].copy()), torch.from_numpy(grid[..., 1].copy())
    ct = torch.from_numpy(RNG.uniform(-1, 1, (len(ids), C, H, W)).astype(np.float32))

    new = table.clone().requires_grad_(True)
    out = SP.grid_sample_frozen_grid(new, gx, gy, "border", ids)
    out.float().backward(ct)

    # the reference gradient is taken in f32 (the table's values are exact in
    # f32) and compared after rounding: the splat also sums in f32 and casts
    old = table.float().requires_grad_(True)
    ly, lx, a0, a1, c0, c1 = TS.border_factors((H, W), gx, gy)
    taps = WP.bilinear_taps_plain(old.index_select(0, ids.long()), ly, lx)
    ref = TS.combine_taps(taps, a0, a1, c0, c1).to(dtype)
    ref.float().backward(ct)

    assert out.dtype == dtype and new.grad.dtype == dtype
    assert torch.equal(out, ref)
    if dtype == torch.float32:
        torch.testing.assert_close(new.grad, old.grad, atol=1e-6, rtol=0)
    else:
        _assert_within_one_bf16_ulp(new.grad.float().numpy(), old.grad.numpy())


def test_cpu_table_sample_launches_nothing():
    cuda.reset_launch_counts()
    tab = torch.rand(2, 3, 8, 8)
    g = torch.rand(3, 8, 8) * 2 - 1
    FW.bilinear_sample_table(tab, torch.tensor([0, 1, 1], dtype=torch.int32), g, g)
    assert cuda.LAUNCHES["bilinear_sample_table"] == 0
    with pytest.raises(RuntimeError, match="no kernel for device"):
        FW.bilinear_sample_table(tab.to("meta"), None, g, g)


def _factor_composition(table, ids, gx, gy):
    """The table sample as it was written before it took coordinates:
    `border_factors`, then index_select, the four taps, the f32 combine and
    the cast."""
    ly, lx, a0, a1, c0, c1 = TS.border_factors(table.shape[2:], gx, gy)
    src = table if ids is None else table.index_select(0, ids.long())
    return TS.combine_taps(WP.bilinear_taps_plain(src, ly, lx), a0, a1, c0, c1).to(table.dtype)


@pytest.mark.parametrize("ids", [
    [1, 1, 0, 2, 0, 2],          # the training step's two uses a plane
    None,
    [0, 1, 2, 3, 8, 9, 10, 11],  # multi-frame: 12 planes, 4-7 unused
])
@pytest.mark.parametrize("kind", ["smooth", "far"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_equals_the_factor_composition(dtype, kind, ids):
    """The coordinates reach the same arithmetic: equal bit for bit, on a
    smooth grid and one reaching three plane widths past every border."""
    U = 3 if ids is None else max(ids) + 1
    H, W, C = 13, 37, 5
    rng = np.random.default_rng(7)
    N = U if ids is None else len(ids)
    table = torch.from_numpy(rng.standard_normal((U, C, H, W)).astype(np.float32)).to(dtype)
    if kind == "smooth":
        grid = _grid(N, H, W, "smooth")
        gx, gy = torch.from_numpy(grid[..., 0].copy()), torch.from_numpy(grid[..., 1].copy())
    else:
        gx, gy = (torch.from_numpy(rng.uniform(-4.0, 4.0, (N, H, W)).astype(np.float32))
                  for _ in range(2))
    ids_t = None if ids is None else torch.tensor(ids, dtype=torch.int32)
    got = FW.bilinear_sample_table_plain(table, ids_t, gx, gy)
    assert got.dtype == dtype and got.shape == (N, C, H, W)
    assert torch.equal(got, _factor_composition(table, ids_t, gx, gy))
    assert torch.equal(FW.bilinear_sample_table(table, ids_t, gx, gy), got)


def test_frozen_grid_builds_factors_only_for_a_backward(monkeypatch):
    """The Function saves the coordinates and builds the bases and weights
    in its backward: a table warp under torch.no_grad() (multi-frame
    inference) calls `sampling.factors` never, one with a backward once."""
    calls = []
    factors = TS.factors

    def counted(*args, **kwargs):
        calls.append(args[3] if len(args) > 3 else kwargs.get("padding_mode"))
        return factors(*args, **kwargs)

    monkeypatch.setattr(TS, "factors", counted)
    U, H, W, C = 3, 16, 40, 4
    ids = torch.tensor([1, 1, 0, 2, 0, 2], dtype=torch.int32)
    grid = _grid(len(ids), H, W, "smooth")
    gx, gy = torch.from_numpy(grid[..., 0].copy()), torch.from_numpy(grid[..., 1].copy())
    table = torch.rand(U, C, H, W, requires_grad=True)
    with torch.no_grad():
        out = SP.grid_sample_frozen_grid(table, gx, gy, "border", ids)
    assert calls == [] and not out.requires_grad
    SP.grid_sample_frozen_grid(table, gx, gy, "border", ids).sum().backward()
    assert calls == ["border"] and table.grad is not None


def test_frozen_grid_zeros_warp_unchanged():
    """Without ids in zeros mode (the SADC depth restore): the forward
    equals the factor composition bit for bit, the image gradient autograd
    of it within atol 1e-6 (the splat sums in another order)."""
    H, W = 24, 40
    rng = np.random.default_rng(8)
    img = torch.from_numpy(rng.random((3, 1, H, W), np.float32))
    angle = torch.from_numpy(rng.uniform(-5.0, 5.0, 3).astype(np.float32))
    from mono_vifi_tpu_torch.ops.image import rotation_grid

    gx, gy = rotation_grid(angle, H, W)
    ct = torch.from_numpy(rng.uniform(-1, 1, (3, 1, H, W)).astype(np.float32))
    new = img.clone().requires_grad_(True)
    out = SP.grid_sample_frozen_grid(new, gx, gy, "zeros")
    out.backward(ct)
    old = img.clone().requires_grad_(True)
    ly, lx, a0, a1, c0, c1 = TS.zeros_factors((H, W), gx, gy)
    ref = TS.combine_taps(WP.bilinear_taps_plain(old, ly, lx), a0, a1, c0, c1)
    ref.backward(ct)
    assert torch.equal(out, ref)
    torch.testing.assert_close(new.grad, old.grad, atol=1e-6, rtol=0)


def test_frozen_grid_table_warp_is_border_only_on_the_card(monkeypatch):
    """The kernel samples in border mode only: a table warp in zeros mode
    with CUDA tensors raises before any launch (the card is stood in for by
    `use_kernel`), where the CPU takes the plain version of that mode."""
    ids = torch.tensor([1, 0], dtype=torch.int32)
    table, g = torch.rand(2, 3, 8, 8), torch.rand(2, 8, 8) * 2 - 1
    ref = SP.grid_sample_frozen_grid(table, g, g, "zeros", ids)
    assert torch.equal(ref, FW.bilinear_sample_table_plain(table, ids, g, g, "zeros"))
    monkeypatch.setattr(cuda, "use_kernel", lambda t: True)
    cuda.reset_launch_counts()
    with pytest.raises(ValueError, match="border-only"):
        SP.grid_sample_frozen_grid(table, g, g, "zeros", ids)
    assert cuda.LAUNCHES["bilinear_sample_table"] == 0
