"""Chip smoke test of the PyTorch + CUDA port (mono_vifi_tpu_torch) on one
NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. the card's name and power limit (nvidia-smi);
  2. build of the hand-written kernels from mono_vifi_tpu_torch/csrc;
  3. each kernel at the shapes its paths give it against its plain PyTorch
     version on the same inputs (max error vs a stated tolerance), with the
     kernel's, the plain version's and, where one exists, a single PyTorch
     call's time (CUDA events), and the least time the card could take: the
     fused sample at the training step's five shapes (bit for bit), its grid
     gradient, the photometric map (at both stacks' shapes, without SSIM)
     and its one-launch gradient (both also at ragged shapes and H = 3 /
     W = 3), the splat at the five fusion levels, with a scattered grid
     and at the SADC restore, and the table sample (bit for bit) at the five
     fusion levels of each of its paths (the training step, the multi-frame
     inference and phase 7's per-epoch multi-frame evaluation) and with a
     grid far out of range, also timed through a CUDA graph (device_ms:
     without the host's launch cost, which dominates the small levels' ms);
  4. the full-width training step (ResNet18, 640x192, batch 10, frozen
     IFRNet-L, affine branch, shared_encoder, bf16 compute, random weights
     from a seed): 2 warm-up and 5 timed steps, finite loss and gradient
     norm, and every kernel's launch count over the 5 steps (all > 0), also
     by shape;
  5. one step's loss terms and the gradient norm of the pose net's
     parameters with the kernels against the same step with every plain
     version, from the same weights, batch and noise (rel 1e-3);
  6. the full-width inference path (ResNet18, 640x192, f32 with TF32 off,
     shared_encoder, frozen IFRNet-S, random weights from a seed, batch 4,
     uint8 frames from a numpy seed): single-frame `predict_disps` with flip
     post-processing, then multi-frame `predict_disps_mf`, each 2 warm-up and
     10 timed batches; the table-sample launches of the multi-frame run
     (> 0); its disparities with the kernels against every plain version
     (max abs error 1e-5); the KITTI eigen protocol over the timed
     predictions against synthetic ground truths (finite; random weights,
     so the numbers say nothing of accuracy);
  7. the training driver (`mono_vifi_tpu_torch.train.Trainer`) from
     configs/resnet18/ResNet18_KITTI_MR.txt at its full width (ResNet18,
     640x192, batch 10, affine, shared_encoder, bf16, IFRNet-L in the step
     and IFRNet-S in evaluation; random weights from the config's seed) on a
     synthetic KITTI-raw tree written to a temporary directory (one drive of
     62 uint8 PNG frames at the native 1242x375 from a numpy seed, train
     and test splits of 60 and 8 lines, sparse synthetic ground truths):
     epoch 0 (6 steps through the real dataset, sampler, threaded loader
     and device prefetch; a mid-epoch checkpoint after step 4), its single-
     and multi-frame evaluation (the table sample launched at each shape
     phase 3 checked for it; the multi-frame disparities with the kernels
     against every plain version, max abs error 1e-5) and epoch-end save;
     then a second trainer
     with `resume` that must come back at epoch 1, step 6 with the saved
     optimizer moments and BatchNorm buffers bit for bit, and runs epoch 1.
     Finite losses and metrics, every kernel launched in the driver's steps
     and the table sample in its multi-frame evaluation; the driver's data
     wait and step time, samples/s over each epoch and over the timed window
     of its warm steps 2-6, and peak memory beside the card's name and power
     limit;
  8. one JSON line describing every kernel, then the result line.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

B, H, W = 10, 192, 640
BI = 4  # the evaluation entry points' default batch
N_TEST = 8  # phase 7's test split: one evaluation batch of 8 (batch_size 10)
DRIVER_EVAL = "training driver's per-epoch multi-frame evaluation"
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_FLOP_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of one call: `iters` calls captured in a CUDA graph and
    replayed between CUDA events (best of 5), so that the host's launch
    cost, which dominates a small kernel's time_ms, is left out."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def smooth_flow(gen, n, h, w, amp_x, amp_y, device):
    """A smooth view-synthesis-like displacement field (n, 2, h, w)."""
    import torch

    ys = torch.linspace(0, 2 * math.pi, h, device=device).view(1, h, 1)
    xs = torch.linspace(0, 2 * math.pi, w, device=device).view(1, 1, w)
    ph = torch.rand((4, n, 1, 1), generator=gen, device=device) * 2 * math.pi
    dx = amp_x * (0.5 * torch.sin(ys + ph[0]) + 0.5 * torch.cos(xs + ph[1]))
    dy = amp_y * (0.5 * torch.sin(xs + ph[2]) + 0.5 * torch.cos(ys + ph[3]))
    return torch.stack([dx, dy], 1)


def entry(name, source, replaces, err, tol, ms, plain_ms, nbytes, flops, library_ms):
    if not err <= tol:
        raise AssertionError(f"{name}: max error {err} above tolerance {tol}")
    b_ms, b_by = bound(nbytes, flops)
    log(f"kernel {name}: max_abs_err {err:.3e} (tol {tol:.1e}) ms {ms:.4f} "
        f"plain_ms {plain_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) library_ms {library_ms}")
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
    }


def kernel_phase(device):
    """Phase 3: every kernel against its plain version at main-path shapes."""
    import torch
    import torch.nn.functional as F

    from mono_vifi_tpu_torch.ops import sampling
    from mono_vifi_tpu_torch.ops.cuda import photometric as PM
    from mono_vifi_tpu_torch.ops.cuda import splat as SP
    from mono_vifi_tpu_torch.ops.cuda import warp as WP
    from mono_vifi_tpu_torch.ops.image import rotation_grid

    gen = torch.Generator(device=device).manual_seed(0)
    out = {}

    # kernel 1: the fused sample at the five shapes of the training step
    # (one launch each per step), and its grid gradient
    def sample_inputs(n, c, mode):
        img = torch.rand((n, c, H, W), generator=gen, device=device)
        if mode == "zeros":
            angle = (torch.rand((n,), generator=gen, device=device) - 0.5) * 10.0
            gx, gy = rotation_grid(angle, H, W)
        else:
            gx, gy = sampling.flow_to_grid(smooth_flow(gen, n, H, W, 40.0, 10.0, device))
        return img, gx.contiguous(), gy.contiguous()

    variants = []
    for n, c, mode, td, path in (
        (12 * B, 3, "border", torch.bfloat16, "photometric warp, 6B targets x 2 sources"),
        (12 * B, 3, "border", torch.float32, None),  # the same shape, f32 taps
        (6 * B, 3, "border", torch.bfloat16, "photometric warp, 3B affine targets x 2"),
        (4 * B, 3, "border", torch.bfloat16, "IFRNet synthesis, 2B pairs x 2 frames"),
        (2 * B, 3, "zeros", torch.float32, "affine rotation of the 2B synthesized frames"),
        (3 * B, 1, "zeros", torch.float32, "SADC depth restore (forward)"),
    ):
        img, gx, gy = sample_inputs(n, c, mode)
        k = WP.bilinear_sample(img, gx, gy, mode, tap_dtype=td)
        p = WP.bilinear_sample_plain(img, gx, gy, mode, tap_dtype=td)
        err = (k.float() - p.float()).abs().max().item()
        ms = time_ms(lambda: WP.bilinear_sample(img, gx, gy, mode, tap_dtype=td))
        pms = time_ms(lambda: WP.bilinear_sample_plain(img, gx, gy, mode, tap_dtype=td),
                      iters=5)
        grid = torch.stack([gx, gy], -1)
        lib = time_ms(lambda: F.grid_sample(img, grid, "bilinear", mode, True))
        nbytes = 2 * img.numel() * 4 + 2 * gx.numel() * 4
        # the weights once per pixel (~30 operations), six products and three
        # sums per channel
        flops = 30.0 * gx.numel() + 9.0 * img.numel()
        variants.append(entry(
            "bilinear_sample", "mono_vifi_tpu_torch/csrc/warp.cu",
            "mono_vifi_tpu/ops/pallas/warp.py:139" if td == torch.bfloat16
            else "mono_vifi_tpu/ops/pallas/warp.py:59",
            err, 0.0, ms, pms, nbytes, flops, lib,
        ) | {"shape": f"img {tuple(img.shape)} f32, {str(td)[6:]} taps, {mode}"}
            | ({"path": path, "launch_shape": tuple(img.shape)} if path else {}))
    out["bilinear_sample"] = variants[0] | {"variants": variants[1:]}

    # its grid gradient at the 6B photometric shape, bf16 taps as there
    img, gx, gy = sample_inputs(12 * B, 3, "border")
    ct = torch.randn(img.shape, generator=gen, device=device)
    td = torch.bfloat16
    kx, ky = WP.bilinear_sample_bwd(img, gx, gy, ct, tap_dtype=td)
    px, py = WP.bilinear_sample_grid_bwd_plain(img, gx, gy, ct, tap_dtype=td)
    err = max((kx - px).abs().max().item(), (ky - py).abs().max().item())
    # the channel sums run in another order than autograd's reductions: four
    # f32 roundings of each of the C terms, each at most max|ct| * max|img|,
    # scaled by the unnormalize's (W - 1) / 2
    tol = 4 * 3 * 2.0**-23 * (W - 1) / 2 * ct.abs().max().item() * img.abs().max().item()
    ms = time_ms(lambda: WP.bilinear_sample_bwd(img, gx, gy, ct, tap_dtype=td))
    pms = time_ms(lambda: WP.bilinear_sample_grid_bwd_plain(img, gx, gy, ct, tap_dtype=td),
                  iters=5)
    grid = torch.stack([gx, gy], -1)
    lib = time_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
        ct, img, grid, 0, 1, True, [False, True]))
    out["bilinear_sample_bwd"] = entry(
        "bilinear_sample_bwd", "mono_vifi_tpu_torch/csrc/warp.cu",
        "none: the port's own gradient kernel (the JAX side took the grid's "
        "gradient of mono_vifi_tpu/ops/pallas/warp.py:258 in XLA)",
        err, tol, ms, pms, 2 * img.numel() * 4 + 4 * gx.numel() * 4,
        30.0 * gx.numel() + 16.0 * img.numel(), lib,
    ) | {"shape": f"img, ct {tuple(img.shape)} f32, bf16 taps, border",
         "path": "photometric warp, 6B targets x 2 sources",
         "launch_shape": tuple(img.shape)}
    del img, gx, gy, ct, grid, kx, ky, px, py

    # kernels 2 and 3: the photometric map over the 6B-target stack, then
    # the 3B-target stack, ragged shapes (odd width: no float2 loads), H = 3,
    # W = 3 and the map without SSIM (an elementwise pass)
    N = 6 * B
    x = torch.rand((N, 3, H, W), generator=gen, device=device)
    y = (x + 0.1 * torch.randn((N, 3, H, W), generator=gen, device=device)).clamp(0, 1)
    variants = []
    for n, h, w, use_ssim in ((N, H, W, True), (3 * B, H, W, True), (8, 187, 629, True),
                              (8, 3, W, True), (8, H, 3, True), (N, H, W, False)):
        xs = x[:n, :, :h, :w].contiguous()
        ys = y[:n, :, :h, :w].contiguous()
        k = PM.ssim_l1_fwd(xs, ys, use_ssim)
        p = PM.ssim_l1_fwd_plain(xs, ys, use_ssim)
        err = (k - p).abs().max().item()
        ms = time_ms(lambda: PM.ssim_l1_fwd(xs, ys, use_ssim))
        pms = time_ms(lambda: PM.ssim_l1_fwd_plain(xs, ys, use_ssim), iters=5)
        variants.append(entry(
            "ssim_l1_fwd", "mono_vifi_tpu_torch/csrc/photometric.cu",
            "mono_vifi_tpu/ops/pallas/photometric.py:90", err, 1e-5, ms, pms,
            (2 * xs.numel() + k.numel()) * 4, (55.0 if use_ssim else 3.0) * xs.numel(), None,
        ) | {"shape": f"x, y {tuple(xs.shape)} f32" + ("" if use_ssim else ", no SSIM")}
            | ({"launch_shape": tuple(xs.shape)} if use_ssim and h == H and w == W else {}))
    out["ssim_l1_fwd"] = variants[0] | {"variants": variants[1:]}
    # the one-launch backward at the path's shape, then ragged shapes (H, W
    # not multiples of the 16x32 tile; H = 3 and W = 3, where the reflect
    # fold reaches across the whole edge)
    variants = []
    for n, h, w in ((N, H, W), (8, 187, 629), (8, 3, W), (8, H, 3)):
        xs = x[:n, :, :h, :w].contiguous()
        ys = y[:n, :, :h, :w].contiguous()
        ct = torch.rand((n,) + xs.shape[2:], generator=gen, device=device)
        k = PM.ssim_l1_bwd(xs, ys, ct)
        p = PM.ssim_l1_bwd_plain(xs, ys, ct)
        scale = p.abs().max().item()
        err = (k - p).abs().max().item()
        ms = time_ms(lambda: PM.ssim_l1_bwd(xs, ys, ct))
        pms = time_ms(lambda: PM.ssim_l1_bwd_plain(xs, ys, ct), iters=5)
        variants.append(entry(
            "ssim_l1_bwd", "mono_vifi_tpu_torch/csrc/photometric.cu",
            "mono_vifi_tpu/ops/pallas/photometric.py:113", err, 1e-4 * scale, ms, pms,
            (3 * xs.numel() + ct.numel()) * 4, 200.0 * xs.numel(), None,
        ) | {"shape": f"x, y {tuple(xs.shape)} f32, one launch"}
            | ({"launch_shape": tuple(xs.shape)} if n == N else {}))
    out["ssim_l1_bwd"] = variants[0] | {"variants": variants[1:]}
    del x, y, xs, ys

    # kernel 4: the fusion warps' backward at the five levels (60 uses of 30
    # unique maps, bf16 cotangent; level 0 is 64 channels at half
    # resolution), level 0 again with a scattered grid (pairs in several
    # bins, each bin holding pairs from all over the cotangent), then the
    # SADC rotate's backward (zeros mode, C=1: the direct path)
    from mono_vifi_tpu_torch.training.monovifi import TABLE_USES

    U, N = 3 * B, 6 * B
    ids = torch.tensor([q * B + j for q in TABLE_USES for j in range(B)],
                       dtype=torch.int32, device=device)
    variants = []

    def splat_case(ct, gx, gy, f, hw, ids, planes, mode, label, replaces, path=None,
                   out_dtype=torch.float32):
        """Check the f32 sums (1e-5 of the largest |value|); with a bf16
        out_dtype (the fusion levels' call: the Function's backward asks for
        the image dtype) also the kernel's own rounding to bf16, within one
        bf16 ulp of the largest value of the plain version's cast. The time
        is that of the path's call, in out_dtype."""
        h, w = hw
        args = (ct, *f, hw, ids, planes)
        k = SP.bilinear_splat(*args)
        p = SP.bilinear_splat_plain(*args)
        err = (k - p).abs().max().item()
        extra = {}
        if out_dtype != torch.float32:
            kb = SP.bilinear_splat(*args, out_dtype=out_dtype)
            ulp = 2.0 ** (math.floor(math.log2(p.abs().max().item())) - 7)
            err_b = (kb.float() - p.to(out_dtype).float()).abs().max().item()
            log(f"kernel bilinear_splat ({label}) bf16 out: max_abs_err {err_b:.3e} "
                f"(tol {ulp:.1e}, one bf16 ulp of the largest value)")
            if not err_b <= ulp:
                raise AssertionError(f"bilinear_splat bf16 out: max error {err_b} above {ulp}")
            extra = {"bf16_out_max_abs_err": err_b,
                     "f32_out_ms": time_ms(lambda: SP.bilinear_splat(*args))}
            del kb
        ms = time_ms(lambda: SP.bilinear_splat(*args, out_dtype=out_dtype))
        pms = time_ms(lambda: SP.bilinear_splat_plain(*args), iters=5)
        # the same function by one library call: grid_sample's backward to the
        # image, per use (no ids), f32
        grid = torch.stack((gx, gy), -1)
        ct32 = ct.float()
        dummy = torch.zeros(ct.shape, device=device)
        lib = time_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
            ct32, dummy, grid, 0, 0 if mode == "zeros" else 1, True, [True, False]))
        U_ = planes or ct.shape[0]
        out_size = torch.empty((), dtype=out_dtype).element_size()
        nbytes = (ct.numel() * ct.element_size() + 6 * f[0].numel() * 4
                  + (ids.numel() * 4 if ids is not None else 0) + U_ * ct.shape[1] * h * w * out_size)
        variants.append(entry(
            "bilinear_splat", "mono_vifi_tpu_torch/csrc/splat.cu", replaces, err,
            1e-5 * p.abs().max().item(), ms, pms, nbytes, 8.0 * ct.numel(), lib,
        ) | {"shape": f"ct {tuple(ct.shape)} {str(ct.dtype)[6:]} -> {str(out_dtype)[6:]}, {label}"}
            | extra | ({"launch_shape": tuple(ct.shape)} if path else {}))
        del k, p

    for level, (C, h, w) in enumerate(((64, H // 2, W // 2), (64, H // 4, W // 4),
                                       (128, H // 8, W // 8), (256, H // 16, W // 16),
                                       (512, H // 32, W // 32))):
        gx, gy = sampling.flow_to_grid(smooth_flow(
            gen, N, h, w, 10.0 * w / (W // 2), 4.0 * h / (H // 2), device))
        f = sampling.border_factors((h, w), gx, gy)
        ctb = torch.randn((N, C, h, w), generator=gen, device=device).to(torch.bfloat16)
        splat_case(ctb, gx, gy, f, (h, w), ids, U, "border",
                   f"{U} unique planes (fusion level {level})",
                   "mono_vifi_tpu/ops/pallas/splat.py:77", path=True, out_dtype=torch.bfloat16)
    C, h, w = 64, H // 2, W // 2
    gx = torch.rand((N, h, w), generator=gen, device=device) * 2.2 - 1.1
    gy = torch.rand((N, h, w), generator=gen, device=device) * 2.2 - 1.1
    ctb = torch.randn((N, C, h, w), generator=gen, device=device).to(torch.bfloat16)
    splat_case(ctb, gx, gy, sampling.border_factors((h, w), gx, gy), (h, w), ids, U, "border",
               f"{U} unique planes, scattered grid",
               "mono_vifi_tpu/ops/pallas/splat.py:77")
    del ctb

    angle = (torch.rand((3 * B,), generator=gen, device=device) - 0.5) * 10.0
    gx, gy = rotation_grid(-angle, H, W)
    f = [t.contiguous() for t in sampling.zeros_factors((H, W), gx, gy)]
    ct1 = torch.rand((3 * B, 1, H, W), generator=gen, device=device)
    splat_case(ct1, gx, gy, f, (H, W), None, None, "zeros",
               "zeros mode (SADC restore, direct path)",
               "mono_vifi_tpu/ops/pallas/splat.py:166", path=True)
    out["bilinear_splat"] = variants[0] | {"variants": variants[1:]}

    # kernel 5: the fusion table warp's forward at the five levels of each of
    # its paths, one launch each per step or batch: the training step (60
    # uses of 30 planes, bf16), the multi-frame inference (8 uses of 12
    # planes, f32) and the training driver's per-epoch multi-frame
    # evaluation (16 uses of 24 planes, bf16: every plane used once, so a
    # use a block where the step's large levels go a plane a block); then
    # level 0 of the step with a grid far out of range; each bit for bit
    from mono_vifi_tpu_torch.ops.cuda import fwarp as FW

    levels = ((64, H // 2, W // 2), (64, H // 4, W // 4), (128, H // 8, W // 8),
              (256, H // 16, W // 16), (512, H // 32, W // 32))
    variants = []
    cases = [(B, TABLE_USES, torch.bfloat16, C, h, w, "smooth", "training step")
             for C, h, w in levels]
    cases += [(BI, (0, 2), torch.float32, C, h, w, "smooth", "multi-frame inference")
              for C, h, w in levels]
    cases += [(N_TEST, (0, 2), torch.bfloat16, C, h, w, "smooth", DRIVER_EVAL)
              for C, h, w in levels]
    cases += [(B, TABLE_USES, torch.bfloat16, 64, H // 2, W // 2, "far", None)]
    for b, uses, dt, C, h, w, kind, path in cases:
        U, N = 3 * b, len(uses) * b
        ids = torch.tensor([q * b + j for q in uses for j in range(b)],
                           dtype=torch.int32, device=device)
        table = torch.randn((U, C, h, w), generator=gen, device=device).to(dt)
        if kind == "far":  # up to three plane widths past every border
            gx = torch.rand((N, h, w), generator=gen, device=device) * 8.0 - 4.0
            gy = torch.rand((N, h, w), generator=gen, device=device) * 8.0 - 4.0
        else:
            gx, gy = sampling.flow_to_grid(smooth_flow(
                gen, N, h, w, 10.0 * w / (W // 2), 4.0 * h / (H // 2), device))
            gx, gy = gx.contiguous(), gy.contiguous()
        k = FW.bilinear_sample_table(table, ids, gx, gy)
        p = FW.bilinear_sample_table_plain(table, ids, gx, gy)
        err = (k.float() - p.float()).abs().max().item()
        if not torch.equal(k, p):
            raise AssertionError(f"bilinear_sample_table {tuple(table.shape)}: not bit for bit")
        ms = time_ms(lambda: FW.bilinear_sample_table(table, ids, gx, gy))
        dev_ms = graph_ms(lambda: FW.bilinear_sample_table(table, ids, gx, gy))
        log(f"kernel bilinear_sample_table {tuple(table.shape)}: device_ms {dev_ms:.4f} "
            "(CUDA graph of 20 launches)")
        pms = time_ms(lambda: FW.bilinear_sample_table_plain(table, ids, gx, gy), iters=5)
        # one library call computing the same function: index_select of the
        # used planes then grid_sample, both timed (the grid in the table's
        # dtype, as grid_sample asks)
        grid = torch.stack([gx, gy], -1).to(dt)
        lib = time_ms(lambda: F.grid_sample(table.index_select(0, ids.long()), grid,
                                            "bilinear", "border", True))
        esize = table.element_size()
        used = len(set(ids.tolist()))
        # the output, the two coordinate planes, the ids, each used plane once
        nbytes = k.numel() * esize + 2 * N * h * w * 4 + used * C * h * w * esize + N * 4
        variants.append(entry(
            "bilinear_sample_table", "mono_vifi_tpu_torch/csrc/fwarp.cu",
            "mono_vifi_tpu/ops/pallas/fwarp.py:47", err, 0.0, ms, pms, nbytes,
            9.0 * k.numel(), lib,
        ) | {"device_ms": dev_ms,
             "shape": f"{N} uses of {U} planes ({C}, {h}, {w}) {str(dt)[6:]}"
                      + ("" if path else ", grid far out of range"),
             "path": path}
            | ({"launch_shape": tuple(table.shape)} if path else {}))
        del k, p, table, grid
    out["bilinear_sample_table"] = variants[0] | {"variants": variants[1:]}
    return out


def make_batch(device):
    import torch

    rng = np.random.default_rng(0)
    K = np.zeros((B, 4, 4), np.float32)
    K[:, 0, 0], K[:, 1, 1] = 0.58 * W, 1.92 * H
    K[:, 0, 2], K[:, 1, 2] = 0.5 * W, 0.5 * H
    K[:, 2, 2] = K[:, 3, 3] = 1
    w_box, h_box = round(W / 1.5), round(H / 1.5)
    batch = {
        k: rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8)
        for k in ("color_n1", "color_0", "color_p1", "color_aug_n1", "color_aug_0",
                  "color_aug_p1", "color_affine_n1", "color_affine_0",
                  "color_affine_p1", "color_affine_aug_0")
    }
    batch.update(
        K=K, inv_K=np.linalg.pinv(K).astype(np.float32),
        Rc=np.tile(np.eye(3, dtype=np.float32), (B, 1, 1)),
        ratio_local=np.full((B, 1), 1.5, np.float32),
        angle=rng.uniform(-5.0, 5.0, (B,)).astype(np.float32),
        box=np.tile(np.array([2, 1, w_box, h_box], np.float32), (B, 1)),
        valid_mask_rec=np.full((B, H, W, 1), 255, np.uint8),
        valid_mask_cons=np.full((B, H, W, 1), 255, np.uint8),
    )
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def step_phase(device):
    """Phases 4 and 5: the full-width step, counted, then kernels vs plain."""
    import torch

    from mono_vifi_tpu_torch.config import Options
    from mono_vifi_tpu_torch.ops import cuda
    from mono_vifi_tpu_torch.training import monovifi as M

    cfg = Options(height=H, width=W, batch_size=B, use_affine=True,
                  compute_dtype="bfloat16", fuse_model_type="shared_encoder",
                  vfi_train_scale="large")
    state = M.create_train_state(cfg, seed=0, steps_per_epoch=3981, device=device)
    step = M.MonoViFiStep(state.bundle, device=device)
    train_step = step.make_train_step()
    batch = make_batch(device)
    gen = torch.Generator(device=device).manual_seed(1)
    for _ in range(2):
        train_step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(5):
        metrics = train_step(state, batch, gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    shapes = dict(cuda.LAUNCH_SHAPES)
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    log(f"step: {dt / 5 * 1e3:.1f} ms/step, {B * 5 / dt:.2f} samples/s, loss {loss:.4f}, "
        f"grad_norm {gnorm:.4f}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"launches over 5 steps: {launches}")
    for (name, shape), count in sorted(shapes.items()):
        log(f"  {name} at {shape}: {count}")
    if not (math.isfinite(loss) and math.isfinite(gnorm)):
        raise AssertionError(f"non-finite step: loss {loss}, grad_norm {gnorm}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    # phase 5: same weights, batch and noise, kernels vs every plain version:
    # the loss terms, and the gradient norm of the pose net's parameters,
    # which reaches the loss through the photometric warps' grid gradient
    noise = {k: torch.randn(s, generator=gen, device=device)
             for k, s in step.noise_shapes(B, H, W).items()}
    pose_params = [q for role in ("pose_encoder", "pose")
                   for q in state.bundle.role(role).parameters()]

    terms = ("loss", "loss_base", "loss_dc", "loss_sadc")

    def loss_terms_and_pose_grad_norm():
        loss, m = step.loss_fn(batch, noise=noise)
        grads = torch.autograd.grad(loss, pose_params)
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        return [float(m[t].detach()) for t in terms] + [float(norm)]

    got = loss_terms_and_pose_grad_norm()
    with cuda.plain_versions():
        ref = loss_terms_and_pose_grad_norm()
    pairs = zip(terms + ("pose-net gradient norm",), got, ref)
    for term, a, b in pairs:
        rel = abs(a - b) / max(abs(b), 1e-12)
        log(f"whole step {term}: kernels {a:.6f} plain {b:.6f} rel {rel:.2e} (tol 1e-3)")
        if not (math.isfinite(a) and rel <= 1e-3):
            raise AssertionError(f"whole-step {term} differs: {a} vs {b}")
    return launches, shapes


def inference_phase(device):
    """Phase 6: single- and multi-frame inference through the entry
    modules' predict functions, timed, counted and checked."""
    import torch

    from mono_vifi_tpu_torch import evaluation
    from mono_vifi_tpu_torch import evaluate_depth as ED
    from mono_vifi_tpu_torch import evaluate_depth_mf as EDM
    from mono_vifi_tpu_torch.config import Options
    from mono_vifi_tpu_torch.ops import cuda
    from mono_vifi_tpu_torch.training.factory import build_bundle
    from mono_vifi_tpu_torch.training.monovifi import multi_frame_disp

    cfg = Options(height=H, width=W, compute_dtype="float32",
                  fuse_model_type="shared_encoder", vfi_test_scale="small")
    bundle = build_bundle(cfg, seed=0, device=device, for_training=False)
    rng = np.random.default_rng(2)
    names = ("color_n1", "color_0", "color_p1")
    batches = [{k: rng.integers(0, 256, (BI, H, W, 3), dtype=np.uint8) for k in names}
               for _ in range(12)]
    n_frames = 10 * BI

    def timed(label, run):
        """2 warm-up batches, then 10 timed and counted -> (predictions,
        launches of the timed batches, the same by kernel and shape)."""
        run(batches[:2])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        pred = run(batches[2:])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches, shapes = dict(cuda.LAUNCHES), dict(cuda.LAUNCH_SHAPES)
        log(f"inference {label}: {dt / 10 * 1e3:.2f} ms/batch of {BI}, "
            f"{n_frames / dt:.2f} frames/s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches {launches}")
        if pred.shape != (n_frames, H, W) or not np.isfinite(pred).all():
            raise AssertionError(f"{label}: predictions {pred.shape} not finite")
        return pred, launches, shapes

    sf_args = ED.eval_args(["--post_process"])
    pred_sf, _, _ = timed("single-frame (flip post-processing)",
                       lambda bs: ED.predict_disps(sf_args, bundle, (b["color_0"] for b in bs)))
    mf_args = EDM.eval_args([])
    pred, launches, shapes = timed("multi-frame", lambda bs: EDM.predict_disps_mf(mf_args, bundle, bs))
    if launches["bilinear_sample_table"] <= 0:
        raise AssertionError("bilinear_sample_table not launched on the multi-frame path")

    imgs = [ED.to_device_images(batches[2][k], device) for k in names]
    dk = multi_frame_disp(bundle, *imgs)
    with cuda.plain_versions():
        dp = multi_frame_disp(bundle, *imgs)
    err = (dk - dp).abs().max().item()
    log(f"multi-frame disparity, kernels vs plain: max abs error {err:.3e} (tol 1e-5)")
    if not err <= 1e-5:
        raise AssertionError(f"multi-frame disparities differ: {err}")

    gts = [rng.uniform(1.0, 80.0, (375, 1242)).astype(np.float32) for _ in range(n_frames)]
    for g in gts:
        g[rng.random(g.shape) < 0.8] = 0.0  # sparse, like projected lidar
    for label, p in (("single-frame", pred_sf), ("multi-frame", pred)):
        log(f"KITTI eigen protocol, {label} predictions (random weights and synthetic "
            "ground truths: the numbers say nothing of accuracy):")
        metrics = evaluation.evaluate_kitti(p, gts, "eigen", printer=log)
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"non-finite {label} metrics {metrics}")
    return launches, shapes


def write_kitti_tree(root, n_frames: int = 62, n_test: int = N_TEST):
    """A KITTI-raw drive of uint8 PNG frames at the native 1242x375 (a
    smooth colour field panning across the frames, plus noise, from a numpy
    seed), train and test split files and sparse synthetic ground truths;
    -> the splits root."""
    import os

    from PIL import Image

    rng = np.random.default_rng(5)
    drive = "2011_09_26/2011_09_26_drive_0001_sync"
    img_dir = os.path.join(root, "kitti", drive, "image_02", "data")
    os.makedirs(img_dir)
    ys, xs = np.mgrid[0:375, 0:1242 + 4 * n_frames] / 60.0
    ph = rng.uniform(0, 2 * np.pi, (3, 2))
    field = np.stack([127.5 + 100.0 * np.sin(xs + ph[c, 0]) * np.cos(ys + ph[c, 1])
                      for c in range(3)], -1).astype(np.uint8)
    for i in range(n_frames):  # the camera pans 4 pixels a frame
        img = field[:, 4 * i:4 * i + 1242] + rng.integers(0, 16, (375, 1242, 3), np.uint8)
        Image.fromarray(img).save(os.path.join(img_dir, f"{i:010d}.png"), compress_level=1)
    splits = os.path.join(root, "splits")
    lines = [f"{drive} {i} l" for i in range(1, n_frames - 1)]
    for split, files in (("smoke", lines), ("eigen", lines[:n_test])):
        os.makedirs(os.path.join(splits, "kitti", split))
        for kind in ("train", "test"):
            with open(os.path.join(splits, "kitti", split, f"{kind}_files.txt"), "w") as f:
                f.write("\n".join(files))
    gts = [rng.uniform(1.0, 80.0, (375, 1242)).astype(np.float32) for _ in range(n_test)]
    for g in gts:
        g[rng.random(g.shape) < 0.8] = 0.0  # sparse, like projected lidar
    np.savez_compressed(os.path.join(splits, "kitti", "eigen", "gt_depths.npz"),
                        data=np.array(gts, dtype=object))
    return splits


def driver_phase(card: str) -> dict:
    """Phase 7: the training driver at full width on real PNG decoding:
    epoch 0, its evaluation and save, a resumed trainer, epoch 1."""
    import dataclasses
    import os
    import tempfile

    import torch

    from mono_vifi_tpu_torch import train as T
    from mono_vifi_tpu_torch.config import parse_options
    from mono_vifi_tpu_torch.ops import cuda

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        T.SPLITS_DIR = write_kitti_tree(tmp)
        log(f"driver: synthetic KITTI tree written in {time.perf_counter() - t0:.1f} s")
        cfg = parse_options([
            "-c", "configs/resnet18/ResNet18_KITTI_MR.txt",
            "--data_path", os.path.join(tmp, "kitti"), "--log_dir", os.path.join(tmp, "logs"),
            "--split", "smoke", "--eval_split", "eigen", "--num_epochs", "2",
            "--save_frequency", "3", "--log_frequency", "1", "--weights_init", "scratch",
            "--device", "cuda", "--resume", "False",
        ])
        log(f"driver: {cfg.exp_name}, {cfg.backbone} {cfg.width}x{cfg.height}, batch "
            f"{cfg.batch_size}, affine {cfg.use_affine}, {cfg.fuse_model_type}, "
            f"{cfg.compute_dtype}, VFI {cfg.vfi_train_scale} / {cfg.vfi_test_scale}, "
            f"{cfg.num_workers} loader threads")
        t1 = T.Trainer(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        t1.run_epoch(0)
        torch.cuda.synchronize()
        wall0 = time.perf_counter() - t0
        steps, step_shapes = dict(cuda.LAUNCHES), dict(cuda.LAUNCH_SHAPES)
        mid = torch.load(t1.ckpt_path, map_location="cpu", weights_only=True)
        if (mid["epoch"], mid["batch_idx"], mid["step_in_total"]) != (0, 4, 4):
            raise AssertionError(f"mid-epoch checkpoint at {mid['epoch']}, "
                                 f"{mid['batch_idx']}, {mid['step_in_total']}")
        log("driver: mid-epoch checkpoint at epoch 0, batch_idx 4, step 4")
        del mid
        cuda.reset_launch_counts()
        t1.end_epoch(0)
        evals, eval_shapes = dict(cuda.LAUNCHES), dict(cuda.LAUNCH_SHAPES)
        if evals["bilinear_sample_table"] <= 0:
            raise AssertionError("bilinear_sample_table not launched in the driver's eval")
        # the evaluation's disparities with the kernels against every plain
        # version, on the trained bf16 weights and the test split's frames
        dk = t1._predict_disps(multi_frame=True)
        with cuda.plain_versions():
            dp = t1._predict_disps(multi_frame=True)
        err = float(np.abs(dk - dp).max())
        log(f"driver: multi-frame evaluation disparities, kernels vs plain: max abs error "
            f"{err:.3e} (tol 1e-5)")
        if not err <= 1e-5:
            raise AssertionError(f"driver's multi-frame disparities differ: {err}")
        saved = torch.load(t1.ckpt_path, map_location="cpu", weights_only=True)
        if not os.path.exists(os.path.join(t1.log_path, "models", "model_0.pth")):
            raise AssertionError("no models/model_0.pth")
        history0, results = t1.history, dict(t1.eval_results)
        t1.close()
        del t1

        t2 = T.Trainer(dataclasses.replace(cfg, resume=True))
        at = (t2.ep_start, t2.batch_start, t2.state.step)
        if at != (1, 0, 6):
            raise AssertionError(f"resumed at epoch, batch, step {at}, expected (1, 0, 6)")
        got = t2.state.optimizer.state_dict()["state"]
        for i, s in saved["optimizer"]["state"].items():
            for k, v in s.items():
                if not torch.equal(got[i][k].cpu(), v):
                    raise AssertionError(f"optimizer state {i}.{k} differs after resume")
        for role, m in t2.bundle.trainable_roles().items():
            for k, v in m.state_dict().items():
                if not torch.equal(v.cpu(), saved[role][k]):
                    raise AssertionError(f"{role}.{k} differs after resume")
        log(f"driver: resumed at epoch 1, step 6; {len(got)} optimizer states and every "
            "weight and BatchNorm buffer equal to the saved ones bit for bit")
        del saved
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        t2.run_epoch(1)
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        for k, v in cuda.LAUNCHES.items():
            steps[k] += v
        for k, v in cuda.LAUNCH_SHAPES.items():
            step_shapes[k] = step_shapes.get(k, 0) + v
        t2.end_epoch(1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        history1 = t2.history
        results.update(t2.eval_results)
        t2.close()

    missing = [k for k, v in steps.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched in the driver's steps: {missing}")
    losses = [h["loss"] for h in history0 + history1]
    if len(losses) != 12 or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"driver losses {losses}")
    if len(results) != 4:
        raise AssertionError(f"evaluations missing: {sorted(results)}")
    for key, res in results.items():
        if not all(math.isfinite(v) for v in res.values()):
            raise AssertionError(f"non-finite metrics {key}: {res}")
    for label, hist, wall in (("epoch 0", history0, wall0),
                              ("epoch 1, resumed", history1, wall1)):
        data = [h["data_s"] * 1e3 for h in hist]
        step = [h["step_s"] * 1e3 for h in hist]
        # the warm window: from the end of step 1 to the end of step 6, the
        # mid-epoch checkpoint after step 4 inside it
        window = hist[-1]["t"] - hist[0]["t"]
        other = window * 1e3 - sum(data[1:]) - sum(step[1:])
        log(f"driver {label} ({card}): {len(hist)} steps; data wait {np.mean(data):.1f} "
            f"ms/step (steps 2-6: {np.mean(data[1:]):.1f}), step {np.mean(step):.1f} ms/step "
            f"(steps 2-6: {np.mean(step[1:]):.1f}); {len(hist) * B / wall:.2f} samples/s "
            f"over the epoch, {(len(hist) - 1) * B / window:.2f} over the timed window of "
            f"steps 2-6 ({window * 1e3:.1f} ms, of which {other:.1f} ms outside data wait and "
            "step: logging and the mid-epoch checkpoint), on the host clock")
    log(f"driver ({card}): peak memory {peak:.2f} GiB")
    log(f"driver: launches over the 12 steps {steps}; in the epoch-0 evaluation {evals}")
    return {"steps": steps, "step_shapes": step_shapes, "eval": evals,
            "eval_shapes": eval_shapes}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from mono_vifi_tpu_torch.ops.cuda import build

    device = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {build.last_build_seconds:.1f} s)")

    kernels = kernel_phase(device)
    launches, shapes = step_phase(device)
    inference, inference_shapes = inference_phase(device)
    driver = driver_phase(card)
    # each variant's counts are those of the path it belongs to: the training
    # step's (phase 4, and the driver's 12 steps as driver_launches), the
    # multi-frame inference's (phase 6) or the driver's evaluation (phase 7);
    # a variant on no path carries its kernel's phase-4 count
    for name, e in kernels.items():
        for v in [e] + e.get("variants", []):
            path = v.get("path")
            if path == "multi-frame inference":
                counts, by_shape = inference, inference_shapes
            elif path == DRIVER_EVAL:
                counts, by_shape = driver["eval"], driver["eval_shapes"]
            else:
                counts, by_shape = launches, shapes
            v["launches"] = counts[name]
            if "launch_shape" not in v:
                continue
            shape = v.pop("launch_shape")
            v["launches_at_shape"] = by_shape.get((name, shape), 0)
            if path in ("multi-frame inference", DRIVER_EVAL):
                if v["launches_at_shape"] <= 0:
                    raise AssertionError(f"{name} not launched at {shape} on the {path}")
            else:
                v["driver_launches"] = driver["steps"][name]
                v["driver_launches_at_shape"] = driver["step_shapes"].get((name, shape), 0)
    log(json.dumps({"kernels": list(kernels.values())}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
