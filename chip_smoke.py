"""Chip smoke test of the PyTorch + CUDA port (mono_vifi_tpu_torch) on one
NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:
  1. the card's name and power limit (nvidia-smi);
  2. build of the hand-written kernels from mono_vifi_tpu_torch/csrc;
  3. each kernel at the shapes its paths give it against its plain PyTorch
     version on the same inputs (max error vs a stated tolerance), with the
     kernel's, the plain version's and, where one exists, a single PyTorch
     call's time (CUDA events), and the least time the card could take;
  4. the full-width training step (ResNet18, 640x192, batch 10, frozen
     IFRNet-L, affine branch, shared_encoder, bf16 compute, random weights
     from a seed): 2 warm-up and 5 timed steps, finite loss and gradient
     norm, and every kernel's launch count over the 5 steps (all > 0);
  5. one step's loss terms with the kernels against the same step with every
     plain version, from the same weights, batch and noise;
  6. the full-width inference path (ResNet18, 640x192, f32 with TF32 off,
     shared_encoder, frozen IFRNet-S, random weights from a seed, batch 4,
     uint8 frames from a numpy seed): single-frame `predict_disps` with flip
     post-processing, then multi-frame `predict_disps_mf`, each 2 warm-up and
     10 timed batches; the table-sample launches of the multi-frame run
     (> 0); its disparities with the kernels against every plain version
     (max abs error 1e-5); the KITTI eigen protocol over the timed
     predictions against synthetic ground truths (finite; random weights,
     so the numbers say nothing of accuracy);
  7. one JSON line describing every kernel, then the result line.
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

    # kernel 1: the photometric warp of 6B targets x 2 sources, 3 channels
    N = 12 * B
    img = torch.rand((N, 3, H, W), generator=gen, device=device)
    gx, gy = sampling.flow_to_grid(smooth_flow(gen, N, H, W, 40.0, 10.0, device))
    ly, lx, a0, a1, c0, c1 = sampling.border_factors((H, W), gx, gy)
    grid = torch.stack([gx, gy], -1)
    lib_ms = time_ms(lambda: F.grid_sample(img, grid, "bilinear", "border", True))
    variants = []
    for td in (torch.bfloat16, torch.float32):
        k = WP.bilinear_taps(img, ly, lx, td)
        p = WP.bilinear_taps_plain(img, ly, lx, td)
        err = (k.float() - p.float()).abs().max().item()
        ms = time_ms(lambda: WP.bilinear_taps(img, ly, lx, td))
        pms = time_ms(lambda: WP.bilinear_taps_plain(img, ly, lx, td), iters=5)
        esize = 2 if td == torch.bfloat16 else 4
        nbytes = img.numel() * 4 + 2 * ly.numel() * 4 + 4 * img.numel() * esize
        variants.append(entry(
            "bilinear_taps", "mono_vifi_tpu_torch/csrc/warp.cu",
            "mono_vifi_tpu/ops/pallas/warp.py:139" if esize == 2
            else "mono_vifi_tpu/ops/pallas/warp.py:59",
            err, 0.0, ms, pms, nbytes, 0.0, lib_ms,
        ) | {"shape": f"img {tuple(img.shape)} f32 -> taps {str(td)[6:]}"})
    out["bilinear_taps"] = variants[0] | {"variants": variants[1:]}

    # kernels 2 and 3: the photometric map over the 6B-target stack
    N = 6 * B
    x = torch.rand((N, 3, H, W), generator=gen, device=device)
    y = (x + 0.1 * torch.randn((N, 3, H, W), generator=gen, device=device)).clamp(0, 1)
    k = PM.ssim_l1_fwd(x, y)
    p = PM.ssim_l1_fwd_plain(x, y)
    err = (k - p).abs().max().item()
    ms = time_ms(lambda: PM.ssim_l1_fwd(x, y))
    pms = time_ms(lambda: PM.ssim_l1_fwd_plain(x, y), iters=5)
    out["ssim_l1_fwd"] = entry(
        "ssim_l1_fwd", "mono_vifi_tpu_torch/csrc/photometric.cu",
        "mono_vifi_tpu/ops/pallas/photometric.py:90", err, 1e-5, ms, pms,
        (2 * x.numel() + k.numel()) * 4, 80.0 * x.numel(), None,
    )
    ct = torch.rand((N, H, W), generator=gen, device=device)
    k = PM.ssim_l1_bwd(x, y, ct)
    p = PM.ssim_l1_bwd_plain(x, y, ct)
    scale = p.abs().max().item()
    err = (k - p).abs().max().item()
    ms = time_ms(lambda: PM.ssim_l1_bwd(x, y, ct))
    pms = time_ms(lambda: PM.ssim_l1_bwd_plain(x, y, ct), iters=5)
    out["ssim_l1_bwd"] = entry(
        "ssim_l1_bwd", "mono_vifi_tpu_torch/csrc/photometric.cu",
        "mono_vifi_tpu/ops/pallas/photometric.py:113", err, 1e-4 * scale, ms, pms,
        (3 * x.numel() + ct.numel()) * 4, 200.0 * x.numel(), None,
    )

    # kernel 4: the fusion warps' backward at level 0 (60 uses of 30 unique
    # 64-channel maps at half resolution, bf16 cotangent), then the SADC
    # rotate's backward (zeros mode, C=1)
    from mono_vifi_tpu_torch.training.monovifi import TABLE_USES

    h, w, C, U = H // 2, W // 2, 64, 3 * B
    N = 6 * B
    ids = torch.tensor([q * B + j for q in TABLE_USES for j in range(B)],
                       dtype=torch.int32, device=device)
    gx, gy = sampling.flow_to_grid(smooth_flow(gen, N, h, w, 10.0, 4.0, device))
    ly, lx, a0, a1, c0, c1 = sampling.border_factors((h, w), gx, gy)
    ctb = torch.randn((N, C, h, w), generator=gen, device=device).to(torch.bfloat16)
    args = (ctb, ly, lx, a0, a1, c0, c1, (h, w), ids, U)
    k = SP.bilinear_splat(*args)
    p = SP.bilinear_splat_plain(*args)
    err = (k - p).abs().max().item()
    tol = 1e-5 * p.abs().max().item()
    ms = time_ms(lambda: SP.bilinear_splat(*args))
    pms = time_ms(lambda: SP.bilinear_splat_plain(*args), iters=5)
    grid = torch.stack([gx, gy], -1)
    dummy = torch.zeros((N, C, h, w), device=device)
    ct32 = ctb.float()
    lib = time_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
        ct32, dummy, grid, 0, 1, True, [True, False]))
    nbytes = ctb.numel() * 2 + 6 * ly.numel() * 4 + ids.numel() * 4 + U * C * h * w * 4
    main = entry(
        "bilinear_splat", "mono_vifi_tpu_torch/csrc/splat.cu",
        "mono_vifi_tpu/ops/pallas/splat.py:77", err, tol, ms, pms, nbytes,
        8.0 * ctb.numel(), lib,
    ) | {"shape": f"ct {tuple(ctb.shape)} bf16, {U} unique planes"}

    N = 3 * B
    angle = (torch.rand((N,), generator=gen, device=device) - 0.5) * 10.0
    gx, gy = rotation_grid(-angle, H, W)
    ly, lx, a0, a1, c0, c1 = sampling.zeros_factors((H, W), gx, gy)
    a0, a1, c0, c1 = (t.contiguous() for t in (a0, a1, c0, c1))
    ct1 = torch.rand((N, 1, H, W), generator=gen, device=device)
    args = (ct1, ly, lx, a0, a1, c0, c1, (H, W))
    k = SP.bilinear_splat(*args)
    p = SP.bilinear_splat_plain(*args)
    err = (k - p).abs().max().item()
    ms = time_ms(lambda: SP.bilinear_splat(*args))
    pms = time_ms(lambda: SP.bilinear_splat_plain(*args), iters=5)
    grid = torch.stack([gx, gy], -1)
    dummy = torch.zeros((N, 1, H, W), device=device)
    lib = time_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
        ct1, dummy, grid, 0, 0, True, [True, False]))
    sadc = entry(
        "bilinear_splat", "mono_vifi_tpu_torch/csrc/splat.cu",
        "mono_vifi_tpu/ops/pallas/splat.py:166", err, 1e-5 * p.abs().max().item(),
        ms, pms, ct1.numel() * 4 + 6 * ly.numel() * 4 + ct1.numel() * 4,
        8.0 * ct1.numel(), lib,
    ) | {"shape": f"ct {tuple(ct1.shape)} f32, zeros mode"}
    out["bilinear_splat"] = main | {"variants": [sadc]}

    # kernel 5: the fusion table warp's forward at level 0 (64 channels at
    # half resolution), on the training step (60 uses of 30 planes, bf16) and
    # on the multi-frame inference path (8 uses of 12 planes, f32)
    from mono_vifi_tpu_torch.ops.cuda import fwarp as FW

    variants = []
    for b, uses, dt in ((B, TABLE_USES, torch.bfloat16), (BI, (0, 2), torch.float32)):
        U, N = 3 * b, len(uses) * b
        ids = torch.tensor([q * b + j for q in uses for j in range(b)],
                           dtype=torch.int32, device=device)
        table = torch.randn((U, C, h, w), generator=gen, device=device).to(dt)
        gx, gy = sampling.flow_to_grid(smooth_flow(gen, N, h, w, 10.0, 4.0, device))
        f = [t.contiguous() for t in sampling.border_factors((h, w), gx, gy)]
        k = FW.bilinear_sample_table(table, ids, *f)
        p = FW.bilinear_sample_table_plain(table, ids, *f)
        err = (k.float() - p.float()).abs().max().item()
        top = p.float().abs().max().item()
        # f32: three roundings of the combine relative to the largest value;
        # bf16: one bf16 ulp of the largest value
        tol = 2.0**-21 * top if dt == torch.float32 else 2.0 ** (math.floor(math.log2(top)) - 7)
        ms = time_ms(lambda: FW.bilinear_sample_table(table, ids, *f))
        pms = time_ms(lambda: FW.bilinear_sample_table_plain(table, ids, *f), iters=5)
        # one library call computing the same function: index_select of the
        # used planes then grid_sample, both timed (the grid in the table's
        # dtype, as grid_sample asks)
        grid = torch.stack([gx, gy], -1).to(dt)
        lib = time_ms(lambda: F.grid_sample(table.index_select(0, ids.long()), grid,
                                            "bilinear", "border", True))
        esize = table.element_size()
        used = len(set(ids.tolist()))
        nbytes = k.numel() * esize + 6 * N * h * w * 4 + used * C * h * w * esize + N * 4
        variants.append(entry(
            "bilinear_sample_table", "mono_vifi_tpu_torch/csrc/fwarp.cu",
            "mono_vifi_tpu/ops/pallas/fwarp.py:47", err, tol, ms, pms, nbytes,
            9.0 * k.numel(), lib,
        ) | {"shape": f"{N} uses of {U} planes ({C}, {h}, {w}) {str(dt)[6:]}",
             "path": "training step" if dt == torch.bfloat16 else "multi-frame inference"})
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
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    log(f"step: {dt / 5 * 1e3:.1f} ms/step, {B * 5 / dt:.2f} samples/s, loss {loss:.4f}, "
        f"grad_norm {gnorm:.4f}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"launches over 5 steps: {launches}")
    if not (math.isfinite(loss) and math.isfinite(gnorm)):
        raise AssertionError(f"non-finite step: loss {loss}, grad_norm {gnorm}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    # phase 5: same weights, batch and noise, kernels vs every plain version
    noise = {k: torch.randn(s, generator=gen, device=device)
             for k, s in step.noise_shapes(B, H, W).items()}
    with torch.no_grad():
        _, mk = step.loss_fn(batch, noise=noise)
        with cuda.plain_versions():
            _, mp = step.loss_fn(batch, noise=noise)
    for term in ("loss", "loss_base", "loss_dc", "loss_sadc"):
        a, b = float(mk[term]), float(mp[term])
        rel = abs(a - b) / max(abs(b), 1e-12)
        log(f"whole step {term}: kernels {a:.6f} plain {b:.6f} rel {rel:.2e} (tol 1e-3)")
        if not rel <= 1e-3:
            raise AssertionError(f"whole-step {term} differs: {a} vs {b}")
    return launches, dt / 5 * 1e3


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
        launches of the timed batches)."""
        run(batches[:2])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        pred = run(batches[2:])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = dict(cuda.LAUNCHES)
        log(f"inference {label}: {dt / 10 * 1e3:.2f} ms/batch of {BI}, "
            f"{n_frames / dt:.2f} frames/s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches {launches}")
        if pred.shape != (n_frames, H, W) or not np.isfinite(pred).all():
            raise AssertionError(f"{label}: predictions {pred.shape} not finite")
        return pred, launches

    sf_args = ED.eval_args(["--post_process"])
    pred_sf, _ = timed("single-frame (flip post-processing)",
                       lambda bs: ED.predict_disps(sf_args, bundle, (b["color_0"] for b in bs)))
    mf_args = EDM.eval_args([])
    pred, launches = timed("multi-frame", lambda bs: EDM.predict_disps_mf(mf_args, bundle, bs))
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
    return launches


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
    launches, _ = step_phase(device)
    inference = inference_phase(device)
    for name, e in kernels.items():
        for v in [e] + e.get("variants", []):
            path = inference if v.get("path") == "multi-frame inference" else launches
            v["launches"] = path[name]
    log(json.dumps({"kernels": list(kernels.values())}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
