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
  8. the LiteMono and D-HRNet training steps (configs/litemono/
     LiteMono_KITTI_MR.txt: batch 8; configs/dhrnet/DHRNet_KITTI_MR.txt:
     batch 6; each 640x192, affine, shared_encoder, bf16, IFRNet-L, parsed
     through `parse_options` as a user runs them, random weights from a
     seed) as phases 4 and 5: ms/step, samples/s and peak memory; every
     kernel's launches, by shape (each shape phase 3 checked for the path
     launched > 0); loss terms and the pose net's gradient norm kernels vs
     plain (rel 1e-3) on the same weights, batch, noise and LiteMono
     stochastic-depth masks;
  9. multi-frame inference of LiteMono, D-HRNet and ResNet50 (and the
     single-frame one of the first two) as phase 6: ms/batch, frames/s,
     the table sample's launches (> 0, and at each shape phase 3 checked
     for the path), disparities kernels vs plain within 1e-5 (D-HRNet's
     weights by torch's default init: the port's saturates its
     disparities; in every inference phase at most half of the compared
     disparities may lie within 1e-3 of 0 or 1);
 10. VFI training (configs/vfi/IFRNet_L_KITTI.txt through `parse_options`:
     IFRNet-L, batch 16, the 160x576 crop, bf16; random init from the
     config's seed) on phase 7's synthetic tree (its 60 lines twice): 2
     warm-up and 5 timed steps on the loader's first batch (ms/step,
     samples/s, peak memory; `bilinear_sample` and `bilinear_sample_bwd`
     launched once a step at (32, 3, 160, 576)); loss and gradient norm
     kernels vs plain (rel 1e-3) on the same weights and batch; the real
     `VFITrainer`'s epoch of 7 steps with a checkpoint after step 5, a
     trainer resumed from it bit for bit (weights and optimizer state) that
     takes steps 6-7, the epoch-end checkpoint, and the depth `Trainer`
     taking it as its frozen IFRNet-L weight for weight;
 11. `test_simple` and `test_video` (the entry modules' `main`, random
     weights) on four PNG frames of that tree at 640x192: the files they
     write, test_video's table-sample launches at batch 1 (at each shape
     phase 3 checked for it), its multi-frame disparities with the kernels
     against every plain version within 1e-5;
 12. multi-card training, two ranks sharing the card (mono_vifi_tpu_torch.
     parallel.spawn_local on cuda:0 with gloo: NCCL refuses two ranks on one
     card; a file rendezvous): each rank takes two steps of
     ResNet18_KITTI_MR.txt at local batch 5 and of IFRNet_L_KITTI.txt at
     local batch 8 (full width, random weights from a seed; smooth frames,
     rank r holding rows r*b:(r+1)*b of the global batch, the global
     draws cut to its rows), in f32 from the port's init and in the
     configs' bf16 from torch's default init (`DDP_RUNS`), against one
     process at batch 10 and 16 on the same weights, batches and draws
     (its step 2 from rank 0's state after step 1): loss terms and
     gradient norm at each step, every BatchNorm buffer and each module's
     parameters after step 2, rel 1e-3 (the bf16 gradient norm 3e-3: see
     DDP_TOL), equal across the ranks; bf16 from the port's init is
     compared and printed without a limit; each kernel launched on both bf16
     paths (by shape on rank 0), ms/step and peak memory per rank; then a
     group of one rank at the whole bf16 batch, its step 1 against the two
     ranks' (rel 1e-3) and the single process's (printed);
 13. the real `Trainer` with `distributed` at a world of 1 on NCCL (the env
     rendezvous) against the plain one-card `Trainer` from the same seed
     on phase 7's tree: 3 steps and a checkpoint after steps 2 and 3, in
     f32 and in bf16, each NCCL step from the plain trainer's state before
     it: the losses step for step rel 1e-5 (f32) and 1e-3 (bf16), ms/step
     of each;
 14. the ResNet18 step with `encoder_remat` against the same step without
     it on the same weights, batch and draws: loss terms, gradient norm and
     BatchNorm buffers rel 1e-3, the statistics moved once; ms/step and peak
     memory each way;
 15. the port's bench (mono_vifi_tpu_torch.bench.main, as `python -m
     mono_vifi_tpu_torch.bench` runs it, cudnn.benchmark on: the ResNet18
     KITTI-MR step, then `--hr`, 320x1024 at batch 4 with encoder_remat):
     its windows' line and JSON line each, every kernel launched in each at
     phase 4's shapes and the HR ResNet18 step's; then the default through
     `bench.run` with cudnn.benchmark off (the autotuner's effect);
 16. the port's convergence smoke (mono_vifi_tpu_torch.convergence_smoke at
     its defaults: 300 bf16 steps on the analytic scene at 96x320, batch 2,
     no affine branch; the port's random init, drawn by the JAX package's
     rule): abs_rel and the disparity's range every 50 steps,
     its JSON line and both abs_rel numbers; the loss must fall below 0.85
     of its first tenth's, every kernel launched at the shapes phase 3
     checked for it;
 17. the three configs/*/*_KITTI_HR.txt (1024x320, batches 4, 3, 3) as
     phase 8's steps (parse_options, ms/step, samples/s, peak memory,
     launches by shape, loss terms and pose gradient norm kernels vs plain
     rel 1e-3); then ResNet18_KITTI_HR.txt through the real `Trainer` on
     phase 7's tree (12 lines: an epoch of 3 steps), started from phase 7's
     models/model_0.pth through --pretrained_path (every key loaded bit for
     bit, none missing or unexpected), its per-epoch single- and
     multi-frame evaluation at 1024x320 (multi-frame disparities kernels vs
     plain within 1e-5) and its save;
 18. a synthetic Cityscapes tree (mono_vifi_tpu_torch.data.synthetic: 36
     preprocessed training stacks of 3 frames at 1024x384, 4 test frames
     of 2048x1024 with their neighbours, camera files, synthetic ground
     truths): ResNet18_CS.txt (512x192, batch 12) through the real
     `Trainer` as in phase 17 (an epoch of 3 steps, the Cityscapes
     evaluation protocol), then LiteMono_CS.txt and DHRNet_CS.txt (batches
     8 and 6) as phase 8's steps;
 19. configs/vfi/IFRNet_L_CS.txt (crop 176x480) on that tree and
     IFRNet_S_KITTI.txt on phase 7's through `VFITrainer`: 2 warm-up and 3
     timed steps of the trainer's own state on its first batch, the image
     warps' kernels launched once a step at the crop, loss and gradient
     norm kernels vs plain (rel 1e-3);
 20. the loader benchmarks as child processes, each a fresh process as a
     user runs it (a bench inside this process reads 7-12% low): `python -m
     mono_vifi_tpu_torch.bench_loader --samples 80` (the `__getitem__`
     stages and the loader's rate with and without the affine branch),
     `python -m mono_vifi_tpu_torch.bench_e2e --loader-sweep` (1, 2, 4, 8
     workers) and `python -m mono_vifi_tpu_torch.bench_e2e --steps 60`
     (loader-fed training samples/s, its data wait), logged beside phase
     15's device-only rate; each must exit 0 with a JSON record last that
     has its keys and a finite, positive value;
 21. the golden parity check (`python -m mono_vifi_tpu_torch.golden_parity`
     through its `main`) on phase 7's tree (an `eigen_benchmark` split
     beside its `eigen`: the same 8 lines and synthetic ground truths),
     phase 7's models/model_0.pth and phase 10's IFRNet-L, at the entry
     modules' defaults (640x192, batch 4, f32 with TF32 off): with no
     golden source it must return 2; single-frame with --post_process and
     --mf (--vfi_scale large), each against golden numbers computed by its
     `run_ours` on the CPU (every kernel's plain version), must return 0
     with all seven metrics of each split within 1e-4 of the CPU's, and
     single-frame 1 with a golden a1 moved by 0.01; --mf must launch the
     table sample at the multi-frame inference's shapes (`golden_launches`
     in the kernels' line); the ms of each card and CPU run;
 22. the whole run's time, one JSON line describing every kernel (each
     variant's launches those of its own path), then the result line.

Phase 3 also checks and times every kernel at the shapes phases 8-19 give
it (the splat at channel groups of 5 and 9, the table sample bit for bit at
18 to 2048 channels and at batch 1, the sample and its grid gradient at the
VFI crops, every kernel at the two-rank step's local batch of 5 and the
VFI step's of 8, at the HR configs' 320x1024 and the Cityscapes configs'
192x512 with their batches, the table sample at the HR and Cityscapes
Trainers' evaluations, and every kernel at the convergence smoke's 96x320,
batch 2, without the affine branch's shapes), each variant naming its
"phase".
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import sys
import tempfile
import time

import numpy as np

B, H, W = 10, 192, 640
BI = 4  # the evaluation entry points' default batch
N_TEST = 8  # phase 7's test split: one evaluation batch of 8 (batch_size 10)
DRIVER_EVAL = "training driver's per-epoch multi-frame evaluation"
HR, CS = (320, 1024), (192, 512)  # (height, width) of *_KITTI_HR.txt and *_CS.txt


# each backbone's encoder levels (channels, height, width) that the fusion
# module warps, at an input of h x w (models/fusion.py: LiteMono fuses from
# its stride-4 level)
def resnet18_levels(h, w):
    return ((64, h // 2, w // 2), (64, h // 4, w // 4), (128, h // 8, w // 8),
            (256, h // 16, w // 16), (512, h // 32, w // 32))


def litemono_levels(h, w):
    return ((48, h // 4, w // 4), (80, h // 8, w // 8), (128, h // 16, w // 16))


def dhrnet_levels(h, w):
    return ((64, h // 2, w // 2), (18, h // 4, w // 4), (36, h // 8, w // 8),
            (72, h // 16, w // 16), (144, h // 32, w // 32))


RESNET18_LEVELS = resnet18_levels(H, W)
RESNET50_LEVELS = ((64, H // 2, W // 2), (256, H // 4, W // 4), (512, H // 8, W // 8),
                   (1024, H // 16, W // 16), (2048, H // 32, W // 32))
# the training paths besides phase 4's whose kernels phase 3 checks at their
# shapes: (label, config, batch, encoder levels, (height, width)). Phase 8:
# the other backbones at 640x192; phases 17-18: the KITTI-HR and Cityscapes
# configurations (ResNet18's Cityscapes steps are those of its Trainer)
BACKBONE_STEPS = (
    ("LiteMono step", "configs/litemono/LiteMono_KITTI_MR.txt", 8, litemono_levels(H, W), (H, W)),
    ("D-HRNet step", "configs/dhrnet/DHRNet_KITTI_MR.txt", 6, dhrnet_levels(H, W), (H, W)),
)
HR_STEPS = (
    ("ResNet18 HR step", "configs/resnet18/ResNet18_KITTI_HR.txt", 4, resnet18_levels(*HR), HR),
    ("LiteMono HR step", "configs/litemono/LiteMono_KITTI_HR.txt", 3, litemono_levels(*HR), HR),
    ("D-HRNet HR step", "configs/dhrnet/DHRNet_KITTI_HR.txt", 3, dhrnet_levels(*HR), HR),
)
CS_STEPS = (
    ("LiteMono CS step", "configs/litemono/LiteMono_CS.txt", 8, litemono_levels(*CS), CS),
    ("D-HRNet CS step", "configs/dhrnet/DHRNet_CS.txt", 6, dhrnet_levels(*CS), CS),
)
CS_DRIVER = ("Cityscapes driver steps", "configs/resnet18/ResNet18_CS.txt", 12,
             resnet18_levels(*CS), CS)
HR_DRIVER = "HR driver steps"  # ResNet18_KITTI_HR.txt's Trainer: HR_STEPS[0]'s shapes
# the HR and Cityscapes Trainers' per-epoch multi-frame evaluations, bf16:
# (label, evaluation batch, levels): phase 7's 8 test frames in batches of
# 4, and the synthetic Cityscapes tree's N_CS_TEST frames in one batch
N_CS_TEST = 4
DRIVER_EVALS = (("HR driver evaluation", 4, resnet18_levels(*HR)),
                ("Cityscapes driver evaluation", N_CS_TEST, resnet18_levels(*CS)))
# phase 12: two ranks sharing the card, each at half of the ResNet18 step's
# batch and of the VFI step's; phase 3 checks the kernels at their shapes
DDP_STEP, DDP_VFI = "two-rank step", "two-rank VFI step"
DDP_B, DDP_VFI_B = B // 2, 16 // 2
# phase 16: the convergence smoke at its command line's defaults (ResNet18,
# shared_all, tiny VFI, batch 2 at 96x320) and without the affine branch: no
# 3B affine stack, rotation or SADC restore
CONVERGENCE = ("convergence smoke", None, 2, resnet18_levels(96, 320), (96, 320))
NO_AFFINE = {CONVERGENCE[0]}
KERNEL_STEPS = BACKBONE_STEPS + HR_STEPS + CS_STEPS + (
    CS_DRIVER, (DDP_STEP, None, DDP_B, RESNET18_LEVELS, (H, W)), CONVERGENCE)
# the multi-frame inference of each other backbone (batch BI, f32): (label,
# backbone, its levels, whether single-frame inference runs too)
BACKBONE_INFERENCE = (
    ("LiteMono multi-frame inference", "LiteMono", BACKBONE_STEPS[0][3], True),
    ("D-HRNet multi-frame inference", "DHRNet", BACKBONE_STEPS[1][3], True),
    ("ResNet50 multi-frame inference", "ResNet50", RESNET50_LEVELS, False),
)
# phase 10: VFI training from configs/vfi/IFRNet_L_KITTI.txt (IFRNet-L, batch 16,
# crop 160x576; both frames' image warps in one launch); phase 19: the same
# from IFRNet_L_CS.txt (crop 176x480) and IFRNet_S_KITTI.txt; phase 11:
# test_video at batch 1 (multi-frame: 2 uses of 3 planes per fusion level)
VFI_STEP = "VFI step"
VFI_B, VFI_CROP, VFI_CROP_CS = 16, (160, 576), (176, 480)
VFI_CONFIGS = (("VFI CS step", "configs/vfi/IFRNet_L_CS.txt", VFI_CROP_CS),
               ("VFI-S step", "configs/vfi/IFRNet_S_KITTI.txt", VFI_CROP))
VFI_SAVE = 4  # phase 10's save_frequency: a mid-epoch checkpoint after step 5
TEST_VIDEO = "test_video"
EXTRA_PHASES = [label for label, *_ in KERNEL_STEPS + BACKBONE_INFERENCE + DRIVER_EVALS
                + VFI_CONFIGS] + [VFI_STEP, TEST_VIDEO, DDP_VFI]
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
    def sample_inputs(n, c, mode, h=H, w=W):
        img = torch.rand((n, c, h, w), generator=gen, device=device)
        if mode == "zeros":
            angle = (torch.rand((n,), generator=gen, device=device) - 0.5) * 10.0
            gx, gy = rotation_grid(angle, h, w)
        else:
            gx, gy = sampling.flow_to_grid(smooth_flow(gen, n, h, w, 40.0, 10.0, device))
        return img, gx.contiguous(), gy.contiguous()

    variants = []
    sample_cases = [(B, None, (H, W))] + [(b, label, hw) for label, _, b, _, hw in KERNEL_STEPS]
    # the VFI steps' image warps, both frames of the batch in one launch: at
    # the KITTI crop (phases 10, 12 and IFRNet-S's in 19) and at the
    # Cityscapes crop (configs/vfi/IFRNet_L_CS.txt, phase 19)
    vfi_path = "VFI training image warps, 2B frames"
    vfi_cases = [(2 * VFI_B, VFI_CROP, VFI_STEP)] + [
        (2 * VFI_B, crop, label) for label, _, crop in VFI_CONFIGS] + [
        (2 * DDP_VFI_B, VFI_CROP, DDP_VFI)]
    for n, c, mode, td, path, phase, hw in [
        (12 * b, 3, "border", torch.bfloat16, "photometric warp, 6B targets x 2 sources", ph, hw)
        for b, ph, hw in sample_cases
    ] + [(12 * B, 3, "border", torch.float32, None, None, (H, W))] + [  # f32 taps
        case for b, ph, hw in sample_cases for case in (
            (6 * b, 3, "border", torch.bfloat16, "photometric warp, 3B affine targets x 2", ph,
             hw),
            (4 * b, 3, "border", torch.bfloat16, "IFRNet synthesis, 2B pairs x 2 frames", ph, hw),
            (2 * b, 3, "zeros", torch.float32, "affine rotation of the 2B synthesized frames",
             ph, hw),
            (3 * b, 1, "zeros", torch.float32, "SADC depth restore (forward)", ph, hw),
        ) if ph not in NO_AFFINE or case[4].startswith("IFRNet")
    ] + [(n, 3, "border", torch.bfloat16, vfi_path, phase, hw)
         for n, hw, phase in vfi_cases]:
        img, gx, gy = sample_inputs(n, c, mode, *hw)
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
            | ({"path": path, "launch_shape": tuple(img.shape)} if path else {})
            | ({"phase": phase} if phase else {}))
    out["bilinear_sample"] = variants[0] | {"variants": variants[1:]}

    # its grid gradient at the 6B photometric shape, bf16 taps as there; then
    # the other paths' 6B and 3B photometric shapes
    variants = []
    stack_path = {12: "photometric warp, 6B targets x 2 sources",
                  6: "photometric warp, 3B affine targets x 2"}

    def sample_bwd_case(img, gx, gy, path, phase, w=W):
        ct = torch.randn(img.shape, generator=gen, device=device)
        td = torch.bfloat16
        kx, ky = WP.bilinear_sample_bwd(img, gx, gy, ct, tap_dtype=td)
        px, py = WP.bilinear_sample_grid_bwd_plain(img, gx, gy, ct, tap_dtype=td)
        err = max((kx - px).abs().max().item(), (ky - py).abs().max().item())
        # the channel sums run in another order than autograd's reductions:
        # four f32 roundings of each of the C terms, each at most max|ct| *
        # max|img|, scaled by the unnormalize's (w - 1) / 2
        tol = 4 * 3 * 2.0**-23 * (w - 1) / 2 * ct.abs().max().item() * img.abs().max().item()
        ms = time_ms(lambda: WP.bilinear_sample_bwd(img, gx, gy, ct, tap_dtype=td))
        pms = time_ms(lambda: WP.bilinear_sample_grid_bwd_plain(img, gx, gy, ct, tap_dtype=td),
                      iters=5)
        grid = torch.stack([gx, gy], -1)
        lib = time_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
            ct, img, grid, 0, 1, True, [False, True]))
        return entry(
            "bilinear_sample_bwd", "mono_vifi_tpu_torch/csrc/warp.cu",
            "none: the port's own gradient kernel (the JAX side took the grid's "
            "gradient of mono_vifi_tpu/ops/pallas/warp.py:258 in XLA)",
            err, tol, ms, pms, 2 * img.numel() * 4 + 4 * gx.numel() * 4,
            30.0 * gx.numel() + 16.0 * img.numel(), lib,
        ) | {"shape": f"img, ct {tuple(img.shape)} f32, bf16 taps, border"} | (
            {"path": path, "launch_shape": tuple(img.shape)} if path else {}) | (
            {"phase": phase} if phase else {})

    for k, n, phase, (h, w) in [(12, 12 * B, None, (H, W))] + [
            (k, k * b, label, hw) for label, _, b, _, hw in KERNEL_STEPS
            for k in ((12,) if label in NO_AFFINE else (12, 6))]:
        img, gx, gy = sample_inputs(n, 3, "border", h, w)
        variants.append(sample_bwd_case(img, gx, gy, stack_path[k], phase, w))
        del img, gx, gy
    # the VFI steps' image-warp gradient (the flows' training signal)
    for n, (h, w), phase in vfi_cases:
        img, gx, gy = sample_inputs(n, 3, "border", h, w)
        variants.append(sample_bwd_case(img, gx, gy, vfi_path, phase, w))
        del img, gx, gy
    out["bilinear_sample_bwd"] = variants[0] | {"variants": variants[1:]}

    # kernels 2 and 3: the photometric map over the 6B-target stack, then
    # the 3B-target stack, ragged shapes (odd width: no float2 loads), H = 3,
    # W = 3 and the map without SSIM (an elementwise pass); then the other
    # paths' 6B and 3B stacks (the 3B stack's backward only with the affine
    # branch: without it the 3B map is the identity reprojection's, no
    # gradient)
    N = 6 * B

    def photometric_pair(n, h, w):
        x = torch.rand((n, 3, h, w), generator=gen, device=device)
        return x, (x + 0.1 * torch.randn(x.shape, generator=gen, device=device)).clamp(0, 1)

    x, y = photometric_pair(N, H, W)
    variants = []
    stacks = [(k * b, label, hw) for label, _, b, _, hw in KERNEL_STEPS for k in (6, 3)]
    bwd_stacks = [(k * b, label, hw) for label, _, b, _, hw in KERNEL_STEPS
                  for k in ((6,) if label in NO_AFFINE else (6, 3))]
    on_path = {(N, H, W), (3 * B, H, W)} | {(n, *hw) for n, _, hw in stacks}
    for n, h, w, use_ssim, phase in (
            [(N, H, W, True, None), (3 * B, H, W, True, None), (8, 187, 629, True, None),
             (8, 3, W, True, None), (8, H, 3, True, None), (N, H, W, False, None)]
            + [(n, *hw, True, label) for n, label, hw in stacks]):
        if phase:
            xs, ys = photometric_pair(n, h, w)
        else:
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
            | ({"launch_shape": tuple(xs.shape)} if use_ssim and (n, h, w) in on_path else {})
            | ({"phase": phase} if phase else {}))
    out["ssim_l1_fwd"] = variants[0] | {"variants": variants[1:]}
    # the one-launch backward at the path's shape, then ragged shapes (H, W
    # not multiples of the 16x32 tile; H = 3 and W = 3, where the reflect
    # fold reaches across the whole edge)
    variants = []
    for n, h, w, phase in ([(N, H, W, None), (8, 187, 629, None), (8, 3, W, None),
                            (8, H, 3, None)] + [(n, *hw, label) for n, label, hw in bwd_stacks]):
        if phase:
            xs, ys = photometric_pair(n, h, w)
        else:
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
            | ({"launch_shape": tuple(xs.shape)} if (n, h, w) in on_path else {})
            | ({"phase": phase} if phase else {}))
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
                   out_dtype=torch.float32, phase=None):
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
        ) | {"shape": f"ct {tuple(ct.shape)} {str(ct.dtype)[6:]} -> {str(out_dtype)[6:]}, {label}",
             "channel_group": SP.splat_channel_group(ct.shape[1], h, w, U_)}
            | extra | ({"launch_shape": tuple(ct.shape)} if path else {})
            | ({"phase": phase} if phase else {}))
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

    # the other paths' fusion levels (6b uses of 3b planes, channel groups of
    # 5 and 9 among them)
    for phase, _, b, levels, _ in KERNEL_STEPS:
        ids_b = torch.tensor([q * b + j for q in TABLE_USES for j in range(b)],
                             dtype=torch.int32, device=device)
        for level, (C, h, w) in enumerate(levels):
            gx, gy = sampling.flow_to_grid(smooth_flow(
                gen, 6 * b, h, w, 10.0 * w / (W // 2), 4.0 * h / (H // 2), device))
            f = sampling.border_factors((h, w), gx, gy)
            ctb = torch.randn((6 * b, C, h, w), generator=gen, device=device).to(torch.bfloat16)
            splat_case(ctb, gx, gy, f, (h, w), ids_b, 3 * b, "border",
                       f"{3 * b} unique planes (fusion level {level})",
                       "mono_vifi_tpu/ops/pallas/splat.py:77", path=True,
                       out_dtype=torch.bfloat16, phase=phase)
    del ctb

    for b, phase, (h, w) in [(B, None, (H, W))] + [
            (b, label, hw) for label, _, b, _, hw in KERNEL_STEPS if label not in NO_AFFINE]:
        angle = (torch.rand((3 * b,), generator=gen, device=device) - 0.5) * 10.0
        gx, gy = rotation_grid(-angle, h, w)
        f = [t.contiguous() for t in sampling.zeros_factors((h, w), gx, gy)]
        ct1 = torch.rand((3 * b, 1, h, w), generator=gen, device=device)
        splat_case(ct1, gx, gy, f, (h, w), None, None, "zeros",
                   "zeros mode (SADC restore, direct path)",
                   "mono_vifi_tpu/ops/pallas/splat.py:166", path=True, phase=phase)
    out["bilinear_splat"] = variants[0] | {"variants": variants[1:]}

    # kernel 5: the fusion table warp's forward at the five levels of each of
    # its paths, one launch each per step or batch: the training step (60
    # uses of 30 planes, bf16), the multi-frame inference (8 uses of 12
    # planes, f32) and the training driver's per-epoch multi-frame
    # evaluation (16 uses of 24 planes, bf16: every plane used once, so a
    # use a block where the step's large levels go a plane a block); then
    # level 0 of the step with a grid far out of range; each bit for bit
    from mono_vifi_tpu_torch.ops.cuda import fwarp as FW

    levels = RESNET18_LEVELS
    variants = []
    cases = [(B, TABLE_USES, torch.bfloat16, C, h, w, "smooth", "training step")
             for C, h, w in levels]
    cases += [(BI, (0, 2), torch.float32, C, h, w, "smooth", "multi-frame inference")
              for C, h, w in levels]
    cases += [(N_TEST, (0, 2), torch.bfloat16, C, h, w, "smooth", DRIVER_EVAL)
              for C, h, w in levels]
    cases += [(b, TABLE_USES, torch.bfloat16, C, h, w, "smooth", label)
              for label, _, b, bl, _ in KERNEL_STEPS for C, h, w in bl]
    cases += [(b, (0, 2), torch.bfloat16, C, h, w, "smooth", label)
              for label, b, bl in DRIVER_EVALS for C, h, w in bl]
    cases += [(BI, (0, 2), torch.float32, C, h, w, "smooth", label)
              for label, _, bl, _ in BACKBONE_INFERENCE for C, h, w in bl]
    cases += [(1, (0, 2), torch.float32, C, h, w, "smooth", TEST_VIDEO) for C, h, w in levels]
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
            | ({"launch_shape": tuple(table.shape)} if path else {})
            | ({"phase": path} if path in EXTRA_PHASES else {}))
        del k, p, table, grid
    out["bilinear_sample_table"] = variants[0] | {"variants": variants[1:]}
    return out


def step_phase(device, config=None, label="step", card=""):
    """Phases 4 and 5: the full-width step, counted, then kernels vs plain;
    ResNet18 as bench.py's, or from `config` through parse_options, as a
    user runs it (phases 8, 17 and 18), on a batch at the config's size."""
    import torch

    from mono_vifi_tpu_torch.bench import make_batch
    from mono_vifi_tpu_torch.config import Options, parse_options
    from mono_vifi_tpu_torch.ops import cuda
    from mono_vifi_tpu_torch.training import monovifi as M

    if config is None:
        cfg = Options(height=H, width=W, batch_size=B, use_affine=True,
                      compute_dtype="bfloat16", fuse_model_type="shared_encoder",
                      vfi_train_scale="large")
    else:
        cfg = parse_options(["-c", config, "--weights_init", "scratch", "--device", "cuda"])
        log(f"{label}: {cfg.exp_name}, {cfg.backbone} {cfg.width}x{cfg.height}, batch "
            f"{cfg.batch_size}, affine {cfg.use_affine}, {cfg.fuse_model_type}, "
            f"{cfg.compute_dtype}, VFI {cfg.vfi_train_scale}")
    nb, h, w = cfg.batch_size, cfg.height, cfg.width
    state = M.create_train_state(cfg, seed=0, steps_per_epoch=3981, device=device)
    step = M.MonoViFiStep(state.bundle, device=device)
    train_step = step.make_train_step()
    batch = make_batch(nb, h, w, device)
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
    log(f"{label}: {dt / 5 * 1e3:.1f} ms/step, {nb * 5 / dt:.2f} samples/s, loss {loss:.4f}, "
        f"grad_norm {gnorm:.4f}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {card}")
    log(f"{label}: launches over 5 steps: {launches}")
    for (name, shape), count in sorted(shapes.items()):
        log(f"  {name} at {shape}: {count}")
    if not (math.isfinite(loss) and math.isfinite(gnorm)):
        raise AssertionError(f"non-finite step: loss {loss}, grad_norm {gnorm}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {label} path: {missing}")

    # phase 5: same weights, batch, noise and stochastic-depth masks,
    # kernels vs every plain version: the loss terms, and the gradient norm
    # of the pose net's parameters, which reaches the loss through the
    # photometric warps' grid gradient
    noise = {k: torch.randn(s, generator=gen, device=device)
             for k, s in step.noise_shapes(nb, h, w).items()}
    noise.update(step.draw_drop_masks(nb, gen))
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
        log(f"whole {label} {term}: kernels {a:.6f} plain {b:.6f} rel {rel:.2e} (tol 1e-3)")
        if not (math.isfinite(a) and rel <= 1e-3):
            raise AssertionError(f"whole {label} {term} differs: {a} vs {b}")
    return launches, shapes


def inference_phase(device, backbone="ResNet18", single=True, card="", torch_init=False):
    """Phase 6: single- and multi-frame inference through the entry
    modules' predict functions, timed, counted and checked; the KITTI
    protocol on ResNet18's predictions. Phase 9 runs it for the other
    backbones (ResNet50: multi-frame only). With `torch_init` the bundle's
    weights are torch's default init (`torch_default_init`). The
    kernels-vs-plain disparities fail the phase where more than half of
    them lie within 1e-3 of 0 or 1: a saturated sigmoid hides any
    difference of its inputs."""
    import torch

    from mono_vifi_tpu_torch import evaluation
    from mono_vifi_tpu_torch import evaluate_depth as ED
    from mono_vifi_tpu_torch import evaluate_depth_mf as EDM
    from mono_vifi_tpu_torch.config import Options
    from mono_vifi_tpu_torch.ops import cuda
    from mono_vifi_tpu_torch.training.factory import build_bundle
    from mono_vifi_tpu_torch.training.monovifi import multi_frame_disp

    cfg = Options(backbone=backbone, height=H, width=W, compute_dtype="float32",
                  fuse_model_type="shared_encoder", vfi_test_scale="small")
    with torch_default_init(torch_init):
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
        log(f"inference {backbone} {label}: {dt / 10 * 1e3:.2f} ms/batch of {BI}, "
            f"{n_frames / dt:.2f} frames/s, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB {card}; launches {launches}")
        if pred.shape != (n_frames, H, W) or not np.isfinite(pred).all():
            raise AssertionError(f"{label}: predictions {pred.shape} not finite")
        return pred, launches, shapes

    if single:
        sf_args = ED.eval_args(["--post_process", "--backbone", backbone])
        pred_sf, _, _ = timed(
            "single-frame (flip post-processing)",
            lambda bs: ED.predict_disps(sf_args, bundle, (b["color_0"] for b in bs)))
    mf_args = EDM.eval_args(["--backbone", backbone])
    pred, launches, shapes = timed("multi-frame", lambda bs: EDM.predict_disps_mf(mf_args, bundle, bs))
    if launches["bilinear_sample_table"] <= 0:
        raise AssertionError("bilinear_sample_table not launched on the multi-frame path")

    imgs = [ED.to_device_images(batches[2][k], device) for k in names]
    dk = multi_frame_disp(bundle, *imgs)
    with cuda.plain_versions():
        dp = multi_frame_disp(bundle, *imgs)
    err = (dk - dp).abs().max().item()
    saturated = ((dp < 1e-3) | (dp > 1 - 1e-3)).float().mean().item()
    log(f"{backbone} multi-frame disparity, kernels vs plain: max abs error {err:.3e} "
        f"(tol 1e-5); {saturated:.1%} of them within 1e-3 of 0 or 1 (at most 50%)")
    if not err <= 1e-5:
        raise AssertionError(f"{backbone} multi-frame disparities differ: {err}")
    if saturated > 0.5:
        raise AssertionError(f"{backbone} multi-frame disparities saturate ({saturated:.1%}): "
                             "the kernels-vs-plain check cannot see a difference")
    if backbone != "ResNet18":
        return launches, shapes

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


def driver_phase(card: str, tmp: str) -> dict:
    """Phase 7: the training driver at full width on real PNG decoding of
    the synthetic tree in `tmp`: epoch 0, its evaluation and save, a resumed
    trainer, epoch 1."""
    import dataclasses
    import os

    import torch

    from mono_vifi_tpu_torch import train as T
    from mono_vifi_tpu_torch.config import parse_options
    from mono_vifi_tpu_torch.ops import cuda

    T.SPLITS_DIR = os.path.join(tmp, "splits")
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


def vfi_step_check(label: str, state, step, batch, crop, card: str, timed: int):
    """The VFI step on one batch: 2 warm-up and `timed` timed steps
    (ms/step, samples/s, peak memory; `bilinear_sample` and
    `bilinear_sample_bwd` launched once a step at the crop), then the loss
    and the gradient norm with the kernels against every plain version on
    the same weights and batch (rel 1e-3: the flows' gradient comes through
    the image warps' grid gradient). -> (launches, launches by shape) of
    the timed steps."""
    import torch

    from mono_vifi_tpu_torch.ops import cuda
    from mono_vifi_tpu_torch.training.monovifi import prepare_batch
    from mono_vifi_tpu_torch.training.optim import global_norm

    n = batch["img0"].shape[0]
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(timed):
        metrics, _ = step(state, batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, shapes = dict(cuda.LAUNCHES), dict(cuda.LAUNCH_SHAPES)
    loss, psnr, gnorm = (float(metrics[k]) for k in ("loss", "psnr", "grad_norm"))
    log(f"{label}: {dt / timed * 1e3:.1f} ms/step, {n * timed / dt:.2f} samples/s, loss "
        f"{loss:.4f}, psnr {psnr:.2f}, grad_norm {gnorm:.4f}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {card}")
    log(f"{label}: launches over {timed} steps: {launches}")
    for (name, shape), count in sorted(shapes.items()):
        log(f"  {name} at {shape}: {count}")
    if not all(math.isfinite(x) for x in (loss, psnr, gnorm)):
        raise AssertionError(f"non-finite {label}: {metrics}")
    for name in ("bilinear_sample", "bilinear_sample_bwd"):
        if shapes.get((name, (2 * n, 3) + tuple(crop)), 0) != timed:
            raise AssertionError(f"{name} not launched once a step at the {label} crop")

    b = prepare_batch(batch, "cuda")

    def loss_and_grad_norm():
        state.optimizer.zero_grad(set_to_none=True)
        out = state.module(b["img0"], b["img2"], b["embt"].reshape(-1, 1, 1, 1),
                           imgt=b["img1"])
        out["loss"].backward()
        return out["loss"].item(), global_norm([p.grad for p in state.params]).item()

    got = loss_and_grad_norm()
    with cuda.plain_versions():
        ref = loss_and_grad_norm()
    for term, x, y in zip(("loss", "gradient norm"), got, ref):
        rel = abs(x - y) / max(abs(y), 1e-12)
        log(f"{label} {term}: kernels {x:.6f} plain {y:.6f} rel {rel:.2e} (tol 1e-3)")
        if not (math.isfinite(x) and rel <= 1e-3):
            raise AssertionError(f"{label} {term} differs: {x} vs {y}")
    return launches, shapes


def vfi_phase(card: str, tmp: str):
    """Phase 10: VFI training from configs/vfi/IFRNet_L_KITTI.txt at full
    width (IFRNet-L, batch 16, crop 160x576, bf16; random init from the
    config's seed) on the synthetic tree in `tmp`: the timed step, kernels
    vs plain, then the real VFITrainer's epoch with a mid-epoch checkpoint,
    a resumed trainer, and the depth Trainer taking the checkpoint as its
    frozen VFI. -> (launches, launches by shape) of the timed steps."""
    import dataclasses
    import os
    import shutil

    import torch

    from mono_vifi_tpu_torch import train as T
    from mono_vifi_tpu_torch import train_vfi as TV
    from mono_vifi_tpu_torch.config import parse_options
    from mono_vifi_tpu_torch.data import device_prefetch
    from mono_vifi_tpu_torch.training import vfi as V

    # the 60 lines of phase 7's split twice: 7 steps of 16 a epoch
    splits = os.path.join(tmp, "splits")
    lines = open(os.path.join(splits, "kitti", "smoke", "train_files.txt")).read()
    os.makedirs(os.path.join(splits, "kitti", "vfi"))
    with open(os.path.join(splits, "kitti", "vfi", "train_files.txt"), "w") as f:
        f.write(lines + "\n" + lines)
    TV.SPLITS_DIR = splits
    cfg = parse_options([
        "-c", "configs/vfi/IFRNet_L_KITTI.txt", "--data_path", os.path.join(tmp, "kitti"),
        "--log_dir", os.path.join(tmp, "vfi_logs"), "--split", "vfi", "--num_epochs", "2",
        "--log_frequency", "1", "--save_frequency", str(VFI_SAVE), "--pretrained_path", "",
        "--resume", "False", "--device", "cuda",
    ])
    log(f"{VFI_STEP}: {cfg.exp_name}, IFRNet-{cfg.vfi_scale} {cfg.width}x{cfg.height} "
        f"cropped to {VFI_CROP}, batch {cfg.batch_size}, {cfg.compute_dtype}, "
        f"{cfg.lr_sche_type} lr {cfg.learning_rate} to {cfg.eta_min}, clip {cfg.clip_grad}")
    a = TV.VFITrainer(cfg)

    # the step on the loader's first batch: 2 warm-up and 5 timed steps of a
    # second state from the same seed, counted, then kernels vs plain
    state = V.create_vfi_state(cfg, max(cfg.seed, 0), a.steps_per_epoch, "cuda")
    step = V.make_vfi_train_step(cfg.clip_grad)
    batch = next(iter(device_prefetch(a.loader, "cuda")))
    launches, shapes = vfi_step_check(VFI_STEP, state, step, batch, VFI_CROP, card, 5)
    del state, step, batch

    # the driver: epoch 0 (7 steps; a checkpoint after step 5), a trainer
    # resumed from it, bit for bit, which takes steps 6 and 7
    t0 = time.perf_counter()
    a.run_epoch(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = len(a.history)
    log(f"{VFI_STEP} driver ({card}): epoch 0, {n} steps in {wall:.2f} s, "
        f"{n * VFI_B / wall:.2f} samples/s with logging and visuals every step and the "
        f"checkpoint; losses {[round(h['loss'], 4) for h in a.history]}")
    saved = torch.load(a.ckpt_path, map_location="cpu", weights_only=True)
    at = (saved["epoch"], saved["batch_idx"], saved["step_in_total"])
    if n != 7 or at != (0, VFI_SAVE + 1, VFI_SAVE + 1):
        raise AssertionError(f"VFI driver: {n} steps, checkpoint at {at}")
    c = TV.VFITrainer(dataclasses.replace(cfg, resume=True))
    if (c.ep_start, c.batch_start, c.state.step) != at:
        raise AssertionError("VFI trainer resumed at "
                             f"{(c.ep_start, c.batch_start, c.state.step)}, expected {at}")
    for k, v in c.state.module.state_dict().items():
        if not torch.equal(v.cpu(), saved["VFI"][k]):
            raise AssertionError(f"VFI.{k} differs after resume")
    got = c.state.optimizer.state_dict()["state"]
    for i, st in saved["optimizer"]["state"].items():
        for k, v in st.items():
            if not torch.equal(got[i][k].cpu(), v):
                raise AssertionError(f"VFI optimizer state {i}.{k} differs after resume")
    c.run_epoch(0)
    resumed = [h["loss"] for h in c.history]
    straight = [h["loss"] for h in a.history[VFI_SAVE + 1:]]
    log(f"{VFI_STEP} driver: resumed at {at} with every weight and {len(got)} optimizer "
        f"states bit for bit; steps 6-7 losses {resumed} (uninterrupted {straight})")
    if len(resumed) != 2 or not all(math.isfinite(x) for x in resumed):
        raise AssertionError(f"resumed VFI losses {resumed}")
    a.save_model(0, ep_end=True)
    a.close()
    c.close()

    # the depth trainer's frozen VFI from that checkpoint
    weights = os.path.join(tmp, "weights")
    os.makedirs(weights)
    shutil.copy(a.ckpt_path, os.path.join(weights, "IFRNet_L_KITTI.pth"))
    saved = torch.load(a.ckpt_path, map_location="cpu", weights_only=True)
    T.SPLITS_DIR = splits
    depth = T.Trainer(parse_options([
        "-c", "configs/resnet18/ResNet18_KITTI_MR.txt", "--data_path", os.path.join(tmp, "kitti"),
        "--log_dir", os.path.join(tmp, "logs"), "--exp_name", "frozen_vfi", "--split", "smoke",
        "--eval_split", "eigen", "--weights_dir", weights, "--weights_init", "scratch",
        "--device", "cuda", "--resume", "False",
    ]))
    for k, v in depth.bundle.vfi_train.state_dict().items():
        if not torch.equal(v.cpu(), saved["VFI"][k]):
            raise AssertionError(f"frozen VFI {k} differs from the VFI checkpoint")
    depth.close()
    log(f"{VFI_STEP}: the depth Trainer's frozen IFRNet-L equals the VFI checkpoint "
        f"(epoch {saved['epoch']}, step {saved['step_in_total']}) bit for bit")
    return launches, shapes


def entries_phase(card: str, tmp: str):
    """Phase 11: `test_simple` and `test_video` on PNG frames of the tree in
    `tmp` at 640x192 (random weights; IFRNet-S random-init): the files they
    write, test_video's table-sample launches at batch 1, and its
    multi-frame disparities with the kernels against every plain version.
    -> (launches, launches by shape) of the test_video run."""
    import glob
    import os
    import shutil

    import torch

    from mono_vifi_tpu_torch import test_simple as TS
    from mono_vifi_tpu_torch import test_video as TVID
    from mono_vifi_tpu_torch.ops import cuda

    frames = os.path.join(tmp, "frames")
    os.makedirs(frames)
    src = sorted(glob.glob(os.path.join(tmp, "kitti", "*", "*", "image_02", "data", "*.png")))
    for p in src[:4]:
        shutil.copy(p, frames)
    t0 = time.perf_counter()
    TS.main(TS.parse_args(["--image_path", frames, "--save_npy"]))
    log(f"{TEST_VIDEO}: test_simple over 4 frames in {time.perf_counter() - t0:.2f} s")
    for p in src[:4]:
        name = os.path.splitext(os.path.basename(p))[0]
        disp = np.load(os.path.join(frames, f"{name}_disp.npy"))
        if disp.shape != (H, W) or not np.isfinite(disp).all() or not os.path.exists(
                os.path.join(frames, f"{name}_disp.jpeg")):
            raise AssertionError(f"test_simple output of {name}: {disp.shape}")

    def run(out):
        TVID.main(TVID.parse_args(["--image_path", frames, "--save_npy", "--output_path",
                                   os.path.join(tmp, out)]))

    run("video_warm")
    torch.cuda.synchronize()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    run("video")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, shapes = dict(cuda.LAUNCHES), dict(cuda.LAUNCH_SHAPES)
    log(f"{TEST_VIDEO}: 4 frames (single- and multi-frame each, batch 1) in {dt:.2f} s "
        f"with model build and file writes, {card}; launches {launches}")
    with cuda.plain_versions():
        run("video_plain")
    err = 0.0
    for p in src[:4]:
        name = os.path.splitext(os.path.basename(p))[0]
        k = np.load(os.path.join(tmp, "video", f"{name}_disp_mf.npy"))
        q = np.load(os.path.join(tmp, "video_plain", f"{name}_disp_mf.npy"))
        if k.shape != (H, W) or not np.isfinite(k).all():
            raise AssertionError(f"test_video output of {name}: {k.shape}")
        err = max(err, float(np.abs(k - q).max()))
    log(f"{TEST_VIDEO}: multi-frame scaled disparities, kernels vs plain: max abs error "
        f"{err:.3e} (tol 1e-5)")
    if not err <= 1e-5:
        raise AssertionError(f"test_video multi-frame disparities differ: {err}")
    if not os.path.exists(os.path.join(tmp, "video", "demo.gif")):
        raise AssertionError("test_video wrote no demo.gif")
    return launches, shapes


def smooth_frames(rng, n: int, h: int, w: int, pan: int = 0) -> np.ndarray:
    """n uint8 frames (n, h, w, 3): a smooth colour field, each frame panned
    `pan` pixels from the last, plus noise in [0, 16) (phase 7's synthetic
    drive, at the step's size)."""
    ys, xs = np.mgrid[0:h, 0:w + pan * n] / 60.0
    ph = rng.uniform(0, 2 * np.pi, (n, 3, 2))
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        field = np.stack([127.5 + 100.0 * np.sin(xs[:, pan * i:pan * i + w] + ph[i, c, 0])
                          * np.cos(ys[:, :w] + ph[i, c, 1]) for c in range(3)], -1)
        out[i] = field.astype(np.uint8) + rng.integers(0, 16, (h, w, 3), np.uint8)
    return out


def ddp_batches(device):
    """Phase 12's global batches: the ResNet18 step's (B, smooth frames in
    each image entry, else phase 4's) and the VFI step's (16 triplets of
    frames panning 4 pixels, at the KITTI crop)."""
    import torch

    from mono_vifi_tpu_torch.bench import make_batch

    batch = make_batch(B, H, W, device)
    rng = np.random.default_rng(12)
    for k, v in batch.items():
        if v.dtype == torch.uint8 and v.shape[-1] == 3:
            batch[k] = torch.from_numpy(smooth_frames(rng, B, H, W)).to(device)
    trip = np.stack([smooth_frames(rng, 3, *VFI_CROP, pan=4) for _ in range(2 * DDP_VFI_B)])
    vfi = {f"img{i}": torch.from_numpy(np.ascontiguousarray(trip[:, i])).to(device)
           for i in range(3)}
    vfi["embt"] = torch.full((2 * DDP_VFI_B,), 0.5, device=device)
    return batch, vfi


@contextlib.contextmanager
def torch_default_init(on: bool = True):
    """With `on`, build bundles and VFI states with torch's default
    initializers in place of the port's init (the JAX package's rule,
    mono_vifi_tpu_torch.models.init). Two checks need them: D-HRNet's
    kernels-vs-plain disparities (phase 9), which the port's init
    saturates at 1, where they cannot differ (tests/test_torch_init_dhrnet.py
    finds the JAX package's own D-HRNet saturating there alike); and phase
    12's bf16 limits, set on torch's init (`DDP_RUNS`)."""
    if not on:
        yield
        return
    from mono_vifi_tpu_torch.training import factory, vfi

    saved = factory.init_like_jax_, vfi.init_like_jax_
    factory.init_like_jax_ = vfi.init_like_jax_ = lambda module: module
    try:
        yield
    finally:
        factory.init_like_jax_, vfi.init_like_jax_ = saved


def ddp_steps(device, cfg, batch, vfi_cfg, vfi_batch, rank: int = 0, timed: int = 0,
              step1=None, torch_init: bool = False) -> dict:
    """Phase 12's two steps of the ResNet18 step and of the VFI step (none
    without `vfi_cfg`), from seed 0 (with `torch_init`, torch's default
    init: `torch_default_init`), on this rank's rows of the global batches (all of them
    alone), with the step's generator seeded per step alike on every rank;
    each path's launches counted from 0 just before it; then `timed` more
    steps of each on the host clock with their peak memory. The state after
    step 1 is kept (`step1`); given one, step 2 starts from it instead.
    -> the metrics, parameters and BatchNorm buffers after each path, its
    launches and times."""
    import copy

    import torch

    from mono_vifi_tpu_torch import parallel
    from mono_vifi_tpu_torch.ops import cuda
    from mono_vifi_tpu_torch.training import monovifi as M
    from mono_vifi_tpu_torch.training import vfi as V

    def rows(b, n):
        return {k: v[rank * n:(rank + 1) * n] for k, v in b.items()}

    def run(step_fn, state, module, local, metrics_of, path):
        if parallel.active():
            parallel.broadcast_module_(module)
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        gen = torch.Generator(device=device)
        metrics = []
        for s in range(2):
            if s == 1 and step1 is None:
                kept = {"model": copy.deepcopy(module.state_dict()),
                        "opt": copy.deepcopy(state.optimizer.state_dict()), "step": state.step}
            elif s == 1:
                module.load_state_dict(step1[path]["step1"]["model"])
                state.optimizer.load_state_dict(step1[path]["step1"]["opt"])
                state.step = step1[path]["step1"]["step"]
            gen.manual_seed(1000 + s)
            metrics.append(metrics_of(step_fn(state, local, gen)))
        torch.cuda.synchronize()
        out = {"metrics": metrics, "launches": dict(cuda.LAUNCHES),
               "shapes": dict(cuda.LAUNCH_SHAPES),
               "params": {k: p.detach().cpu().clone() for k, p in module.named_parameters()
                          if p.requires_grad},
               "stats": {k: t.cpu().clone() for k, t in module.named_buffers()}}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(timed):
            step_fn(state, local, gen)
        torch.cuda.synchronize()
        out["ms"] = (time.perf_counter() - t0) / max(timed, 1) * 1e3
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        return out | ({"step1": kept} if step1 is None else {})

    with torch_default_init(torch_init):
        state = M.create_train_state(cfg, 0, steps_per_epoch=3981, device=device)
    train_step = M.MonoViFiStep(state.bundle, device=device).make_train_step()
    depth = run(lambda st, b, g: train_step(st, b, g), state, state.bundle,
                rows(batch, cfg.batch_size), lambda m: {k: float(v) for k, v in m.items()},
                "depth")
    del state, train_step
    torch.cuda.empty_cache()
    if vfi_cfg is None:
        return {"depth": depth}
    with torch_default_init(torch_init):
        vstate = V.create_vfi_state(vfi_cfg, 0, steps_per_epoch=1000, device=device)
    vfi_step = V.make_vfi_train_step(vfi_cfg.clip_grad)
    vfi = run(lambda st, b, g: vfi_step(st, b), vstate, vstate.module,
              rows(vfi_batch, vfi_cfg.batch_size),
              lambda m: {k: float(v) for k, v in m[0].items()}, "vfi")
    del vstate, vfi_step
    torch.cuda.empty_cache()
    return {"depth": depth, "vfi": vfi}


def ddp_configs(batch: int, vfi_batch: int, device="cuda", dtype="bfloat16"):
    """The ResNet18 and VFI configurations at the given batches, computing
    in `dtype` (theirs: bf16)."""
    from mono_vifi_tpu_torch.config import parse_options

    cfg = parse_options(["-c", "configs/resnet18/ResNet18_KITTI_MR.txt", "--weights_init",
                         "scratch", "--batch_size", str(batch), "--device", str(device),
                         "--compute_dtype", dtype])
    vfi_cfg = parse_options(["-c", "configs/vfi/IFRNet_L_KITTI.txt", "--batch_size",
                             str(vfi_batch), "--device", str(device), "--compute_dtype", dtype])
    return cfg, vfi_cfg


# phase 12's limits by compute dtype, on the relative difference of the loss
# terms (and the PSNR), of the gradient norm, and of the BatchNorm buffers
# and each module's parameters after step 2. In f32 the ranks and the single
# process differ in the order of sums and the BatchNorm variance's formula.
# In bf16 the gradient norm moves further, for two reasons (H100 80GB HBM3
# at 700 W, PR 9's chip runs). (1) In a process group every BatchNorm2d is
# `_GlobalBatchNorm` (f32 statistics and normalization, the output cast to
# bf16) where the single process runs cuDNN's bf16 BatchNorm; the two round
# the normalized activations apart, and the pose net's gradient, a
# difference of neighbouring taps, carries that into the norm: a group of
# ONE rank already reads 13.275215 against the single process's 13.269624
# at step 1 (4.2e-4), and two ranks 13.275991, 5.9e-5 from one rank
# (`ddp_phase` compares the three). (2) Each rank's convolutions round its
# half of a weight gradient to bf16 before the all-reduce sums them, where
# the single process rounds the whole: the VFI step, which has no
# BatchNorm, reads 7.4e-4 and 9.6e-4 at steps 1 and 2. The ResNet18 step
# read 4.8e-4 and 1.03e-3. The gradient norm's bf16 limit is 3e-3, about
# three times the largest; everything else keeps 1e-3.
DDP_TOL = {"float32": {"mean": 1e-3, "grad_norm": 1e-3, "state": 1e-3},
           "bfloat16": {"mean": 1e-3, "grad_norm": 3e-3, "state": 1e-3}}

# phase 12's runs: (label, compute dtype, torch's default init?). DDP_TOL was
# set on torch's default init (PR 9). From the port's init (the JAX package's
# rule, the one users train from) the f32 run reads at most 2.67e-5 on the
# parameters after step 2 against its 1e-3, and takes that limit; the bf16 run
# read 1.008e-3 (an H100 80GB HBM3 at 700 W, PR 11), the ranks rounding wider
# activations apart as above, so bf16 keeps its limits on torch's init and its
# run from the port's init is printed beside it with none (label not in DDP_TOL).
DDP_RUNS = (("float32", "float32", False), ("bfloat16", "bfloat16", True),
            ("bfloat16, port's init", "bfloat16", False))


def ddp_rank(out_dir: str, device: str, runs=DDP_RUNS, vfi: bool = True) -> None:
    """One rank of phase 12 (a process of `parallel.spawn_local`, on cuda:0
    with gloo): its share, B / world and 16 / world, of the ResNet18 step
    and (with `vfi`) of the VFI step in each of `runs`; the bf16 steps of
    a group of two then timed; saved for the parent."""
    import torch

    from mono_vifi_tpu_torch import parallel
    from mono_vifi_tpu_torch.ops.cuda import build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load()
    rank, world = parallel.rank_and_world()
    device = torch.device(device)
    batch, vfi_batch = ddp_batches(device)
    out = {}
    for label, dtype, torch_init in runs:
        cfg, vfi_cfg = ddp_configs(B // world, 2 * DDP_VFI_B // world, device, dtype)
        out[label] = ddp_steps(device, cfg, batch, vfi_cfg if vfi else None, vfi_batch, rank,
                               timed=3 if label == "bfloat16" and world > 1 else 0,
                               torch_init=torch_init)
    torch.save(out, f"{out_dir}/world{world}_rank{rank}.pt")


def rel(a, b) -> float:
    """|a - b| over |b|: of numbers, or of vectors by their norms."""
    import torch

    if isinstance(a, torch.Tensor):
        return float(torch.linalg.vector_norm((a - b).double())
                     / max(float(torch.linalg.vector_norm(b.double())), 1e-30))
    return abs(a - b) / max(abs(b), 1e-30)


def groups(tensors: dict, key: str) -> dict:
    """Phase 12's units of comparison: each BatchNorm buffer alone; the
    parameters of each top-level module (a role of the bundle, a part of
    IFRNet) as one vector. A zero-initialized bias alone is the size of
    the update, whose sign follows the sign of gradients near zero."""
    import torch

    if key == "stats":
        return {k: v.float() for k, v in tensors.items()}
    out: dict = {}
    for k, v in tensors.items():
        out.setdefault(k.split(".", 1)[0], []).append(v.float().reshape(-1))
    return {k: torch.cat(v) for k, v in out.items()}


def ddp_phase(card: str, tmp: str, device):
    """Phase 12: two ranks share cuda:0 (gloo: NCCL refuses two ranks on one
    card), each at half the batch of the ResNet18 step (5 of 10) and of
    the VFI step (8 of 16), against one process at the whole batch from the
    same weights, batches and draws, in each of `DDP_RUNS` (f32 and the
    configs' bf16): the loss terms and the gradient norm at each of two
    steps, and after them every BatchNorm buffer and the parameters of
    every module (norm of the difference over the norm, `groups`), within
    DDP_TOL of the single process's (the run without limits printed);
    every number equal across the ranks. The single
    process takes its step 2 from rank 0's state after step 1: AdamW's
    first update moves each weight by the learning rate in the direction of
    its gradient's sign, so where the ranks' halves of a gradient nearly
    cancel, a rounding of either flips it, and step 2 would compare two
    other weights. Then a group of one rank takes the bf16 ResNet18 step
    at the whole batch: its step 1 is held to the two ranks' within the
    loss terms' limit, and its distance from the single process is
    printed (DDP_TOL's comment). -> the launches of rank 0's two bf16
    paths."""
    import torch

    from mono_vifi_tpu_torch import parallel

    on = "cuda:0" if device.type == "cuda" else "cpu"
    t0 = time.perf_counter()
    parallel.spawn_local(ddp_rank, 2, tmp, on, device=on, backend="gloo")
    ranks = [torch.load(f"{tmp}/world2_rank{r}.pt", map_location="cpu", weights_only=False)
             for r in range(2)]
    log(f"ddp: two ranks on {on} took {time.perf_counter() - t0:.1f} s with their start")
    batch, vfi_batch = ddp_batches(device)
    for run, dtype, torch_init in DDP_RUNS:
        tol = DDP_TOL.get(run)  # none: printed only

        def within(e, kind):
            return tol is None or e <= tol[kind]

        def limit(kind):
            return "no limit" if tol is None else f"tol {tol[kind]:.0e}"

        cfg, vfi_cfg = ddp_configs(B, 2 * DDP_VFI_B, device, dtype)
        ref = ddp_steps(device, cfg, batch, vfi_cfg, vfi_batch, step1=ranks[0][run],
                        torch_init=torch_init)
        for path, label in (("depth", DDP_STEP), ("vfi", DDP_VFI)):
            name = f"ddp {label} {run}"
            for s in range(2):
                for k, v in ref[path]["metrics"][s].items():
                    got = [r[run][path]["metrics"][s][k] for r in ranks]
                    e, kind = rel(got[0], v), "grad_norm" if k == "grad_norm" else "mean"
                    log(f"{name} step {s + 1} {k}: ranks {got[0]:.6f} {got[1]:.6f} one process "
                        f"{v:.6f} rel {e:.2e} ({limit(kind)})")
                    if not (math.isfinite(got[0]) and within(e, kind) and got[0] == got[1]):
                        raise AssertionError(f"{name} step {s + 1} {k}: {got} vs {v}")
            for key in ("stats", "params"):
                worst, across = 0.0, 0.0
                mine = [groups(r[run][path][key], key) for r in ranks]
                for k, v in groups(ref[path][key], key).items():
                    if k.endswith("num_batches_tracked"):
                        if not all(torch.equal(m[k], v) for m in mine):
                            raise AssertionError(f"{name} {k} differs")
                        continue
                    worst = max(worst, rel(mine[0][k], v))
                    across = max(across, rel(mine[1][k], mine[0][k]))
                log(f"{name} {key} after step 2 ({len(ref[path][key])} tensors): rank 0 vs one "
                    f"process worst rel {worst:.2e}, rank 1 vs rank 0 {across:.2e} "
                    f"({limit('state')})")
                if not (within(worst, "state") and within(across, "state")):
                    raise AssertionError(f"{name} {key} differ: {worst}, {across}")
        if run == "bfloat16":
            one = ref["depth"]["metrics"][0]
    t0 = time.perf_counter()
    parallel.spawn_local(ddp_rank, 1, tmp, on, DDP_RUNS[1:2], False, device=on,
                         backend="gloo")
    world1 = torch.load(f"{tmp}/world1_rank0.pt", map_location="cpu", weights_only=False)
    log(f"ddp: one rank on {on} took {time.perf_counter() - t0:.1f} s with its start")
    for k, v in world1["bfloat16"]["depth"]["metrics"][0].items():
        two = ranks[0]["bfloat16"]["depth"]["metrics"][0][k]
        e, t = rel(two, v), DDP_TOL["bfloat16"]["mean"]
        log(f"ddp {DDP_STEP} bfloat16 step 1 {k}: a group of one rank {v:.6f}, two ranks "
            f"{two:.6f} rel {e:.2e} (tol {t:.0e}); one process without a group {one[k]:.6f} "
            f"rel {rel(v, one[k]):.2e}")
        if not (math.isfinite(v) and e <= t):
            raise AssertionError(f"ddp one rank vs two, step 1 {k}: {v} vs {two}")
    for path, label in (("depth", DDP_STEP), ("vfi", DDP_VFI)):
        for r, out in enumerate(ranks):
            o = out["bfloat16"][path]
            log(f"ddp {label} bfloat16 rank {r} ({card}): {o['ms']:.1f} ms/step with the other "
                f"rank on the same card (no throughput figure), peak memory "
                f"{o['peak_gib']:.2f} GiB; launches over the 2 steps {o['launches']}")
        log(f"ddp {label} bfloat16: launches by shape on rank 0:")
        for (name, shape), count in sorted(ranks[0]["bfloat16"][path]["shapes"].items()):
            log(f"  {name} at {shape}: {count}")
    depth, vfi = ranks[0]["bfloat16"]["depth"], ranks[0]["bfloat16"]["vfi"]
    missing = [k for k, v in depth["launches"].items() if v <= 0]
    missing += [k for k in ("bilinear_sample", "bilinear_sample_bwd") if vfi["launches"][k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the two-rank paths: {missing}")
    return {DDP_STEP: (depth["launches"], depth["shapes"]),
            DDP_VFI: (vfi["launches"], vfi["shapes"])}


# phase 13's limits on the losses, by compute dtype. Each step of the NCCL
# trainer starts from the plain trainer's state before that step: AdamW's
# first update moves each weight by the learning rate in the direction of
# its gradient's sign, so from step 2 on two free runs compare other weights
# (bf16 on an H100 80GB HBM3 at 700 W: 1.65e-4, 5.8e-4, 7.3e-4 at steps 1-3
# of two free runs, PR 9's first runs). In f32 the two trainers then differ only in the BatchNorm's
# arithmetic (`_GlobalBatchNorm`, sums of x and x^2, against cuDNN) and the
# order of sums; in bf16 they also round the BatchNorm's output apart
# (DDP_TOL's comment).
NCCL1_TOL = {"float32": 1e-5, "bfloat16": 1e-3}


def nccl1_phase(card: str, tmp: str, device, extra_args=()) -> None:
    """Phase 13: the real `Trainer` with `distributed` at a world of 1 on
    NCCL (the env rendezvous as torchrun sets it) against the plain
    one-card `Trainer`, from the same seed on phase 7's synthetic tree:
    3 steps with a checkpoint after steps 2 and 3, in f32 and in the
    config's bf16, each step of the NCCL trainer from the plain one's state
    before it; the losses step for step within NCCL1_TOL; ms/step of each. (`extra_args` cut the
    configuration for a rehearsal on the CPU, where the backend is
    gloo.)"""
    import copy
    import dataclasses
    import os
    import socket

    import torch
    import torch.distributed as dist

    from mono_vifi_tpu_torch import parallel
    from mono_vifi_tpu_torch import train as T
    from mono_vifi_tpu_torch.config import ENV_RENDEZVOUS, parse_options

    splits = os.path.join(tmp, "splits")
    lines = open(os.path.join(splits, "kitti", "smoke", "train_files.txt")).read().split("\n")
    os.makedirs(os.path.join(splits, "kitti", "nccl1"))
    with open(os.path.join(splits, "kitti", "nccl1", "train_files.txt"), "w") as f:
        f.write("\n".join(lines[:3 * B]))
    T.SPLITS_DIR = splits
    cfg = parse_options([
        "-c", "configs/resnet18/ResNet18_KITTI_MR.txt", "--data_path", os.path.join(tmp, "kitti"),
        "--log_dir", os.path.join(tmp, "nccl1_logs"), "--split", "nccl1", "--eval_split", "eigen",
        "--num_epochs", "1", "--save_frequency", "1", "--log_frequency", "1",
        "--weights_init", "scratch", "--device", str(device), "--resume", "False",
        *extra_args,
    ])

    def share(t, states: dict, keep: bool) -> None:
        """Before each step (where the trainer seeds its draws) keep the
        trainer's state, or take the kept one of the same step."""
        seed = t.noise_seed

        def at(step: int) -> int:
            if keep:
                states[step] = (copy.deepcopy(t.bundle.state_dict()),
                                copy.deepcopy(t.state.optimizer.state_dict()))
            else:
                t.bundle.load_state_dict(states[step][0])
                t.state.optimizer.load_state_dict(states[step][1])
            if device.type == "cuda":  # the copies stay out of the step's time
                torch.cuda.synchronize()
            return seed(step)

        t.noise_seed = at

    for dtype, tol in NCCL1_TOL.items():
        runs, states = {}, {}
        for label, distributed in (("plain", False), ("nccl", True)):
            if distributed:
                with socket.socket() as sock:
                    sock.bind(("127.0.0.1", 0))
                    port = sock.getsockname()[1]
                os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                                  MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            t = T.Trainer(dataclasses.replace(cfg, exp_name=f"{label}_{dtype}",
                                              distributed=distributed, compute_dtype=dtype))
            try:
                backend = dist.get_backend() if parallel.active() else None
                if distributed and (backend != parallel.default_backend(device) or t.world != 1):
                    raise AssertionError(f"nccl1: backend {backend}, world {t.world}")
                share(t, states, keep=not distributed)
                t.run_epoch(0)
                if device.type == "cuda":
                    torch.cuda.synchronize()
                saved = torch.load(t.ckpt_path, map_location="cpu", weights_only=True)
                runs[label] = ([h["loss"] for h in t.history], [h["step_s"] for h in t.history],
                               (saved["epoch"], saved["batch_idx"], saved["step_in_total"]))
                t.close()
            finally:
                vars(t).pop("noise_seed", None)  # `share`'s closure holds the trainer
                if parallel.active():
                    dist.destroy_process_group()
                for k in ENV_RENDEZVOUS:
                    os.environ.pop(k, None)
            del t
        states.clear()
        for label, (losses, step_s, at) in runs.items():
            log(f"nccl1 {label} Trainer {dtype} ({card}): losses {losses}; step "
                f"{[round(x * 1e3, 1) for x in step_s]} ms (steps 2-3: "
                f"{np.mean(step_s[1:]) * 1e3:.1f} ms/step); last checkpoint at {at}")
            if len(losses) != 3 or at != (0, 3, 3):
                raise AssertionError(f"nccl1 {label}: {len(losses)} steps, checkpoint at {at}")
        for s, (a, b) in enumerate(zip(runs["nccl"][0], runs["plain"][0])):
            e = rel(a, b)
            log(f"nccl1 {dtype} step {s + 1} (from the plain state): loss NCCL {a:.6f} "
                f"plain {b:.6f} rel {e:.2e} (tol {tol:.0e})")
            if not (math.isfinite(a) and e <= tol):
                raise AssertionError(f"nccl1 {dtype} step {s + 1}: loss {a} vs {b}")


def remat_phase(card: str, device) -> None:
    """Phase 14: the ResNet18 step with `encoder_remat` against the same
    step without it, from the same weights, batch and draws: loss terms and
    gradient norm rel 1e-3, every BatchNorm buffer rel 1e-3 of the no-remat
    step's with `num_batches_tracked` moved once; then 2 warm-up and 3
    timed steps each way, ms/step and peak memory."""
    import dataclasses

    import torch

    from mono_vifi_tpu_torch.bench import make_batch
    from mono_vifi_tpu_torch.training import monovifi as M
    from mono_vifi_tpu_torch.training.optim import global_norm

    cfg, _ = ddp_configs(B, 2 * DDP_VFI_B, device)
    batch = make_batch(B, H, W, device)
    out = {}
    for remat in (False, True):
        state = M.create_train_state(dataclasses.replace(cfg, encoder_remat=remat), 0,
                                     steps_per_epoch=3981, device=device)
        step = M.MonoViFiStep(state.bundle, device=device)
        gen = torch.Generator(device=device).manual_seed(7)
        noise = step.draw_noise(B, H, W, gen)
        before = {k: t.clone() for k, t in state.bundle.named_buffers()}
        loss, metrics = step.loss_fn(batch, noise=noise)
        loss.backward()
        gnorm = float(global_norm([p.grad for p in state.params if p.grad is not None]))
        terms = {k: float(v.detach()) for k, v in metrics.items()} | {"grad_norm": gnorm}
        stats = {k: t.clone() for k, t in state.bundle.named_buffers()}
        moved = {int(stats[k] - before[k]) for k in stats if k.endswith("num_batches_tracked")}
        train_step = step.make_train_step()
        for _ in range(2):
            train_step(state, batch, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(3):
            train_step(state, batch, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 3 * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        out[remat] = (terms, stats, moved, ms, peak)
        log(f"remat {remat} ({card}): {ms:.1f} ms/step, peak memory {peak:.2f} GiB; one step "
            f"moved num_batches_tracked by {sorted(moved)}")
        del state, step, train_step
        torch.cuda.empty_cache()
    ref, got = out[False], out[True]
    for k, v in ref[0].items():
        e = rel(got[0][k], v)
        log(f"remat {k}: remat {got[0][k]:.6f} no remat {v:.6f} rel {e:.2e} (tol 1e-3)")
        if not (math.isfinite(got[0][k]) and e <= 1e-3):
            raise AssertionError(f"remat {k}: {got[0][k]} vs {v}")
    worst = max(rel(got[1][k].float(), v.float()) for k, v in ref[1].items()
                if not k.endswith("num_batches_tracked"))
    log(f"remat: BatchNorm buffers worst rel {worst:.2e} (tol 1e-3); memory saved "
        f"{ref[4] - got[4]:.2f} GiB, time added {got[3] - ref[3]:.1f} ms/step")
    if not (worst <= 1e-3 and got[2] == ref[2] == {1}):
        raise AssertionError(f"remat BatchNorm statistics: rel {worst}, moved {got[2]}")

def bench_phase() -> dict:
    """Phase 15: the port's bench as a user runs it (`python -m
    mono_vifi_tpu_torch.bench`, cudnn.benchmark on), the default ResNet18
    KITTI-MR step, then `--hr`: each prints its windows' line and its JSON
    record; every kernel launched in each run (the counts set to 0 just
    before it). Then the default once more through `bench.run` alone, with
    cudnn.benchmark off as in every other phase: the autotuner's effect.
    -> ({"bench": (counts, by shape), "bench --hr": ...}: phase 4's shapes
    and the HR ResNet18 step's, the default run's samples/s)."""
    import torch

    from mono_vifi_tpu_torch import bench
    from mono_vifi_tpu_torch.ops import cuda

    out = {}
    for argv in ([], ["--hr"]):
        torch.cuda.empty_cache()
        cuda.reset_launch_counts()
        try:
            rec = bench.main(argv)
        finally:
            torch.backends.cudnn.benchmark = False
        launches = dict(cuda.LAUNCHES)
        out[" ".join(["bench"] + argv)] = (launches, dict(cuda.LAUNCH_SHAPES))
        if not argv:
            mr_rate = rec["value"]
        log(f"bench {' '.join(argv) or '(default)'}: launches over its 32 steps {launches}")
        if not (math.isfinite(rec["value"]) and rec["tflop_per_step"] > 0):
            raise AssertionError(f"bench {argv}: {rec}")
        missing = [k for k, v in launches.items() if v <= 0]
        if missing:
            raise AssertionError(f"kernels not launched in the bench {argv}: {missing}")
    torch.cuda.empty_cache()
    rec = bench.run(bench.bench_options([]), "cuda")
    log(f"bench (default) with cudnn.benchmark off: {rec['value']:.2f} samples/s")
    return out, mr_rate


def convergence_phase(card: str) -> tuple:
    """Phase 16: the port's convergence smoke at its command line's defaults
    (`python -m mono_vifi_tpu_torch.convergence_smoke`: 300 steps at 96x320,
    batch 2, bf16, shared_all, tiny VFI, lr 2e-4; the port's random init
    by the JAX package's rule):
    the JSON line, both abs_rel numbers, every kernel launched; the loss
    must fall, loss_last10 < 0.85 * loss_first10 (the criterion of
    tests/test_convergence.py's bf16 test); a trajectory row every 50
    steps. -> (counts, by shape)."""
    import torch

    from mono_vifi_tpu_torch import convergence_smoke as C
    from mono_vifi_tpu_torch.ops import cuda

    torch.cuda.empty_cache()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    _, _, b, _, (h, w) = CONVERGENCE
    out = C.run(steps=300, H=h, W=w, B=b, compute_dtype="bfloat16", log_every=25,
                device="cuda", trace_every=50)
    dt = time.perf_counter() - t0
    launches, shapes = dict(cuda.LAUNCHES), dict(cuda.LAUNCH_SHAPES)
    for step, err, lo, hi, loss in out.pop("trace"):
        log(f"convergence step {step}: abs_rel {err:.4f}, disparity {lo:.4g} to {hi:.4g}"
            + (f", mean loss_base {loss:.5f} since the last row" if loss is not None else ""))
    log(json.dumps({"metric": "convergence_smoke", **out}))
    log(f"convergence: 300 steps in {dt:.1f} s ({card}); loss_base {out['loss_first10']:.5f} "
        f"-> {out['loss_last10']:.5f} (gate: below 0.85 x the first); abs_rel "
        f"{out['abs_rel_initial']:.4f} -> {out['abs_rel_final']:.4f} (printed, not gated); "
        f"launches {launches}")
    if not out["loss_last10"] < 0.85 * out["loss_first10"]:
        raise AssertionError(f"convergence: the loss did not fall enough: {out}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched in the convergence smoke: {missing}")
    return launches, shapes


# phase 20: each child's command and the keys of the record on its last line
LOADER_BENCHES = (
    (["mono_vifi_tpu_torch.bench_loader", "--samples", "80"],
     {"metric", "use_affine", "workers", "value", "unit", "cpu_count"}),
    (["mono_vifi_tpu_torch.bench_e2e", "--loader-sweep"],
     {"metric", "value", "unit", "workers", "stage_uint8", "cpu_count"}),
    (["mono_vifi_tpu_torch.bench_e2e", "--steps", "60"],
     {"metric", "value", "unit", "steps", "workers", "dispatch_fraction", "device"}),
)


def loader_e2e_phase(card: str, bench_rate: float) -> None:
    """Phase 20: the loader benchmarks (LOADER_BENCHES), each a child
    process from the repository root as a user runs it; every line each
    prints is logged. A child that exits non-zero, or whose last line is not
    a JSON record with its keys and a finite, positive `value`, fails the
    run. The e2e step is phase 4's step at phase 4's shapes (phase 3 checks
    its kernels there; phase 7's loader-fed `Trainer` counts their
    launches), so this phase adds nothing to the kernels' line."""
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    for argv, keys in LOADER_BENCHES:
        cmd = [sys.executable, "-m"] + argv
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=300)
        for line in proc.stdout.splitlines():
            log(f"  {argv[0].split('.')[-1]}: {line}")
        if proc.returncode != 0:
            raise AssertionError(f"{' '.join(argv)} exited {proc.returncode}: "
                                 f"{proc.stderr[-4000:]}")
        lines = proc.stdout.strip().splitlines()
        try:
            rec = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError) as e:
            raise AssertionError(f"{' '.join(argv)}: no JSON record last: {e}") from e
        if set(rec) != keys or not (math.isfinite(rec["value"]) and rec["value"] > 0):
            raise AssertionError(f"{' '.join(argv)}: record {rec}, expected keys {keys}")
        log(f"{' '.join(argv)}: {time.perf_counter() - t0:.1f} s")
    log(f"loader-fed training (bench_e2e) {rec['value']:.2f} samples/s against the device-only "
        f"bench's {bench_rate:.2f} (phase 15, inside this process), {card}")


GOLDEN_TOL = 1e-4  # each of the seven metrics, the card against the CPU's plain versions
GOLDEN_MOVE = 0.01  # the negative check's shift of a golden a1
GOLDEN_MODES = (("single-frame", ["--post_process"]), ("multi-frame", ["--mf"]))


def golden_phase(card: str, tmp: str, ckpt: str, weights_dir: str) -> tuple:
    """Phase 21: `python -m mono_vifi_tpu_torch.golden_parity` (its `main`)
    on the synthetic tree in `tmp` (an `eigen_benchmark` split beside its
    `eigen`, the same lines and ground truths), `ckpt` and IFRNet-L from
    `weights_dir`, at the entry modules' defaults (640x192, batch 4, f32).
    No golden source must return 2. Each mode of GOLDEN_MODES: the golden
    numbers from `run_ours` on the CPU (every kernel's plain version), then
    `main --golden` on the card must return 0, all seven metrics of each
    split within GOLDEN_TOL of the CPU's; the single-frame mode must return
    1 with a golden a1 moved by GOLDEN_MOVE. -> (launches, by shape) of the
    multi-frame card run."""
    import shutil

    import torch

    from mono_vifi_tpu_torch import evaluate_depth as ED
    from mono_vifi_tpu_torch import evaluate_depth_mf as EDM
    from mono_vifi_tpu_torch import golden_parity as GP
    from mono_vifi_tpu_torch.ops import cuda

    splits = os.path.join(tmp, "splits")
    shutil.copytree(os.path.join(splits, "kitti", "eigen"),
                    os.path.join(splits, "kitti", "eigen_benchmark"))
    ED.SPLITS_DIR = EDM.SPLITS_DIR = splits
    common = ["--kitti_path", os.path.join(tmp, "kitti"), "--ckpt", ckpt,
              "--weights_dir", weights_dir, "--vfi_scale", "large"]
    rc = GP.main(common)
    log(f"golden parity with no golden source: exit code {rc} (expected 2)")
    if rc != 2:
        raise AssertionError(f"golden_parity with no golden source returned {rc}")
    counts = None
    for label, flags in GOLDEN_MODES:
        name = flags[0][2:]
        t0 = time.perf_counter()
        golden = GP.run_ours(GP.parse_args(common + flags + ["--device", "cpu"]))
        cpu_ms = (time.perf_counter() - t0) * 1e3
        path, save = (os.path.join(tmp, f"{kind}_{name}.json") for kind in ("golden", "ours"))
        with open(path, "w") as f:
            json.dump(golden, f)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        cuda.reset_launch_counts()
        t0 = time.perf_counter()
        rc = GP.main(common + flags + ["--golden", path, "--save", save])
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        launches, shapes = dict(cuda.LAUNCHES), dict(cuda.LAUNCH_SHAPES)
        with open(save) as f:
            ours = json.load(f)["ours"]
        diffs = {(s, k): abs(ours[s][k] - golden[s][k]) for s in GP.SPLITS for k in GP.ALL_NAMES}
        worst = max(diffs, key=diffs.get)
        log(f"golden parity {label}: exit code {rc} (expected 0); card run {card_ms:.1f} ms "
            f"({card}), CPU run {cpu_ms:.1f} ms (plain versions; each with the model build "
            f"and 2 x {N_TEST} frames); largest |Δ| of the seven metrics card vs CPU "
            f"{diffs[worst]:.3e} ({worst[0]} {worst[1]}; tol {GOLDEN_TOL:.0e}); launches "
            f"{launches}")
        if rc != 0:
            raise AssertionError(f"golden_parity {label} against the CPU's numbers returned {rc}")
        if not diffs[worst] <= GOLDEN_TOL:
            raise AssertionError(f"golden parity {label}: {worst} differs by {diffs[worst]}")
        if "--mf" in flags:
            if launches["bilinear_sample_table"] <= 0:
                raise AssertionError("bilinear_sample_table not launched by golden_parity --mf")
            counts = (launches, shapes)
            continue
        # the negative check on the cheaper mode (the comparison is the same)
        golden["eigen"]["a1"] += GOLDEN_MOVE
        with open(path, "w") as f:
            json.dump(golden, f)
        rc = GP.main(common + flags + ["--golden", path])
        log(f"golden parity {label}, eigen a1 moved by {GOLDEN_MOVE}: exit code {rc} "
            "(expected 1)")
        if rc != 1:
            raise AssertionError(f"golden_parity {label} against a moved a1 returned {rc}")
    return counts


def config_driver_phase(card: str, tmp: str, label: str, eval_label: str, argv: list,
                        pretrained: str | None = None) -> dict:
    """Phases 17-18: the real `Trainer` of a KITTI-HR or Cityscapes config
    at its full width on a synthetic tree in `tmp` (`argv`: the config and
    its data paths): with `pretrained`, the weights of that `model_0.pth`
    through `--pretrained_path`, every role's keys those of the file, none
    missing or unexpected, each tensor equal bit for bit; one epoch, its
    single- and multi-frame evaluation (the multi-frame disparities with
    the kernels against every plain version, max abs error 1e-5) and the
    epoch-end save. -> {label: the steps' (launches, by shape), eval_label:
    the evaluation's}."""
    import torch

    from mono_vifi_tpu_torch import train as T
    from mono_vifi_tpu_torch.config import parse_options
    from mono_vifi_tpu_torch.ops import cuda

    T.SPLITS_DIR = os.path.join(tmp, "splits")
    cfg = parse_options(argv + [
        "--log_dir", os.path.join(tmp, "logs"), "--num_epochs", "1", "--save_frequency",
        "1000", "--log_frequency", "1", "--weights_init", "scratch", "--device", "cuda",
        "--resume", "False"] + (["--pretrained_path", pretrained] if pretrained else []))
    log(f"{label}: {cfg.exp_name}, {cfg.dataset}, {cfg.backbone} {cfg.width}x{cfg.height}, "
        f"batch {cfg.batch_size}, affine {cfg.use_affine}, {cfg.fuse_model_type}, "
        f"{cfg.compute_dtype}, VFI {cfg.vfi_train_scale} / {cfg.vfi_test_scale}")
    torch.cuda.empty_cache()
    t = T.Trainer(cfg)
    if pretrained:
        saved = torch.load(pretrained, map_location="cpu", weights_only=True)
        roles = t.bundle.trainable_roles()
        for role, m in roles.items():
            sd = m.state_dict()
            if role not in saved or set(saved[role]) != set(sd):
                raise AssertionError(f"{label}: {role} keys differ from {pretrained}")
            for k, v in sd.items():
                if not torch.equal(v.cpu(), saved[role][k]):
                    raise AssertionError(f"{label}: {role}.{k} differs from {pretrained}")
        kept = t.load_pretrained(pretrained)
        if kept:
            raise AssertionError(f"{label}: load_pretrained kept {kept}")
        log(f"{label}: {sum(len(saved[r]) for r in roles)} tensors of {len(roles)} roles "
            f"loaded from {pretrained} bit for bit; load_pretrained reports no key missing "
            "or of another shape, and the file has no key the model lacks")
        del saved
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda.reset_launch_counts()
    t0 = time.perf_counter()
    t.run_epoch(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps, step_shapes = dict(cuda.LAUNCHES), dict(cuda.LAUNCH_SHAPES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    cuda.reset_launch_counts()
    t.end_epoch(0)
    evals, eval_shapes = dict(cuda.LAUNCHES), dict(cuda.LAUNCH_SHAPES)
    dk = t._predict_disps(multi_frame=True)
    with cuda.plain_versions():
        dp = t._predict_disps(multi_frame=True)
    err = float(np.abs(dk - dp).max())
    log(f"{label}: multi-frame evaluation disparities {dk.shape}, kernels vs plain: max abs "
        f"error {err:.3e} (tol 1e-5)")
    hist, results = t.history, dict(t.eval_results)
    written = os.path.exists(os.path.join(t.log_path, "models", "model_0.pth"))
    t.close()
    del t
    data = [h["data_s"] * 1e3 for h in hist]
    step = [h["step_s"] * 1e3 for h in hist]
    log(f"{label} ({card}): {len(hist)} steps in {wall:.2f} s ({len(hist) * cfg.batch_size / wall:.2f} "
        f"samples/s over the epoch, cold first step included); data wait {np.mean(data):.1f} "
        f"ms/step, step {np.mean(step):.1f} ms/step (steps 2-: {np.mean(step[1:]):.1f}); "
        f"peak memory {peak:.2f} GiB; losses {[round(h['loss'], 4) for h in hist]}")
    log(f"{label}: launches in the steps {steps}; in the evaluation {evals}")
    for (name, shape), count in sorted(step_shapes.items()):
        log(f"  {name} at {shape}: {count}")
    if not err <= 1e-5:
        raise AssertionError(f"{label}: multi-frame disparities differ: {err}")
    if not written:
        raise AssertionError(f"{label}: no models/model_0.pth")
    if len(hist) < 2 or not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"{label}: losses {[h['loss'] for h in hist]}")
    if len(results) != 2 or not all(math.isfinite(v) for r in results.values()
                                    for v in r.values()):
        raise AssertionError(f"{label}: evaluations {results}")
    missing = [k for k, v in steps.items() if v <= 0]
    if missing or evals["bilinear_sample_table"] <= 0:
        raise AssertionError(f"{label}: kernels not launched: {missing}, evaluation {evals}")
    return {label: (steps, step_shapes), eval_label: (evals, eval_shapes)}


def vfi_configs_phase(card: str, tmp: str) -> dict:
    """Phase 19: configs/vfi/IFRNet_L_CS.txt on phase 18's Cityscapes tree
    and IFRNet_S_KITTI.txt on phase 7's KITTI tree (phase 10's split) through
    `VFITrainer` (parsed as a user runs them; random init from the config's
    seed): the trainer's own state and step on its loader's first batch
    (`vfi_step_check`, 3 timed steps). -> {label: (launches, by shape)}."""
    import torch

    from mono_vifi_tpu_torch import train_vfi as TV
    from mono_vifi_tpu_torch.config import parse_options
    from mono_vifi_tpu_torch.data import device_prefetch

    TV.SPLITS_DIR = os.path.join(tmp, "splits")
    out = {}
    for label, config, crop in VFI_CONFIGS:
        cfg = parse_options([
            "-c", config, "--data_path", os.path.join(tmp, "kitti"), "--data_path_pre",
            os.path.join(tmp, "cityscapes_pre"), "--log_dir", os.path.join(tmp, "vfi_logs"),
            "--split", "vfi", "--pretrained_path", "", "--resume", "False", "--device", "cuda",
        ])
        log(f"{label}: {cfg.exp_name}, {cfg.dataset}, IFRNet-{cfg.vfi_scale} "
            f"{cfg.width}x{cfg.height} cropped to {crop}, batch {cfg.batch_size}, "
            f"{cfg.compute_dtype}")
        torch.cuda.empty_cache()
        a = TV.VFITrainer(cfg)
        batch = next(iter(device_prefetch(a.loader, "cuda")))
        out[label] = vfi_step_check(label, a.state, a.train_step, batch, crop, card, 3)
        a.close()
        del a, batch
    return out


def attach_launches(kernels: dict, step: tuple, inference: tuple, driver: dict, extra: dict,
                    bench_counts: dict, golden: tuple) -> None:
    """Give each variant of phase 3's kernels the counts of the path it
    belongs to, (counts, by shape) each: the training step's (phase 4, and
    the driver's 12 steps as driver_launches), the multi-frame inference's
    (phase 6), the driver's evaluation (phase 7) or another path named by
    its "phase" in `extra` (another backbone's step or inference, VFI
    training, test_video, the two-rank steps, the convergence smoke, the HR
    and Cityscapes paths: phases 8-19); a variant on no path carries its
    kernel's phase-4 count. The bench's runs (phase 15) go through phase 4's
    shapes and the HR ResNet18 step's, the golden parity check's multi-frame
    run (phase 21) through the multi-frame inference's: their counts stand
    beside those. Raises where a variant's path did not launch its kernel at
    its shape."""
    def from_bench(v, key, name, shape):
        counts, by_shape = bench_counts[key]
        key = key.replace(" --", "_")
        v[f"{key}_launches"] = counts[name]
        v[f"{key}_launches_at_shape"] = by_shape.get((name, shape), 0)
        if v[f"{key}_launches_at_shape"] <= 0:
            raise AssertionError(f"{name} not launched at {shape} in the {key} run")

    for name, e in kernels.items():
        for v in [e] + e.get("variants", []):
            path = v.get("path")
            if "phase" in v:
                counts, by_shape = extra[v["phase"]]
                v["launches"] = counts[name]
                shape = v.pop("launch_shape")
                v["launches_at_shape"] = by_shape.get((name, shape), 0)
                if v["launches_at_shape"] <= 0:
                    raise AssertionError(f"{name} not launched at {v['shape']} on the "
                                         f"{v['phase']} path")
                if v["phase"] == HR_STEPS[0][0]:  # the same shapes in the HR Trainer
                    counts, by_shape = extra[HR_DRIVER]
                    v["driver_launches"] = counts[name]
                    v["driver_launches_at_shape"] = by_shape.get((name, shape), 0)
                    from_bench(v, "bench --hr", name, shape)
                continue
            if path == "multi-frame inference":
                counts, by_shape = inference
            elif path == DRIVER_EVAL:
                counts, by_shape = driver["eval"], driver["eval_shapes"]
            else:
                counts, by_shape = step
            v["launches"] = counts[name]
            if "launch_shape" not in v:
                continue
            shape = v.pop("launch_shape")
            v["launches_at_shape"] = by_shape.get((name, shape), 0)
            if path == "multi-frame inference":
                v["golden_launches"] = golden[0][name]
                v["golden_launches_at_shape"] = golden[1].get((name, shape), 0)
                if v["golden_launches_at_shape"] <= 0:
                    raise AssertionError(f"{name} not launched at {shape} by golden_parity --mf")
            if path in ("multi-frame inference", DRIVER_EVAL):
                if v["launches_at_shape"] <= 0:
                    raise AssertionError(f"{name} not launched at {shape} on the {path}")
            else:
                v["driver_launches"] = driver["steps"][name]
                v["driver_launches_at_shape"] = driver["step_shapes"].get((name, shape), 0)
                from_bench(v, "bench", name, shape)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from mono_vifi_tpu_torch.bench import card_name
    from mono_vifi_tpu_torch.data.synthetic import write_cityscapes_tree, write_kitti_tree
    from mono_vifi_tpu_torch.ops.cuda import build

    device = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_name()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc {build.last_build_seconds:.1f} s)")
    t_start = t0

    kernels = kernel_phase(device)
    launches, shapes = step_phase(device, card=card)
    inference, inference_shapes = inference_phase(device, card=card)
    extra = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_kitti_tree(tmp)
        log(f"synthetic KITTI tree written in {time.perf_counter() - t0:.1f} s")
        driver = driver_phase(card, tmp)
        # phases 8-11: the other backbones' steps and inference, VFI training
        # and the test entry points, each with its own counts (set to 0 just
        # before the path runs, read just after)
        for label, config, *_ in BACKBONE_STEPS:
            t0 = time.perf_counter()
            extra[label] = step_phase(device, config, label, card)
            log(f"{label}: phase took {time.perf_counter() - t0:.1f} s")
        for label, backbone, _, single in BACKBONE_INFERENCE:
            # D-HRNet's disparities saturate from the port's init (torch_default_init)
            extra[label] = inference_phase(device, backbone, single, card,
                                           torch_init=backbone == "DHRNet")
        for label, phase in ((VFI_STEP, vfi_phase), (TEST_VIDEO, entries_phase)):
            t0 = time.perf_counter()
            extra[label] = phase(card, tmp)
            log(f"{label}: phase took {time.perf_counter() - t0:.1f} s")
        # phases 12-14: multi-card training and encoder_remat
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        extra.update(ddp_phase(card, tmp, device))
        log(f"ddp: phase took {time.perf_counter() - t0:.1f} s")
        for label, phase in (("nccl1", lambda: nccl1_phase(card, tmp, device)),
                             ("remat", lambda: remat_phase(card, device))):
            t0 = time.perf_counter()
            phase()
            log(f"{label}: phase took {time.perf_counter() - t0:.1f} s")
        # phases 15-16: the bench and the convergence smoke, each run's counts
        # kept for the kernels' line
        t0 = time.perf_counter()
        bench_counts, bench_rate = bench_phase()
        log(f"bench: phase took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        extra[CONVERGENCE[0]] = convergence_phase(card)
        log(f"convergence: phase took {time.perf_counter() - t0:.1f} s")
        # phases 17-19: the KITTI-HR and Cityscapes configurations, bare steps
        # and Trainers (HR from phase 7's weights), and the other VFI configs
        for label, config, *_ in HR_STEPS:
            t0 = time.perf_counter()
            extra[label] = step_phase(device, config, label, card)
            log(f"{label}: phase took {time.perf_counter() - t0:.1f} s")
        with open(os.path.join(tmp, "splits", "kitti", "smoke", "train_files.txt")) as f:
            lines = f.read().split("\n")
        os.makedirs(os.path.join(tmp, "splits", "kitti", "hr"))
        with open(os.path.join(tmp, "splits", "kitti", "hr", "train_files.txt"), "w") as f:
            f.write("\n".join(lines[:3 * HR_STEPS[0][2]]))  # an epoch of 3 steps
        t0 = time.perf_counter()
        extra.update(config_driver_phase(
            card, tmp, HR_DRIVER, DRIVER_EVALS[0][0],
            ["-c", HR_STEPS[0][1], "--data_path", os.path.join(tmp, "kitti"), "--split", "hr",
             "--eval_split", "eigen"],
            pretrained=os.path.join(tmp, "logs", "ResNet18_KITTI_MR", "models", "model_0.pth")))
        log(f"{HR_DRIVER}: phase took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        write_cityscapes_tree(tmp, n_train=3 * CS_DRIVER[2], n_test=N_CS_TEST)
        log(f"synthetic Cityscapes tree written in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        extra.update(config_driver_phase(
            card, tmp, CS_DRIVER[0], DRIVER_EVALS[1][0],
            ["-c", CS_DRIVER[1], "--data_path", os.path.join(tmp, "cityscapes"),
             "--data_path_pre", os.path.join(tmp, "cityscapes_pre")]))
        log(f"{CS_DRIVER[0]}: phase took {time.perf_counter() - t0:.1f} s")
        for label, config, *_ in CS_STEPS:
            t0 = time.perf_counter()
            extra[label] = step_phase(device, config, label, card)
            log(f"{label}: phase took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        extra.update(vfi_configs_phase(card, tmp))
        log(f"VFI configs: phase took {time.perf_counter() - t0:.1f} s")
        # phase 20: the loader benchmarks, each its own process
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        loader_e2e_phase(card, bench_rate)
        log(f"loader benchmarks: phase took {time.perf_counter() - t0:.1f} s")
        # phase 21: the golden parity check on phase 7's weights and phase
        # 10's IFRNet-L, against the CPU's numbers
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        golden = golden_phase(
            card, tmp, os.path.join(tmp, "logs", "ResNet18_KITTI_MR", "models", "model_0.pth"),
            os.path.join(tmp, "weights"))
        log(f"golden parity: phase took {time.perf_counter() - t0:.1f} s")
    attach_launches(kernels, (launches, shapes), (inference, inference_shapes), driver, extra,
                    bench_counts, golden)
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from the build to the end")
    log(json.dumps({"kernels": list(kernels.values())}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
