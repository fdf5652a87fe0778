"""Training-step throughput of the port on one card (the counterpart of the
root bench.py).

Times the fused Mono-ViFI training step (reference train.py:698-886: two
IFRNet-L synthesis pairs and the flows, 6 pose pairs, the single- and
multi-frame depth branches, the photometric, SVDC and SADC losses, the
backward and the AdamW update) at the reference configuration
configs/resnet18/ResNet18_KITTI_MR.txt (ResNet18, 640x192, batch 10, affine
branch, shared_encoder, bf16 compute), random weights from seed 0, on a
uint8 batch from a numpy seed, and prints one JSON line last:

    python -m mono_vifi_tpu_torch.bench [--backbone ResNet18|LiteMono|DHRNet]
        [--batch N] [--hr] [--device cuda]

`--backbone` takes another backbone at its KITTI-MR batch (LiteMono 8,
D-HRNet 6); `--hr` the high-resolution configuration (the *_KITTI_HR.txt
size, 320x1024, batch 4, the encoder recomputed in the backward pass);
`--batch` overrides the batch. The step runs on the card; with no card it
raises unless `--device cpu` is given.

The command line turns cuDNN's autotuner on for the card
(`cudnn.benchmark`), as the training entry does, so the step runs the
convolution algorithms users' runs pick; `run` alone leaves the switch as
its caller set it. The run: 2 warm-up steps (the first under PyTorch's
FLOP counter; every step has the same shapes, so the autotuner tries its
algorithms in the first), then 3 windows of 10 steps, each timed on the
host clock between two synchronizations with the last loss read to a
Python float, and on the card between two CUDA events. `value` is the samples per second of the
median window. A line before the last prints each window's samples/s,
ms/step by the host clock and by the events, the events' span over the
host's (near 1 whenever the host waits for the card at the window's end:
the events bracket the idle gaps too, so it is no busy share; the
profiler gives that, profile_torch_step.py), the peak memory and the
card's name and power limit.

`vs_baseline` compares with an estimated PyTorch reference throughput of
20 samples/s (about 2 steps/s at batch 10 on a V100-class GPU; the
reference repository publishes no throughput, see BASELINE.md).

`tflop_per_step` is counted by torch.utils.flop_counter over one whole
step: forward, backward, the optimizer and the frozen IFRNet. It counts
matrix products and convolutions; the hand-written kernels' own arithmetic
(samples, splats, the SSIM map: under 2% of the step's device time) and
elementwise work are not counted. `mfu_vs_989tflops_bf16` divides the
counted rate by the H100 SXM's dense bf16 peak of 989.4 TFLOP/s.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from mono_vifi_tpu_torch.config import Options

BASELINE_SAMPLES_PER_SEC = 20.0  # estimated PyTorch-GPU reference (see above)
PEAK_BF16_FLOP_PER_S = 989.4e12  # H100 SXM, dense
MR_BATCH = {"ResNet18": 10, "LiteMono": 8, "DHRNet": 6}  # configs/*/*_KITTI_MR.txt
HR_SIZE, HR_BATCH = (320, 1024), 4


def make_batch(B: int, H: int, W: int, device, seed: int = 0) -> dict:
    """A training batch of B uint8 frames of H x W in the data pipeline's
    format (NHWC images and masks uint8, intrinsics for an H x W image, the
    affine branch's parameters) on `device`, drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
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


def bench_options(argv=None) -> Options:
    """The root bench.py's command line (plus `--device`) -> the step's
    configuration."""
    ap = argparse.ArgumentParser(description="Training-step throughput of the port")
    ap.add_argument("--backbone", default="ResNet18", choices=tuple(MR_BATCH),
                    help="ResNet18 (default, the tracked metric) | LiteMono | DHRNet")
    ap.add_argument("--batch", type=int, default=0,
                    help="override the batch (default: the reference config's)")
    ap.add_argument("--hr", action="store_true",
                    help="the high-resolution 320x1024 configuration (reference "
                         "*_KITTI_HR.txt: batch 4, encoder recomputed in the backward)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    H, W = HR_SIZE if args.hr else (192, 640)
    return Options(
        height=H, width=W, batch_size=args.batch or (HR_BATCH if args.hr
                                                     else MR_BATCH[args.backbone]),
        backbone=args.backbone, use_affine=True, compute_dtype="bfloat16",
        fuse_model_type="shared_encoder", encoder_remat=args.hr, weights_init="scratch",
        device=args.device,
    )


def metric_name(cfg: Options, device: torch.device) -> str:
    """bench.py's metric names, with `torch` and the device: the tracked
    ResNet18 KITTI-MR step, else one naming the backbone, size and batch."""
    where = "1gpu" if device.type == "cuda" else "cpu"
    if (cfg.backbone, cfg.width, cfg.height, cfg.batch_size) == ("ResNet18", 640, 192, 10):
        return f"monovifi_torch_train_samples_per_sec_640x192_bs10_{where}"
    return (f"monovifi_torch_{cfg.backbone.lower()}_train_samples_per_sec_"
            f"{cfg.width}x{cfg.height}_bs{cfg.batch_size}_{where}")


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def run(cfg: Options, device, iters: int = 10, windows: int = 3) -> dict:
    """Time the training step of `cfg` on `device` (see the module
    docstring); print the windows' line, then the JSON record; -> the
    record."""
    from mono_vifi_tpu_torch.training import monovifi as M
    from mono_vifi_tpu_torch.training.factory import resolve_device
    from mono_vifi_tpu_torch.utils import flops

    dev = resolve_device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    B, H, W = cfg.batch_size, cfg.height, cfg.width
    state = M.create_train_state(cfg, seed=0, steps_per_epoch=3981, device=dev)
    train_step = M.MonoViFiStep(state.bundle, device=dev).make_train_step()
    batch = make_batch(B, H, W, dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    step_flops = flops(lambda: train_step(state, batch, gen), grad=True)
    float(train_step(state, batch, gen)["loss"])
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    host, span = [], []
    for _ in range(windows):
        sync()
        if on_card:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            metrics = train_step(state, batch, gen)
        if on_card:
            end.record()
        loss = float(metrics["loss"])
        sync()
        host.append(time.perf_counter() - t0)
        span.append(start.elapsed_time(end) / 1e3 if on_card else None)
        if not np.isfinite(loss):
            raise FloatingPointError(f"non-finite loss {loss}")
    median = statistics.median(host)
    where = card_name() if on_card else "cpu"
    parts = []
    for i, (h, s) in enumerate(zip(host, span)):
        events = (f"{s / iters * 1e3:.2f} ms/step by CUDA events, event span / host span "
                  f"{s / h:.1%}" if s is not None else "device time not measured")
        parts.append(f"window {i}: {B * iters / h:.2f} samples/s, {h / iters * 1e3:.2f} "
                     f"ms/step by the host clock, {events}")
    peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB" if on_card
            else "not measured")
    print(f"bench {cfg.backbone} {W}x{H} batch {B}, {cfg.compute_dtype}, encoder_remat "
          f"{cfg.encoder_remat} on {where}: " + "; ".join(parts) + f"; peak memory {peak}",
          flush=True)
    rate = B * iters / median
    rec = {
        "metric": metric_name(cfg, dev),
        "value": rate,
        "unit": "samples/s",
        "vs_baseline": rate / BASELINE_SAMPLES_PER_SEC,
        "tflop_per_step": step_flops / 1e12,
        "mfu_vs_989tflops_bf16": step_flops * iters / median / PEAK_BF16_FLOP_PER_S,
        "device": where,
    }
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> dict:
    """The command line: cuDNN's autotuner on for the card, as the training
    entry sets it (mono_vifi_tpu_torch.train.run); -> the record."""
    cfg = bench_options(argv)
    if torch.device(cfg.device).type == "cuda":
        torch.backends.cudnn.benchmark = True
    return run(cfg, cfg.device)


if __name__ == "__main__":
    main()
