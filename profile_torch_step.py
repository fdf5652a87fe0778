"""Where the port's full-width paths spend the card's time.

`--path train` (the default) builds the training step of `--config` (default
configs/resnet18/ResNet18_KITTI_MR.txt: ResNet18, 640x192, batch 10, frozen
IFRNet-L, affine, shared_encoder, bf16; any other depth config gives its own
step), parsed as a user runs it, with random weights from a seed, on a uint8
batch at the config's size; `--path single` and `--path multi` build the
inference paths of the evaluation entry modules (the config's backbone at
the config's size in f32 with TF32 off, frozen IFRNet-S, batch 4 of uint8
frames from a numpy seed, through `predict_disps` with flip post-processing
and `predict_disps_mf`); `--path vfi` builds the VFI training step of
`--config` (default configs/vfi/IFRNet_L_KITTI.txt: IFRNet-L, batch 16, the
160x576 crop, bf16; a Cityscapes config's crop is 176x480) on a batch of
frames from a numpy seed, and also
times the plain feature warps at the step's three levels, forward and
forward + backward (CUDA events), as a share of the step's device time.
`--world1` runs the training step as the one rank of an NCCL process group
(a file rendezvous in a temporary directory), so that every BatchNorm is
the global one (`models.common._GlobalBatchNorm`): the step's multi-card
arithmetic at a world of 1, to set beside the run without it. Each
runs 2 warm-up calls, times 5
with the host clock, then traces 3 with torch.profiler and prints per call:
the device's busy share (kernel time over wall time), the kernel time by
category, the port's kernels, and the 20 kernels that take the most time.
Tracing slows the host, so the busy share is given against both the traced
and the untraced wall time; the peak device memory of the untraced calls is
printed beside their time. The categories are the benchmark's
(`perfbench/trace.py`), with each of the port's kernels by its name; the
port's kernels are told apart by the `__global__` functions in the sources
of the package this script imports, its own checkout's when run from that
checkout's root, so the script reads any version of the port. Run from the
repository root on a machine with a CUDA device:

    python3 profile_torch_step.py [--path train|single|multi|vfi] [--config FILE]
        [--backbone NAME] [--world1]
"""

from __future__ import annotations

import argparse
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

from mono_vifi_tpu_torch.bench import card_name, make_batch
from perfbench.trace import KERNEL_NAME, category, port_kernel_names


def label(name: str, port_kernels: set[str]) -> str:
    """The benchmark's category of a device operation, a port kernel by
    its own name."""
    cat = category(name, port_kernels)
    return f"port: {KERNEL_NAME.match(name).group(1)}" if cat == "port" else cat


def event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of one call of `fn` by CUDA events over `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def train_call(dev, cfg):
    """-> (one training step, samples per call)."""
    from mono_vifi_tpu_torch.training import monovifi as M

    state = M.create_train_state(cfg, seed=0, steps_per_epoch=3981, device=dev)
    train_step = M.MonoViFiStep(state.bundle, device=dev).make_train_step()
    batch = make_batch(cfg.batch_size, cfg.height, cfg.width, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    return lambda: train_step(state, batch, gen), cfg.batch_size


def inference_call(dev, cfg, multi: bool):
    """-> (one inference batch of the config's backbone and size through the
    entry module, frames per call)."""
    from mono_vifi_tpu_torch import evaluate_depth as ED
    from mono_vifi_tpu_torch import evaluate_depth_mf as EDM
    from mono_vifi_tpu_torch.config import Options
    from mono_vifi_tpu_torch.training.factory import build_bundle

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    H, W = cfg.height, cfg.width
    cfg = Options(backbone=cfg.backbone, height=H, width=W, compute_dtype="float32",
                  fuse_model_type="shared_encoder", vfi_test_scale="small")
    bundle = build_bundle(cfg, seed=0, device=dev, for_training=False)
    rng = np.random.default_rng(2)
    args = (EDM if multi else ED).eval_args([] if multi else ["--post_process"])
    batch = {k: rng.integers(0, 256, (args.batch_size, H, W, 3), dtype=np.uint8)
             for k in ("color_n1", "color_0", "color_p1")}
    if multi:
        return lambda: EDM.predict_disps_mf(args, bundle, [batch]), args.batch_size
    return lambda: ED.predict_disps(args, bundle, [batch["color_0"]]), args.batch_size


def vfi_crop(cfg) -> tuple:
    """The training crop of the VFI dataset class that `VFITrainer` reads
    for the config's dataset."""
    from mono_vifi_tpu_torch.data.vfi import CityscapesVFIDataset, KITTIVFIDataset

    return (CityscapesVFIDataset if cfg.dataset == "cityscapes" else KITTIVFIDataset).crop_hw


def vfi_call(dev, cfg):
    """-> (one VFI training step, samples per call)."""
    from mono_vifi_tpu_torch.training import vfi as V

    state = V.create_vfi_state(cfg, seed=0, steps_per_epoch=1000, device=dev)
    step = V.make_vfi_train_step(cfg.clip_grad)
    rng = np.random.default_rng(3)
    n = cfg.batch_size
    batch = {k: torch.from_numpy(rng.integers(0, 256, (n,) + vfi_crop(cfg) + (3,), np.uint8)).to(dev)
             for k in ("img0", "img1", "img2")}
    batch["embt"] = torch.full((n,), 0.5, device=dev)
    return lambda: step(state, batch), n


def feature_warp_ms(dev, cfg) -> list[tuple[tuple, float, float]]:
    """The plain feature warps of IFRNet's decoders 3-1 at the VFI crop
    (both frames' features in one call, as models/ifrnet.py calls them, in
    the compute dtype; the flows f32): -> [(shape, forward ms, forward +
    backward ms)] by CUDA events."""
    from mono_vifi_tpu_torch.models.ifrnet import PYRAMID_CHANNELS
    from mono_vifi_tpu_torch.ops.sampling import warp_planar
    from mono_vifi_tpu_torch.training.factory import compute_dtype

    dt = compute_dtype(cfg)
    h, w = vfi_crop(cfg)[0], vfi_crop(cfg)[1] // 2  # the encoder's input: (1.0, 0.5) of the crop
    out = []
    for lvl, c in enumerate(PYRAMID_CHANNELS[cfg.vfi_scale][:3]):
        shape = (2 * cfg.batch_size, c, h >> (lvl + 1), w >> (lvl + 1))
        img = torch.randn(shape, device=dev, dtype=dt, requires_grad=True)
        flow = torch.randn((shape[0], 2) + shape[2:], device=dev, requires_grad=True)

        def fwd():
            return warp_planar(img, flow)

        def fwd_bwd():
            o = fwd()
            torch.autograd.grad(o, (img, flow), torch.ones_like(o))

        with torch.no_grad():
            f_ms = event_ms(fwd)
        out.append((shape, f_ms, event_ms(fwd_bwd)))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("train", "single", "multi", "vfi"), default="train")
    ap.add_argument("--config", default=None)
    ap.add_argument("--backbone", default=None,
                    help="the config's backbone replaced (ResNet50 has no config file)")
    ap.add_argument("--world1", action="store_true",
                    help="the training step as the one rank of an NCCL process group")
    args = ap.parse_args()
    path = args.path
    if args.world1 and path != "train":
        ap.error("--world1 profiles the training step")
    if args.config is None:
        args.config = ("configs/vfi/IFRNet_L_KITTI.txt" if path == "vfi"
                       else "configs/resnet18/ResNet18_KITTI_MR.txt")
    dev = torch.device("cuda")
    print(card_name())
    from mono_vifi_tpu_torch.config import parse_options

    cfg = parse_options(["-c", args.config, "--weights_init", "scratch", "--device", "cuda"]
                        + (["--backbone", args.backbone] if args.backbone else []))
    if path == "vfi":
        print(f"{args.config}: IFRNet-{cfg.vfi_scale}, batch {cfg.batch_size}, crop "
              f"{vfi_crop(cfg)}, {cfg.compute_dtype}")
        call, n = vfi_call(dev, cfg)
    elif path == "train":
        print(f"{args.config}: {cfg.backbone}, batch {cfg.batch_size}"
              + (", one rank of an NCCL process group" if args.world1 else ""))
        if args.world1:
            import torch.distributed as dist

            rendezvous = tempfile.TemporaryDirectory()
            dist.init_process_group("nccl", init_method=f"file://{rendezvous.name}/file",
                                    rank=0, world_size=1)
        call, n = train_call(dev, cfg)
    else:
        print(f"{args.config}: {cfg.backbone}, batch {cfg.batch_size}")
        call, n = inference_call(dev, cfg, path == "multi")
    unit = "step" if path in ("train", "vfi") else "batch"
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 5 * 1e3
    print(f"{path} untraced: {wall:.1f} ms/{unit}, {n / wall * 1e3:.2f} "
          f"{'frames' if unit == 'batch' else 'samples'}/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    calls = 3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) / calls * 1e3
    by_name = defaultdict(float)
    for e in prof.events():
        # device-side work only: kernels, copies, memsets (not the user
        # annotations, which span the kernels they contain)
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            by_name[e.name] += e.time_range.elapsed_us() / 1e3 / calls
    busy = sum(by_name.values())
    print(f"traced: {traced:.1f} ms/{unit} wall, {busy:.1f} ms/{unit} of device work; "
          f"busy share {busy / traced:.1%} of the traced wall time, "
          f"{busy / wall:.1%} of the untraced one")
    by_cat = defaultdict(float)
    port_kernels = port_kernel_names()
    for name, ms in by_name.items():
        by_cat[label(name, port_kernels)] += ms
    print(f"kernel time by category (ms/{unit}):")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.3f}  {ms / busy:6.1%}  {cat}")
    port = sum(ms for cat, ms in by_cat.items() if cat.startswith("port: "))
    print(f"port kernels: {port:.3f} ms/{unit} ({port / busy:.1%})")
    print(f"top kernels (ms/{unit}):")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:20]:
        print(f"  {ms:9.3f}  {ms / busy:6.1%}  {name[:140]}")
    if path == "vfi":
        total_f = total_fb = 0.0
        for shape, f_ms, fb_ms in feature_warp_ms(dev, cfg):
            total_f, total_fb = total_f + f_ms, total_fb + fb_ms
            print(f"plain feature warp {shape}: forward {f_ms:.3f} ms, forward + backward "
                  f"{fb_ms:.3f} ms (backward {fb_ms - f_ms:.3f})")
        print(f"plain feature warps: forward {total_f:.3f} ms/step ({total_f / busy:.1%}), "
              f"backward {total_fb - total_f:.3f} ms/step ({(total_fb - total_f) / busy:.1%} "
              "of the step's device time)")
    if args.world1:
        dist.destroy_process_group()
        rendezvous.cleanup()


if __name__ == "__main__":
    main()
