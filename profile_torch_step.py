"""Where the port's full-width paths spend the card's time.

`--path train` (the default) builds the training step chip_smoke.py drives
(ResNet18, 640x192, batch 10, frozen IFRNet-L, affine, shared_encoder, bf16,
random weights from a seed); `--path single` and `--path multi` build the
inference paths chip_smoke.py drives (the same ResNet18 at 640x192 in f32
with TF32 off, frozen IFRNet-S, batch 4 of uint8 frames from a numpy seed,
through the evaluation entry modules' `predict_disps` with flip
post-processing and `predict_disps_mf`). Each runs 2 warm-up calls, times 5
with the host clock, then traces 3 with torch.profiler and prints per call:
the device's busy share (kernel time over wall time), the kernel time by
category, the port's kernels, and the 20 kernels that take the most time.
Tracing slows the host, so the busy share is given against both the traced
and the untraced wall time; the peak device memory of the untraced calls is
printed beside their time. The port's kernels are told apart by the names of
the `__global__` functions in the checkout's `mono_vifi_tpu_torch/csrc`, so
the script reads any version of the port. Run from the repository root on
a machine with a CUDA device:

    python3 profile_torch_step.py [--path train|single|multi]
"""

from __future__ import annotations

import argparse
import re
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from chip_smoke import B, BI, H, W, make_batch

# a kernel as the profiler names it: `[void ](anonymous namespace)::<name>...`
# (the return type shows on templates only)
KERNEL_NAME = re.compile(r"^(?:void )?\(anonymous namespace\)::(\w+)")
CATEGORIES = (
    ("convolution", ("conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad")),
    ("matmul", ("gemm", "cutlass", "nvjet")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_")),
    ("reduction", ("reduce",)),
    ("gather/scatter/index", ("index", "gather", "scatter")),
    ("elementwise", ("elementwise", "vectorized")),
)


def port_kernel_names() -> set[str]:
    """The `__global__` functions of this checkout's kernel sources."""
    csrc = Path(__file__).parent / "mono_vifi_tpu_torch" / "csrc"
    return set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
        "\n".join(p.read_text() for p in sorted(csrc.glob("*.cu")))))


def category(name: str, port_kernels: set[str]) -> str:
    kernel = KERNEL_NAME.match(name)
    if kernel and kernel.group(1) in port_kernels:
        return f"port: {kernel.group(1)}"
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def train_call(dev):
    """-> (one training step, samples per call)."""
    from mono_vifi_tpu_torch.config import Options
    from mono_vifi_tpu_torch.training import monovifi as M

    cfg = Options(height=H, width=W, batch_size=B, use_affine=True,
                  compute_dtype="bfloat16", fuse_model_type="shared_encoder",
                  vfi_train_scale="large")
    state = M.create_train_state(cfg, seed=0, steps_per_epoch=3981, device=dev)
    train_step = M.MonoViFiStep(state.bundle, device=dev).make_train_step()
    batch = make_batch(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    return lambda: train_step(state, batch, gen), B


def inference_call(dev, multi: bool):
    """-> (one inference batch through the entry module, frames per call)."""
    from mono_vifi_tpu_torch import evaluate_depth as ED
    from mono_vifi_tpu_torch import evaluate_depth_mf as EDM
    from mono_vifi_tpu_torch.config import Options
    from mono_vifi_tpu_torch.training.factory import build_bundle

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Options(height=H, width=W, compute_dtype="float32",
                  fuse_model_type="shared_encoder", vfi_test_scale="small")
    bundle = build_bundle(cfg, seed=0, device=dev, for_training=False)
    rng = np.random.default_rng(2)
    batch = {k: rng.integers(0, 256, (BI, H, W, 3), dtype=np.uint8)
             for k in ("color_n1", "color_0", "color_p1")}
    if multi:
        args = EDM.eval_args([])
        return lambda: EDM.predict_disps_mf(args, bundle, [batch]), BI
    args = ED.eval_args(["--post_process"])
    return lambda: ED.predict_disps(args, bundle, [batch["color_0"]]), BI


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("train", "single", "multi"), default="train")
    path = ap.parse_args().path
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0])
    call, n = train_call(dev) if path == "train" else inference_call(dev, path == "multi")
    unit = "step" if path == "train" else "batch"
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
          f"{'samples' if path == 'train' else 'frames'}/s, peak memory "
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
        by_cat[category(name, port_kernels)] += ms
    print(f"kernel time by category (ms/{unit}):")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.3f}  {ms / busy:6.1%}  {cat}")
    port = sum(ms for cat, ms in by_cat.items() if cat.startswith("port: "))
    print(f"port kernels: {port:.3f} ms/{unit} ({port / busy:.1%})")
    print(f"top kernels (ms/{unit}):")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:20]:
        print(f"  {ms:9.3f}  {ms / busy:6.1%}  {name[:140]}")


if __name__ == "__main__":
    main()
