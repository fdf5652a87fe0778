"""Where the port's full-width training step spends the card's time.

Builds the step chip_smoke.py drives (ResNet18, 640x192, batch 10, frozen
IFRNet-L, affine, shared_encoder, bf16, random weights from a seed), runs
2 warm-up steps, times 5 steps with the host clock, then traces 3 steps with
torch.profiler and prints per step: the device's busy share (kernel time
over wall time), the kernel time by category, the four port kernels, and
the 20 kernels that take the most time. Tracing slows the host, so the
busy share is given against both the traced and the untraced wall time.
Run from the repository root on a machine with a CUDA device:

    python3 profile_torch_step.py
"""

from __future__ import annotations

import subprocess
import time
from collections import defaultdict

import torch

from chip_smoke import B, H, W, make_batch

PORT_KERNELS = {
    "taps_kernel": "bilinear_taps",
    "::fwd_kernel": "ssim_l1_fwd",
    "bwd_fields_kernel": "ssim_l1_bwd",
    "bwd_combine_kernel": "ssim_l1_bwd",
    "splat_kernel": "bilinear_splat",
}
CATEGORIES = (
    ("convolution", ("conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad")),
    ("matmul", ("gemm", "cutlass", "nvjet")),
    ("batch norm", ("batch_norm", "batchnorm", "bn_")),
    ("reduction", ("reduce",)),
    ("gather/scatter/index", ("index", "gather", "scatter")),
    ("elementwise", ("elementwise", "vectorized")),
)


def category(name: str) -> str:
    if "anonymous namespace" in name:
        for key, kernel in PORT_KERNELS.items():
            if key in name:
                return f"port: {kernel}"
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def main() -> None:
    from mono_vifi_tpu_torch.config import Options
    from mono_vifi_tpu_torch.training import monovifi as M

    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0])
    cfg = Options(height=H, width=W, batch_size=B, use_affine=True,
                  compute_dtype="bfloat16", fuse_model_type="shared_encoder",
                  vfi_train_scale="large")
    state = M.create_train_state(cfg, seed=0, steps_per_epoch=3981, device=dev)
    train_step = M.MonoViFiStep(state.bundle, device=dev).make_train_step()
    batch = make_batch(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for _ in range(2):
        train_step(state, batch, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        train_step(state, batch, gen)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 5 * 1e3
    print(f"untraced: {wall:.1f} ms/step, {B / wall * 1e3:.2f} samples/s")

    steps = 3
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            train_step(state, batch, gen)
        torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) / steps * 1e3
    by_name = defaultdict(float)
    for e in prof.events():
        # device-side work only: kernels, copies, memsets (not the user
        # annotations, which span the kernels they contain)
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            by_name[e.name] += e.time_range.elapsed_us() / 1e3 / steps
    busy = sum(by_name.values())
    print(f"traced: {traced:.1f} ms/step wall, {busy:.1f} ms/step of device work; "
          f"busy share {busy / traced:.1%} of the traced wall time, "
          f"{busy / wall:.1%} of the untraced one")
    by_cat = defaultdict(float)
    for name, ms in by_name.items():
        by_cat[category(name)] += ms
    print("kernel time by category (ms/step):")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.3f}  {ms / busy:6.1%}  {cat}")
    print("top kernels (ms/step):")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:20]:
        print(f"  {ms:9.3f}  {ms / busy:6.1%}  {name[:140]}")


if __name__ == "__main__":
    main()
