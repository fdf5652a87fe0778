"""Loader-fed training throughput of the port (the counterpart of
tools/bench_e2e.py).

Times the assembled training loop: the threaded `DataLoader` over a
KITTI-layout tree of noise frames at the native 1242x375
(bench_loader.make_kitti_dir), `data.loader.device_prefetch` (pinned host
batches copied on a side stream, two ahead) and the fused training step
(`MonoViFiStep.make_train_step`) on the card, at the JAX tool's
configuration: ResNet18, 640x192, batch 10, affine, bf16, shared_encoder,
random weights from a seed (`weights_init="scratch"`), the schedule of an
epoch of 3981 steps:

    python -m mono_vifi_tpu_torch.bench_e2e [--steps 60] [--batch 10]
        [--workers N] [--loader-only] [--loader-sweep] [--no-uint8]
        [--keep-dir D] [--device cuda]

The e2e mode warms up on the first real batch (reading its loss), then runs
`--steps` steps, each with its noise from a generator seeded for the step,
and synchronizes once at the end by reading the last loss. It prints a line
with ms/step, the data wait (ms/step the host spent blocked in the loader's
iterator), `os.cpu_count()`, torch's intra-op threads and the peak memory,
then the JSON record last: the JAX tool's keys (`metric`, `value` in
samples/s, `unit`, `steps`, `workers`, `dispatch_fraction`) and `device`,
the card's name and power limit. The step runs on the card; with no card
it raises unless `--device cpu` is given. The command line turns cuDNN's
autotuner on for the card, as the training entry does.

`dispatch_fraction` is the host time inside the step call over the timed
window. In JAX that call returns after an asynchronous dispatch, so a high
fraction means the host waits on the device. The port's eager step runs
all of its Python in that call (the device idles 16-29% of a step for the
host, PERF.md), so here the fraction reads high whoever binds: the data
wait names the side that does.

`--loader-only` times the loader alone (80 samples) and `--loader-sweep`
at 1, 2, 4 and 8 workers (60 samples each); neither does device work or
needs a card. `--workers 0` (the default) means min(8, os.cpu_count()).
`--no-uint8` stages float32 batches. The tree is written to a temporary
directory and removed, unless `--keep-dir` names one to keep.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from mono_vifi_tpu_torch.bench_loader import (
    kitti_dataset, make_kitti_dir, repeated_files, time_loader,
)
from mono_vifi_tpu_torch.config import Options
from mono_vifi_tpu_torch.data import DataLoader, StatefulSampler

STEPS_PER_EPOCH = 3981  # the JAX tool's schedule


def build_loader(root, batch_size, workers, n_files=200, stage_uint8=True,
                 size=(192, 640)) -> DataLoader:
    """The threaded loader over at least `n_files` training items of `size`
    (H, W) (tools/bench_e2e.py build_loader, which fixes 192x640)."""
    ds = kitti_dataset(root, repeated_files(n_files), stage_uint8=stage_uint8, size=size)
    return DataLoader(ds, batch_size, sampler=StatefulSampler(len(ds), seed=1),
                      num_workers=workers)


def e2e_options(batch_size: int = 10, device="cuda") -> Options:
    """The JAX tool's configuration."""
    return Options(
        height=192, width=640, batch_size=batch_size, backbone="ResNet18", use_affine=True,
        compute_dtype="bfloat16", fuse_model_type="shared_encoder", weights_init="scratch",
        device=str(device),
    )


def noise_seed(step: int) -> int:
    return 2 * 1_000_003 + step


def bench_e2e(root, steps, batch_size, workers, stage_uint8=True, device="cuda",
              cfg: Options | None = None) -> dict:
    """Time `steps` loader-fed training steps of `cfg` (default
    `e2e_options(batch_size)`) on `device` (see the module docstring);
    print the timing line, then the JSON record; -> the record."""
    from mono_vifi_tpu_torch.bench import card_name
    from mono_vifi_tpu_torch.data.loader import device_prefetch
    from mono_vifi_tpu_torch.training import monovifi as M
    from mono_vifi_tpu_torch.training.factory import resolve_device

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    cfg = cfg or e2e_options(batch_size, dev)
    B = cfg.batch_size
    state = M.create_train_state(cfg, seed=0, steps_per_epoch=STEPS_PER_EPOCH, device=dev)
    train_step = M.MonoViFiStep(state.bundle, device=dev).make_train_step()
    loader = build_loader(root, B, workers, n_files=(steps + 8) * B, stage_uint8=stage_uint8,
                          size=(cfg.height, cfg.width))
    gen = torch.Generator(device=dev)

    # warm-up on the first real batch, synchronized by reading its loss
    it = device_prefetch(loader, dev, size=2)
    gen.manual_seed(noise_seed(0))
    loss0 = float(train_step(state, next(it), gen)["loss"])
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    n = 0
    t_wait = t_step = 0.0
    t0 = t_ask = time.perf_counter()
    for i, batch in enumerate(it):
        t_got = time.perf_counter()
        t_wait += t_got - t_ask
        gen.manual_seed(noise_seed(i + 1))
        metrics = train_step(state, batch, gen)
        t_ask = time.perf_counter()
        t_step += t_ask - t_got
        n += B
        if i + 1 >= steps:
            break
    loss = float(metrics["loss"])  # the one synchronization
    dt = time.perf_counter() - t0
    if not (np.isfinite(loss0) and np.isfinite(loss)):
        raise FloatingPointError(f"non-finite loss: first {loss0}, last {loss}")
    done = n // B
    where = card_name() if on_card else "cpu"
    peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB" if on_card
            else "not measured")
    print(f"e2e {cfg.backbone} {cfg.width}x{cfg.height} batch {B}, {cfg.compute_dtype}, "
          f"{workers} loader workers, on {where}: {done} steps, {dt / done * 1e3:.2f} ms/step, "
          f"data wait {t_wait / done * 1e3:.2f} ms/step, in the step call "
          f"{t_step / done * 1e3:.2f} ms/step; loss {loss0:.5f} -> {loss:.5f}; "
          f"os.cpu_count() {os.cpu_count()}, torch threads {torch.get_num_threads()}; "
          f"peak memory {peak}", flush=True)
    rec = {
        "metric": f"monovifi_torch_e2e_train_samples_per_sec_{cfg.width}x{cfg.height}",
        "value": n / dt,
        "unit": "samples/s",
        "steps": done,
        "workers": workers,
        "dispatch_fraction": t_step / dt,
        "device": where,
    }
    print(json.dumps(rec), flush=True)
    return rec


def bench_loader_rate(root, n_samples, batch_size, workers, stage_uint8=True) -> dict:
    """The loader's rate alone (tools/bench_e2e.py bench_loader_rate)."""
    loader = build_loader(root, batch_size, workers, n_files=n_samples + 40,
                          stage_uint8=stage_uint8)
    return {
        "metric": "loader_samples_per_sec",
        "value": time_loader(loader, n_samples),
        "unit": "samples/s",
        "workers": workers,
        "stage_uint8": stage_uint8,
        "cpu_count": os.cpu_count(),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Loader-fed training throughput of the port")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=10)
    ap.add_argument("--workers", type=int, default=0, help="0 = min(8, os.cpu_count())")
    ap.add_argument("--loader-only", action="store_true")
    ap.add_argument("--loader-sweep", action="store_true",
                    help="measure the loader's rate at 1, 2, 4, 8 workers")
    ap.add_argument("--no-uint8", action="store_true", help="stage float32 batches")
    ap.add_argument("--keep-dir", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    u8 = not args.no_uint8
    workers = args.workers or min(8, os.cpu_count() or 1)
    device = None
    if not (args.loader_sweep or args.loader_only):
        from mono_vifi_tpu_torch.training.factory import resolve_device

        device = resolve_device(args.device)  # no card: raise before writing the tree
    root = args.keep_dir or tempfile.mkdtemp(prefix="kitti_bench_")
    try:
        make_kitti_dir(root)
        if args.loader_sweep:
            for w in (1, 2, 4, 8):
                print(json.dumps(bench_loader_rate(root, 60, args.batch, w, u8)), flush=True)
            return
        if args.loader_only:
            print(json.dumps(bench_loader_rate(root, 80, args.batch, workers, u8)), flush=True)
            return
        if device.type == "cuda":
            torch.backends.cudnn.benchmark = True
        bench_e2e(root, args.steps, args.batch, workers, u8, device)
    finally:
        if not args.keep_dir:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
