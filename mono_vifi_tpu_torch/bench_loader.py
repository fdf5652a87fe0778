"""Host input-pipeline benchmark of the port (the counterpart of
tools/bench_loader.py).

Writes a KITTI-layout tree of noise frames at the native 1242x375, then
measures the port's threaded `DataLoader` over `KITTIRAWDataset` at the
flagship training configuration (640x192, frames [0, -1, 1], batch 10),
with and without the affine augmentation, and the per-stage cost of one
`__getitem__` (decode, resize, color jitter, the affine chain full and
windowed, its masks, the whole item):

    python -m mono_vifi_tpu_torch.bench_loader [--samples 80] [--workers 8]
        [--batch_size 10]

Prints one JSON line for the stages, then one per `use_affine` with
`loader_samples_per_sec`; each carries `os.cpu_count()`, since the rate
depends on the host's cores. No device work: it needs no card. The tree is
the JAX tool's (the same noise from `np.random.default_rng(0)`, PIL's
default PNG compression), so the two tools' rates compare on one host.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time

import numpy as np

from mono_vifi_tpu_torch.data import DataLoader, KITTIRAWDataset, StatefulSampler

DRIVE = "2011_09_26/2011_09_26_drive_0001_sync"


def make_kitti_dir(root: str, n_frames: int = 24, size=(1242, 375)) -> None:
    """`n_frames` uniform-noise RGB frames of `size` (W, H) as PNG under
    root/<DRIVE>/image_02/data, as tools/bench_loader.py writes them."""
    from PIL import Image

    img_dir = os.path.join(root, DRIVE, "image_02", "data")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n_frames):
        arr = (rng.random((size[1], size[0], 3)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(img_dir, f"{i:010d}.png"))


def kitti_dataset(root: str, files: list, use_affine: bool = True,
                  stage_uint8: bool = False, size=(192, 640)) -> KITTIRAWDataset:
    """The training dataset both tools time: `size` (H, W) 192x640, frames
    [0, -1, 1], one scale, training augmentation, seed 1."""
    return KITTIRAWDataset(
        root, files, height=size[0], width=size[1], frame_idxs=[0, -1, 1], num_scales=1,
        use_affine=use_affine, is_train=True, seed=1, stage_uint8=stage_uint8,
    )


def repeated_files(n: int) -> list:
    """Frames 1-22 of the drive (each has both neighbours), repeated to at
    least `n` lines."""
    files = [f"{DRIVE} {i} l" for i in range(1, 23)]
    return files * max(1, (n + len(files) - 1) // len(files))


def time_loader(loader, n_samples: int) -> float:
    """Samples/s over at least `n_samples`, after one warm batch (the pool
    and the page cache)."""
    it = iter(loader)
    next(it)
    t0 = time.perf_counter()
    n = 0
    for batch in it:
        n += batch["color_0"].shape[0]
        if n >= n_samples:
            break
    return n / (time.perf_counter() - t0)


def bench_loader(root, n_samples, batch_size, workers, use_affine=True) -> float:
    """The loader's samples/s (tools/bench_loader.py bench_loader)."""
    ds = kitti_dataset(root, repeated_files(n_samples), use_affine)
    loader = DataLoader(ds, batch_size, sampler=StatefulSampler(len(ds), seed=1),
                        num_workers=workers)
    return time_loader(loader, n_samples)


def bench_stages(root) -> dict:
    """Per-stage cost of one training sample (ms), the JAX tool's seven
    keys, each the mean of a loop after one untimed call."""
    import random

    from PIL import Image

    from mono_vifi_tpu_torch.data.augment import ColorJitter, to_array

    ds = kitti_dataset(root, [f"{DRIVE} 5 l"])

    def timeit(fn, iters=20):
        fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3

    folder, fidx, side = ds.index_to_folder_and_frame_idx(0)
    out = {"decode_3_frames_ms": timeit(
        lambda: [ds.get_color(folder, fidx + i, side, False) for i in (-1, 0, 1)])}
    raw = ds.get_color(folder, fidx, side, False)
    out["resize_to_640x192_ms"] = timeit(lambda: raw.resize((640, 192), ds.interp), iters=50)
    resized = raw.resize((640, 192), ds.interp)
    jit = ColorJitter(rng=random.Random(0))
    out["color_jitter_ms"] = timeit(lambda: to_array(jit(resized)), iters=50)
    K = ds.load_intrinsics(folder, fidx)
    K[0, :] *= 640
    K[1, :] *= 192
    p = ds._affine_params(ds._rng(0), K, np.linalg.pinv(K))
    out["affine_full_chain_ms"] = timeit(
        lambda: to_array(raw.resize(p["size_re"], ds.interp)
                         .rotate(p["angle"], resample=Image.BILINEAR, expand=False)
                         .crop(p["crop"])))
    out["affine_windowed_ms"] = timeit(lambda: to_array(ds._affine_window(raw, p)))
    out["affine_masks_ms"] = timeit(lambda: ds._affine_masks(p), iters=50)
    out["full_getitem_ms"] = timeit(lambda: ds[0], iters=10)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Host input-pipeline benchmark of the port")
    ap.add_argument("--samples", type=int, default=80)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--batch_size", type=int, default=10)
    args = ap.parse_args(argv)
    cpus = os.cpu_count()
    root = tempfile.mkdtemp(prefix="kitti_bench_")
    try:
        make_kitti_dir(root)
        stages = bench_stages(root)
        print(json.dumps({"metric": "getitem_stage_ms", **stages, "cpu_count": cpus}),
              flush=True)
        for affine in (True, False):
            rate = bench_loader(root, args.samples, args.batch_size, args.workers, affine)
            print(json.dumps({
                "metric": "loader_samples_per_sec", "use_affine": affine,
                "workers": args.workers, "value": rate, "unit": "samples/s",
                "cpu_count": cpus,
            }), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
