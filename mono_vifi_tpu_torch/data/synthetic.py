"""Synthetic dataset trees in the layouts the port's readers expect, drawn
from a numpy seed, for runs of the real trainers where the datasets are
not at hand (the card's tests and the CPU tests): uint8 PNG frames of a smooth
colour field that pans a few pixels a frame, plus noise, at the datasets'
native sizes, the split files, the intrinsics and sparse synthetic ground
truths. The ground truths are random, so the evaluation protocols' numbers
say nothing of accuracy.
"""

from __future__ import annotations

import json
import os

import numpy as np

KITTI_DRIVE = "2011_09_26/2011_09_26_drive_0001_sync"
CS_CITY = "synth"  # no "_": the reader splits frame names on it
CS_TRAIN_FRAME = (1024, 384)  # one frame of prepare_cityscapes.py's stack
CS_RAW = (2048, 1024)  # leftImg8bit_sequence
# a Cityscapes camera (fx, fy, u0, v0 at 2048x1024)
CS_CAMERA = {"fx": 2262.52, "fy": 2265.3017905988554, "u0": 1096.98, "v0": 513.137}


def _panning_field(rng, h: int, w: int) -> np.ndarray:
    """A smooth uint8 colour field (h, w, 3) of random phases."""
    ys, xs = np.arange(h)[:, None] / 60.0, np.arange(w)[None, :] / 60.0
    ph = rng.uniform(0, 2 * np.pi, (3, 2))
    return np.stack([127.5 + 100.0 * np.sin(xs + ph[c, 0]) * np.cos(ys + ph[c, 1])
                     for c in range(3)], -1).astype(np.uint8)


def _sparse_depths(rng, n: int, h: int, w: int) -> list[np.ndarray]:
    """n depth maps in [1, 80) m with 80% of the pixels empty, like
    projected lidar."""
    gts = [rng.uniform(1.0, 80.0, (h, w)).astype(np.float32) for _ in range(n)]
    for g in gts:
        g[rng.random(g.shape) < 0.8] = 0.0
    return gts


def write_kitti_tree(root: str, n_frames: int = 62, n_test: int = 8) -> str:
    """A KITTI-raw drive of `n_frames` PNG frames at the native 1242x375
    (the camera pans 4 pixels a frame), train split `smoke` of every frame
    with both neighbours, test split `eigen` of its first `n_test` lines
    with sparse ground truths (`gt_depths.npz`); -> the splits root."""
    from PIL import Image

    rng = np.random.default_rng(5)
    img_dir = os.path.join(root, "kitti", KITTI_DRIVE, "image_02", "data")
    os.makedirs(img_dir)
    field = _panning_field(rng, 375, 1242 + 4 * n_frames)
    for i in range(n_frames):
        img = field[:, 4 * i:4 * i + 1242] + rng.integers(0, 16, (375, 1242, 3), np.uint8)
        Image.fromarray(img).save(os.path.join(img_dir, f"{i:010d}.png"), compress_level=1)
    splits = os.path.join(root, "splits")
    lines = [f"{KITTI_DRIVE} {i} l" for i in range(1, n_frames - 1)]
    for split, files in (("smoke", lines), ("eigen", lines[:n_test])):
        os.makedirs(os.path.join(splits, "kitti", split))
        for kind in ("train", "test"):
            with open(os.path.join(splits, "kitti", split, f"{kind}_files.txt"), "w") as f:
                f.write("\n".join(files))
    np.savez_compressed(os.path.join(splits, "kitti", "eigen", "gt_depths.npz"),
                        data=np.array(_sparse_depths(rng, n_test, 375, 1242), dtype=object))
    return splits


def write_cityscapes_tree(root: str, n_train: int = 36, n_test: int = 4) -> str:
    """A Cityscapes tree of one city under `root`:
      - `cityscapes_pre/`: `n_train` training items as prepare_cityscapes.py
        writes them, each a vertical stack of frames t-1, t, t+1 at 1024x384
        (a 1024x1152 PNG) with its `_cam.txt` intrinsics;
      - `cityscapes/`: `n_test` test frames of `leftImg8bit_sequence/test`
        at 2048x1024 with their +-2 neighbours and `camera/test` json;
      - `splits/cityscapes/`: train and test file lists and a sparse
        ground truth `gt_depths/{i:03d}_depth.npy` (1024x2048) per test
        frame.
    -> the splits root."""
    from PIL import Image

    rng = np.random.default_rng(6)
    pre = os.path.join(root, "cityscapes_pre", CS_CITY)
    seq_dir = os.path.join(root, "cityscapes", "leftImg8bit_sequence", "test", CS_CITY)
    cam_dir = os.path.join(root, "cityscapes", "camera", "test", CS_CITY)
    for d in (pre, seq_dir, cam_dir):
        os.makedirs(d)
    w, h = CS_TRAIN_FRAME
    s = w / CS_RAW[0]  # prepare_cityscapes.py's rescale of the intrinsics
    K = np.array([[CS_CAMERA["fx"] * s, 0.0, CS_CAMERA["u0"] * s],
                  [0.0, CS_CAMERA["fy"] * s, CS_CAMERA["v0"] * s], [0.0, 0.0, 1.0]])
    train = []
    for i in range(n_train):  # sequence i, frames 18-20 as one item
        name = f"{CS_CITY}_{i:06d}_000019"
        field = _panning_field(rng, h, w + 8)
        tall = np.concatenate([field[:, 4 * k:4 * k + w] for k in range(3)], 0)
        tall = tall + rng.integers(0, 16, tall.shape, np.uint8)
        Image.fromarray(tall).save(os.path.join(pre, name + ".png"), compress_level=1)
        with open(os.path.join(pre, name + "_cam.txt"), "w") as f:
            f.write(",".join(str(v) for v in K.flatten().tolist()))
        train.append(f"{CS_CITY} {name}")
    W, H = CS_RAW
    test = []
    for i in range(n_test):  # sequence i, frame 19 and its neighbours 17, 21
        field = _panning_field(rng, H, W + 16)
        for k, frame in enumerate((17, 19, 21)):
            img = field[:, 8 * k:8 * k + W] + rng.integers(0, 16, (H, W, 3), np.uint8)
            name = f"{CS_CITY}_{i:06d}_{frame:06d}"
            Image.fromarray(img).save(os.path.join(seq_dir, name + "_leftImg8bit.png"),
                                      compress_level=1)
        name = f"{CS_CITY}_{i:06d}_000019"
        with open(os.path.join(cam_dir, name + "_camera.json"), "w") as f:
            json.dump({"intrinsic": CS_CAMERA}, f)
        test.append(f"{CS_CITY} {name}")
    splits = os.path.join(root, "splits")
    gt_dir = os.path.join(splits, "cityscapes", "gt_depths")
    os.makedirs(gt_dir)
    for kind, lines in (("train", train), ("test", test)):
        with open(os.path.join(splits, "cityscapes", f"{kind}_files.txt"), "w") as f:
            f.write("\n".join(lines))
    for i, g in enumerate(_sparse_depths(rng, n_test, H, W)):
        np.save(os.path.join(gt_dir, f"{i:03d}_depth.npy"), g)
    return splits
