"""The port's training-mode data pipeline against the JAX package's, on the
CPU, bit for bit: training items of KITTIRAWDataset (same seed, epoch and
index; PNG frames written to tmp_path at a small native size) with the
affine branch on and off, uint8 staging on and off, one and two scales, and
the color jitter's default path and its exact PIL path; Cityscapes training
items with dynamic-object masks; the samplers and the loader's batches under
a sampler; `generate_depth_map`, `get_depth` and the gt_depths export on a
synthetic calibration and scan; and `device_prefetch` on the CPU (dtypes
kept, values unchanged)."""

import functools

import numpy as np
import pytest
import torch
from PIL import Image

from mono_vifi_tpu.data import DataLoader as JDataLoader
from mono_vifi_tpu.data import mono_dataset as jmono_dataset
from mono_vifi_tpu.data.augment import ColorJitter as JColorJitter
from mono_vifi_tpu.data.cityscapes import CityscapesDataset as JCityscapes
from mono_vifi_tpu.data.kitti import KITTIRAWDataset as JKITTI
from mono_vifi_tpu.data.kitti_utils import generate_depth_map as jgenerate_depth_map
from mono_vifi_tpu.data.samplers import StatefulDistributedSampler as JDistSampler
from mono_vifi_tpu.data.samplers import StatefulSampler as JSampler
from mono_vifi_tpu_torch.data import (
    CityscapesDataset, DataLoader, KITTIRAWDataset, StatefulDistributedSampler,
    StatefulSampler, device_prefetch,
)
from mono_vifi_tpu_torch.data import mono_dataset
from mono_vifi_tpu_torch.data.augment import ColorJitter
from mono_vifi_tpu_torch.data.kitti_utils import generate_depth_map

H, W = 64, 96
DRIVE = "2011_09_26/2011_09_26_drive_0001_sync"


def _write_png(path, h, w, rng):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path)


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    """One drive of frames 0..6 at 75x248 on image_02 and image_03."""
    root = tmp_path_factory.mktemp("kitti")
    rng = np.random.default_rng(0)
    for cam in ("02", "03"):
        for i in range(7):
            _write_png(root / DRIVE / f"image_{cam}/data/{i:010d}.png", 75, 248, rng)
    return root


FILES = [f"{DRIVE} {i} {side}" for i, side in ((1, "l"), (3, "r"), (5, "l"), (2, "l"))]


def _assert_items_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("jitter", ["default", "pil"])
@pytest.mark.parametrize("num_scales", [1, 2])
@pytest.mark.parametrize("stage_uint8", [False, True])
@pytest.mark.parametrize("affine", [False, True])
def test_kitti_training_items_match_jax(kitti_dir, monkeypatch, affine, stage_uint8,
                                        num_scales, jitter):
    if jitter == "pil":  # the exact torchvision / PIL path in both packages
        monkeypatch.setattr(mono_dataset, "ColorJitter", functools.partial(ColorJitter, fast=False))
        monkeypatch.setattr(jmono_dataset, "ColorJitter",
                            functools.partial(JColorJitter, fast=False))
    args = (str(kitti_dir), FILES, H, W, [0, -1, 1], num_scales)
    kw = dict(use_affine=affine, is_train=True, seed=5, stage_uint8=stage_uint8)
    port, ref = KITTIRAWDataset(*args, **kw), JKITTI(*args, **kw)
    flips = augs = 0
    for epoch in (0, 3):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(FILES)):
            _assert_items_equal(port[i], ref[i])
            r = port._rng(i)
            augs += r.random() > 0.5
            flips += r.random() > 0.5
    assert 0 < flips < 8 and 0 < augs < 8  # both branches of each draw are taken


def test_color_jitter_paths_match_jax():
    """Both jitter paths, same draws, on an image where the hue shift bites."""
    import random

    img = Image.fromarray(np.random.default_rng(1).integers(0, 256, (20, 30, 3), np.uint8))
    for fast in (False, True):
        for seed in range(4):
            a = ColorJitter(rng=random.Random(seed), fast=fast)
            b = JColorJitter(rng=random.Random(seed), fast=fast)
            assert (a.order, a.hue, a.fast) == (b.order, b.hue, b.fast)
            np.testing.assert_array_equal(np.asarray(a(img)), np.asarray(b(img)))


@pytest.fixture(scope="module")
def cityscapes_dir(tmp_path_factory):
    """Preprocessed training triplets (3 frames stacked vertically) with
    cam.txt intrinsics, and dynamic-object masks (uint8 and float)."""
    root = tmp_path_factory.mktemp("cs")
    masks = tmp_path_factory.mktemp("cs_masks")
    rng = np.random.default_rng(2)
    for num in (19, 40):
        name = f"aachen_000000_{num:06d}"
        _write_png(root / "aachen" / f"{name}.png", 3 * 48, 128, rng)
        (root / "aachen" / f"{name}_cam.txt").write_text(
            f"{1100.0 + num},0,{512.5},0,1105.5,{190.25},0,0,1")
        for suffix in ("", "-1", "+1"):
            m = rng.random((48, 128)) > 0.7
            np.save(masks / f"aachen_000000_{num}{suffix}.npy",
                    m.astype(np.uint8) * 255 if suffix == "" else m.astype(np.float32))
    return root, masks


@pytest.mark.parametrize("affine", [False, True])
def test_cityscapes_training_items_with_doj_masks_match_jax(cityscapes_dir, affine):
    root, masks = cityscapes_dir
    files = ["aachen aachen_000000_000019", "aachen aachen_000000_000040"]
    args = (str(root), files, H, W, [0, -1, 1], 1)
    kw = dict(use_affine=affine, is_train=True, seed=3, stage_uint8=True, doj_mask=True,
              mask_dir=str(masks))
    port, ref = CityscapesDataset(*args, **kw), JCityscapes(*args, **kw)
    for epoch in (0, 1, 2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(2):
            item = port[i]
            _assert_items_equal(item, ref[i])
            assert "doj_mask_n1" in item and ("doj_mask_0_affine" in item) == affine


@pytest.mark.parametrize("n,seed,epoch,start_iter", [
    (10, 0, 0, 0), (37, 1234, 3, 5), (1, 7, 1, 0), (100, 5, 19, 99),
])
def test_samplers_match_jax(n, seed, epoch, start_iter):
    port, ref = StatefulSampler(n, seed), JSampler(n, seed)
    for s in (port, ref):
        s.set_epoch(epoch)
        s.set_start_iter(start_iter)
    assert list(port) == list(ref) and len(port) == len(ref)
    for replicas in (2, 3):
        for rank in range(replicas):
            port = StatefulDistributedSampler(n, seed, rank=rank, num_replicas=replicas)
            ref = JDistSampler(n, seed, rank=rank, num_replicas=replicas)
            for s in (port, ref):
                s.set_epoch(epoch)
                s.set_start_iter(start_iter // replicas)
            assert list(port) == list(ref) and len(port) == len(ref)


@pytest.mark.parametrize("num_workers", [1, 3])
def test_loader_batches_under_a_sampler_match_jax(kitti_dir, num_workers):
    files = [f"{DRIVE} {i} l" for i in range(1, 6)]
    args = (str(kitti_dir), files, H, W, [0, -1, 1], 1)
    kw = dict(use_affine=True, is_train=True, seed=9, stage_uint8=True)
    out = []
    for ds_cls, sampler_cls, loader_cls in ((KITTIRAWDataset, StatefulSampler, DataLoader),
                                            (JKITTI, JSampler, JDataLoader)):
        sampler = sampler_cls(len(files), 11)
        sampler.set_epoch(2)
        sampler.set_start_iter(1)
        ds = ds_cls(*args, **kw)
        ds.set_epoch(2)
        loader = loader_cls(ds, 2, sampler=sampler, num_workers=num_workers, drop_last=True)
        out.append((len(loader), list(loader)))
    (n_port, port), (n_ref, ref) = out
    assert n_port == n_ref == 2 and len(port) == len(ref) == 2
    for a, b in zip(port, ref):
        _assert_items_equal(a, b)


@pytest.fixture(scope="module")
def velodyne(tmp_path_factory):
    """A calibration directory in KITTI's format and a scan of 4000 points,
    some behind the camera, some projecting onto one pixel."""
    root = tmp_path_factory.mktemp("calib")
    rng = np.random.default_rng(4)
    (root / "calib_cam_to_cam.txt").write_text(
        "calib_time: 09-Jan-2012 13:57:47\n"
        "S_rect_02: 1.242000e+03 3.750000e+02\n"
        "R_rect_00: " + " ".join(map(str, np.eye(3).ravel() + 1e-3 * rng.standard_normal(9)))
        + "\n"
        "P_rect_02: 7.215377e+02 0 6.095593e+02 4.485728e+01 0 7.215377e+02 1.728540e+02 "
        "2.163791e-01 0 0 1 2.745884e-03\n"
        "P_rect_03: 7.215377e+02 0 6.095593e+02 -3.395242e+02 0 7.215377e+02 "
        "1.728540e+02 2.199936e+00 0 0 1 2.729905e-03\n")
    R = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], float)  # velodyne x forward
    (root / "calib_velo_to_cam.txt").write_text(
        "R: " + " ".join(map(str, R.ravel())) + "\nT: -4.069766e-03 -7.631618e-02 "
        "-2.717806e-01\n")
    pts = np.stack([rng.uniform(-5, 60, 4000), rng.uniform(-20, 20, 4000),
                    rng.uniform(-2, 2, 4000), rng.random(4000)], 1).astype(np.float32)
    pts[:50] = pts[50]  # duplicates: the minimum depth is kept
    velo = root / "0000000000.bin"
    pts.tofile(velo)
    return str(root), str(velo)


@pytest.mark.parametrize("cam,vel_depth", [(2, False), (3, False), (2, True)])
def test_generate_depth_map_matches_jax(velodyne, cam, vel_depth):
    calib, velo = velodyne
    got = generate_depth_map(calib, velo, cam, vel_depth)
    ref = jgenerate_depth_map(calib, velo, cam, vel_depth)
    assert got.shape == (375, 1242) and (got > 0).sum() > 100
    np.testing.assert_array_equal(got, ref)


def test_device_prefetch_keeps_dtypes_and_values():
    rng = np.random.default_rng(0)
    batches = [{"color_0": rng.integers(0, 256, (2, 4, 5, 3), dtype=np.uint8),
                "K": rng.random((2, 4, 4)).astype(np.float32)} for _ in range(5)]
    out = list(device_prefetch(iter(batches), "cpu", size=2))
    assert len(out) == 5
    for a, b in zip(out, batches):
        assert a["color_0"].dtype == torch.uint8 and a["K"].dtype == torch.float32
        np.testing.assert_array_equal(a["color_0"].numpy(), b["color_0"])
        np.testing.assert_array_equal(a["K"].numpy(), b["K"])


@pytest.fixture(scope="module")
def kitti_velo(velodyne, tmp_path_factory):
    """Two drives of one date, each with one scan, and the date's calibration
    files: the layout of KITTI raw; -> (data path, test file lines)."""
    import os
    import shutil

    calib, velo = velodyne
    data = tmp_path_factory.mktemp("kitti_velo")
    lines = []
    for i in range(2):
        d = data / "2011_09_26" / f"2011_09_26_drive_000{i}_sync" / "velodyne_points" / "data"
        d.mkdir(parents=True)
        shutil.copy(velo, d / f"{i:010d}.bin")
        lines.append(f"2011_09_26/2011_09_26_drive_000{i}_sync {i} l")
    for f in ("calib_cam_to_cam.txt", "calib_velo_to_cam.txt"):
        shutil.copy(os.path.join(calib, f), data / "2011_09_26" / f)
    return str(data), lines


def test_export_gt_depth_matches_jax(kitti_velo, tmp_path, monkeypatch):
    """`python -m mono_vifi_tpu_torch.export_gt_depth` against the root
    script: the same gt_depths.npz from the same scans (eigen split)."""
    import export_gt_depth as jexport
    from mono_vifi_tpu_torch import export_gt_depth as export

    data, lines = kitti_velo
    out = {}
    for name, mod in (("port", export), ("jax", jexport)):
        splits = tmp_path / name
        (splits / "kitti" / "eigen").mkdir(parents=True)
        (splits / "kitti" / "eigen" / "test_files.txt").write_text("\n".join(lines))
        monkeypatch.setattr(mod, "SPLITS_DIR", str(splits))
        mod.export_gt_depths_kitti(data, "eigen")
        out[name] = np.load(splits / "kitti" / "eigen" / "gt_depths.npz",
                            allow_pickle=True)["data"]
    assert out["port"].shape == out["jax"].shape == (2, 375, 1242)
    np.testing.assert_array_equal(out["port"].astype(np.float32), out["jax"].astype(np.float32))


@pytest.mark.parametrize("do_flip", [False, True])
def test_kitti_get_depth_and_paths_match_jax(kitti_velo, do_flip):
    from mono_vifi_tpu.data.kitti import KITTIOdomDataset as JOdom
    from mono_vifi_tpu_torch.data import KITTIOdomDataset

    data, lines = kitti_velo
    args = (data, lines, H, W)
    folder, frame = lines[1].split()[:2]
    got = KITTIRAWDataset(*args).get_depth(folder, int(frame), "l", do_flip)
    ref = JKITTI(*args).get_depth(folder, int(frame), "l", do_flip)
    assert got.shape == (375, 1242) and got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    odom = ("/data/odom", ["3 17 r"], H, W)
    assert KITTIOdomDataset(*odom).get_image_path("3", 17, "r") == \
        JOdom(*odom).get_image_path("3", 17, "r")
