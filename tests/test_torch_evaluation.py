"""The port's copies of the evaluation host code against the JAX package's:
the depth metrics (torch and numpy), the four evaluation protocols and flip
post-processing on synthetic variable-size ground truths (atol 1e-6: the
same float64/float32 numpy arithmetic on both sides), and the eval-mode
KITTI / Cityscapes datasets and the loader on a few synthetic image files
(items equal exactly: the same PIL decode and resize).
"""

import json

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from PIL import Image

from mono_vifi_tpu import evaluation as JE
from mono_vifi_tpu.data import CityscapesDataset as JCityscapes
from mono_vifi_tpu.data import DataLoader as JDataLoader
from mono_vifi_tpu.data import KITTIRAWDataset as JKITTI
from mono_vifi_tpu.ops import metrics as JMET
from mono_vifi_tpu_torch import evaluation as TE
from mono_vifi_tpu_torch.data import CityscapesDataset, DataLoader, KITTIRAWDataset
from mono_vifi_tpu_torch.ops import metrics as TMET

RNG = np.random.default_rng(61)
SILENT = dict(printer=lambda *a: None)


def _depths(shapes, lo=0.5, hi=79.5):
    return [(lo + (hi - lo) * RNG.random(s)).astype(np.float32) for s in shapes]


def test_depth_errors_match_jax():
    gt, pred = _depths([(500,), (500,)])
    ref = JMET.compute_depth_errors(jnp.asarray(gt), jnp.asarray(pred))
    got = TMET.compute_depth_errors(torch.from_numpy(gt), torch.from_numpy(pred))
    np.testing.assert_allclose([float(v) for v in got], [float(v) for v in ref],
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(TMET.compute_depth_errors_np(gt, pred),
                               JMET.compute_depth_errors_np(gt, pred), atol=1e-6)
    np.testing.assert_allclose(TMET.compute_make3d_errors_np(gt, pred),
                               JMET.compute_make3d_errors_np(gt, pred), atol=1e-6)


def _compare(got: dict, ref: dict):
    assert got.keys() == ref.keys()
    np.testing.assert_allclose([got[k] for k in ref], [ref[k] for k in ref], atol=1e-6)


@pytest.mark.parametrize("split,stereo", [("eigen", False), ("eigen_benchmark", False),
                                          ("eigen", True)])
def test_kitti_protocol_matches_jax(split, stereo):
    pred = (0.01 + RNG.random((4, 24, 80))).astype(np.float32)
    gts = _depths([(75, 248), (60, 200), (90, 300), (75, 250)])
    gts[1][::3] = 0.0  # invalid pixels
    _compare(TE.evaluate_kitti(pred, gts, split, stereo, **SILENT),
             JE.evaluate_kitti(pred, gts, split, stereo, **SILENT))


@pytest.mark.parametrize("stereo", [False, True])
def test_cityscapes_protocol_matches_jax(stereo):
    pred = (0.01 + RNG.random((2, 32, 64))).astype(np.float32)
    gts = _depths([(512, 2048), (500, 2000)])
    _compare(TE.evaluate_cityscapes(pred, gts, stereo, **SILENT),
             JE.evaluate_cityscapes(pred, gts, stereo, **SILENT))


def test_nyuv2_and_make3d_protocols_match_jax():
    pred = (0.05 + RNG.random((3, 24, 32))).astype(np.float32)
    gts = _depths([(48, 64), (40, 50), (30, 70)], 0.2, 12.0)
    _compare(TE.evaluate_nyuv2(pred, gts, **SILENT), JE.evaluate_nyuv2(pred, gts, **SILENT))
    gts = _depths([(55, 305), (60, 200), (40, 90)], 0.5, 80.0)
    for stereo in (False, True):
        _compare(TE.evaluate_make3d(pred, gts, stereo, **SILENT),
                 JE.evaluate_make3d(pred, gts, stereo, **SILENT))


def test_post_process_and_resize_match_jax():
    l, r = RNG.random((2, 3, 24, 40))
    np.testing.assert_allclose(TE.batch_post_process_disparity(l, r),
                               JE.batch_post_process_disparity(l, r), atol=1e-12)
    img = RNG.random((24, 40))
    for kw in (dict(align_corners=True), dict(align_corners=False), dict(mode="nearest")):
        np.testing.assert_array_equal(TE.resize_np(img, (37, 91), **kw),
                                      JE.resize_np(img, (37, 91), **kw))


def _write_png(path, h, w):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray((RNG.random((h, w, 3)) * 255).astype(np.uint8)).save(path)


@pytest.fixture(scope="module")
def kitti_dir(tmp_path_factory):
    """One drive with frames 0..4 on image_02 (no frame 5: a missing
    neighbour)."""
    root = tmp_path_factory.mktemp("kitti")
    for i in range(5):
        _write_png(root / "2011_09_26/2011_09_26_drive_0001_sync/image_02/data"
                   / f"{i:010d}.png", 75, 248)
    return root


@pytest.fixture(scope="module")
def cityscapes_dir(tmp_path_factory):
    """Two test frames with +/-2 neighbours for the first only, and their
    camera files."""
    root = tmp_path_factory.mktemp("cityscapes")
    seq = root / "leftImg8bit_sequence/test/berlin"
    for num in (17, 19, 21, 40):
        _write_png(seq / f"berlin_000000_{num:06d}_leftImg8bit.png", 64, 128)
    for num in (19, 40):
        cam = root / "camera/test/berlin" / f"berlin_000000_{num:06d}_camera.json"
        cam.parent.mkdir(parents=True, exist_ok=True)
        cam.write_text(json.dumps({"intrinsic": {"fx": 2262.5 + num, "fy": 2265.3,
                                                 "u0": 1096.9, "v0": 513.1}}))
    return root


KITTI_FILES = [f"2011_09_26/2011_09_26_drive_0001_sync {i} l" for i in (1, 3, 4)]
CS_FILES = ["berlin berlin_000000_000019", "berlin berlin_000000_000040"]


def _assert_items_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("frame_idxs", [[0], [0, -1, 1]])
def test_kitti_eval_items_match_jax(kitti_dir, frame_idxs):
    args = (str(kitti_dir), KITTI_FILES, 64, 96, frame_idxs, 1)
    port, ref = KITTIRAWDataset(*args), JKITTI(*args, is_train=False)
    assert len(port) == len(ref) == 3
    for i in range(3):
        _assert_items_equal(port[i], ref[i])
    if frame_idxs != [0]:  # frame 4 has no frame 5: the centre stands in
        np.testing.assert_array_equal(port[2]["color_p1"], port[2]["color_0"])


def test_cityscapes_eval_items_match_jax(cityscapes_dir):
    args = (str(cityscapes_dir), CS_FILES, 64, 96, [0, -1, 1], 1)
    port, ref = CityscapesDataset(*args), JCityscapes(*args, is_train=False)
    for i in range(2):
        _assert_items_equal(port[i], ref[i])
    np.testing.assert_array_equal(port[1]["color_n1"], port[1]["color_0"])


@pytest.mark.parametrize("num_workers", [1, 3])
def test_loader_batches_match_jax(kitti_dir, num_workers):
    args = (str(kitti_dir), KITTI_FILES, 64, 96, [0, -1, 1], 1)
    port = list(DataLoader(KITTIRAWDataset(*args), 2, num_workers=num_workers,
                           drop_last=False))
    ref = list(JDataLoader(JKITTI(*args, is_train=False), 2, num_workers=num_workers,
                           drop_last=False))
    assert [b["color_0"].shape[0] for b in port] == [2, 1]
    for a, b in zip(port, ref, strict=True):
        _assert_items_equal(a, b)


def test_training_mode_is_ported_for_kitti(kitti_dir):
    """KITTI's (and Cityscapes') training items are ported; they equal the
    JAX package's in tests/test_torch_data_train.py."""
    item = KITTIRAWDataset(str(kitti_dir), KITTI_FILES, 64, 96, [0], 1, is_train=True)[0]
    assert item["color_0"].shape == (64, 96, 3)


def test_training_mode_is_not_ported():
    """Every training dataset of the JAX trainer is ported, NYUv2 included
    (its items equal the JAX package's in tests/test_torch_readers.py); the
    trainer refuses a dataset it does not know."""
    from mono_vifi_tpu_torch import train
    from mono_vifi_tpu_torch.data import NYUDataset

    assert train.dataset_class("nyuv2") is NYUDataset
    with pytest.raises(ValueError, match="unknown dataset"):
        train.dataset_class("make3d")
