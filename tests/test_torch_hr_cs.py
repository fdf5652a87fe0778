"""The KITTI-HR and Cityscapes configurations' driver paths on the CPU, at
tiny sizes (64x96, tiny VFI, f32), on the synthetic trees that the card's
tests (tests/test_torch_card.py) write (mono_vifi_tpu_torch.data.synthetic):

  - the HR start: a `Trainer` from ResNet18_KITTI_HR.txt with
    `--pretrained_path` at another `Trainer`'s `models/model_0.pth` loads
    every key of every trainable role bit for bit, and `load_pretrained`
    reports none kept; a key missing from the file is reported;
  - the Cityscapes tree: `CityscapesDataset` reads its training stacks into
    a batch of ResNet18_CS.txt's shape (batch 12 at 512x192, uint8, the
    affine keys) and its test frames at the config's size, with the
    intrinsics of the camera files; the `Trainer` of that config evaluates
    on it through the Cityscapes protocol and saves.
"""

import os

import numpy as np
import pytest
import torch

from mono_vifi_tpu_torch import train as T
from mono_vifi_tpu_torch.config import parse_options
from mono_vifi_tpu_torch.data import CityscapesDataset, DataLoader
from mono_vifi_tpu_torch.data.synthetic import (
    CS_CAMERA, CS_RAW, write_cityscapes_tree, write_kitti_tree,
)
from mono_vifi_tpu_torch.utils import readlines

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--height", "64", "--width", "96", "--batch_size", "2", "--compute_dtype", "float32",
        "--vfi_train_scale", "tiny", "--vfi_test_scale", "tiny", "--weights_init", "scratch",
        "--device", "cpu", "--resume", "False", "--num_workers", "2"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def in_root(monkeypatch):
    monkeypatch.chdir(ROOT)


def test_hr_trainer_starts_from_an_mr_trainers_model_0(tmp_path, monkeypatch, in_root):
    splits = write_kitti_tree(str(tmp_path), n_frames=8, n_test=2)
    monkeypatch.setattr(T, "SPLITS_DIR", splits)
    paths = ["--data_path", str(tmp_path / "kitti"), "--log_dir", str(tmp_path / "logs"),
             "--split", "smoke", "--eval_split", "eigen"]
    mr = T.Trainer(parse_options(["-c", "configs/resnet18/ResNet18_KITTI_MR.txt"] + paths + TINY))
    mr.save_model(0, ep_end=True)
    mr.close()
    model_0 = str(tmp_path / "logs" / "ResNet18_KITTI_MR" / "models" / "model_0.pth")
    hr_argv = ["-c", "configs/resnet18/ResNet18_KITTI_HR.txt"] + paths + TINY + ["--seed", "7"]
    scratch = T.Trainer(parse_options(hr_argv + ["--pretrained_path", ""]))
    hr = T.Trainer(parse_options(hr_argv + ["--pretrained_path", model_0]))
    saved = torch.load(model_0, map_location="cpu", weights_only=True)
    roles = hr.bundle.trainable_roles()
    assert set(roles) <= set(saved)
    for role, m in roles.items():
        sd = m.state_dict()
        assert set(sd) == set(saved[role]), role
        for k, v in sd.items():
            assert torch.equal(v, saved[role][k]), (role, k)
    assert hr.load_pretrained(model_0) == []
    # the seed alone gives other weights: the equality above is the load's
    k = "encoder.conv1.weight"
    assert not torch.equal(scratch.bundle.encoder.state_dict()[k], saved["encoder"][k])
    del saved["encoder"][k]
    torch.save(saved, tmp_path / "partial.pth")
    assert hr.load_pretrained(str(tmp_path / "partial.pth")) == [f"encoder.{k} (missing)"]
    for t in (scratch, hr):
        t.close()


def test_cityscapes_tree_reads_into_the_configs_batch(tmp_path, in_root):
    splits = write_cityscapes_tree(str(tmp_path), n_train=12, n_test=1)
    cfg = parse_options(["-c", "configs/resnet18/ResNet18_CS.txt", "--data_path",
                         str(tmp_path / "cityscapes"), "--data_path_pre",
                         str(tmp_path / "cityscapes_pre"), "--device", "cpu"])
    assert (cfg.batch_size, cfg.height, cfg.width, cfg.use_affine) == (12, 192, 512, True)
    train = CityscapesDataset(
        cfg.data_path_pre, readlines(os.path.join(splits, "cityscapes", "train_files.txt")),
        cfg.height, cfg.width, cfg.frame_ids, cfg.num_scales, use_affine=cfg.use_affine,
        is_train=True, seed=cfg.seed, stage_uint8=True)
    batch = next(iter(DataLoader(train, cfg.batch_size, num_workers=2)))
    for name in ("n1", "0", "p1"):
        for key in (f"color_{name}", f"color_aug_{name}", f"color_affine_{name}"):
            assert batch[key].shape == (12, 192, 512, 3) and batch[key].dtype == np.uint8, key
    assert batch["K"].shape == (12, 4, 4) and batch["valid_mask_rec"].shape == (12, 192, 512, 1)
    test = CityscapesDataset(
        cfg.data_path, readlines(os.path.join(splits, "cityscapes", "test_files.txt")),
        cfg.height, cfg.width, [0, -1, 1], cfg.num_scales, is_train=False)
    item = test[0]
    assert item["color_0"].shape == (192, 512, 3)
    assert not np.array_equal(item["color_n1"], item["color_0"])  # the +-2 frames were found
    W, H = CS_RAW
    np.testing.assert_allclose(item["K"][0, 0], CS_CAMERA["fx"] / W * cfg.width, rtol=1e-6)
    np.testing.assert_allclose(item["K"][1, 1], CS_CAMERA["fy"] / (H * 0.75) * cfg.height,
                               rtol=1e-6)


def test_cityscapes_trainer_evaluates_on_the_tree(tmp_path, monkeypatch, in_root):
    splits = write_cityscapes_tree(str(tmp_path), n_train=2, n_test=2)
    monkeypatch.setattr(T, "SPLITS_DIR", splits)
    t = T.Trainer(parse_options([
        "-c", "configs/resnet18/ResNet18_CS.txt", "--data_path", str(tmp_path / "cityscapes"),
        "--data_path_pre", str(tmp_path / "cityscapes_pre"), "--log_dir",
        str(tmp_path / "logs"), "--num_epochs", "1"] + TINY))
    assert len(t.gt_depths) == 2 and t.gt_depths[0].shape == (CS_RAW[1], CS_RAW[0])
    t.run_epoch(0)
    t.end_epoch(0)
    t.close()
    assert len(t.history) == 1 and np.isfinite(t.history[0]["loss"])
    assert sorted(t.eval_results) == [(0, "multi-frame"), (0, "single-frame")]
    assert all(np.isfinite(v) for r in t.eval_results.values() for v in r.values())
    assert os.path.exists(tmp_path / "logs" / "ResNet18_CS" / "models" / "model_0.pth")
