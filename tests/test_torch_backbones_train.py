"""The training driver and the evaluation entry points with every backbone,
on the CPU: `python -m mono_vifi_tpu_torch.train -c
configs/{litemono,dhrnet}/*_KITTI_MR.txt` parsed as a user runs it, with
overrides for the synthetic KITTI tree of tests/test_torch_train.py (64x96,
batch 2, so three steps an epoch; f32, tiny VFI), takes an epoch with a
checkpoint after its second step; a trainer resumed from that checkpoint
takes the third step as the uninterrupted run did, LiteMono with the same
stochastic-depth masks (loss rtol 1e-6, as tests/test_torch_train.py).
The evaluation entry points build, load and report every backbone they
list.
"""

import shutil

import numpy as np
import pytest
import torch

from mono_vifi_tpu_torch import evaluate_depth as ED
from mono_vifi_tpu_torch import evaluate_depth_mf as EDM
from mono_vifi_tpu_torch import train as T
from mono_vifi_tpu_torch.config import parse_options
from mono_vifi_tpu_torch.training import monovifi as TM

from tests.test_torch_train import ROOT, kitti_env  # noqa: F401  (the fixture)

CONFIGS = ("configs/litemono/LiteMono_KITTI_MR.txt", "configs/dhrnet/DHRNet_KITTI_MR.txt")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs files in parallel processes, and
    a process whose eight OpenMP threads wait on busy cores spins."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _options(config, data_path, log_dir, resume=False):
    return parse_options([
        "-c", str(ROOT / config), "--data_path", data_path, "--log_dir", log_dir,
        "--split", "tiny", "--eval_split", "tiny", "--height", "64", "--width", "96",
        "--batch_size", "2", "--num_epochs", "1", "--save_frequency", "1",
        "--log_frequency", "1", "--compute_dtype", "float32", "--vfi_train_scale", "tiny",
        "--vfi_test_scale", "tiny", "--weights_init", "scratch", "--num_workers", "2",
        "--device", "cpu", "--resume", str(resume),
    ])


@pytest.fixture
def drawn_masks(monkeypatch):
    """Every drop-path draw of the step, in order."""
    draws = []
    draw = TM.MonoViFiStep.draw_drop_masks

    def record(self, B, generator=None):
        out = draw(self, B, generator)
        draws.append({k: v.clone() for k, v in out.items()})
        return out

    monkeypatch.setattr(TM.MonoViFiStep, "draw_drop_masks", record)
    return draws


@pytest.mark.parametrize("config", CONFIGS, ids=["LiteMono", "DHRNet"])
def test_config_trains_and_resumes_mid_epoch(config, kitti_env, monkeypatch, drawn_masks,
                                             tmp_path):
    data_path, splits_dir = kitti_env
    monkeypatch.setattr(T, "SPLITS_DIR", splits_dir)
    log_dir = str(tmp_path / "logs")
    cfg = _options(config, data_path, log_dir)
    assert (cfg.backbone, cfg.height, cfg.width) == (
        "LiteMono" if "LiteMono" in config else "DHRNet", 64, 96)
    t = T.Trainer(cfg)
    save = t.save_model

    def save_and_keep_mid_epoch(epoch, batch_idx=0, ep_end=False):
        save(epoch, batch_idx, ep_end)
        if batch_idx == 2:
            shutil.copy(t.ckpt_path, tmp_path / "ckpt_mid.pth")

    t.save_model = save_and_keep_mid_epoch
    t.run_epoch(0)
    t.close()
    assert t.state.step == 3 and len(t.history) == 3
    assert all(np.isfinite(h["loss"]) for h in t.history)
    masks = [d.get("drop_path_encoder") for d in drawn_masks]
    assert len(masks) == 3
    if cfg.backbone == "LiteMono":  # 8B images, one row per block
        assert all(m.shape == (18, 16) for m in masks)
        assert not torch.equal(masks[1], masks[2])
    else:
        assert masks == [None] * 3

    resumed = tmp_path / "resumed"
    (resumed / cfg.exp_name).mkdir(parents=True)
    shutil.copy(tmp_path / "ckpt_mid.pth", resumed / cfg.exp_name / "ckpt.pth")
    t2 = T.Trainer(_options(config, data_path, str(resumed), resume=True))
    assert (t2.ep_start, t2.batch_start, t2.state.step) == (0, 2, 2)
    t2.run_epoch(0)
    t2.close()
    assert len(drawn_masks) == 4
    again = drawn_masks[3].get("drop_path_encoder")
    assert (again is None) if masks[2] is None else torch.equal(again, masks[2])
    np.testing.assert_allclose(t2.history[0]["loss"], t.history[2]["loss"], rtol=1e-6)


@pytest.mark.parametrize("backbone", ["ResNet18", "ResNet50", "LiteMono", "DHRNet"])
def test_evaluation_entry_points_take_every_listed_backbone(backbone, tmp_path):
    small = ["--backbone", backbone, "--height", "64", "--width", "96", "--device", "cpu"]
    ED.main(ED.eval_args(small))  # builds, reports, evaluates nothing
    EDM.main(EDM.eval_args(small))
    bundle = ED.load_model(ED.eval_args(small))
    assert bundle.cfg.backbone == backbone
