"""Multi-card training of the port on the CPU, continued from
tests/test_torch_parallel.py (whose rank processes run the cases here, two
gloo ranks each): the LiteMono step with injected global stochastic-depth
masks and the VFI step (each one SGD step at learning rate 1, as the
ResNet18 step there) against the port at the global batch; the depth
`Trainer` with `num_devices=2` on a synthetic KITTI tree (both ranks step
alike, only rank 0 writes and evaluates, a mid-epoch resume takes the
uninterrupted run's next step). tests/test_torch_parallel_launch.py starts
the ranks as the command line does.

Tolerances (f32, CPU): the LiteMono step as the ResNet18 step in
tests/test_torch_parallel.py (loss terms and gradient norm rtol 1e-5, each
gradient leaf 1e-3 of its norm, statistics atol 1e-6). The VFI step has no
BatchNorm: loss, PSNR and gradient norm rtol 1e-5, each gradient leaf 1e-4
of its norm (the ranks' convolutions see batch 1 where the global step's
see batch 2, and sum in another order). The ranks agree bit for bit; the
resumed step equals the uninterrupted one to rtol 1e-6, as in
tests/test_torch_train.py.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil

import numpy as np
import pytest
import torch

from mono_vifi_tpu_torch import parallel
from mono_vifi_tpu_torch import train as T
from mono_vifi_tpu_torch.config import Options, parse_options
from mono_vifi_tpu_torch.training import vfi as TV

from tests.test_torch_parallel import (
    assert_ranks_equal, assert_step_close, depth_step, local_batch, run_ranks, start_ranks,
    wait_ranks,
)

H, W, B = 64, 96, 2
DRIVE = "2011_09_26/2011_09_26_drive_0001_sync"
# one SGD step at learning rate 1: each parameter moves by its clipped gradient
VFI_CFG = dict(height=H, width=W, vfi_scale="tiny", compute_dtype="float32",
               optimizer="sgd", learning_rate=1.0)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------- LiteMono and VFI steps

def _vfi_case(job, rank, world):
    b = job["batch"]["img0"].shape[0] // world
    return vfi_step(job["cfg"], local_batch(job["batch"], rank, b))


def vfi_step(cfg: dict, batch: dict) -> dict:
    state = TV.create_vfi_state(Options(**cfg), seed=0, steps_per_epoch=5, device="cpu")
    metrics, _ = TV.make_vfi_train_step(5.0)(state, batch)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: p.grad.clone() for k, p in state.module.named_parameters()},
            "params": {k: p.detach().clone() for k, p in state.module.named_parameters()},
            "stats": {}}


@pytest.fixture(scope="module")
def litemono_and_vfi(tmp_path_factory):
    """Both jobs' ranks run while the parent takes the global-batch steps."""
    from mono_vifi_tpu_torch.training.monovifi import MonoViFiStep, create_train_state
    from tests.test_torch_step import CFG, make_batch

    cfg = CFG | {"backbone": "LiteMono", "optimizer": "sgd", "learning_rate": 1.0}
    state = create_train_state(Options(**cfg), 0, steps_per_epoch=10, device="cpu")
    step = MonoViFiStep(state.bundle, device="cpu")
    rng = np.random.default_rng(2)
    noise = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in step.noise_shapes(B, H, W).items()}
    masks = rng.random((state.bundle.encoder.num_drop_paths,
                        step.encoder_batches(B)["encoder"])) >= 0.2
    assert not masks.all() and masks.any()
    noise["drop_path_encoder"] = masks
    batch = make_batch()
    lite = start_ranks("depth_step", {"cfg": cfg | {"batch_size": 1}, "batch": batch,
                                      "noise": noise, "b": 1},
                       tmp_path_factory.mktemp("litemono"))
    vbatch = {k: rng.random((B, H, W, 3), dtype=np.float32) for k in ("img0", "img1", "img2")}
    vbatch["embt"] = np.full((B,), 0.5, np.float32)
    vfi = start_ranks("vfi_step", {"cfg": VFI_CFG, "batch": vbatch},
                      tmp_path_factory.mktemp("vfi"))
    lite_ref = depth_step(cfg, batch, noise, B)
    vfi_ref = vfi_step(VFI_CFG, vbatch)
    return (wait_ranks(lite), lite_ref), (wait_ranks(vfi), vfi_ref)


def test_litemono_step_over_two_ranks_equals_the_global_batch_step(litemono_and_vfi):
    outs, ref = litemono_and_vfi[0]
    assert_ranks_equal(outs)
    assert_step_close(outs[0], ref)


def test_vfi_step_over_two_ranks_equals_the_global_batch_step(litemono_and_vfi):
    outs, ref = litemono_and_vfi[1]
    assert_ranks_equal(outs)
    assert_step_close(outs[0], ref, terms=("loss", "psnr"), grad_rtol=1e-4)


# ------------------------------------------------------------ the trainers

@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    """Frames 0..7 at 75x248; train split of 6 lines (3 steps of 1 on each
    of 2 ranks), test split of 3 with sparse synthetic ground truths."""
    from PIL import Image

    root = tmp_path_factory.mktemp("kitti")
    img_dir = root / DRIVE / "image_02" / "data"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(8):
        Image.fromarray(rng.integers(0, 256, (75, 248, 3), dtype=np.uint8)).save(
            img_dir / f"{i:010d}.png")
    splits = tmp_path_factory.mktemp("splits")
    d = splits / "kitti" / "tiny"
    d.mkdir(parents=True)
    lines = [f"{DRIVE} {i} l" for i in range(1, 7)]
    (d / "train_files.txt").write_text("\n".join(lines))
    (d / "test_files.txt").write_text("\n".join(lines[:3]))
    gts = [rng.uniform(1.0, 80.0, (75, 248)).astype(np.float32) for _ in range(3)]
    for g in gts:
        g[rng.random(g.shape) < 0.8] = 0.0
    np.savez_compressed(d / "gt_depths.npz", data=np.array(gts, dtype=object))
    return str(root), str(splits)


def trainer_argv(data_path: str, log_dir: str) -> list[str]:
    return ["--data_path", data_path, "--log_dir", log_dir, "--split", "tiny",
            "--eval_split", "tiny", "--height", str(H), "--width", str(W), "--batch_size", "1",
            "--num_epochs", "1", "--use_affine", "true", "--compute_dtype", "float32",
            "--num_workers", "2", "--log_frequency", "1", "--save_frequency", "1",
            "--seed", "1", "--vfi_train_scale", "tiny", "--vfi_test_scale", "tiny",
            "--weights_init", "scratch", "--device", "cpu", "--exp_name", "run"]


def _weights(bundle):
    return {f"{r}.{k}": v.detach().clone()
            for r, m in bundle.trainable_roles().items() for k, v in m.state_dict().items()}


def _trainer_case(job, rank, world):
    """Epoch 0 (3 steps, a checkpoint after each of steps 2 and 3, the one
    after step 2 kept aside), its evaluation and save; then a trainer
    resumed from the kept checkpoint takes step 3. Every write of the
    trainers is recorded."""
    T.SPLITS_DIR = job["splits"]
    writes = []

    def recorded(fn):
        def wrapper(*args, **kwargs):
            writes.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapper

    for name in ("save_checkpoint", "save_weights"):
        setattr(T.ckpt_lib, name, recorded(getattr(T.ckpt_lib, name)))
    T.Trainer.save_opts = recorded(T.Trainer.save_opts)

    cfg = parse_options(job["argv"] + ["--num_devices", "2"])
    t = T.Trainer(cfg)
    save = t.save_model

    def save_and_keep_mid_epoch(epoch, batch_idx=0, ep_end=False):
        save(epoch, batch_idx, ep_end)
        if batch_idx == 2 and t.is_chief:
            shutil.copy(t.ckpt_path, job["mid"])

    t.save_model = save_and_keep_mid_epoch
    t.run_epoch(0)
    weights = _weights(t.bundle)
    t.end_epoch(0)
    t.close()
    handlers = sum(isinstance(h, logging.FileHandler) for h in logging.getLogger().handlers)
    out = {"world": t.world, "steps_per_epoch": t.steps_per_epoch, "weights": weights,
           "losses": [h["loss"] for h in t.history], "eval": sorted(t.eval_results),
           "file_handlers": handlers}
    if t.is_chief:
        os.makedirs(os.path.join(job["resume_dir"], "run"))
        shutil.copy(job["mid"], os.path.join(job["resume_dir"], "run", "ckpt.pth"))
    parallel.barrier()
    t2 = T.Trainer(dataclasses.replace(cfg, log_dir=job["resume_dir"], resume=True))
    out["resumed_at"] = (t2.ep_start, t2.batch_start, t2.state.step)
    t2.run_epoch(0)
    t2.close()
    return out | {"resumed_weights": _weights(t2.bundle),
                  "resumed_losses": [h["loss"] for h in t2.history], "writes": writes}


@pytest.fixture(scope="module")
def two_rank_trainer(kitti_tree, tmp_path_factory):
    data_path, splits = kitti_tree
    d = tmp_path_factory.mktemp("trainer")
    job = {"argv": trainer_argv(data_path, str(d / "logs")), "splits": splits,
           "mid": str(d / "ckpt_mid.pth"), "resume_dir": str(d / "resumed")}
    return run_ranks("trainer", job, d), str(d / "logs" / "run")


def test_trainer_ranks_step_alike(two_rank_trainer):
    outs, _ = two_rank_trainer
    for o in outs:
        assert o["world"] == 2 and o["steps_per_epoch"] == 3 and len(o["losses"]) == 3
        assert all(np.isfinite(o["losses"]))
    assert outs[0]["losses"] == outs[1]["losses"]
    for k, v in outs[0]["weights"].items():
        assert torch.equal(outs[1]["weights"][k], v), k


def test_trainer_only_rank_0_writes_and_evaluates(two_rank_trainer):
    outs, run = two_rank_trainer
    assert outs[1]["writes"] == [] and outs[1]["eval"] == [] and outs[1]["file_handlers"] == 0
    assert sorted(outs[0]["writes"]) == sorted(
        ["save_opts"] * 2 + ["save_checkpoint"] * 4 + ["save_weights"])
    assert outs[0]["eval"] == [(0, "multi-frame"), (0, "single-frame")]
    assert outs[0]["file_handlers"] == 1
    ckpt = torch.load(os.path.join(run, "ckpt.pth"), weights_only=True)
    assert (ckpt["epoch"], ckpt["batch_idx"], ckpt["step_in_total"]) == (1, 0, 3)
    assert os.path.exists(os.path.join(run, "models", "model_0.pth"))


def test_trainer_resumed_mid_epoch_takes_the_same_next_step(two_rank_trainer):
    outs, _ = two_rank_trainer
    for o in outs:
        assert o["resumed_at"] == (0, 2, 2)
        np.testing.assert_allclose(o["resumed_losses"], o["losses"][2:], rtol=1e-6)
        for k, v in o["weights"].items():
            np.testing.assert_allclose(o["resumed_weights"][k].numpy(), v.numpy(),
                                       rtol=1e-6, atol=1e-9, err_msg=k)


CASES = {"vfi_step": _vfi_case, "trainer": _trainer_case}
