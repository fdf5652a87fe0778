"""The port's training driver on the CPU (64x96, batch 2, f32, tiny VFI,
affine, shared_encoder) on a synthetic KITTI tree in tmp_path: the trainer
takes its steps, writes `ckpt.pth` and `models/model_0.pth`, evaluates, and
resumes at the epoch end and mid-epoch; the JAX package reads the port's
`model_0.pth`; `apply_pretrained` equals the JAX package's; and the port's
step trains on the synthetic scene of tests/test_convergence.py.

Tolerances (f32, CPU): a run resumed from a mid-epoch checkpoint takes the
uninterrupted run's next step, loss and weights to rtol 1e-6 (the same
arithmetic on the same inputs); the JAX disparities from `model_0.pth`
atol 2e-4, as tests/test_torch_eval.py; the pretrained weights exactly.
"""

import json
import os
import pathlib
import shutil

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from PIL import Image

from mono_vifi_tpu import convert as jconvert
from mono_vifi_tpu.config import Options as JOptions
from mono_vifi_tpu.training import checkpoint as jckpt
from mono_vifi_tpu.training import monovifi as JM
from mono_vifi_tpu.training.pretrained import apply_pretrained as japply_pretrained
from mono_vifi_tpu_torch import convert
from mono_vifi_tpu_torch import train as T
from mono_vifi_tpu_torch.config import Options
from mono_vifi_tpu_torch.ops.geometry import disp_to_depth
from mono_vifi_tpu_torch.training import monovifi as TM
from mono_vifi_tpu_torch.training.factory import build_bundle

from tests.synthetic_scene import make_scene_batch, median_scaled_abs_rel

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, H, W = 2, 64, 96
DRIVE = "2011_09_26/2011_09_26_drive_0001_sync"


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs files in parallel processes, and
    a process whose eight OpenMP threads wait on busy cores spins (this
    file took ~10x longer under load with eight than with two)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def kitti_env(tmp_path_factory):
    """Frames 0..7 at 75x248, train split of 6 (3 steps of 2), test split of
    3 with sparse synthetic ground truths."""
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


def _cfg(data_path, log_dir, **kw):
    return Options(**({
        "exp_name": "run", "data_path": data_path, "log_dir": log_dir, "dataset": "kitti",
        "split": "tiny", "eval_split": "tiny", "height": H, "width": W, "batch_size": B,
        "num_epochs": 2, "use_affine": True, "compute_dtype": "float32",
        "fuse_model_type": "shared_encoder", "num_workers": 2, "log_frequency": 1,
        "save_frequency": 1, "seed": 1, "vfi_train_scale": "tiny", "vfi_test_scale": "tiny",
        "weights_init": "scratch", "device": "cpu",
    } | kw))


def _trainer(monkeypatch, splits_dir, cfg):
    monkeypatch.setattr(T, "SPLITS_DIR", splits_dir)
    return T.Trainer(cfg)


def _weights(bundle):
    return {f"{r}.{k}": v.detach().clone()
            for r, m in bundle.trainable_roles().items() for k, v in m.state_dict().items()}


@pytest.fixture(scope="module")
def epoch0(kitti_env, tmp_path_factory):
    """One uninterrupted epoch (3 steps, steps 2 and 3 traced by
    torch.profiler, a checkpoint after each of steps 2 and 3, the mid-epoch
    one kept aside), then its evaluation and save."""
    data_path, splits_dir = kitti_env
    log_dir = str(tmp_path_factory.mktemp("logs"))
    mp = pytest.MonkeyPatch()
    try:
        t = _trainer(mp, splits_dir, _cfg(data_path, log_dir, profile_steps=2))
        save = t.save_model

        def save_and_keep_mid_epoch(epoch, batch_idx=0, ep_end=False):
            save(epoch, batch_idx, ep_end)
            if batch_idx == 2:
                shutil.copy(t.ckpt_path, os.path.join(log_dir, "ckpt_mid.pth"))

        t.save_model = save_and_keep_mid_epoch
        t.run_epoch(0)
        weights = _weights(t.bundle)
        t.end_epoch(0)
        t.close()
    finally:
        mp.undo()
    return t, weights, log_dir


def test_trainer_steps_checkpoints_and_evaluates(epoch0):
    t, _, log_dir = epoch0
    assert t.steps_per_epoch == 3 and t.state.step == 3
    assert [h["batch"] for h in t.history] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and h["data_s"] >= 0 for h in t.history)
    run = os.path.join(log_dir, "run")
    for f in ("ckpt.pth", "models/model_0.pth", "opt.json", "logger.log", "profile/trace.json",
              "codes/mono_vifi_tpu_torch/train.py", "codes/mono_vifi_tpu_torch/csrc/warp.cu"):
        assert os.path.exists(os.path.join(run, f)), f
    ckpt = torch.load(os.path.join(run, "ckpt.pth"), weights_only=True)
    assert {"encoder", "depth", "depth_mf", "fusion_module", "pose_encoder", "pose",
            "optimizer"} <= ckpt.keys()
    assert (ckpt["epoch"], ckpt["batch_idx"], ckpt["step_in_total"]) == (1, 0, 3)
    assert (ckpt["height"], ckpt["width"], ckpt["use_stereo"]) == (H, W, False)
    weights = torch.load(os.path.join(run, "models/model_0.pth"), weights_only=True)
    assert "optimizer" not in weights and "encoder_mf" not in weights
    for tag in ("single-frame", "multi-frame"):
        assert all(np.isfinite(v) for v in t.eval_results[0, tag].values())


def test_profile_trace_names_the_port_spans_from_step_2(epoch0):
    """profile_steps=2 traces steps 2 and 3 (the first, with cuDNN's
    autotuning on the card, would swamp the trace), with the trainer's and
    the step's spans in it."""
    _, _, log_dir = epoch0
    run = os.path.join(log_dir, "run")
    with open(os.path.join(run, "profile", "trace.json")) as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert {"run_epoch.data_wait", "run_epoch.step", "train_step.clip"} <= set(names)
    assert names.count("run_epoch.step") == names.count("train_step.clip") == 2
    with open(os.path.join(run, "logger.log")) as f:
        assert "Profiler trace of steps 2 to 3 of the epoch" in f.read()


def test_eval_needs_no_padding(epoch0):
    """The last, shorter test batch gives what one batch of all three does."""
    t = epoch0[0]
    got = t._predict_disps(multi_frame=False)
    imgs = TM.prepare_batch({"x": np.stack([t.test_dataset[i]["color_0"] for i in range(3)])},
                            "cpu")["x"]
    want = disp_to_depth(TM.single_frame_disp(t.bundle, imgs), 0.1, 100.0)[0][:, 0].numpy()
    assert got.shape == (3, H, W)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_resume_at_epoch_end_restores_the_state(epoch0, kitti_env, monkeypatch):
    t, _, log_dir = epoch0
    data_path, splits_dir = kitti_env
    t2 = _trainer(monkeypatch, splits_dir, _cfg(data_path, log_dir, resume=True))
    assert (t2.ep_start, t2.batch_start, t2.state.step) == (1, 0, 3)
    got, want = t2.state.optimizer.state_dict(), t.state.optimizer.state_dict()
    assert got["param_groups"] == want["param_groups"]
    assert got["state"].keys() == want["state"].keys() and len(got["state"]) > 100
    for i, s in want["state"].items():
        for k, v in s.items():
            assert torch.equal(got["state"][i][k], v), (i, k)
    now = _weights(t2.bundle)
    for k, v in _weights(t.bundle).items():
        assert torch.equal(now[k], v), k
    t2.close()


def test_resume_mid_epoch_takes_the_same_next_step(epoch0, kitti_env, monkeypatch, tmp_path):
    t, weights, log_dir = epoch0
    data_path, splits_dir = kitti_env
    (tmp_path / "run").mkdir()
    shutil.copy(os.path.join(log_dir, "ckpt_mid.pth"), tmp_path / "run" / "ckpt.pth")
    t2 = _trainer(monkeypatch, splits_dir, _cfg(data_path, str(tmp_path), resume=True))
    assert (t2.ep_start, t2.batch_start, t2.state.step) == (0, 2, 2)
    t2.run_epoch(0)
    assert [h["batch"] for h in t2.history] == [2]
    np.testing.assert_allclose(t2.history[0]["loss"], t.history[2]["loss"], rtol=1e-6)
    now = _weights(t2.bundle)
    for k, v in weights.items():
        np.testing.assert_allclose(now[k].numpy(), v.numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=k)
    t2.close()


def test_jax_reads_model_0_and_reproduces_the_disparities(epoch0):
    t, _, log_dir = epoch0
    jcfg = JOptions(height=H, width=W, compute_dtype="float32", weights_init="scratch",
                    vfi_train_scale="tiny", vfi_test_scale="tiny")
    loaded = jckpt.load_reference_pth(os.path.join(log_dir, "run", "models", "model_0.pth"),
                                      jcfg, 5)
    x = np.random.default_rng(3).random((B, H, W, 3)).astype(np.float32)
    ref = np.asarray(JM.single_frame_disp(JM.ModelBundle(jcfg), loaded["params"],
                                          loaded["batch_stats"], jnp.asarray(x)))
    got = TM.single_frame_disp(t.bundle, torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=2e-4)


def _torchvision_resnet18(seed):
    """A resnet18.pth in torchvision's layout: the port's ResNet keys
    without the `encoder.` prefix, BatchNorm statistics drawn, and fc.*"""
    rng = np.random.default_rng(seed)
    enc = build_bundle(Options(compute_dtype="float32", vfi_train_scale="tiny",
                               vfi_test_scale="tiny"), seed, "cpu", for_training=False).encoder
    sd = {k.removeprefix("encoder."): v.clone() for k, v in enc.state_dict().items()}
    for k in sd:
        if k.endswith(("running_mean", "bias")):
            sd[k] = torch.from_numpy((0.1 * rng.standard_normal(sd[k].shape)).astype(np.float32))
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, sd[k].shape).astype(np.float32))
    sd["fc.weight"] = torch.randn(1000, 512)
    sd["fc.bias"] = torch.randn(1000)
    return sd


def test_apply_pretrained_matches_jax(tmp_path):
    torch.save(_torchvision_resnet18(4), tmp_path / "resnet18.pth")
    kw = dict(height=H, width=W, batch_size=B, compute_dtype="float32",
              vfi_train_scale="tiny", vfi_test_scale="tiny", weights_dir=str(tmp_path))
    port = TM.create_train_state(Options(**kw, weights_init="pretrained"), 0, 10, "cpu").bundle

    # the JAX trees of another random init, then the JAX package's hook
    init = build_bundle(Options(**kw), 9, "cpu")
    sd = {r: {k: v.numpy() for k, v in init.role(r).state_dict().items()}
          for r in ("encoder", "pose_encoder")}
    enc = jconvert.convert_depth_encoder(sd["encoder"], 18)
    pose = jconvert.convert_pose_encoder(sd["pose_encoder"], 18)
    params = {"encoder": enc["params"], "pose_encoder": pose["params"]}
    bstats = {"encoder": enc["batch_stats"], "pose_encoder": pose["batch_stats"]}
    params, bstats = japply_pretrained(JOptions(**kw, weights_init="pretrained"),
                                       params, bstats)
    ref = convert.bundle_state_dicts(params, bstats)
    for role in ("encoder", "pose_encoder"):
        got = port.role(role).state_dict()
        for k, v in ref[role].items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(got[k], v), (role, k)
    assert not torch.equal(port.pose_encoder.state_dict()["encoder.conv1.weight"],
                           init.pose_encoder.state_dict()["encoder.conv1.weight"])


def test_apply_pretrained_without_the_file_keeps_random_init(tmp_path):
    kw = dict(height=H, width=W, compute_dtype="float32", vfi_train_scale="tiny",
              vfi_test_scale="tiny", weights_dir=str(tmp_path))
    port = TM.create_train_state(Options(**kw, weights_init="pretrained"), 3, 10, "cpu")
    scratch = build_bundle(Options(**kw), 3, "cpu")
    for k, v in scratch.encoder.state_dict().items():
        assert torch.equal(port.bundle.encoder.state_dict()[k], v), k
    lite = dict(kw, backbone="LiteMono")
    port = TM.create_train_state(Options(**lite, weights_init="pretrained"), 3, 10, "cpu")
    scratch = build_bundle(Options(**lite), 3, "cpu")
    for k, v in scratch.encoder.state_dict().items():
        assert torch.equal(port.bundle.encoder.state_dict()[k], v), k


def test_training_converges_on_synthetic_scene():
    """40 steps of the port's step on the analytic scene, at the settings and
    thresholds of tests/test_convergence.py (f32, lr 4e-4, shared_all, tiny
    VFI), from that test's own initial weights: the JAX package's random
    init (jitted; the same values as its eager init) carried over by the
    port's converter, so both packages' runs start from the same values
    (the port's own init draws the same distributions from another RNG)."""
    import jax

    kw = dict(height=H, width=W, batch_size=B, compute_dtype="float32",
              fuse_model_type="shared_all", vfi_train_scale="tiny", vfi_test_scale="tiny",
              learning_rate=4e-4, lr_sche_type="step", decay_step=(10**6,),
              weights_init="scratch")
    jb = JM.ModelBundle(JOptions(**kw, fast_warp=False))
    params, bstats = jax.jit(jb.init_variables)(jax.random.PRNGKey(0))
    vfi = jax.jit(lambda k: jb.init_vfi(k, "train"))(jax.random.PRNGKey(1))
    state = TM.create_train_state(Options(**kw), 0, 40, "cpu")
    convert.load_into_bundle(state.bundle, *(jax.tree.map(np.asarray, t) for t in (params, bstats)),
                             vfi_params=jax.tree.map(np.asarray, vfi))
    train_step = TM.MonoViFiStep(state.bundle, "cpu").make_train_step()
    batch, gt_depth = make_scene_batch(B, H, W)
    x = TM.prepare_batch({"x": batch["color_0"]}, "cpu")["x"]

    def depth_err():
        depth = disp_to_depth(TM.single_frame_disp(state.bundle, x), 0.1, 100.0)[1]
        return median_scaled_abs_rel(depth[:, 0].numpy(), gt_depth)

    gen = torch.Generator().manual_seed(7)
    err0 = depth_err()
    losses = [float(train_step(state, batch, gen)["loss_base"]) for _ in range(40)]
    err1 = depth_err()
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    assert last < 0.85 * first, (first, last)
    assert err1 < 0.8 * err0, (err0, err1)


def test_trainer_refuses_without_a_card_and_unported_datasets(monkeypatch, kitti_env):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.main(["-c", str(ROOT / "configs/resnet18/ResNet18_KITTI_MR.txt")])
    # Make3D is an evaluation set only: the trainer has no dataset for it
    with pytest.raises(ValueError, match="unknown dataset make3d"):
        T.Trainer(Options(dataset="make3d", device="cpu"))
