"""The port's paths on the card at their full widths, each against the same
path with every kernel's plain version (`ops.cuda.plain_versions()`): the
nine depth training steps, single- and multi-frame inference per backbone,
the `Trainer`'s epoch, checkpoint and resume, the KITTI-HR and Cityscapes
`Trainer`s, VFI training and its hand-off to the depth `Trainer`,
test_simple and test_video, two ranks on one card against one process, the
`Trainer` on NCCL at a world of one, `encoder_remat`, the bench, the
convergence smoke and the loader tools, and the golden parity check against
its own CPU run. Each path also fails where it launched a kernel at a shape
that no case of tests/test_torch_kernels_gpu.py holds against the plain
version (its `PATH_SHAPES`). Random weights from seeds; the trainers read
synthetic KITTI and Cityscapes trees (mono_vifi_tpu_torch.data.synthetic)
written once to a temporary directory. Nothing here is timed: perfbench/
measures the port. Every test is marked `gpu` and skips without a card. This
file imports no JAX, so:

    python -m pytest --noconftest -m gpu tests/test_torch_card.py
"""

import contextlib
import copy
import dataclasses
import glob
import json
import math
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import test_torch_kernels_gpu as KG

from mono_vifi_tpu_torch import bench, evaluation, parallel
from mono_vifi_tpu_torch import convergence_smoke as CONV
from mono_vifi_tpu_torch import evaluate_depth as ED
from mono_vifi_tpu_torch import evaluate_depth_mf as EDM
from mono_vifi_tpu_torch import golden_parity as GP
from mono_vifi_tpu_torch import test_simple as TSIM
from mono_vifi_tpu_torch import test_video as TVID
from mono_vifi_tpu_torch import train as T
from mono_vifi_tpu_torch import train_vfi as TV
from mono_vifi_tpu_torch.bench import make_batch
from mono_vifi_tpu_torch.config import ENV_RENDEZVOUS, Options, parse_options
from mono_vifi_tpu_torch.data import device_prefetch
from mono_vifi_tpu_torch.data.synthetic import (_panning_field, write_cityscapes_tree,
                                                 write_kitti_tree)
from mono_vifi_tpu_torch.data.vfi import CityscapesVFIDataset, KITTIVFIDataset
from mono_vifi_tpu_torch.ops import cuda
from mono_vifi_tpu_torch.training import factory
from mono_vifi_tpu_torch.training import monovifi as M
from mono_vifi_tpu_torch.training import vfi as V
from mono_vifi_tpu_torch.training.optim import global_norm

ROOT = Path(__file__).resolve().parents[1]
H, W = 192, 640
BI = ED.eval_args([]).batch_size
NAMES = ("color_n1", "color_0", "color_p1")
MR_CONFIG = str(ROOT / "configs/resnet18/ResNet18_KITTI_MR.txt")
VFI_CONFIG = str(ROOT / "configs/vfi/IFRNet_L_KITTI.txt")
DEPTH_CONFIGS = [str(ROOT / c) for c in KG.DEPTH_CONFIGS]
TERMS = ("loss", "loss_base", "loss_dc", "loss_sadc")


def rel(a, b) -> float:
    """|a - b| over |b|: of numbers, or of tensors by their norms."""
    if isinstance(a, torch.Tensor):
        return float(torch.linalg.vector_norm((a - b).double())
                     / max(float(torch.linalg.vector_norm(b.double())), 1e-30))
    return abs(a - b) / max(abs(b), 1e-30)


def finite(values) -> bool:
    return all(math.isfinite(v) for v in values)


def unchecked(shapes) -> list:
    """The (kernel, shape) launch keys among `shapes` (`ops.cuda.LAUNCH_SHAPES`
    after a path's run) that no case of tests/test_torch_kernels_gpu.py
    covers."""
    return sorted(k for k in shapes if k not in KG.PATH_SHAPES)


@contextlib.contextmanager
def torch_default_init(on: bool = True):
    """With `on`, bundles and VFI states take torch's default initializers
    in place of the port's (the JAX package's rule). D-HRNet's disparities
    saturate at 1 from the port's init, where kernels and plain versions
    cannot differ (tests/test_torch_init_dhrnet.py finds the JAX package's
    own D-HRNet saturating there alike); the two-rank bf16 limits were set
    on torch's init (DDP_RUNS)."""
    if not on:
        yield
        return
    with pytest.MonkeyPatch.context() as mp:
        for mod in (factory, V):
            mp.setattr(mod, "init_like_jax_", lambda module: module)
        yield


@contextlib.contextmanager
def splits_of(root: str):
    """The trainers and evaluation entries read their split files under
    `root`."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (T, TV, ED, EDM):
            mp.setattr(mod, "SPLITS_DIR", os.path.join(root, "splits"))
        yield


def add_split(root: str, name: str, lines: list[str]) -> None:
    d = os.path.join(root, "splits", "kitti", name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "train_files.txt"), "w") as f:
        f.write("\n".join(lines))


def smoke_lines(root: str) -> list[str]:
    with open(os.path.join(root, "splits", "kitti", "smoke", "train_files.txt")) as f:
        return f.read().split("\n")


@pytest.fixture(scope="module")
def card():
    """The card, with TF32 off: the plain versions compute in f32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    b = torch.backends
    flags = b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32 = flags


@pytest.fixture(scope="module")
def kitti(card, tmp_path_factory):
    """A synthetic KITTI-raw tree: one drive of 62 PNG frames at 1242x375,
    split `smoke` (60 lines), split `eigen` (8 lines with sparse ground
    truths), and `vfi`, the 60 lines twice (7 steps of 16). -> its root."""
    root = str(tmp_path_factory.mktemp("card"))
    write_kitti_tree(root)
    lines = smoke_lines(root)
    add_split(root, "vfi", lines + lines)
    return root


@pytest.fixture(scope="module")
def cityscapes(kitti):
    """A synthetic Cityscapes tree beside the KITTI one: 36 preprocessed
    training stacks at 1024x384, 4 test frames at 2048x1024. -> the root."""
    write_cityscapes_tree(kitti, n_train=36, n_test=4)
    return kitti


def trainer_args(root: str, config: str, *extra: str) -> Options:
    return parse_options(["-c", config, "--log_dir", os.path.join(root, "logs"),
                          "--weights_init", "scratch", "--device", "cuda", "--resume", "False",
                          "--log_frequency", "1", *extra])


# ---- the depth training steps


@pytest.mark.gpu
@pytest.mark.parametrize("config", DEPTH_CONFIGS, ids=lambda c: Path(c).stem)
def test_depth_step(card, config):
    """One step of each config at its full width: finite, every kernel
    launched, each at a shape of PATH_SHAPES. Then the loss terms and the
    pose net's gradient norm (it reaches the loss through the photometric
    warps' grid gradient), kernels vs plain on the same weights, batch,
    noise and masks, rel 1e-3."""
    cfg = parse_options(["-c", config, "--weights_init", "scratch", "--device", "cuda"])
    nb, h, w = cfg.batch_size, cfg.height, cfg.width
    state = M.create_train_state(cfg, seed=0, steps_per_epoch=3981, device=card)
    step = M.MonoViFiStep(state.bundle, device=card)
    batch = make_batch(nb, h, w, card)
    gen = torch.Generator(device=card).manual_seed(1)
    cuda.reset_launch_counts()
    metrics = step.make_train_step()(state, batch, gen)
    assert finite([float(metrics["loss"]), float(metrics["grad_norm"])]), metrics
    assert all(v > 0 for v in cuda.LAUNCHES.values()), dict(cuda.LAUNCHES)
    assert unchecked(cuda.LAUNCH_SHAPES) == []

    noise = {k: torch.randn(s, generator=gen, device=card)
             for k, s in step.noise_shapes(nb, h, w).items()}
    noise.update(step.draw_drop_masks(nb, gen))
    pose = [q for role in ("pose_encoder", "pose") for q in state.bundle.role(role).parameters()]

    def terms_and_pose_grad_norm():
        loss, m = step.loss_fn(batch, noise=noise)
        grads = torch.autograd.grad(loss, pose)
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        return [float(m[t].detach()) for t in TERMS] + [float(norm)]

    got = terms_and_pose_grad_norm()
    with cuda.plain_versions():
        ref = terms_and_pose_grad_norm()
    for name, a, b in zip(TERMS + ("pose-net gradient norm",), got, ref):
        assert math.isfinite(a) and rel(a, b) <= 1e-3, (name, a, b)


@pytest.mark.gpu
def test_encoder_remat_matches_no_remat(card):
    """The ResNet18 KITTI-MR step with `encoder_remat` against it without:
    loss terms, gradient norm and BatchNorm buffers rel 1e-3, the
    statistics moved once."""
    cfg = ddp_configs(1, card, "bfloat16")[0]
    batch = make_batch(cfg.batch_size, H, W, card)
    out = {}
    for remat in (False, True):
        state = M.create_train_state(dataclasses.replace(cfg, encoder_remat=remat), 0,
                                     steps_per_epoch=3981, device=card)
        step = M.MonoViFiStep(state.bundle, device=card)
        noise = step.draw_noise(cfg.batch_size, H, W, torch.Generator(device=card).manual_seed(7))
        before = {k: t.clone() for k, t in state.bundle.named_buffers()}
        loss, metrics = step.loss_fn(batch, noise=noise)
        loss.backward()
        terms = {k: float(v.detach()) for k, v in metrics.items()}
        terms["grad_norm"] = float(global_norm([p.grad for p in state.params if p.grad is not None]))
        stats = {k: t.clone() for k, t in state.bundle.named_buffers()}
        moved = {int(stats[k] - before[k]) for k in stats if k.endswith("num_batches_tracked")}
        out[remat] = terms, stats, moved
    (ref, ref_stats, ref_moved), (got, stats, moved) = out[False], out[True]
    for k, v in ref.items():
        assert math.isfinite(got[k]) and rel(got[k], v) <= 1e-3, (k, got[k], v)
    worst = max(rel(stats[k].float(), v.float()) for k, v in ref_stats.items()
                if not k.endswith("num_batches_tracked"))
    assert worst <= 1e-3
    assert moved == ref_moved == {1}


# ---- inference


@pytest.mark.gpu
@pytest.mark.parametrize("backbone,single", [("ResNet18", True), ("LiteMono", True),
                                             ("DHRNet", True), ("ResNet50", False)])
def test_inference(card, backbone, single):
    """The evaluation entries' single-frame (flip post-processing) and
    multi-frame inference at 640x192, batch 4, f32: finite, the table sample
    launched at shapes of PATH_SHAPES, multi-frame disparities kernels vs
    plain within 1e-5 with at most half within 1e-3 of 0 or 1 (a saturated
    sigmoid hides any difference); ResNet18's through the KITTI eigen
    protocol on synthetic ground truths (finite: the weights are random)."""
    cfg = Options(backbone=backbone, height=H, width=W, compute_dtype="float32",
                  fuse_model_type="shared_encoder", vfi_test_scale="small")
    with torch_default_init(backbone == "DHRNet"):
        bundle = factory.build_bundle(cfg, seed=0, device=card, for_training=False)
    rng = np.random.default_rng(2)
    batch = {k: rng.integers(0, 256, (BI, H, W, 3), dtype=np.uint8) for k in NAMES}
    preds = []
    if single:
        args = ED.eval_args(["--post_process", "--backbone", backbone])
        preds.append(ED.predict_disps(args, bundle, [batch["color_0"]]))
    cuda.reset_launch_counts()
    preds.append(EDM.predict_disps_mf(EDM.eval_args(["--backbone", backbone]), bundle, [batch]))
    assert cuda.LAUNCHES["bilinear_sample_table"] > 0
    assert unchecked(cuda.LAUNCH_SHAPES) == []
    for p in preds:
        assert p.shape == (BI, H, W) and np.isfinite(p).all()

    imgs = [ED.to_device_images(batch[k], card) for k in NAMES]
    dk = M.multi_frame_disp(bundle, *imgs)
    with cuda.plain_versions():
        dp = M.multi_frame_disp(bundle, *imgs)
    assert (dk - dp).abs().max().item() <= 1e-5
    assert ((dp < 1e-3) | (dp > 1 - 1e-3)).float().mean().item() <= 0.5
    if backbone == "ResNet18":
        gts = [rng.uniform(1.0, 80.0, (375, 1242)).astype(np.float32) for _ in range(BI)]
        for g in gts:
            g[rng.random(g.shape) < 0.8] = 0.0  # sparse, like projected lidar
        for p in preds:
            assert finite(evaluation.evaluate_kitti(p, gts, "eigen").values())


@pytest.mark.gpu
def test_test_simple_and_test_video(kitti, tmp_path):
    """The entry modules' `main` on four frames of the synthetic tree
    (random weights): the files they write, test_video's table sample
    launched at shapes of PATH_SHAPES, its multi-frame disparities kernels
    vs plain within 1e-5."""
    frames = tmp_path / "frames"
    frames.mkdir()
    src = sorted(glob.glob(os.path.join(kitti, "kitti", "*", "*", "image_02", "data", "*.png")))
    names = [Path(p).stem for p in src[:4]]
    for p in src[:4]:
        shutil.copy(p, frames)
    TSIM.main(TSIM.parse_args(["--image_path", str(frames), "--save_npy"]))
    for name in names:
        disp = np.load(frames / f"{name}_disp.npy")
        assert disp.shape == (H, W) and np.isfinite(disp).all()
        assert (frames / f"{name}_disp.jpeg").exists()

    def video(out):
        TVID.main(TVID.parse_args(["--image_path", str(frames), "--save_npy",
                                   "--output_path", str(tmp_path / out)]))
        return [np.load(tmp_path / out / f"{name}_disp_mf.npy") for name in names]

    cuda.reset_launch_counts()
    got = video("video")
    assert cuda.LAUNCHES["bilinear_sample_table"] > 0
    assert unchecked(cuda.LAUNCH_SHAPES) == []
    with cuda.plain_versions():
        ref = video("video_plain")
    for k, q in zip(got, ref):
        assert k.shape == (H, W) and np.isfinite(k).all()
        assert np.abs(k - q).max() <= 1e-5
    assert (tmp_path / "video" / "demo.gif").exists()


# ---- the training drivers


def predict_kernels_vs_plain(t) -> float:
    """A Trainer's multi-frame evaluation disparities, kernels against every
    plain version: the largest absolute difference."""
    dk = t._predict_disps(multi_frame=True)
    with cuda.plain_versions():
        dp = t._predict_disps(multi_frame=True)
    return float(np.abs(dk - dp).max())


def differing(tensors: dict, saved: dict, prefix: str = "") -> list[str]:
    """The names of `tensors` not bit for bit equal to `saved`'s."""
    return [f"{prefix}{k}" for k, v in tensors.items()
            if k not in saved or not torch.equal(v.cpu(), saved[k])]


def optimizer_differing(optimizer, saved: dict) -> list[str]:
    got = optimizer.state_dict()["state"]
    return [f"optimizer {i}.{k}" for i, s in saved["optimizer"]["state"].items()
            for k, v in s.items() if not torch.equal(got[i][k].cpu(), v)]


@pytest.fixture(scope="module")
def mr_trainer(kitti):
    """The `Trainer` of ResNet18_KITTI_MR.txt (640x192, batch 10, affine,
    bf16) on the synthetic tree: epoch 0 of 6 steps with a checkpoint after
    step 4, its single- and multi-frame evaluation and save; then a trainer
    resumed from the epoch-end checkpoint runs epoch 1. -> what the test
    checks, and the path of models/model_0.pth."""
    cfg = trainer_args(kitti, MR_CONFIG, "--data_path", os.path.join(kitti, "kitti"),
                       "--split", "smoke", "--eval_split", "eigen", "--num_epochs", "2",
                       "--save_frequency", "3")
    out = {}
    with splits_of(kitti):
        t = T.Trainer(cfg)
        cuda.reset_launch_counts()
        t.run_epoch(0)
        launches, shapes = dict(cuda.LAUNCHES), set(cuda.LAUNCH_SHAPES)
        mid = torch.load(t.ckpt_path, map_location="cpu", weights_only=True)
        out["mid_checkpoint"] = mid["epoch"], mid["batch_idx"], mid["step_in_total"]
        del mid
        cuda.reset_launch_counts()
        t.end_epoch(0)
        out["eval_table_launches"] = cuda.LAUNCHES["bilinear_sample_table"]
        shapes |= set(cuda.LAUNCH_SHAPES)
        out["eval_err"] = predict_kernels_vs_plain(t)
        out["model_0"] = os.path.join(t.log_path, "models", "model_0.pth")
        saved = torch.load(t.ckpt_path, map_location="cpu", weights_only=True)
        history, results = list(t.history), dict(t.eval_results)
        t.close()

        t = T.Trainer(dataclasses.replace(cfg, resume=True))
        out["resumed_at"] = t.ep_start, t.batch_start, t.state.step
        out["resume_differing"] = optimizer_differing(t.state.optimizer, saved) + [
            name for role, m in t.bundle.trainable_roles().items()
            for name in differing(m.state_dict(), saved[role], f"{role}.")]
        del saved
        cuda.reset_launch_counts()
        t.run_epoch(1)
        out["step_launches"] = {k: v + cuda.LAUNCHES[k] for k, v in launches.items()}
        t.end_epoch(1)
        out["unchecked"] = unchecked(shapes | set(cuda.LAUNCH_SHAPES))
        history += t.history
        results.update(t.eval_results)
        t.close()
    out["losses"] = [h["loss"] for h in history]
    out["results"] = results
    return out


@pytest.mark.gpu
def test_trainer_epoch_checkpoint_and_resume(mr_trainer):
    """Finite losses and metrics, every kernel launched, each at a shape of
    PATH_SHAPES, the evaluation's disparities kernels vs plain within 1e-5,
    the mid-epoch checkpoint at (0, 4, 4), the resumed trainer at (1, 0, 6)
    with every weight, buffer and optimizer moment bit for bit the saved
    ones."""
    r = mr_trainer
    assert r["mid_checkpoint"] == (0, 4, 4)
    assert all(v > 0 for v in r["step_launches"].values()), r["step_launches"]
    assert r["eval_table_launches"] > 0
    assert r["unchecked"] == []
    assert r["eval_err"] <= 1e-5
    assert os.path.exists(r["model_0"])
    assert r["resumed_at"] == (1, 0, 6)
    assert r["resume_differing"] == []
    assert len(r["losses"]) == 12 and finite(r["losses"])
    assert len(r["results"]) == 4
    assert all(finite(res.values()) for res in r["results"].values()), r["results"]


def check_config_trainer(root: str, argv: list[str], pretrained: str | None = None) -> None:
    """One epoch of a config's `Trainer` (`pretrained`'s weights loaded bit
    for bit, no key missing or unexpected): finite losses and metrics, every
    kernel launched, each at a shape of PATH_SHAPES, the evaluation's
    disparities kernels vs plain within 1e-5, models/model_0.pth written."""
    cfg = trainer_args(root, *argv, "--num_epochs", "1", "--save_frequency", "1000",
                       *(["--pretrained_path", pretrained] if pretrained else []))
    with splits_of(root):
        t = T.Trainer(cfg)
        try:
            if pretrained:
                saved = torch.load(pretrained, map_location="cpu", weights_only=True)
                for role, m in t.bundle.trainable_roles().items():
                    assert role in saved and set(saved[role]) == set(m.state_dict()), role
                    assert differing(m.state_dict(), saved[role], f"{role}.") == []
                assert not t.load_pretrained(pretrained)
                del saved
            cuda.reset_launch_counts()
            t.run_epoch(0)
            assert all(v > 0 for v in cuda.LAUNCHES.values()), dict(cuda.LAUNCHES)
            assert unchecked(cuda.LAUNCH_SHAPES) == []
            cuda.reset_launch_counts()
            t.end_epoch(0)
            assert cuda.LAUNCHES["bilinear_sample_table"] > 0
            assert unchecked(cuda.LAUNCH_SHAPES) == []
            assert predict_kernels_vs_plain(t) <= 1e-5
            losses = [h["loss"] for h in t.history]
            assert len(losses) >= 2 and finite(losses)
            assert len(t.eval_results) == 2
            assert all(finite(r.values()) for r in t.eval_results.values()), t.eval_results
            assert os.path.exists(os.path.join(t.log_path, "models", "model_0.pth"))
        finally:
            t.close()


@pytest.mark.gpu
def test_hr_trainer_from_mr_weights(kitti, mr_trainer):
    """ResNet18_KITTI_HR.txt (1024x320, batch 4, encoder_remat) for an
    epoch of 3 steps, from the KITTI-MR Trainer's model_0.pth."""
    add_split(kitti, "hr", smoke_lines(kitti)[:12])
    check_config_trainer(kitti, [str(ROOT / "configs/resnet18/ResNet18_KITTI_HR.txt"),
                                 "--data_path", os.path.join(kitti, "kitti"), "--split", "hr",
                                 "--eval_split", "eigen"], pretrained=mr_trainer["model_0"])


@pytest.mark.gpu
def test_cityscapes_trainer(cityscapes):
    """ResNet18_CS.txt (512x192, batch 12) for an epoch of 3 steps on the
    synthetic Cityscapes tree, with the Cityscapes evaluation protocol."""
    check_config_trainer(cityscapes, [str(ROOT / "configs/resnet18/ResNet18_CS.txt"),
                                      "--data_path", os.path.join(cityscapes, "cityscapes"),
                                      "--data_path_pre",
                                      os.path.join(cityscapes, "cityscapes_pre")])


# ---- VFI training


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["IFRNet_L_KITTI", "IFRNet_L_CS", "IFRNet_S_KITTI"])
def test_vfi_step(kitti, request, config):
    """A `VFITrainer`'s step on its loader's first batch: finite, the image
    warps and their gradient one launch each at the crop, a shape of
    PATH_SHAPES; then the loss and the gradient norm (the flows' signal
    comes through the warps' grid gradient), kernels vs plain, rel 1e-3."""
    root = request.getfixturevalue("cityscapes") if "_CS" in config else kitti
    crop = (CityscapesVFIDataset if "_CS" in config else KITTIVFIDataset).crop_hw
    cfg = parse_options([
        "-c", str(ROOT / f"configs/vfi/{config}.txt"), "--data_path", os.path.join(root, "kitti"),
        "--data_path_pre", os.path.join(root, "cityscapes_pre"),
        "--log_dir", os.path.join(root, "vfi_step_logs"), "--split", "vfi",
        "--pretrained_path", "", "--resume", "False", "--device", "cuda"])
    with splits_of(root):
        a = TV.VFITrainer(cfg)
    try:
        state = a.state
        batch = next(iter(device_prefetch(a.loader, "cuda")))
        n = batch["img0"].shape[0]
        cuda.reset_launch_counts()
        metrics, _ = a.train_step(state, batch)
        assert finite(float(metrics[k]) for k in ("loss", "psnr", "grad_norm")), metrics
        for name in ("bilinear_sample", "bilinear_sample_bwd"):
            assert cuda.LAUNCH_SHAPES[name, (2 * n, 3) + crop] == 1, name
        assert unchecked(cuda.LAUNCH_SHAPES) == []

        b = M.prepare_batch(batch, "cuda")

        def loss_and_grad_norm():
            state.optimizer.zero_grad(set_to_none=True)
            out = state.module(b["img0"], b["img2"], b["embt"].reshape(-1, 1, 1, 1),
                               imgt=b["img1"])
            out["loss"].backward()
            return out["loss"].item(), global_norm([p.grad for p in state.params]).item()

        got = loss_and_grad_norm()
        with cuda.plain_versions():
            ref = loss_and_grad_norm()
        for name, x, y in zip(("loss", "gradient norm"), got, ref):
            assert math.isfinite(x) and rel(x, y) <= 1e-3, (name, x, y)
    finally:
        a.close()


@pytest.fixture(scope="module")
def vfi_trainer(kitti):
    """IFRNet_L_KITTI.txt's `VFITrainer` on the `vfi` split: epoch 0 of 7
    steps, a checkpoint after step 5, a trainer resumed there takes steps 6
    and 7; the epoch-end checkpoint becomes weights/IFRNet_L_KITTI.pth, the
    depth `Trainer`'s frozen IFRNet-L. -> what the test checks, the
    weights directory."""
    cfg = parse_options([
        "-c", VFI_CONFIG, "--data_path", os.path.join(kitti, "kitti"),
        "--log_dir", os.path.join(kitti, "vfi_logs"), "--split", "vfi", "--num_epochs", "2",
        "--log_frequency", "1", "--save_frequency", "4", "--pretrained_path", "",
        "--resume", "False", "--device", "cuda"])
    weights = os.path.join(kitti, "weights")
    out = {"weights_dir": weights}
    with splits_of(kitti):
        a = TV.VFITrainer(cfg)
        a.run_epoch(0)
        out["steps"] = len(a.history)
        saved = torch.load(a.ckpt_path, map_location="cpu", weights_only=True)
        out["checkpoint_at"] = saved["epoch"], saved["batch_idx"], saved["step_in_total"]
        c = TV.VFITrainer(dataclasses.replace(cfg, resume=True))
        out["resumed_at"] = c.ep_start, c.batch_start, c.state.step
        out["resume_differing"] = (differing(c.state.module.state_dict(), saved["VFI"])
                                   + optimizer_differing(c.state.optimizer, saved))
        c.run_epoch(0)
        out["resumed_losses"] = [h["loss"] for h in c.history]
        a.save_model(0, ep_end=True)
        a.close()
        c.close()
        os.makedirs(weights)
        shutil.copy(a.ckpt_path, os.path.join(weights, "IFRNet_L_KITTI.pth"))
        saved = torch.load(a.ckpt_path, map_location="cpu", weights_only=True)
        depth = T.Trainer(trainer_args(kitti, MR_CONFIG, "--data_path", os.path.join(kitti, "kitti"),
                                       "--exp_name", "frozen_vfi", "--split", "smoke",
                                       "--eval_split", "eigen", "--weights_dir", weights))
        out["frozen_differing"] = differing(depth.bundle.vfi_train.state_dict(), saved["VFI"])
        depth.close()
    return out


@pytest.mark.gpu
def test_vfi_trainer_resume_and_hand_off(vfi_trainer):
    """The resumed trainer at the checkpoint, bit for bit, its two steps
    finite; the depth Trainer's frozen IFRNet-L bit for bit the VFI's."""
    r = vfi_trainer
    assert r["steps"] == 7 and r["checkpoint_at"] == (0, 5, 5)
    assert r["resumed_at"] == r["checkpoint_at"]
    assert r["resume_differing"] == []
    assert len(r["resumed_losses"]) == 2 and finite(r["resumed_losses"])
    assert r["frozen_differing"] == []


# ---- several ranks


def smooth_frames(rng, n: int, h: int, w: int, pan: int = 0) -> np.ndarray:
    """n uint8 frames (n, h, w, 3): frame i the window at `pan` * i pixels
    of a smooth colour field of its own phases, plus noise in [0, 16)."""
    fields = [_panning_field(rng, h, w + pan * n) for _ in range(n)]
    return np.stack([f[:, pan * i:pan * i + w] + rng.integers(0, 16, (h, w, 3), np.uint8)
                     for i, f in enumerate(fields)])


DDP_B, DDP_VFI_B = 10, 16  # the global batches: ResNet18 KITTI-MR and IFRNet-L KITTI


def ddp_batches(device):
    """The global batches: the ResNet18 step's (smooth frames in each image
    entry) and the VFI step's (triplets of frames panning 4 pixels, at the
    KITTI crop)."""
    batch = make_batch(DDP_B, H, W, device)
    rng = np.random.default_rng(12)
    for k, v in batch.items():
        if v.dtype == torch.uint8 and v.shape[-1] == 3:
            batch[k] = torch.from_numpy(smooth_frames(rng, DDP_B, H, W)).to(device)
    trip = np.stack([smooth_frames(rng, 3, *KITTIVFIDataset.crop_hw, pan=4)
                     for _ in range(DDP_VFI_B)])
    vfi = {f"img{i}": torch.from_numpy(np.ascontiguousarray(trip[:, i])).to(device)
           for i in range(3)}
    vfi["embt"] = torch.full((DDP_VFI_B,), 0.5, device=device)
    return batch, vfi


def ddp_configs(world: int, device, dtype: str):
    """The ResNet18 and VFI configurations at a world's local batches."""
    cfg = parse_options(["-c", MR_CONFIG, "--weights_init", "scratch", "--batch_size",
                         str(DDP_B // world), "--device", str(device), "--compute_dtype", dtype])
    vfi_cfg = parse_options(["-c", VFI_CONFIG, "--batch_size", str(DDP_VFI_B // world),
                             "--device", str(device), "--compute_dtype", dtype])
    return cfg, vfi_cfg


def ddp_steps(device, world: int, dtype: str, torch_init: bool, rank: int = 0,
              vfi: bool = True, step1=None) -> dict:
    """Two steps of the ResNet18 step and (with `vfi`) of the VFI step from
    seed 0 on this rank's rows of the global batches, the step's generator
    seeded per step alike on every rank, each path's launches counted from
    0; the state after step 1 is kept, or, given `step1`, step 2 starts
    from it. -> per path the metrics, launches, launch keys outside
    PATH_SHAPES, parameters and BatchNorm buffers after step 2."""
    batch, vfi_batch = ddp_batches(device)
    cfg, vfi_cfg = ddp_configs(world, device, dtype)

    def rows(b, n):
        return {k: v[rank * n:(rank + 1) * n] for k, v in b.items()}

    def run(step_fn, state, module, local, metrics_of, path):
        if parallel.active():
            parallel.broadcast_module_(module)
        cuda.reset_launch_counts()
        gen = torch.Generator(device=device)
        metrics, kept = [], None
        for s in range(2):
            if s == 1 and step1 is None:
                kept = {"model": copy.deepcopy(module.state_dict()),
                        "opt": copy.deepcopy(state.optimizer.state_dict()), "step": state.step}
            elif s == 1:
                module.load_state_dict(step1[path]["step1"]["model"])
                state.optimizer.load_state_dict(step1[path]["step1"]["opt"])
                state.step = step1[path]["step1"]["step"]
            gen.manual_seed(1000 + s)
            metrics.append(metrics_of(step_fn(state, local, gen)))
        return {"metrics": metrics, "launches": dict(cuda.LAUNCHES),
                "unchecked": unchecked(cuda.LAUNCH_SHAPES), "step1": kept,
                "params": {k: p.detach().cpu().clone() for k, p in module.named_parameters()
                           if p.requires_grad},
                "stats": {k: t.cpu().clone() for k, t in module.named_buffers()}}

    with torch_default_init(torch_init):
        state = M.create_train_state(cfg, 0, steps_per_epoch=3981, device=device)
    train_step = M.MonoViFiStep(state.bundle, device=device).make_train_step()
    out = {"depth": run(train_step, state, state.bundle, rows(batch, cfg.batch_size),
                        lambda m: {k: float(v) for k, v in m.items()}, "depth")}
    del state, train_step
    if vfi:
        with torch_default_init(torch_init):
            vstate = V.create_vfi_state(vfi_cfg, 0, steps_per_epoch=1000, device=device)
        vfi_step = V.make_vfi_train_step(vfi_cfg.clip_grad)
        out["vfi"] = run(lambda st, b, g: vfi_step(st, b), vstate, vstate.module,
                         rows(vfi_batch, vfi_cfg.batch_size),
                         lambda m: {k: float(v) for k, v in m[0].items()}, "vfi")
    torch.cuda.empty_cache()
    return out


# Limits on the relative difference of the loss terms (and PSNR), the
# gradient norm, and the BatchNorm buffers and parameters after step 2. In
# f32 the ranks differ from one process only in the order of sums and the
# variance's formula. In bf16 the gradient norm moves further (H100 80GB
# HBM3, 700 W): a group's `_GlobalBatchNorm` (f32, its output cast to bf16)
# rounds the normalized activations apart from cuDNN's bf16 BatchNorm, and
# the pose net's gradient carries that into the norm (one rank 4.2e-4 from
# one process at step 1); each rank rounds its half of a weight gradient to
# bf16 before the all-reduce (the VFI step, no BatchNorm, 7.4e-4 and
# 9.6e-4). The ResNet18 step read up to 1.03e-3, so 3e-3 there.
DDP_TOL = {"float32": {"mean": 1e-3, "grad_norm": 1e-3, "state": 1e-3},
           "bfloat16": {"mean": 1e-3, "grad_norm": 3e-3, "state": 1e-3}}
# The runs: (label, compute dtype, torch's default init?). DDP_TOL was set
# on torch's init. From the port's init the f32 run read at most 2.67e-5;
# the bf16 run read 1.008e-3 (wider activations rounded apart), so it has
# no limit (label not in DDP_TOL): only the ranks' agreement is checked.
DDP_RUNS = (("float32", "float32", False), ("bfloat16", "bfloat16", True),
            ("bfloat16, port's init", "bfloat16", False))


def ddp_rank(out_dir: str, runs, vfi: bool) -> None:
    """One rank of a group sharing cuda:0 over gloo (a process of
    `parallel.spawn_local`): its share of each of `runs`, saved for the
    parent."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = parallel.rank_and_world()
    out = {label: ddp_steps(torch.device("cuda"), world, dtype, torch_init, rank, vfi)
           for label, dtype, torch_init in runs}
    torch.save(out, f"{out_dir}/world{world}_rank{rank}.pt")


def spawn_ranks(out_dir: str, world: int, runs, vfi: bool = True) -> list[dict]:
    torch.cuda.empty_cache()
    parallel.spawn_local(ddp_rank, world, out_dir, runs, vfi, device="cuda:0", backend="gloo")
    return [torch.load(f"{out_dir}/world{world}_rank{r}.pt", map_location="cpu",
                       weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def two_ranks(card, tmp_path_factory):
    """Two ranks sharing cuda:0 over gloo (NCCL refuses two ranks on one
    card), each at half of each global batch, in each of DDP_RUNS."""
    return spawn_ranks(str(tmp_path_factory.mktemp("ranks")), 2, DDP_RUNS)


def groups(tensors: dict, key: str) -> dict:
    """The units of comparison: each BatchNorm buffer alone; the parameters
    of each top-level module (a role of the bundle, a part of IFRNet) as one
    vector. A zero-initialized bias alone is the size of the update, whose
    sign follows the sign of gradients near zero."""
    if key == "stats":
        return {k: v.float() for k, v in tensors.items()}
    out: dict = {}
    for k, v in tensors.items():
        out.setdefault(k.split(".", 1)[0], []).append(v.float().reshape(-1))
    return {k: torch.cat(v) for k, v in out.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("run,dtype,torch_init", DDP_RUNS, ids=[r[0] for r in DDP_RUNS])
def test_two_ranks_match_one_process(card, two_ranks, run, dtype, torch_init):
    """Two ranks at local batches 5 and 8 against one process at 10 and 16,
    its step 2 from rank 0's state after step 1 (AdamW's first update
    follows each gradient's sign, which a rounding flips where the ranks'
    halves nearly cancel): loss terms and gradient norm at each step, then
    BatchNorm buffers and parameters (`groups`), within DDP_TOL and equal
    across the ranks; in bf16 every kernel launched, each at a shape of
    PATH_SHAPES."""
    tol = DDP_TOL.get(run)

    def within(e, kind):
        return tol is None or e <= tol[kind]

    ref = ddp_steps(card, 1, dtype, torch_init, step1=two_ranks[0][run])
    for path in ("depth", "vfi"):
        for s in range(2):
            for k, v in ref[path]["metrics"][s].items():
                got = [r[run][path]["metrics"][s][k] for r in two_ranks]
                e = rel(got[0], v)
                assert math.isfinite(got[0]) and got[0] == got[1], (path, s, k, got)
                assert within(e, "grad_norm" if k == "grad_norm" else "mean"), (path, s, k, e)
        for key in ("stats", "params"):
            mine = [groups(r[run][path][key], key) for r in two_ranks]
            for k, v in groups(ref[path][key], key).items():
                if k.endswith("num_batches_tracked"):
                    assert all(torch.equal(m[k], v) for m in mine), (path, k)
                    continue
                assert within(rel(mine[0][k], v), "state"), (path, key, k)
                assert within(rel(mine[1][k], mine[0][k]), "state"), (path, key, k)
    if run == "bfloat16":
        depth, vfi = two_ranks[0][run]["depth"], two_ranks[0][run]["vfi"]
        assert all(v > 0 for v in depth["launches"].values()), depth["launches"]
        assert vfi["launches"]["bilinear_sample"] > 0
        assert vfi["launches"]["bilinear_sample_bwd"] > 0
        for path in (depth, vfi):
            assert path["unchecked"] == []


@pytest.mark.gpu
def test_one_rank_group_matches_two_ranks(two_ranks, tmp_path):
    """A group of one rank at the whole bf16 ResNet18 batch (every
    BatchNorm the global one): its step 1 within the loss terms' limit of
    the two ranks' (DDP_TOL's comment)."""
    one = spawn_ranks(str(tmp_path), 1, DDP_RUNS[1:2], vfi=False)[0]
    for k, v in one["bfloat16"]["depth"]["metrics"][0].items():
        two = two_ranks[0]["bfloat16"]["depth"]["metrics"][0][k]
        assert math.isfinite(v) and rel(two, v) <= DDP_TOL["bfloat16"]["mean"], (k, v, two)


# Each NCCL step starts from the plain trainer's state before it; the two
# then differ in the BatchNorm's arithmetic (`_GlobalBatchNorm` against
# cuDNN) and, in bf16, its output's rounding (DDP_TOL's comment).
NCCL1_TOL = {"float32": 1e-5, "bfloat16": 1e-3}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(NCCL1_TOL))
def test_trainer_on_nccl_at_a_world_of_one(kitti, dtype):
    """The `Trainer` with `distributed` at a world of 1 on NCCL (the env
    rendezvous) against the plain `Trainer`: 3 steps and their checkpoints,
    the losses step for step within NCCL1_TOL."""
    add_split(kitti, "nccl1", smoke_lines(kitti)[:30])
    cfg = trainer_args(kitti, MR_CONFIG, "--data_path", os.path.join(kitti, "kitti"),
                       "--log_dir", os.path.join(kitti, "nccl1_logs"), "--split", "nccl1",
                       "--eval_split", "eigen", "--num_epochs", "1", "--save_frequency", "1",
                       "--compute_dtype", dtype)
    states, runs = {}, {}

    def share(t, keep: bool) -> None:
        """Before each step (where the trainer seeds its draws) keep the
        trainer's state, or take the kept one of the same step."""
        seed = t.noise_seed

        def at(step: int) -> int:
            if keep:
                states[step] = (copy.deepcopy(t.bundle.state_dict()),
                                copy.deepcopy(t.state.optimizer.state_dict()))
            else:
                t.bundle.load_state_dict(states[step][0])
                t.state.optimizer.load_state_dict(states[step][1])
            return seed(step)

        t.noise_seed = at

    with splits_of(kitti), pytest.MonkeyPatch.context() as mp:
        for label, distributed in (("plain", False), ("nccl", True)):
            if distributed:
                with socket.socket() as sock:
                    sock.bind(("127.0.0.1", 0))
                    port = sock.getsockname()[1]
                for k, v in zip(ENV_RENDEZVOUS, ("0", "1", "0", "127.0.0.1", str(port))):
                    mp.setenv(k, v)
            t = T.Trainer(dataclasses.replace(cfg, exp_name=f"{label}_{dtype}",
                                              distributed=distributed))
            try:
                if distributed:
                    assert dist.get_backend() == "nccl" and t.world == 1
                share(t, keep=not distributed)
                t.run_epoch(0)
                saved = torch.load(t.ckpt_path, map_location="cpu", weights_only=True)
                runs[label] = ([h["loss"] for h in t.history],
                               (saved["epoch"], saved["batch_idx"], saved["step_in_total"]))
                t.close()
            finally:
                vars(t).pop("noise_seed", None)  # `share`'s closure holds the trainer
                if parallel.active():
                    dist.destroy_process_group()
    for label, (losses, at) in runs.items():
        assert len(losses) == 3 and at == (0, 3, 3), (label, losses, at)
    for s, (a, b) in enumerate(zip(runs["nccl"][0], runs["plain"][0])):
        assert math.isfinite(a) and rel(a, b) <= NCCL1_TOL[dtype], (s + 1, a, b)


# ---- the port's tools


@pytest.mark.gpu
@pytest.mark.parametrize("argv", [[], ["--hr"]], ids=["mr", "hr"])
def test_bench(card, argv):
    """`python -m mono_vifi_tpu_torch.bench [--hr]` (its `main`): the
    record's keys and finite values, every kernel launched, each at a shape
    of PATH_SHAPES."""
    benchmark = torch.backends.cudnn.benchmark
    cuda.reset_launch_counts()
    try:
        rec = bench.main(argv)
    finally:
        torch.backends.cudnn.benchmark = benchmark
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "tflop_per_step",
                        "mfu_vs_989tflops_bf16", "device"}
    assert finite([rec["value"], rec["vs_baseline"], rec["mfu_vs_989tflops_bf16"]])
    assert rec["tflop_per_step"] > 0
    assert all(v > 0 for v in cuda.LAUNCHES.values()), dict(cuda.LAUNCHES)
    assert unchecked(cuda.LAUNCH_SHAPES) == []


@pytest.mark.gpu
def test_convergence_smoke(card):
    """The convergence smoke at its command line's defaults (300 bf16 steps
    at 96x320, batch 2): the loss falls below 0.85 of its first tenth's
    (tests/test_convergence.py's bf16 criterion), every kernel launched,
    each at a shape of PATH_SHAPES."""
    cuda.reset_launch_counts()
    out = CONV.run(steps=300, H=96, W=320, B=2, compute_dtype="bfloat16", device="cuda")
    assert finite(out[k] for k in ("loss_first10", "loss_last10", "abs_rel_initial",
                                   "abs_rel_final")), out
    assert out["loss_last10"] < 0.85 * out["loss_first10"], out
    assert all(v > 0 for v in cuda.LAUNCHES.values()), dict(cuda.LAUNCHES)
    assert unchecked(cuda.LAUNCH_SHAPES) == []


@pytest.mark.gpu
@pytest.mark.parametrize("argv,keys", [
    (["mono_vifi_tpu_torch.bench_loader", "--samples", "20"],
     {"metric", "use_affine", "workers", "value", "unit", "cpu_count"}),
    (["mono_vifi_tpu_torch.bench_e2e", "--loader-sweep"],
     {"metric", "value", "unit", "workers", "stage_uint8", "cpu_count"}),
    (["mono_vifi_tpu_torch.bench_e2e", "--steps", "10"],
     {"metric", "value", "unit", "steps", "workers", "dispatch_fraction", "device"}),
], ids=["bench_loader", "bench_e2e-loader-sweep", "bench_e2e"])
def test_loader_tool(card, argv, keys):
    """The loader benchmarks, each its own process as a user runs it (few
    samples and steps: no rate is read): exit 0, a JSON record last with
    its keys and a finite, positive value."""
    proc = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(rec) == keys, rec
    assert math.isfinite(rec["value"]) and rec["value"] > 0, rec


GOLDEN_TOL = 1e-4  # each of the seven metrics, the card against the CPU's plain versions


@pytest.fixture(scope="module")
def golden_args(kitti, mr_trainer, vfi_trainer):
    """golden_parity's arguments: the synthetic tree (`eigen_benchmark` a
    copy of `eigen`), the MR Trainer's model_0.pth, the VFI trainer's
    IFRNet-L, the entry modules' defaults (640x192, batch 4, f32)."""
    splits = os.path.join(kitti, "splits", "kitti")
    shutil.copytree(os.path.join(splits, "eigen"), os.path.join(splits, "eigen_benchmark"),
                    dirs_exist_ok=True)
    return ["--kitti_path", os.path.join(kitti, "kitti"), "--ckpt", mr_trainer["model_0"],
            "--weights_dir", vfi_trainer["weights_dir"], "--vfi_scale", "large"]


@pytest.mark.gpu
def test_golden_parity_without_a_golden_source_exits_2(kitti, golden_args):
    with splits_of(kitti):
        assert GP.main(golden_args) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("flags", [["--post_process"], ["--mf"]], ids=["single-frame", "mf"])
def test_golden_parity_against_the_cpu(kitti, golden_args, flags, tmp_path):
    """golden_parity's `main` on the card against its `run_ours` on the CPU
    (plain versions): exit 0, the seven metrics of each split within
    GOLDEN_TOL, every launch at a shape of PATH_SHAPES; --mf launches the
    table sample; a golden a1 moved by 0.01 exits 1."""
    golden_path, save = tmp_path / "golden.json", tmp_path / "ours.json"
    with splits_of(kitti):
        golden = GP.run_ours(GP.parse_args(golden_args + flags + ["--device", "cpu"]))
        golden_path.write_text(json.dumps(golden))
        cuda.reset_launch_counts()
        assert GP.main(golden_args + flags + ["--golden", str(golden_path),
                                              "--save", str(save)]) == 0
        launches = cuda.LAUNCHES["bilinear_sample_table"]
        assert unchecked(cuda.LAUNCH_SHAPES) == []
        ours = json.loads(save.read_text())["ours"]
        worst = max(abs(ours[s][k] - golden[s][k]) for s in GP.SPLITS for k in GP.ALL_NAMES)
        assert worst <= GOLDEN_TOL
        if "--mf" in flags:
            assert launches > 0
        else:
            golden["eigen"]["a1"] += 0.01
            golden_path.write_text(json.dumps(golden))
            assert GP.main(golden_args + flags + ["--golden", str(golden_path)]) == 1
