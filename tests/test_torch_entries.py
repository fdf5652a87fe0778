"""The port's `test_simple` and `test_video` entry modules against the root
JAX scripts, and its `magma` table against matplotlib, on the CPU.

Both sides run the same weights: a seeded random evaluation bundle of the
port (BatchNorm running statistics from a numpy seed). The port's scripts
load it from a reference `.pth` checkpoint and its IFRNet-S from
`weights_dir/IFRNet_S_KITTI.pth`; the JAX scripts' `load_model` is replaced
by the same weights carried into Flax by the JAX package's converter, for
two reasons: the root evaluate_depth_mf.load_model raises UnboundLocalError
before it builds anything (its function-local `import jax` shadows the
module's at its first line that uses jax), and the root evaluate_depth
load_model initializes the whole training bundle op by op (about a minute
on a CPU). Both run on the same PNG frames written to tmp_path (each side
in its own copy of the directory, since both write beside the frames).

Tolerances (f32, CPU): the saved scaled disparities (`*_disp*.npy`, in
[0.01, 10]) atol 1e-5: XLA and PyTorch sum the convolutions in other
orders, and these random-weight disparities come out of a sigmoid whose
input differs by ~1e-6. The jpeg and gif files are compared by existence
and size, since a colormap turns a 1e-6 difference at a bin edge into
another colour. `magma` equals matplotlib's, uint8 for uint8.
"""

import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import test_simple as JTS
import test_video as JTVID
from mono_vifi_tpu import convert as jconvert
from mono_vifi_tpu.config import Options as JOptions
from mono_vifi_tpu.training import monovifi as JM
from mono_vifi_tpu_torch import test_simple as TS
from mono_vifi_tpu_torch import test_video as TVID
from mono_vifi_tpu_torch.config import Options
from mono_vifi_tpu_torch.training import checkpoint as ckpt_lib
from mono_vifi_tpu_torch.training.factory import build_bundle
from mono_vifi_tpu_torch.utils.colormap import magma

H, W = 64, 96


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads, as the other heavy files of the suite."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """-> (checkpoint path, weights_dir, bundle) of one seeded evaluation
    bundle."""
    root = tmp_path_factory.mktemp("weights")
    cfg = Options(height=H, width=W, compute_dtype="float32", vfi_test_scale="small")
    bundle = build_bundle(cfg, 13, "cpu", for_training=False)
    rng = np.random.default_rng(4)
    for m in bundle.modules():
        if hasattr(m, "running_mean"):
            m.running_mean.copy_(torch.from_numpy(
                (0.1 * rng.standard_normal(m.running_mean.shape)).astype(np.float32)))
            m.running_var.copy_(torch.from_numpy(
                rng.uniform(0.5, 1.5, m.running_var.shape).astype(np.float32)))
    ckpt = root / "model_0.pth"
    ckpt_lib.save_weights(str(ckpt), bundle, cfg)
    torch.save({"VFI": bundle.vfi_test.state_dict()}, root / "IFRNet_S_KITTI.pth")
    return str(ckpt), str(root), bundle


@pytest.fixture(scope="module")
def jax_model(weights):
    """(JAX bundle, params, batch_stats, IFRNet-S params) of the same
    weights, by the JAX package's torch -> Flax converter."""
    src = weights[2]

    def sd(m):
        return {k: v.numpy() for k, v in m.state_dict().items()}

    enc = jconvert.convert_depth_encoder(sd(src.encoder), 18)
    params = {"encoder": enc["params"],
              "depth": jconvert.convert_depth_decoder(sd(src.depth))["params"],
              "depth_mf": jconvert.convert_depth_decoder(sd(src.depth_mf))["params"],
              "fusion_module": jconvert.convert_fusion_module(sd(src.fusion_module))["params"]}
    jb = JM.ModelBundle(JOptions(height=H, width=W, compute_dtype="float32",
                                 vfi_test_scale="small", vfi_train_scale="tiny",
                                 weights_init="scratch"))
    return jb, params, {"encoder": enc["batch_stats"]}, jconvert.convert_ifrnet(
        sd(src.vfi_test))["params"]


@pytest.fixture(scope="module")
def frame_dirs(tmp_path_factory):
    """Three 90x200 PNG frames of a smooth pan plus noise; -> a copy of the
    directory for each side."""
    src = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(9)
    ys, xs = np.mgrid[0:90, 0:212] / 15.0
    field = np.stack([127 + 100 * np.sin(xs + c) * np.cos(ys - c) for c in range(3)], -1)
    for i in range(3):
        img = field[:, 4 * i:4 * i + 200] + rng.integers(0, 12, (90, 200, 3))
        Image.fromarray(img.clip(0, 255).astype(np.uint8)).save(src / f"{i:04d}.png")
    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = tmp_path_factory.mktemp(side)
        for p in src.iterdir():
            shutil.copy(p, dirs[side] / p.name)
    return dirs


def _common(ckpt):
    return ["--pretrained_path", ckpt, "--height", str(H), "--width", str(W), "--save_npy"]


def test_test_simple_matches_the_jax_script(weights, jax_model, frame_dirs, monkeypatch):
    ckpt = weights[0]
    monkeypatch.setattr(JTS, "load_model", lambda args: jax_model[:3])
    JTS.main(JTS.parse_args(["--image_path", str(frame_dirs["jax"])] + _common(ckpt)))
    TS.main(TS.parse_args(["--image_path", str(frame_dirs["port"]), "--device", "cpu"]
                          + _common(ckpt)))
    for i in range(3):
        ref = np.load(frame_dirs["jax"] / f"{i:04d}_disp.npy")
        got = np.load(frame_dirs["port"] / f"{i:04d}_disp.npy")
        assert got.shape == ref.shape == (H, W)
        np.testing.assert_allclose(got, ref, atol=1e-5)
        with Image.open(frame_dirs["port"] / f"{i:04d}_disp.jpeg") as im:
            assert im.size == (200, 90)  # the frame's own size


def test_test_simple_takes_the_root_scripts_command_line():
    """Every flag of the root test_simple.py parses in the port to the same
    value; `--post_process`, which neither script acts on, included."""
    argv = ["--image_path", "img.png", "--pretrained_path", "ckpt.pth", "--backbone",
            "LiteMono", "--height", "96", "--width", "320", "--ext", "jpg", "--save_npy",
            "--post_process"]
    ref = vars(JTS.parse_args(argv))
    assert ref["post_process"] is True
    assert vars(TS.parse_args(argv)) == ref | {"device": "cuda"}


def test_the_root_mf_load_model_raises_before_it_builds():
    """Why the root scripts' multi-frame `load_model` is replaced here and in
    tests/test_torch_golden_parity.py (module docstring): it reads `jax`
    before its function-local `import jax` binds it."""
    import evaluate_depth_mf as JEDM

    args = JEDM.eval_args(["--height", str(H), "--width", str(W)])
    with pytest.raises(UnboundLocalError):
        JEDM.load_model(args, "KITTI")


def test_test_simple_single_file(weights, tmp_path):
    """`--image_path` naming one image writes beside it."""
    ckpt = weights[0]
    path = tmp_path / "one.png"
    Image.fromarray(np.full((40, 70, 3), 128, np.uint8)).save(path)
    TS.main(TS.parse_args(["--image_path", str(path), "--device", "cpu"] + _common(ckpt)))
    assert (tmp_path / "one_disp.jpeg").exists() and (tmp_path / "one_disp.npy").exists()


def test_test_video_matches_the_jax_script(weights, jax_model, frame_dirs, tmp_path,
                                          monkeypatch):
    ckpt, weights_dir = weights[:2]
    monkeypatch.setattr(JTVID, "load_model", lambda args, tag: jax_model)
    argv = _common(ckpt) + ["--weights_dir", weights_dir, "--vfi_scale", "small"]
    out = {side: tmp_path / side for side in ("jax", "port")}
    JTVID.main(JTVID.parse_args(["--image_path", str(frame_dirs["jax"]),
                                 "--output_path", str(out["jax"])] + argv))
    TVID.main(TVID.parse_args(["--image_path", str(frame_dirs["port"]),
                               "--output_path", str(out["port"]), "--device", "cpu"] + argv))
    for i in range(3):
        for tag in ("sf", "mf"):
            ref = np.load(out["jax"] / f"{i:04d}_disp_{tag}.npy")
            got = np.load(out["port"] / f"{i:04d}_disp_{tag}.npy")
            assert got.shape == ref.shape == (H, W)
            np.testing.assert_allclose(got, ref, atol=1e-5, err_msg=f"{i} {tag}")
            assert (out["port"] / f"{i:04d}_disp_{tag}.jpeg").exists()
    with Image.open(out["port"] / "demo.gif") as gif:
        assert gif.size == (W, 3 * H) and gif.n_frames == 3


def test_test_video_refuses_an_empty_directory(tmp_path):
    with pytest.raises(FileNotFoundError, match="no \\*.png frames"):
        TVID.main(TVID.parse_args(["--image_path", str(tmp_path), "--device", "cpu",
                                   "--height", str(H), "--width", str(W)]))


def test_magma_equals_matplotlib():
    import matplotlib

    cm = matplotlib.colormaps["magma"]
    x = np.concatenate([np.linspace(-0.5, 1.5, 20001), np.arange(257) / 256.0,
                        np.nextafter(np.arange(1, 257) / 256.0, 0.0)])
    ref = (cm(np.clip(x, 0.0, 1.0))[..., :3] * 255).astype(np.uint8)
    np.testing.assert_array_equal(magma(x), ref)
    img = np.random.default_rng(0).random((17, 23))
    np.testing.assert_array_equal(magma(img), (cm(img)[..., :3] * 255).astype(np.uint8))
    assert magma(img).dtype == np.uint8 and magma(img).shape == (17, 23, 3)
