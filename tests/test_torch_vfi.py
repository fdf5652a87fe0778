"""The port's VFI training against the JAX package's, on the CPU: the IFRNet
losses (value and input gradient), IFRNet with the middle frame (the
prediction, the loss and every parameter's gradient), one whole VFI step
against `make_vfi_train_step`, the VFI datasets' items, `flow_to_color`,
the VFI checkpoint read as a frozen VFI (the port's own and a JAX
train_vfi.py `ckpt.pkl`, through the depth `Trainer`), and
`python -m mono_vifi_tpu_torch.train_vfi` on a synthetic KITTI tree with a
mid-epoch resume.

Tolerances (f32, CPU): loss values rtol 1e-5 and input gradients atol 1e-6
(one f32 reduction order against another); IFRNet's prediction atol 2e-4 as
tests/test_torch_models.py, its loss rtol 1e-5, each parameter's gradient
within 1e-4 of its norm (measured ~1e-6: the two libraries sum the
convolutions' products in other orders); the step's psnr and grad_norm rtol
1e-5, the updated parameters atol 1e-6 where the gradient is at least
1e-5 (an AdamW step of lr 1e-4 moves a weight by lr * g / (|g| + 1e-8); a
few ulps of such a gradient move that by far less) and within 2 * lr where
it is smaller (there the step's direction is a matter of rounding);
datasets, `flow_to_color` and the frozen VFI's weights exactly; a resumed
run's loss and weights rtol 1e-6 of the uninterrupted run's. bf16: the
port's bf16 loss within 1.5x the JAX package's bf16-to-f32 distance (plus
1e-3 of the f32 loss); measured 1.5e-6 against JAX's 7.8e-5, and a bf16
geometry loss on random features 6.8e-4 from f32 (relative) in both.
"""

import os
import pathlib
import shutil

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from PIL import Image

from mono_vifi_tpu import convert as jconvert
from mono_vifi_tpu.config import Options as JOptions
from mono_vifi_tpu.data.vfi import CityscapesVFIDataset as JCSVFI
from mono_vifi_tpu.data.vfi import KITTIVFIDataset as JKITTIVFI
from mono_vifi_tpu.models import ifrnet as JIF
from mono_vifi_tpu.ops import losses as JL
from mono_vifi_tpu.training import vfi as JV
from mono_vifi_tpu.training.optim import make_optimizer as jmake_optimizer
from mono_vifi_tpu.utils.flow_vis import flow_to_color as jflow_to_color
from mono_vifi_tpu_torch import convert
from mono_vifi_tpu_torch import train as T
from mono_vifi_tpu_torch import train_vfi as TV
from mono_vifi_tpu_torch.config import Options
from mono_vifi_tpu_torch.data import CityscapesVFIDataset, KITTIVFIDataset
from mono_vifi_tpu_torch.models import ifrnet as TIF
from mono_vifi_tpu_torch.ops import losses as TL
from mono_vifi_tpu_torch.training import checkpoint as ckpt_lib
from mono_vifi_tpu_torch.training import vfi as TVS
from mono_vifi_tpu_torch.utils.flow_vis import flow_to_color

ROOT = pathlib.Path(__file__).resolve().parents[1]
DRIVE = "2011_09_26/2011_09_26_drive_0001_sync"
RNG = np.random.default_rng(17)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads, as the other heavy files of the suite."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rand(*shape):
    return RNG.random(shape).astype(np.float32)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def smooth(b, h, w):
    """Low-frequency images: the image warps' grid gradient is a difference
    of neighbouring taps, which jumps where rounding moves a coordinate
    across a pixel; on smooth images the jumps are small."""
    lo = RNG.random((b, h // 8 + 1, w // 8 + 1, 3))
    ys, xs = np.linspace(0, h // 8, h), np.linspace(0, w // 8, w)
    y0 = np.floor(ys).astype(int).clip(0, h // 8 - 1)
    x0 = np.floor(xs).astype(int).clip(0, w // 8 - 1)
    wy, wx = (ys - y0)[None, :, None, None], (xs - x0)[None, None, :, None]
    top = lo[:, y0][:, :, x0] * (1 - wx) + lo[:, y0][:, :, x0 + 1] * wx
    bot = lo[:, y0 + 1][:, :, x0] * (1 - wx) + lo[:, y0 + 1][:, :, x0 + 1] * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


# ------------------------------------------------------------------ losses

def _loss_cases():
    d = rand(2, 16, 24, 3) - 0.5
    m = (RNG.random((2, 16, 24, 1)) > 0.3).astype(np.float32)
    f = rand(2, 16, 24, 2) * 4 - 2
    g = rand(2, 16, 24, 2) * 4 - 2
    w = rand(2, 16, 24, 3)
    x, y = rand(2, 20, 28, 3), rand(2, 20, 28, 3)
    fx, fy = rand(2, 12, 16, 5) - 0.5, rand(2, 12, 16, 5) - 0.5
    return {
        "charbonnier_l1": (lambda a: JL.charbonnier_l1(a), lambda a: TL.charbonnier_l1(a), d),
        "charbonnier_l1_mask": (lambda a: JL.charbonnier_l1(a, jnp.asarray(m)),
                                lambda a: TL.charbonnier_l1(a, nchw(m)), d),
        "charbonnier_ada": (lambda a: JL.charbonnier_ada(a, jnp.asarray(w)),
                            lambda a: TL.charbonnier_ada(a, nchw(w)), d),
        "get_robust_weight": (
            lambda a: jnp.sum(JL.get_robust_weight(jnp.asarray(f), a, 0.3) ** 2),
            lambda a: torch.sum(TL.get_robust_weight(nchw(f), a, 0.3) ** 2), g),
        "ternary_loss": (lambda a: JL.ternary_loss(a, jnp.asarray(y)),
                         lambda a: TL.ternary_loss(a, nchw(y)), x),
        "geometry_loss": (lambda a: JL.geometry_loss(a, jnp.asarray(fy)),
                          lambda a: TL.geometry_loss(a, nchw(fy)), fx),
    }


LOSS_CASES = _loss_cases()


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_vfi_loss_matches_jax(name):
    jfn, tfn, x = LOSS_CASES[name]
    ref, jgrad = jax.value_and_grad(jfn)(jnp.asarray(x))
    xt = nchw(x).requires_grad_(True)
    got = tfn(xt)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(jgrad), atol=1e-6)


def test_geometry_loss_second_argument_gradient():
    """The geometry loss is not detached in its second argument (the middle
    frame's encoder features are trained through it)."""
    x, y = rand(2, 12, 16, 4), rand(2, 12, 16, 4)
    jgrad = jax.grad(lambda b: JL.geometry_loss(jnp.asarray(x), b))(jnp.asarray(y))
    yt = nchw(y).requires_grad_(True)
    TL.geometry_loss(nchw(x), yt).backward()
    np.testing.assert_allclose(nhwc(yt.grad), np.asarray(jgrad), atol=1e-6)


# ------------------------------------------------------------------ IFRNet

def _port_and_jax_ifrnet(scale, seed=0):
    torch.manual_seed(seed)
    net = TIF.IFRNet(scale)
    params = jconvert.convert_ifrnet({k: v.numpy() for k, v in net.state_dict().items()})
    return net, params["params"]


def _grad_rel_errors(net, jgrads):
    ref = convert.ifrnet(jax.tree.map(np.asarray, jgrads))
    assert set(ref) == {k for k, _ in net.named_parameters()}
    return {k: float(np.linalg.norm(p.grad.numpy() - ref[k].numpy())
                     / max(np.linalg.norm(ref[k].numpy()), 1e-12))
            for k, p in net.named_parameters()}


@pytest.mark.parametrize("scale, h, w", [("tiny", 64, 96), ("small", 32, 64)])
def test_ifrnet_with_imgt_matches_jax(scale, h, w):
    net, params = _port_and_jax_ifrnet(scale)
    img0, imgt, img1 = (smooth(2, h, w) for _ in range(3))
    embt = np.full((2, 1, 1, 1), 0.5, np.float32)
    jnet = JIF.IFRNet(scale=scale)

    def lf(p):
        out = jnet.apply({"params": p}, jnp.asarray(img0), jnp.asarray(img1),
                         jnp.asarray(embt), imgt=jnp.asarray(imgt))
        return out["loss"], out

    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(lf, has_aux=True))(params)
    out = net(nchw(img0), nchw(img1), torch.from_numpy(embt), imgt=nchw(imgt))
    out["loss"].backward()
    np.testing.assert_allclose(out["loss"].item(), float(jloss), rtol=1e-5)
    for k in ("imgt_pred", "flow0", "flow1", "mask"):
        np.testing.assert_allclose(nhwc(out[k]), np.asarray(jout[k]), atol=2e-4, err_msg=k)
    errs = _grad_rel_errors(net, jgrads)
    worst = max(errs, key=errs.get)
    assert errs[worst] < 1e-4, (worst, errs[worst])


def test_bf16_vfi_loss_is_as_close_to_f32_as_jax():
    """IFRNet-S with the middle frame in bf16 and in f32 in each package, on
    the same weights: the port's bf16 loss is held to its own f32 loss, at
    most 1.5x as far as the JAX package's bf16 loss from its f32 loss (plus
    a floor of 1e-3 of the f32 value), as tests/test_torch_bf16.py does.
    The two bf16 results are not compared directly: JAX builds the image
    warps' grids in bf16, the port in f32. The census losses run in the
    features' dtype with f32 accumulation, as JAX's bf16 kernel."""
    net32, params = _port_and_jax_ifrnet("small", seed=2)
    netbf = TIF.IFRNet("small", torch.bfloat16)
    netbf.load_state_dict(net32.state_dict())
    img0, imgt, img1 = (smooth(2, 32, 64) for _ in range(3))
    embt = np.full((2, 1, 1, 1), 0.5, np.float32)
    args = [jnp.asarray(x) for x in (img0, img1, embt)]
    jloss = {dt: float(jax.jit(lambda p, a, b, e, t: JIF.IFRNet(scale="small", dtype=dt).apply(
        {"params": p}, a, b, e, imgt=t)["loss"])(params, *args, jnp.asarray(imgt)))
             for dt in (None, jnp.bfloat16)}
    with torch.no_grad():
        tloss = {net: net(nchw(img0), nchw(img1), torch.from_numpy(embt),
                          imgt=nchw(imgt))["loss"].item() for net in (net32, netbf)}
    port_d = abs(tloss[netbf] - tloss[net32])
    jax_d = abs(jloss[jnp.bfloat16] - jloss[None])
    assert np.isfinite(tloss[netbf]) and port_d <= 1.5 * jax_d + 1e-3 * abs(tloss[net32]), (
        tloss, jloss)


def test_ifrnet_image_warps_train_the_flows():
    """The image warps' grid gradient reaches the flow decoder: with the
    loss on the prediction only, decoder1's last conv (the full-resolution
    flows) gets a nonzero gradient, and only_flow outputs are unchanged by
    passing imgt."""
    net, _ = _port_and_jax_ifrnet("tiny", seed=3)
    img0, imgt, img1 = (nchw(smooth(1, 32, 64)) for _ in range(3))
    embt = torch.full((1, 1, 1, 1), 0.5)
    out = net(img0, img1, embt, imgt=imgt)
    torch.mean((out["imgt_pred"] - imgt) ** 2).backward()
    assert net.decoder1.convblock[2].weight.grad.abs().max() > 0
    with torch.no_grad():
        a = net(img0, img1, embt, only_flow=True)
        b = net(img0, img1, embt, imgt=imgt, only_flow=True)
    assert set(b) == {"flow0", "flow1", "mask"}
    for k in a:
        assert torch.equal(a[k], b[k])


# ------------------------------------------------------------------ step

def test_vfi_step_matches_jax():
    kw = dict(height=64, width=96, vfi_scale="tiny", compute_dtype="float32",
              lr_sche_type="cos", learning_rate=1e-4, eta_min=1e-5, num_epochs=2)
    state = TVS.create_vfi_state(Options(**kw), seed=0, steps_per_epoch=5, device="cpu")
    params = jconvert.convert_ifrnet(
        {k: v.numpy() for k, v in state.module.state_dict().items()})["params"]
    module = JIF.IFRNet(scale="tiny")
    tx = jmake_optimizer(JOptions(**kw), 5)
    jstate = JV.VFITrainState(step=jnp.zeros((), jnp.int32), params=params,
                              opt_state=tx.init(params))
    batch = {"img0": smooth(2, 64, 96), "img1": smooth(2, 64, 96), "img2": smooth(2, 64, 96),
             "embt": np.full((2,), 0.5, np.float32)}
    jstate, jm, jaux = jax.jit(JV.make_vfi_train_step(module, tx))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    metrics, aux = TVS.make_vfi_train_step(5.0)(state, batch)
    for k in ("loss", "psnr", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(nhwc(aux["imgt_pred"]), np.asarray(jaux["imgt_pred"]),
                               atol=2e-4)
    assert state.step == int(jstate.step) == 1
    # the first AdamW step moves a weight by lr * g / (|g| + 1e-8) (+ the
    # decay): where |g| >= 1e-5 the two gradients' ~1e-6 relative difference
    # moves that by far less than 1e-6; where g is near 0 its direction is
    # a matter of rounding, and the move is only bounded by lr
    ref = convert.ifrnet(jax.tree.map(np.asarray, jstate.params))
    lr = 1e-4
    for k, p in state.module.named_parameters():
        got, want = p.detach().numpy(), ref[k].numpy()
        firm = np.abs(p.grad.numpy()) >= 1e-5
        np.testing.assert_allclose(got[firm], want[firm], atol=1e-6, err_msg=k)
        assert np.abs(got - want).max() <= 2 * lr, k


# ------------------------------------------------------------------ data

def _write_png(path, h, w, rng):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path)


@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    """Frames 0..9 of one drive at 100x300 (the VFI datasets upscale them)
    and a train split of the 8 lines with both neighbours."""
    root = tmp_path_factory.mktemp("kitti_vfi")
    rng = np.random.default_rng(0)
    for i in range(10):
        _write_png(root / "kitti" / DRIVE / "image_02" / "data" / f"{i:010d}.png", 100, 300,
                   rng)
    split = root / "splits" / "kitti" / "tiny"
    split.mkdir(parents=True)
    lines = [f"{DRIVE} {i} l" for i in range(1, 9)]
    (split / "train_files.txt").write_text("\n".join(lines))
    (split / "test_files.txt").write_text("\n".join(lines[:2]))
    return root


def _assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("is_train", [True, False])
def test_kitti_vfi_items_match_jax(kitti_tree, is_train):
    files = (kitti_tree / "splits/kitti/tiny/train_files.txt").read_text().splitlines()
    args = (str(kitti_tree / "kitti"), files, 170, 600)
    ours = KITTIVFIDataset(*args, is_train=is_train, seed=7)
    ref = JKITTIVFI(*args, is_train=is_train, seed=7)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(files)):
            _assert_items_equal(ours[i], ref[i])
    assert ours[0]["img0"].shape == ((160, 576, 3) if is_train else (170, 600, 3))


def test_cityscapes_vfi_items_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    files = []
    for i in range(4):
        _write_png(tmp_path / "aachen" / f"aachen_{i:06d}.png", 3 * 90, 250, rng)
        files.append(f"aachen aachen_{i:06d}")
    args = (str(tmp_path), files, 192, 512)
    ours = CityscapesVFIDataset(*args, is_train=True, seed=3)
    ref = JCSVFI(*args, is_train=True, seed=3)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(files)):
            _assert_items_equal(ours[i], ref[i])
    assert ours[0]["img1"].shape == (176, 480, 3)


def test_flow_to_color_matches_jax():
    flow = (RNG.standard_normal((40, 56, 2)) * 5).astype(np.float32)
    np.testing.assert_array_equal(flow_to_color(flow), jflow_to_color(flow))
    np.testing.assert_array_equal(flow_to_color(flow, clip_flow=3.0),
                                  jflow_to_color(flow, clip_flow=3.0))


# ------------------------------------------------------------------ driver

def _vfi_argv(tree, log_dir, *extra):
    return ["-c", str(ROOT / "configs/vfi/IFRNet_S_KITTI.txt"), "--device", "cpu",
            "--data_path", str(tree / "kitti"), "--log_dir", str(log_dir), "--split", "tiny",
            "--batch_size", "2", "--vfi_scale", "tiny", "--compute_dtype", "float32",
            "--num_workers", "2", "--pretrained_path", "", "--resume", "False", *extra]


@pytest.fixture
def vfi_splits(kitti_tree, monkeypatch):
    monkeypatch.setattr(TV, "SPLITS_DIR", str(kitti_tree / "splits"))
    monkeypatch.setattr(T, "SPLITS_DIR", str(kitti_tree / "splits"))
    return kitti_tree


def test_train_vfi_resumes_mid_epoch(vfi_splits, tmp_path):
    """A 4-step epoch with a checkpoint after step 3; a trainer resumed from
    it takes step 4 with the uninterrupted run's loss and weights."""
    from mono_vifi_tpu_torch.config import parse_options

    cfg = parse_options(_vfi_argv(vfi_splits, tmp_path, "--num_epochs", "2",
                                  "--save_frequency", "2", "--log_frequency", "1"))
    a = TV.VFITrainer(cfg)
    a.run_epoch(0)
    a.close()
    mid = torch.load(a.ckpt_path, map_location="cpu", weights_only=True)
    assert (mid["epoch"], mid["batch_idx"], mid["step_in_total"]) == (0, 3, 3)
    assert (mid["vfi_scale"], mid["height"], mid["width"]) == ("tiny", 192, 640)
    assert sorted(os.listdir(os.path.join(a.log_path, "visuals"))) == [
        f"step_{s}.jpeg" for s in (1, 2, 3, 4)]

    cfg.resume = True
    b = TV.VFITrainer(cfg)
    assert (b.ep_start, b.batch_start, b.state.step) == (0, 3, 3)
    b.run_epoch(0)
    b.close()
    assert [h["batch"] for h in b.history] == [3]
    np.testing.assert_allclose(b.history[0]["loss"], a.history[3]["loss"], rtol=1e-6)
    for (k, v), w in zip(b.state.module.state_dict().items(),
                         a.state.module.state_dict().values()):
        np.testing.assert_allclose(v.numpy(), w.numpy(), rtol=1e-6, atol=1e-9, err_msg=k)


def _depth_trainer_vfi(tree, log_dir, weights_dir):
    """The depth Trainer (64x96, small VFI in both roles) with
    weights_dir -> its frozen VFIs' state_dicts."""
    cfg = Options(exp_name="depth", data_path=str(tree / "kitti"), log_dir=str(log_dir),
                  split="tiny", eval_split="tiny", height=64, width=96, batch_size=2,
                  compute_dtype="float32", vfi_train_scale="small", vfi_test_scale="small",
                  weights_dir=str(weights_dir), num_workers=1, weights_init="scratch",
                  device="cpu")
    trainer = T.Trainer(cfg)
    trainer.close()
    return [trainer.bundle.vfi_train.state_dict(), trainer.bundle.vfi_test.state_dict()]


def test_train_vfi_checkpoint_is_the_depth_trainers_frozen_vfi(vfi_splits, tmp_path):
    """`python -m mono_vifi_tpu_torch.train_vfi` from IFRNet_S_KITTI.txt: an
    epoch, its checkpoint; the depth Trainer takes that checkpoint, copied
    to weights_dir, as both frozen VFIs, weight for weight."""
    TV.main(_vfi_argv(vfi_splits, tmp_path / "logs", "--vfi_scale", "small",
                      "--num_epochs", "1", "--log_frequency", "2", "--save_frequency", "100"))
    ckpt = tmp_path / "logs" / "IFRNet_S_KITTI" / "ckpt.pth"
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    assert (saved["epoch"], saved["batch_idx"], saved["step_in_total"]) == (1, 0, 4)
    weights = tmp_path / "weights"
    weights.mkdir()
    shutil.copy(ckpt, weights / "IFRNet_S_KITTI.pth")
    for sd in _depth_trainer_vfi(vfi_splits, tmp_path / "depth", weights):
        for k, v in saved["VFI"].items():
            assert torch.equal(sd[k], v), k


def test_jax_train_vfi_ckpt_pkl_is_a_frozen_vfi(vfi_splits, tmp_path):
    """A `ckpt.pkl` that the JAX package's VFITrainer.save_model writes
    (optax state included) loads through the restricted unpickler: as the
    depth Trainer's frozen VFI and as the VFI trainer's pretrained weights;
    the unpickler still refuses other globals."""
    import pickle
    import types

    import train_vfi as JTV

    # the JAX trainer's state after 3 steps, without its data and mesh:
    # IFRNet-S weights and the optax AdamW + clip state over them
    jcfg = JOptions(height=64, width=96, vfi_scale="small", compute_dtype="float32")
    torch.manual_seed(5)
    params = jconvert.convert_ifrnet(
        {k: v.numpy() for k, v in TIF.IFRNet("small").state_dict().items()})["params"]
    state = JV.VFITrainState(step=jnp.asarray(3, jnp.int32), params=params,
                             opt_state=jmake_optimizer(jcfg, 4).init(params))
    pkl = tmp_path / "ckpt.pkl"
    JTV.VFITrainer.save_model(types.SimpleNamespace(
        is_chief=True, cfg=jcfg, state=state, _ckpt_path=lambda: str(pkl)), 0, batch_idx=2)
    assert b"optax" in pkl.read_bytes()
    ref = convert.ifrnet(jax.tree.map(np.asarray, params))
    weights = tmp_path / "weights"
    weights.mkdir()
    shutil.copy(pkl, weights / "IFRNet_S_KITTI.pkl")
    for sd in _depth_trainer_vfi(vfi_splits, tmp_path / "depth", weights):
        for k, v in ref.items():
            assert torch.equal(sd[k], v), k

    from mono_vifi_tpu_torch.config import parse_options

    vt = TV.VFITrainer(parse_options(_vfi_argv(vfi_splits, tmp_path / "logs", "--vfi_scale",
                                               "small", "--pretrained_path", str(pkl))))
    vt.close()
    for k, v in vt.state.module.state_dict().items():
        assert torch.equal(v, ref[k]), k

    bad = tmp_path / "bad.pkl"
    bad.write_bytes(pickle.dumps({"params": {}, "x": pathlib.PurePosixPath("a")}))
    with pytest.raises(pickle.UnpicklingError, match="pathlib"):
        ckpt_lib.load_weights_pkl(str(bad))
