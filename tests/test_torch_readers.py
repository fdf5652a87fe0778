"""The port's NYUv2 and Make3D readers against the JAX package's, on the
CPU, on synthetic files written to tmp_path: NYUv2 `.h5` test samples and
undistorted training items, Make3D JPEG + `.mat` samples; then
`evaluate_depth --nyuv2_path / --make3d_path` against the root JAX script,
and the port trainer's NYUv2 training and per-epoch evaluation.

Items are compared exactly (the same PIL, cv2 and scipy calls). The
evaluation's metrics rtol 1e-4: both sides evaluate the same weights (the
port from a reference `.pth`, the JAX script through the JAX package's
converter, since its own `load_model` initializes the whole training bundle
op by op, about a minute on a CPU) and their disparities differ by ~1e-6.
The trainer's NYUv2 metrics equal, to rtol 1e-6, the JAX package's NYUv2
protocol over the port's predictions on the same samples.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import evaluate_depth as JED
from mono_vifi_tpu import convert as jconvert
from mono_vifi_tpu import evaluation as JE
from mono_vifi_tpu.config import Options as JOptions
from mono_vifi_tpu.data.make3d import Make3DDataset as JMake3D
from mono_vifi_tpu.data.nyuv2 import NYUDataset as JNYU
from mono_vifi_tpu.training import monovifi as JM
from mono_vifi_tpu_torch import evaluate_depth as ED
from mono_vifi_tpu_torch import evaluation as TE
from mono_vifi_tpu_torch import train as T
from mono_vifi_tpu_torch.config import Options
from mono_vifi_tpu_torch.data import Make3DDataset, NYUDataset
from mono_vifi_tpu_torch.training import checkpoint as ckpt_lib
from mono_vifi_tpu_torch.training.factory import build_bundle

H, W = 64, 96
MAKE3D_LINES = ["060705-17.10.14-p-049t000", "060705-17.10.14-p-080t000"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads, as the other heavy files of the suite."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _smooth_rgb(rng, h, w):
    """A smooth colour field plus a little noise (compresses, and survives
    the readers' resizes as structure rather than noise)."""
    ys, xs = np.mgrid[0:h, 0:w] / 40.0
    ph = rng.uniform(0, 2 * np.pi, 3)
    img = np.stack([127 + 90 * np.sin(xs + p) * np.cos(ys - p) for p in ph], -1)
    return (img + rng.integers(0, 20, (h, w, 3))).clip(0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def nyu_tree(tmp_path_factory):
    """NYUv2: 3 `.h5` test samples (480x640 rgb, depth in (0, 12)), 11 PNG
    training frames at 480x640 and 2 training lines of 9 paths each (centre,
    then -4..-1, 1..4); split files under splits/nyuv2."""
    import h5py

    root = tmp_path_factory.mktemp("nyu")
    rng = np.random.default_rng(3)
    test = []
    for i in range(3):
        name = f"val/official/{i:05d}.h5"
        (root / name).parent.mkdir(parents=True, exist_ok=True)
        with h5py.File(root / name, "w") as f:
            f["rgb"] = _smooth_rgb(rng, 480, 640).transpose(2, 0, 1)
            f["depth"] = rng.uniform(0.0, 12.0, (480, 640)).astype(np.float32)
        test.append(name)
    frames = root / "train" / "kitchen_0001"
    frames.mkdir(parents=True)
    for i in range(11):
        Image.fromarray(_smooth_rgb(rng, 480, 640)).save(frames / f"r-{i:03d}.png")
    train = [" ".join(f"train/kitchen_0001/r-{c + o:03d}.png"
                      for o in (0, -4, -3, -2, -1, 1, 2, 3, 4)) for c in (4, 6)]
    splits = root / "splits" / "nyuv2"
    splits.mkdir(parents=True)
    (splits / "test_files.txt").write_text("\n".join(test))
    (splits / "train_files.txt").write_text("\n".join(train))
    return root


@pytest.fixture(scope="module")
def make3d_tree(tmp_path_factory):
    """Make3D: Test134 JPEGs at 1704x2272 and Gridlaserdata `.mat` grids
    (55, 305, 4), depth in (0, 80)."""
    from scipy.io import savemat

    root = tmp_path_factory.mktemp("make3d")
    rng = np.random.default_rng(4)
    (root / "Test134").mkdir()
    (root / "Gridlaserdata").mkdir()
    for line in MAKE3D_LINES:
        Image.fromarray(_smooth_rgb(rng, 2272, 1704)).save(root / "Test134" / f"img-{line}.jpg")
        grid = rng.uniform(0.0, 80.0, (55, 305, 4)).astype(np.float64)
        savemat(root / "Gridlaserdata" / f"depth_sph_corr-{line}.mat", {"Position3DGrid": grid})
    return root


def _assert_items_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_nyuv2_test_items_match_jax(nyu_tree):
    files = (nyu_tree / "splits/nyuv2/test_files.txt").read_text().splitlines()
    ours = NYUDataset(str(nyu_tree), files, H, W, [0], 1)
    ref = JNYU(str(nyu_tree), files, H, W, [0], 1)
    np.testing.assert_array_equal(ours.K, ref.K)
    for i in range(len(files)):
        (rgb, depth), (jrgb, jdepth) = ours.load_test_item(i), ref.load_test_item(i)
        assert rgb.shape == (H, W, 3) and depth.shape == (427, 561)
        np.testing.assert_array_equal(rgb, jrgb)
        np.testing.assert_array_equal(depth, jdepth)


@pytest.mark.parametrize("use_affine", [False, True])
def test_nyuv2_training_items_match_jax(nyu_tree, use_affine):
    """Undistorted (cv2), cropped, resized and augmented training items,
    uint8-staged as the trainer asks, across two epochs."""
    files = (nyu_tree / "splits/nyuv2/train_files.txt").read_text().splitlines()
    kw = dict(use_affine=use_affine, is_train=True, seed=5, stage_uint8=True)
    ours = NYUDataset(str(nyu_tree), files, H, W, [0, -1, 1], 1, **kw)
    ref = JNYU(str(nyu_tree), files, H, W, [0, -1, 1], 1, **kw)
    np.testing.assert_array_equal(ours.K, ref.K)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(files)):
            _assert_items_equal(ours[i], ref[i])


def test_make3d_items_match_jax(make3d_tree):
    for res in (None, (H, W)):
        ours = Make3DDataset(str(make3d_tree), MAKE3D_LINES, res)
        ref = JMake3D(str(make3d_tree), MAKE3D_LINES, res)
        assert len(ours) == 2
        for i in range(2):
            _assert_items_equal(ours[i], ref[i])
        assert ours[0]["depth"].shape == (21, 305)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """-> (reference `.pth` of a seeded evaluation bundle, the JAX bundle,
    params and batch_stats of the same weights)."""
    cfg = Options(height=H, width=W, compute_dtype="float32")
    src = build_bundle(cfg, 21, "cpu", for_training=False)
    rng = np.random.default_rng(8)
    for m in src.modules():
        if hasattr(m, "running_mean"):
            m.running_mean.copy_(torch.from_numpy(
                (0.1 * rng.standard_normal(m.running_mean.shape)).astype(np.float32)))
            m.running_var.copy_(torch.from_numpy(
                rng.uniform(0.5, 1.5, m.running_var.shape).astype(np.float32)))
    path = tmp_path_factory.mktemp("w") / "model_0.pth"
    ckpt_lib.save_weights(str(path), src, cfg)

    def sd(m):
        return {k: v.numpy() for k, v in m.state_dict().items()}

    enc = jconvert.convert_depth_encoder(sd(src.encoder), 18)
    params = {"encoder": enc["params"],
              "depth": jconvert.convert_depth_decoder(sd(src.depth))["params"]}
    jb = JM.ModelBundle(JOptions(height=H, width=W, compute_dtype="float32",
                                 vfi_train_scale="tiny", weights_init="scratch"))
    return str(path), (jb, params, {"encoder": enc["batch_stats"]})


def _recording(module, name, store, monkeypatch):
    fn = getattr(module, name)

    def record(*args, **kwargs):
        store[name] = fn(*args, **kwargs)
        return store[name]

    monkeypatch.setattr(module, name, record)


def test_evaluate_depth_nyuv2_and_make3d_match_jax(nyu_tree, make3d_tree, weights,
                                                   monkeypatch, tmp_path):
    """`evaluate_depth --nyuv2_path --make3d_path` (with and without flip
    post-processing) reports the JAX script's metrics."""
    splits = tmp_path / "splits"
    (splits / "make3d").mkdir(parents=True)
    (splits / "make3d" / "test_files.txt").write_text("\n".join(MAKE3D_LINES))
    (splits / "nyuv2").mkdir()
    (splits / "nyuv2" / "test_files.txt").write_text(
        (nyu_tree / "splits/nyuv2/test_files.txt").read_text())
    monkeypatch.setattr(ED, "SPLITS_DIR", str(splits))
    monkeypatch.setattr(JED, "SPLITS_DIR", str(splits))
    path, jax_model = weights
    monkeypatch.setattr(JED, "load_model", lambda args: jax_model)
    got, ref = {}, {}
    for name in ("evaluate_nyuv2", "evaluate_make3d"):
        _recording(TE, name, got, monkeypatch)
        _recording(JE, name, ref, monkeypatch)
    for extra in ([], ["--post_process"]):
        argv = ["--pretrained_path", path, "--height", str(H), "--width", str(W),
                "--nyuv2_path", str(nyu_tree), "--make3d_path", str(make3d_tree)] + extra
        JED.main(JED.eval_args(argv))
        ED.main(ED.eval_args(argv + ["--device", "cpu"]))
        for name in ("evaluate_nyuv2", "evaluate_make3d"):
            assert got[name].keys() == ref[name].keys()
            for k in ref[name]:
                np.testing.assert_allclose(got[name][k], ref[name][k], rtol=1e-4,
                                           err_msg=f"{name} {k} {extra}")
        got.clear()
        ref.clear()


def test_trainer_trains_and_evaluates_on_nyuv2(nyu_tree, monkeypatch, tmp_path):
    """dataset=nyuv2: an epoch of the training step on undistorted NYUv2
    items, then the per-epoch NYUv2 evaluation, equal to the JAX package's
    protocol over the port's predictions on the `.h5` samples."""
    monkeypatch.setattr(T, "SPLITS_DIR", str(nyu_tree / "splits"))
    cfg = Options(exp_name="nyu", dataset="nyuv2", data_path=str(nyu_tree),
                  log_dir=str(tmp_path), height=H, width=W, batch_size=2,
                  compute_dtype="float32", vfi_train_scale="tiny", vfi_test_scale="tiny",
                  num_workers=1, weights_init="scratch", num_epochs=1, log_frequency=1,
                  device="cpu")
    trainer = T.Trainer(cfg)
    trainer.train()
    trainer.close()
    assert len(trainer.history) == 1 and np.isfinite(trainer.history[0]["loss"])
    res = trainer.eval_results[0, "nyuv2"]
    ds = trainer.test_dataset
    items = [ds.load_test_item(i) for i in range(len(ds))]
    args = ED.eval_args(["--device", "cpu"])
    pred = ED.predict_disps(args, trainer.bundle, (rgb[None] for rgb, _ in items))
    ref = JE.evaluate_nyuv2(pred, [d for _, d in items], printer=lambda *a: None)
    assert res.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(res[k], ref[k], rtol=1e-6, err_msg=k)
