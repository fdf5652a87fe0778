"""The port's inference path against the JAX package's, on the CPU: the
single- and multi-frame eval forwards and the entry modules' predict
functions (64x96, batch 2, f32, IFRNet-S), checkpoint loading (reference
`.pth` and the JAX package's weight-only `.pkl`), and the entry modules'
refusal to run without a card.

Weights: a seeded random port bundle with BatchNorm running statistics
drawn from a numpy seed (so that eval-mode normalization is not the
identity), carried into Flax trees by the JAX package's converter and from
those into the port's bundles by `convert.load_into_bundle`.

Tolerances (f32, CPU). Single-frame disparities atol 2e-4, as
tests/test_eval_e2e_parity.py (XLA and PyTorch convolutions sum in another
order). Multi-frame disparities atol 2e-4: the flows of the two IFRNets
agree to ~1e-4 pixels, and the fusion warp (the port: the table sample's
plain version; JAX on the CPU: its plain XLA warp, `fast_warp` being off
off-TPU) turns that into feature differences of the same order, which the
decoder's sigmoid does not amplify. Loading is compared by the
disparities it gives (atol 2e-4), and port to port exactly.
"""

import argparse
import pickle

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import evaluate_depth as JED
from mono_vifi_tpu import convert as jconvert
from mono_vifi_tpu.config import Options as JOptions
from mono_vifi_tpu.ops.geometry import disp_to_depth as jdisp_to_depth
from mono_vifi_tpu.training import checkpoint as jckpt
from mono_vifi_tpu.training import monovifi as JM
from mono_vifi_tpu_torch import convert
from mono_vifi_tpu_torch import evaluate_depth as ED
from mono_vifi_tpu_torch import evaluate_depth_mf as EDM
from mono_vifi_tpu_torch.config import Options
from mono_vifi_tpu_torch.training import checkpoint as ckpt_lib
from mono_vifi_tpu_torch.training import monovifi as TM
from mono_vifi_tpu_torch.training.factory import build_bundle

B, H, W = 2, 64, 96
KW = dict(height=H, width=W, compute_dtype="float32", vfi_test_scale="small")
ATOL = 2e-4


def _sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def jax_weights():
    """(JAX bundle, params, batch_stats, small-VFI params) as numpy trees,
    made from a seeded port bundle (BatchNorm running statistics drawn with
    numpy) by the JAX package's own torch -> Flax converter."""
    src = build_bundle(Options(**KW), 11, "cpu", for_training=False)
    rng = np.random.default_rng(8)
    for m in src.modules():
        if hasattr(m, "running_mean"):
            m.running_mean.copy_(torch.from_numpy(
                (0.1 * rng.standard_normal(m.running_mean.shape)).astype(np.float32)))
            m.running_var.copy_(torch.from_numpy(
                rng.uniform(0.5, 1.5, m.running_var.shape).astype(np.float32)))
    enc = jconvert.convert_depth_encoder(_sd(src.encoder), 18)
    params = {"encoder": enc["params"],
              "depth": jconvert.convert_depth_decoder(_sd(src.depth))["params"],
              "depth_mf": jconvert.convert_depth_decoder(_sd(src.depth_mf))["params"],
              "fusion_module": jconvert.convert_fusion_module(_sd(src.fusion_module))["params"]}
    vfi = jconvert.convert_ifrnet(_sd(src.vfi_test))["params"]
    jb = JM.ModelBundle(JOptions(**KW, weights_init="scratch", vfi_train_scale="tiny"))
    return jb, params, {"encoder": enc["batch_stats"]}, vfi


def _port_bundle(jax_weights, seed=0):
    """A port bundle of other random weights, then the JAX weights loaded
    into it by convert.load_into_bundle."""
    _, params, bstats, vfi = jax_weights
    b = build_bundle(Options(**KW), seed, "cpu", for_training=False)
    convert.load_into_bundle(b, params, bstats, vfi_test_params=vfi)
    return b


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(6)
    return [rng.random((B, H, W, 3), np.float32) for _ in range(3)]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _args(post_process=False):
    return argparse.Namespace(post_process=post_process, min_depth=0.1, max_depth=100.0)


@pytest.mark.parametrize("post_process", [False, True])
def test_single_frame_predictions_match_jax(jax_weights, frames, post_process):
    """single_frame_disp, then the entry module's predict_disps (flip
    post-processing and scaling) against the JAX entry's, same weights."""
    jb, params, bstats, _ = jax_weights
    b = _port_bundle(jax_weights)
    ref = np.asarray(jax.jit(lambda x: JM.single_frame_disp(jb, params, bstats, x))(
        jnp.asarray(frames[0])))
    got = TM.single_frame_disp(b, _nchw(frames[0]))
    assert got.dtype == torch.float32 and got.shape == (B, 1, H, W)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=ATOL)

    args = _args(post_process)
    ref = JED.predict_disps(args, jb, params, bstats, iter(frames[:2]))
    got = ED.predict_disps(args, b, iter(frames[:2]))
    assert got.shape == ref.shape == (2 * B, H, W)
    np.testing.assert_allclose(got, ref, atol=ATOL * 10)  # scaled disparity: x10 range


def test_multi_frame_predictions_match_jax(jax_weights, frames):
    """multi_frame_disp (small VFI flows, one encoder pass, table-path
    fusion, depth_mf) and predict_disps_mf against the JAX package."""
    jb, params, bstats, vfi = jax_weights
    b = _port_bundle(jax_weights)
    ref = np.asarray(jax.jit(lambda *x: JM.multi_frame_disp(jb, params, bstats, vfi, *x))(
        *(jnp.asarray(f) for f in frames)))
    got = TM.multi_frame_disp(b, *(_nchw(f) for f in frames))
    assert got.dtype == torch.float32 and got.shape == (B, 1, H, W)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=ATOL)

    batch = dict(zip(("color_n1", "color_0", "color_p1"), frames))
    u8 = {k: (v * 255).astype(np.uint8) for k, v in batch.items()}
    f32 = {k: v.astype(np.float32) / 255.0 for k, v in u8.items()}
    p_u8 = EDM.predict_disps_mf(_args(), b, [u8])
    p_f32 = EDM.predict_disps_mf(_args(), b, [f32])
    np.testing.assert_array_equal(p_u8, p_f32)  # uint8 frames are dequantized exactly
    scaled_ref = np.asarray(jdisp_to_depth(jnp.asarray(ref), 0.1, 100.0)[0])[..., 0]
    np.testing.assert_allclose(EDM.predict_disps_mf(_args(), b, [batch]), scaled_ref,
                               atol=ATOL * 10)  # scaled disparity: x10 range


def test_reference_pth_loads_like_jax(tmp_path, jax_weights, frames):
    """A reference-keyed `.pth` written from a port bundle's roles: loaded by
    the port (into a bundle of other weights) it reproduces the writer's
    disparities exactly; loaded by the JAX package it gives the same
    disparities within ATOL. With multi_frame the multi-frame roles take the
    encoder and decoder slots (evaluate_depth_mf.py:59-71)."""
    src = _port_bundle(jax_weights)
    other = build_bundle(Options(**KW), 7, "cpu", for_training=False)
    path = str(tmp_path / "ref.pth")
    torch.save({"encoder": src.encoder.state_dict(), "depth": src.depth.state_dict(),
                "depth_mf": src.depth_mf.state_dict(),
                "fusion_module": src.fusion_module.state_dict(),
                "encoder_mf": other.encoder.state_dict(), "height": H, "width": W}, path)
    dst = build_bundle(Options(**KW), 5, "cpu", for_training=False)
    assert ckpt_lib.load_reference_pth(path, dst) == []
    x = _nchw(frames[1])
    want = TM.single_frame_disp(src, x)
    assert torch.equal(TM.single_frame_disp(dst, x), want)

    jb, params, bstats, _ = jax_weights
    loaded = jckpt.load_reference_pth(path, JOptions(**KW), 5)
    jp = jckpt.merge_params(params, loaded["params"])
    jbs = jckpt.merge_params(bstats, loaded["batch_stats"])
    ref = np.asarray(JM.single_frame_disp(jb, jp, jbs, jnp.asarray(frames[1])))
    np.testing.assert_allclose(want.permute(0, 2, 3, 1).numpy(), ref, atol=ATOL)

    mf = build_bundle(Options(**KW), 5, "cpu", for_training=False)
    ckpt_lib.load_reference_pth(path, mf, multi_frame=True)
    for k, v in other.encoder.state_dict().items():
        assert torch.equal(mf.encoder.state_dict()[k], v), k
    for k, v in src.depth_mf.state_dict().items():
        assert torch.equal(mf.depth.state_dict()[k], v), k


def test_jax_weight_snapshot_loads_like_jax(tmp_path, jax_weights, frames):
    """A JAX `save_weights` snapshot (numpy trees, batch_stats as an extra)
    through the restricted unpickler and the Flax -> port converter."""
    jb, params, bstats, vfi = jax_weights
    path = str(tmp_path / "model_0.pkl")
    jckpt.save_weights(path, params, JOptions(**KW), extra={"batch_stats": bstats})
    b = build_bundle(Options(**KW), 5, "cpu", for_training=False)
    assert ckpt_lib.load_jax_weights(path, b) == []
    ref = np.asarray(JM.single_frame_disp(jb, params, bstats, jnp.asarray(frames[2])))
    got = TM.single_frame_disp(b, _nchw(frames[2]))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=ATOL)

    # without batch_stats the running statistics keep their init values, named
    jckpt.save_weights(path, params, JOptions(**KW))
    kept = ckpt_lib.load_jax_weights(path, b)
    assert kept and all("running_" in k or "num_batches" in k for k in kept)


def test_weight_snapshot_unpickler_refuses_other_globals(tmp_path):
    path = tmp_path / "bad.pkl"
    path.write_bytes(pickle.dumps({"params": {}, "x": argparse.Namespace(a=1)}))
    with pytest.raises(pickle.UnpicklingError, match="argparse.Namespace"):
        ckpt_lib.load_weights_pkl(str(path))


def test_entry_points_refuse_to_run_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = ["--height", str(H), "--width", str(W)]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ED.main(ED.eval_args(small))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EDM.main(EDM.eval_args(small + ["--kitti_path", str(tmp_path)]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_bundle(Options(**KW), for_training=False)
    # --make3d_path reads the Make3D split's files (none here)
    with pytest.raises(FileNotFoundError, match="Test134"):
        ED.main(ED.eval_args(small + ["--device", "cpu", "--make3d_path", str(tmp_path)]))
    ED.main(ED.eval_args(small + ["--device", "cpu"]))  # builds, reports, evaluates nothing
    EDM.main(EDM.eval_args(small + ["--device", "cpu"]))
