"""The port's models against the JAX package's Flax models on the same
weights: the port's random weights are carried into Flax by the JAX
package's own torch -> Flax converter (mono_vifi_tpu/convert.py), which
also pins the port's state_dict keys to the reference schema. CPU, f32,
atol 2e-4 as tests/test_models.py (poses 1e-6, BatchNorm statistics 1e-5).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mono_vifi_tpu import convert as jconvert
from mono_vifi_tpu.models import fusion as JF
from mono_vifi_tpu.models import ifrnet as JIF
from mono_vifi_tpu.models import monodepth2 as JMD
from mono_vifi_tpu.models import posenet as JP
from mono_vifi_tpu_torch import convert
from mono_vifi_tpu_torch.models import fusion as TF
from mono_vifi_tpu_torch.models import ifrnet as TIF
from mono_vifi_tpu_torch.models import monodepth2 as TMD
from mono_vifi_tpu_torch.models import posenet as TP

RNG = np.random.default_rng(41)


def rand(*shape, lo=0.0, hi=1.0):
    return (lo + (hi - lo) * RNG.random(shape)).astype(np.float32)


def nchw(x):
    return torch.from_numpy(np.array(np.moveaxis(x, -1, 1), copy=True))


def nhwc(x):
    return np.moveaxis(x.detach().numpy(), 1, -1)


def sd_np(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def seeded(cls, *args, seed=0, **kwargs):
    torch.manual_seed(seed)
    return cls(*args, **kwargs)


@pytest.fixture(scope="module")
def encoder():
    return seeded(TMD.DepthEncoder, 18)


def test_depth_encoder_eval(encoder):
    x = rand(2, 64, 96, 3)
    v = jconvert.convert_depth_encoder(sd_np(encoder), 18)
    ref = JMD.DepthEncoder(18).apply(v, jnp.asarray(x), train=False)
    encoder.eval()
    with torch.no_grad():
        got = encoder(nchw(x))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(nhwc(g), np.asarray(r), atol=2e-4)


def test_depth_encoder_train_batchnorm(encoder):
    """Train mode: batch-statistics normalization, and running statistics
    moved by the JAX package's rule (momentum 0.9, biased variance)."""
    x = rand(3, 64, 96, 3)
    enc = seeded(TMD.DepthEncoder, 18, seed=1)
    v = jconvert.convert_depth_encoder(sd_np(enc), 18)
    ref, mut = JMD.DepthEncoder(18).apply(v, jnp.asarray(x), train=True,
                                          mutable=["batch_stats"])
    enc.train()
    with torch.no_grad():
        got = enc(nchw(x))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(nhwc(g), np.asarray(r), atol=2e-4)
    new = convert.depth_encoder(jax.tree.map(np.asarray, v["params"]),
                                jax.tree.map(np.asarray, mut["batch_stats"]))
    sd = enc.state_dict()
    for k, r in new.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[k].numpy(), r.numpy(), atol=1e-5, err_msg=k)


def test_depth_decoder(encoder):
    feats = [rand(2, 64 // s, 96 // s, c) for s, c in
             zip((2, 4, 8, 16, 32), (64, 64, 128, 256, 512))]
    dec = seeded(TMD.DepthDecoder, scales=(0,))
    v = jconvert.convert_depth_decoder(sd_np(dec), scales=(0,))
    ref = JMD.DepthDecoder(scales=(0,)).apply(v, [jnp.asarray(f) for f in feats])
    with torch.no_grad():
        got = dec([nchw(f) for f in feats])
    np.testing.assert_allclose(nhwc(got[0]), np.asarray(ref[0]), atol=2e-4)


def test_pose_net():
    x = rand(2, 64, 96, 6)
    enc = seeded(TP.PoseEncoder, 18).eval()
    dec = seeded(TP.PoseDecoder, seed=1)
    ve = jconvert.convert_pose_encoder(sd_np(enc), 18)
    vd = jconvert.convert_pose_decoder(sd_np(dec))
    feats = JP.PoseEncoder(18).apply(ve, jnp.asarray(x), train=False)
    aa_r, tr_r = JP.PoseDecoder().apply(vd, feats[-1])
    with torch.no_grad():
        aa, tr = dec(enc(nchw(x))[-1])
    np.testing.assert_allclose(aa.numpy(), np.asarray(aa_r), atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(tr_r), atol=1e-6)


@pytest.mark.parametrize("scale,size,batch", [
    pytest.param(s, (64, 96), 2, id=s) for s in ("tiny", "small", "large")
] + [pytest.param("tiny", (320, 1024), 1, id="tiny-320x1024")])
def test_ifrnet(scale, size, batch):
    """At 320x1024 (the HR configs' frozen VFI) the flow network runs at the
    (0.6, 0.3125) downscale; that case draws its frames from a generator of
    its own, so the module's draws for the other tests stay as they were."""
    if size == (64, 96):
        img0, img1 = rand(batch, *size, 3), rand(batch, *size, 3)
    else:
        g = np.random.default_rng(43)
        img0, img1 = (g.random((batch, *size, 3)).astype(np.float32) for _ in range(2))
    net = seeded(TIF.IFRNet, scale)
    v = jconvert.convert_ifrnet(sd_np(net))
    embt = np.full((batch, 1, 1, 1), 0.5, np.float32)
    jnet = JIF.IFRNet(scale=scale)
    ref = jnet.apply(v, jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(embt))
    ref_f = jnet.apply(v, jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(embt),
                       only_flow=True)
    with torch.no_grad():
        got = net(nchw(img0), nchw(img1), torch.from_numpy(embt))
        got_f = net(nchw(img0), nchw(img1), torch.from_numpy(embt), only_flow=True)
    for k in ("flow0", "flow1", "mask", "imgt_pred"):
        np.testing.assert_allclose(nhwc(got[k]), np.asarray(ref[k]), atol=2e-4, err_msg=k)
    assert set(got_f) == {"flow0", "flow1", "mask"}
    for k in got_f:
        np.testing.assert_allclose(nhwc(got_f[k]), np.asarray(ref_f[k]), atol=2e-4, err_msg=k)


def test_ifrnet_scale_factor():
    assert TIF.resolve_scale_factor(320, 1024) == JIF._resolve_scale_factor(320, 1024)
    assert TIF.resolve_scale_factor(192, 640) == JIF._resolve_scale_factor(192, 640)


@pytest.mark.parametrize("layout", ["training", "inference"])
def test_fusion_module(layout):
    """The unique-table path equals the JAX package's FusionModule on the
    concatenated neighbour pyramids, in both callers' table layouts: the
    training step's (3 unique pyramids, 6 warp uses through the frozen-grid
    Function) and the multi-frame inference's (the 3B stack itself, uses
    0..B-1 and 2B..3B-1)."""
    B, H, W = 2, 64, 64
    chans = (64, 64, 128, 256, 512)
    uniq = [[rand(B, H // s, W // s, c) for s, c in zip((2, 4, 8, 16, 32), chans)]
            for _ in range(3)]  # training: f0, fn1, fp1; inference: n1, 0, p1
    if layout == "training":
        uses = (1, 1, 0, 2, 0, 2)  # prev: fn1, fn1, f0; next: fp1, f0, fp1
        prev = [np.concatenate([uniq[u][i] for u in uses[:3]], 0) for i in range(5)]
        nxt = [np.concatenate([uniq[u][i] for u in uses[3:]], 0) for i in range(5)]
        center = [np.concatenate([uniq[0][i]] * 3, 0) for i in range(5)]
    else:
        uses = (0, 2)
        prev, center, nxt = uniq
    n = len(uses) // 2 * B
    fl_n1 = rand(n, H, W, 2, lo=-2, hi=2)
    fl_p1 = rand(n, H, W, 2, lo=-2, hi=2)
    mask = rand(n, H, W, 1)
    fus = seeded(TF.FusionModule, chans)
    v = jconvert.convert_fusion_module(sd_np(fus), num_levels=5)
    ref = JF.FusionModule(num_ch_enc=chans).apply(
        v, [[jnp.asarray(f) for f in p] for p in (prev, center, nxt)],
        (jnp.asarray(fl_n1), jnp.asarray(fl_p1)), jnp.asarray(mask),
    )
    unique = [torch.cat([nchw(uniq[u][i]) for u in range(3)], 0) for i in range(5)]
    ids = torch.tensor([u * B + j for u in uses for j in range(B)], dtype=torch.int32)
    with torch.no_grad():
        got = fus([nchw(f) for f in center], (nchw(fl_n1), nchw(fl_p1)), nchw(mask),
                  (unique, ids))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(nhwc(g), np.asarray(r), atol=2e-4)


def test_embed_flow():
    x = rand(2, 8, 12, 2, lo=-3, hi=3)
    np.testing.assert_allclose(nhwc(TF.embed_flow(nchw(x))), np.asarray(JF.embed_flow(jnp.asarray(x))),
                               atol=1e-5)
