"""The frozen reference against the port's plain path at a tiny size on the
CPU (f32), and its FLOP count against the port's own count."""

from __future__ import annotations

import hashlib
import types

import pytest
import torch

from perfbench import registry, weights
from perfbench.counts import flops
from perfbench.drivers import train, video
from perfbench.reference.config import Config
from perfbench.reference.training import factory as ref_factory
from perfbench.reference.training import monovifi as ref_step

OPTS = {"height": 64, "width": 96, "batch_size": 2, "use_affine": True,
        "fuse_model_type": "shared_encoder", "vfi_train_scale": "tiny",
        "vfi_test_scale": "tiny", "compute_dtype": "float32"}


# sha256 of each cell's `initial_weights` on the CPU at seed 2**31 + 977 (every
# tensor's name, then its bytes, in draw order), as drawn before the weight
# rules were declared by module: the rules may move, the draws may not
DRAW_DIGESTS = {
    "resnet18_kitti_mr.train_mem": "d24a6cdf706c8b76a2a8a27d524e4f4fa362a98cc851888295d99bad93f8ffde",
    "dhrnet_kitti_mr.train_mem": "b208405ee83e84299795ba0b89cb692f4e2248fea74cecebb50efedc25c58b89",
    "resnet18_kitti_mr.video_b1": "56666554288bffae295e48dfe6ee611005274e2beb76fe99c25a8bdc2a5454bf",
    "ifrnet_l_kitti.train_vfi": "242a48cd8a80ec653cdc7650beeb3bd424ca9dd287261a8b7ee44943eed2c164",
}


def port_bundle(opts, for_training=True):
    from mono_vifi_tpu_torch.config import Options
    from mono_vifi_tpu_torch.training.factory import ModelBundle

    return ModelBundle(Options(**opts, device="cpu"), for_training)


@pytest.mark.parametrize("backbone", ["ResNet18", "DHRNet", "LiteMono"])
def test_reference_loss_and_gradients_match_the_port(backbone):
    from mono_vifi_tpu_torch.training import monovifi as M

    opts = {**OPTS, "backbone": backbone}
    ref = ref_factory.ModelBundle(Config.from_keys(opts))
    w = weights.draw(ref, 7, "cpu")
    weights.load(ref, w)
    port = port_bundle(opts)
    weights.load(port, w)
    batch = train.make_pool(7, 1, 2, 64, 96, "cpu")[0]
    gen = torch.Generator().manual_seed(3)
    loss_r, _ = ref_step.MonoViFiStep(ref).loss_fn(batch, gen)
    gen.manual_seed(3)
    loss_p, _ = M.MonoViFiStep(port, device="cpu").loss_fn(batch, gen)
    assert torch.allclose(loss_r, loss_p, rtol=1e-5)
    loss_r.backward()
    loss_p.backward()
    grads_p = dict(port.named_parameters())
    for name, p in ref.named_parameters():
        if p.grad is None:
            assert grads_p[name].grad is None or not grads_p[name].grad.any(), name
            continue
        scale = p.grad.abs().max().clamp_min(1e-6)
        assert torch.allclose(p.grad, grads_p[name].grad, atol=1e-4 * scale, rtol=1e-3), name


@pytest.mark.parametrize("backbone", ["ResNet18", "LiteMono"])
def test_reference_disparities_match_the_port(backbone):
    from mono_vifi_tpu_torch.training import monovifi as M

    opts = {**OPTS, "backbone": backbone}
    ref = ref_factory.ModelBundle(Config.from_keys(opts), for_training=False)
    w = weights.draw(ref, 5, "cpu")
    weights.load(ref, w)
    port = port_bundle(opts, for_training=False)
    weights.load(port, w)
    frames = video.make_video(5, 3, 64, 96, 4)
    imgs = [torch.from_numpy(f[None]).permute(0, 3, 1, 2).contiguous() for f in frames]
    assert torch.allclose(ref_step.single_frame_disp(ref, imgs[1]),
                          M.single_frame_disp(port, imgs[1]), atol=1e-6)
    assert torch.allclose(ref_step.multi_frame_disp(ref, *imgs),
                          M.multi_frame_disp(port, *imgs), atol=1e-6)


@pytest.mark.parametrize("backbone", ["ResNet18", "LiteMono"])
def test_flop_count_equals_the_ports_count(backbone):
    from mono_vifi_tpu_torch.training import monovifi as M
    from mono_vifi_tpu_torch.utils import flops as port_flops

    opts = {**OPTS, "backbone": backbone}
    port = port_bundle(opts)
    step = M.MonoViFiStep(port, device="cpu")
    batch = train.make_pool(1, 1, 2, 64, 96, "cpu")[0]
    counted = port_flops(lambda: step.loss_fn(batch)[0].backward(), grad=True)
    assert flops.train_step(opts) == counted
    img = torch.zeros((1, 3, 64, 96))
    ev = port_bundle(opts, for_training=False)
    counted = (port_flops(M.single_frame_disp, ev, img)
               + port_flops(M.multi_frame_disp, ev, img, img, img))
    assert flops.video_frame(opts) == counted


def test_weights_are_the_seeds():
    ref = ref_factory.ModelBundle(Config.from_keys(OPTS), for_training=False)
    a, b = weights.draw(ref, 9, "cpu"), weights.draw(ref, 9, "cpu")
    c = weights.draw(ref, 10, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)


@pytest.mark.parametrize("cell", sorted(DRAW_DIGESTS))
def test_weights_drawn_bit_for_bit_as_pinned(cell):
    c = registry.find_cell(cell)
    ctx = types.SimpleNamespace(cell=c, seed=2**31 + 977, device=torch.device("cpu"))
    digest = hashlib.sha256()
    for name, t in registry.driver(c).initial_weights(ctx).items():
        digest.update(name.encode())
        digest.update(t.contiguous().numpy().tobytes())
    assert digest.hexdigest() == DRAW_DIGESTS[cell]


def test_litemono_blocks_match_the_port_with_open_branches():
    """The encoder with its layer scales at 0.7 and uneven temperatures, so
    that every block's branch, the attention's above all, carries weight:
    features and gradients against the port's in training, with the same
    keep masks, and the features in evaluation."""
    from mono_vifi_tpu_torch.models import litemono as port_litemono

    cfg = Config.from_keys({**OPTS, "backbone": "LiteMono"})
    ref, _ = ref_factory.build_depth_net(cfg, torch.float32)
    w = weights.draw(ref, 3, "cpu")
    gen = torch.Generator().manual_seed(4)
    for k in w:
        if k.rsplit(".", 1)[-1] in ("gamma", "gamma_xca"):
            w[k].fill_(0.7)
        elif k.endswith("temperature"):
            w[k] = torch.rand(w[k].shape, generator=gen) + 0.5
    port = port_litemono.DepthEncoder(height=64, width=96)
    weights.load(ref, w)
    weights.load(port, w)
    x = torch.rand((3, 3, 64, 96), generator=gen)
    masks = ref.draw_drop_masks(3, gen.manual_seed(5))
    assert torch.equal(masks, port.draw_drop_masks(3, gen.manual_seed(5)))
    assert not masks.all()
    feats_r, feats_p = ref(x, masks), port.train()(x, masks)
    for a, b in zip(feats_r, feats_p):
        assert torch.allclose(a, b, atol=1e-5), (a - b).abs().max()
    sum(f.square().mean() for f in feats_r).backward()
    sum(f.square().mean() for f in feats_p).backward()
    grads_p = dict(port.named_parameters())
    for name, p in ref.named_parameters():
        scale = p.grad.abs().max().clamp_min(1e-6)
        assert torch.allclose(p.grad, grads_p[name].grad, atol=1e-4 * scale, rtol=1e-3), name
    with torch.no_grad():
        for a, b in zip(ref.eval()(x), port.eval()(x)):
            assert torch.allclose(a, b, atol=1e-5), (a - b).abs().max()
