"""The frozen reference against the port's plain path at a tiny size on the
CPU (f32), and its FLOP count against the port's own count."""

from __future__ import annotations

import pytest
import torch

from perfbench import weights
from perfbench.counts import flops
from perfbench.drivers import train, video
from perfbench.reference.config import Config
from perfbench.reference.training import factory as ref_factory
from perfbench.reference.training import monovifi as ref_step

OPTS = {"height": 64, "width": 96, "batch_size": 2, "use_affine": True,
        "fuse_model_type": "shared_encoder", "vfi_train_scale": "tiny",
        "vfi_test_scale": "tiny", "compute_dtype": "float32"}


def port_bundle(opts, for_training=True):
    from mono_vifi_tpu_torch.config import Options
    from mono_vifi_tpu_torch.training.factory import ModelBundle

    return ModelBundle(Options(**opts, device="cpu"), for_training)


@pytest.mark.parametrize("backbone", ["ResNet18", "DHRNet"])
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


def test_reference_disparities_match_the_port():
    from mono_vifi_tpu_torch.training import monovifi as M

    ref = ref_factory.ModelBundle(Config.from_keys(OPTS), for_training=False)
    w = weights.draw(ref, 5, "cpu")
    weights.load(ref, w)
    port = port_bundle(OPTS, for_training=False)
    weights.load(port, w)
    frames = video.make_video(5, 3, 64, 96, 4)
    imgs = [torch.from_numpy(f[None]).permute(0, 3, 1, 2).contiguous() for f in frames]
    assert torch.allclose(ref_step.single_frame_disp(ref, imgs[1]),
                          M.single_frame_disp(port, imgs[1]), atol=1e-6)
    assert torch.allclose(ref_step.multi_frame_disp(ref, *imgs),
                          M.multi_frame_disp(port, *imgs), atol=1e-6)


def test_flop_count_equals_the_ports_count():
    from mono_vifi_tpu_torch.training import monovifi as M
    from mono_vifi_tpu_torch.utils import flops as port_flops

    port = port_bundle(OPTS)
    step = M.MonoViFiStep(port, device="cpu")
    batch = train.make_pool(1, 1, 2, 64, 96, "cpu")[0]
    counted = port_flops(lambda: step.loss_fn(batch)[0].backward(), grad=True)
    assert flops.train_step(OPTS) == counted
    img = torch.zeros((1, 3, 64, 96))
    ev = port_bundle(OPTS, for_training=False)
    counted = (port_flops(M.single_frame_disp, ev, img)
               + port_flops(M.multi_frame_disp, ev, img, img, img))
    assert flops.video_frame(OPTS) == counted


def test_weights_are_the_seeds():
    ref = ref_factory.ModelBundle(Config.from_keys(OPTS), for_training=False)
    a, b = weights.draw(ref, 9, "cpu"), weights.draw(ref, 9, "cpu")
    c = weights.draw(ref, 10, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a)
