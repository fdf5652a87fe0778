"""The port's LiteMono training step against the benchmark's plain reference
(`perfbench/reference/models/litemono.py`) on the CPU at a tiny size
(64x96, B=2, f32, shared encoder, affine branch) from the benchmark's
seeded weights, with the same automask noise and stochastic-depth masks;
the step unchanged by a running profiler, which sees LiteMono's spans
inside the step's encoder and decoder spans; and the drop masks and
position features as device constants, made once and drawn as before."""

import copy

import pytest
import torch

from mono_vifi_tpu_torch.config import Options
from mono_vifi_tpu_torch.ops import image as image_ops
from mono_vifi_tpu_torch.training import monovifi as M
from mono_vifi_tpu_torch.training.factory import ModelBundle
from perfbench import weights
from perfbench.drivers.train import make_pool
from perfbench.reference.config import Config
from perfbench.reference.training import factory as ref_factory
from perfbench.reference.training import monovifi as ref_monovifi

B, H, W = 2, 64, 96
OPTS = {"height": H, "width": W, "batch_size": B, "backbone": "LiteMono", "use_affine": True,
        "fuse_model_type": "shared_encoder", "vfi_train_scale": "tiny",
        "vfi_test_scale": "tiny", "compute_dtype": "float32"}
SPANS = ("litemono.stem", "litemono.cdc", "litemono.xca", "litemono.mlp", "litemono.decoder")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def start():
    """The port's bundle and the reference's, both with seed 7's benchmark
    weights, and one batch."""
    ref = ref_factory.ModelBundle(Config.from_keys(OPTS))
    w = weights.draw(ref, 7, "cpu")
    weights.load(ref, w)
    port = ModelBundle(Options(**OPTS, device="cpu"))
    weights.load(port, w)
    return port, ref, make_pool(7, 1, B, H, W, "cpu")[0]


@pytest.fixture(scope="module")
def plain(start):
    """The port's step from the start, with noise seed 3's draws: the
    draws, the loss and the gradients."""
    port, _, batch = start
    noise = noise_of(M.MonoViFiStep(port, device="cpu"), 3)
    return (noise,) + port_step(port, batch, noise)


def noise_of(step, seed):
    return step.draw_noise(B, H, W, torch.Generator().manual_seed(seed))


def port_step(port, batch, noise):
    """The port's loss and gradients from `port`'s state, left untouched."""
    bundle = copy.deepcopy(port)
    loss, _ = M.MonoViFiStep(bundle, device="cpu").loss_fn(batch, noise=noise)
    loss.backward()
    return loss.detach(), {k: p.grad for k, p in bundle.named_parameters()}


def test_litemono_step_matches_the_reference(start, plain):
    _, ref, batch = start
    noise, loss_p, grads_p = plain
    ref_step = ref_monovifi.MonoViFiStep(ref)
    ref_noise = noise_of(ref_step, 3)
    assert noise.keys() == ref_noise.keys() and "drop_path_encoder" in noise
    assert all(torch.equal(noise[k], ref_noise[k]) for k in noise)
    assert noise["drop_path_encoder"].shape == (18, 8 * B)
    loss_r, _ = ref_step.loss_fn(batch, noise=ref_noise)
    assert torch.allclose(loss_r, loss_p, rtol=1e-5, atol=0)
    loss_r.backward()
    for name, p in ref.named_parameters():
        if p.grad is None:
            assert grads_p[name] is None or not grads_p[name].any(), name
            continue
        scale = p.grad.abs().max().clamp_min(1e-6)
        assert torch.allclose(p.grad, grads_p[name], atol=1e-4 * scale, rtol=1e-3), name


def test_profiler_changes_nothing_and_sees_the_litemono_spans(start, plain):
    """Each part of the encoder inside `forward.encoder`; the single-frame
    decoder inside `forward.depth`, the multi-frame one inside
    `forward.fusion`."""
    port, _, batch = start
    noise, loss, grads = plain
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = port_step(port, batch, noise)
    assert torch.equal(loss, traced[0])
    assert all(torch.equal(g, traced[1][k]) for k, g in grads.items() if g is not None)
    ranges = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]
    stages = [r for r in ranges if r[0].startswith("forward.")]

    def stage_of(t0, t1):
        return [n for n, a, b in stages if a <= t0 and t1 <= b]

    seen = {}
    for name, a, b in ranges:
        if name.startswith("litemono."):
            seen.setdefault(name, set()).update(stage_of(a, b))
    assert set(seen) == set(SPANS)
    for name in SPANS[:-1]:
        assert seen[name] == {"forward.encoder"}, (name, seen[name])
    assert seen["litemono.decoder"] == {"forward.depth", "forward.fusion"}
    counts = {n: sum(r[0] == n for r in ranges) for n in SPANS}
    # 3 stem spans; 15 CDC blocks; 3 LGFI blocks; an MLP in each of the 18
    # blocks; two decoders
    assert counts == {"litemono.stem": 3, "litemono.cdc": 15, "litemono.xca": 3,
                      "litemono.mlp": 18, "litemono.decoder": 2}


def test_drop_masks_and_position_features_made_once(start):
    """A second draw and a second forward make no device constant; the
    masks are bit for bit those of the keep rates built from a host copy
    on every draw, from the same generator."""
    enc = copy.deepcopy(start[0].encoder)
    x = torch.rand((2, 3, H, W), generator=torch.Generator().manual_seed(1))
    enc.draw_drop_masks(2, torch.Generator().manual_seed(0))
    enc(x, enc.draw_drop_masks(2, torch.Generator().manual_seed(0)))
    misses = image_ops.CONSTANT_COUNTS["misses"]
    gen = torch.Generator().manual_seed(5)
    masks = enc.draw_drop_masks(4 * B, gen)
    enc(x, enc.draw_drop_masks(2, gen))
    assert image_ops.CONSTANT_COUNTS["misses"] == misses
    gen.manual_seed(5)
    keep = 1.0 - torch.tensor(enc.drop_rates).view(-1, 1)
    assert torch.equal(masks, torch.rand((enc.num_drop_paths, 4 * B), generator=gen) < keep)
    assert masks.any() and not masks.all()
