"""The port's whole training step with LiteMono and with D-HRNet against the
JAX package's `MonoViFiStep.loss_fn` on the CPU, at the config of
tests/test_torch_step.py (64x96, B=2, f32, tiny VFI, affine,
shared_encoder) with the backbone swapped: the same weights (torch's
default init: tests/test_torch_parallel.py torch_default_init), batch,
automask noise and, for LiteMono, the same stochastic-depth keep masks
(injected into the JAX encoder through an interceptor in place of its own
draws).

Tolerances (f32, CPU): loss terms rtol 1e-4. Gradient leaves: the norm of
the difference over the norm of the JAX leaf, per role (GRAD_RTOL), for
the reasons tests/test_torch_step.py gives: the decoders and the fusion
convs agree closely; the pose path's gradient is a difference of
neighbouring taps; the encoders' leaves are reached through BatchNorm
backward at small batch (D-HRNet's through four stages of it: 1e-1, see
ENCODER_RTOL). BatchNorm running statistics as
tests/test_torch_backbones.py (atol 2e-5, rtol 1e-4).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mono_vifi_tpu import convert as jconvert
from mono_vifi_tpu.config import Options as JOptions
from mono_vifi_tpu.training import monovifi as JM
from mono_vifi_tpu.training.optim import make_optimizer as jmake_optimizer
from mono_vifi_tpu_torch import convert
from mono_vifi_tpu_torch.config import Options
from mono_vifi_tpu_torch.models.litemono import _MODELS
from mono_vifi_tpu_torch.training import monovifi as TM

from tests.test_torch_backbones import (
    STATS_ATOL, STATS_RTOL, drop_interceptor, jax_trees, np_sd,
)
from tests.test_torch_parallel import torch_default_init
from tests.test_torch_step import CFG, B, H, W, make_batch

GRAD_RTOL = {"depth": 1e-4, "depth_mf": 1e-4, "fusion_module": 1e-4, "pose": 1e-2,
             "encoder": 1e-2, "pose_encoder": 3e-2}
# D-HRNet's small BatchNorm leaves (18-channel branches, fuse layers) are
# reached through four stages of fusing branches, each BatchNorm backward at
# batch 2, and through the grid gradient's jumps: rounding-sized changes of
# the port's own weights move them by percents
# (test_dhrnet_encoder_gradients_are_rounding_sensitive), so the two
# packages' f32 roundings do too
ENCODER_RTOL = {"LiteMono": 1e-2, "DHRNet": 1e-1}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs files in parallel processes, and
    a process whose eight OpenMP threads wait on busy cores spins."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["LiteMono", "DHRNet"])
def run(request):
    """One loss + gradient evaluation in each package: (backbone, JAX
    metrics, the JAX trees, JAX updated batch stats, JAX gradients as port
    state_dicts, port state holding its gradients, port metrics)."""
    backbone = request.param
    cfg = CFG | {"backbone": backbone}
    with torch_default_init():
        state = TM.create_train_state(Options(**cfg), 0, steps_per_epoch=10, device="cpu")
    step = TM.MonoViFiStep(state.bundle, device="cpu")
    params, bstats = jax_trees(backbone, state.bundle)
    vfi = jconvert.convert_ifrnet(np_sd(state.bundle.vfi_train))["params"]
    jcfg = JOptions(**cfg, vfi_test_scale="tiny")
    jstep = JM.MonoViFiStep(JM.ModelBundle(jcfg), jmake_optimizer(jcfg, 10))
    batch = make_batch()
    rng = jax.random.PRNGKey(2)
    r_n1, r_n2, _, _ = jax.random.split(rng, 4)
    noise = {"n1": np.asarray(jax.random.normal(r_n1, (2, 6 * B, H, W))),
             "n2": np.asarray(jax.random.normal(r_n2, (2, 3 * B, H, W)))}
    masks = None
    if backbone == "LiteMono":
        n_img = step.encoder_batches(B)["encoder"]
        masks = np.random.default_rng(6).random(
            (state.bundle.encoder.num_drop_paths, n_img)) >= 0.2
        assert not masks.all()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def lf(p):
        return jstep.loss_fn(p, bstats, vfi, jbatch, rng, train=True)

    fn = jax.jit(jax.value_and_grad(lf, has_aux=True))
    if masks is not None:
        with drop_interceptor(masks, _MODELS["lite-mono"]["depth"]):
            (_, (new_bstats, metrics)), grads = fn(params)
    else:
        (_, (new_bstats, metrics)), grads = fn(params)

    port_noise = {k: torch.from_numpy(v.copy()) for k, v in noise.items()}
    if masks is not None:
        port_noise["drop_path_encoder"] = torch.from_numpy(masks)
    loss, port_metrics = step.loss_fn(batch, noise=port_noise)
    loss.backward()
    grads = convert.bundle_state_dicts(jax.tree.map(np.asarray, grads), backbone=backbone)
    return (backbone, metrics, params, jax.tree.map(np.asarray, new_bstats), grads, state,
            port_metrics)


@pytest.mark.parametrize("term", ["loss", "loss_base", "loss_dc", "loss_sadc"])
def test_loss_terms_match_jax(run, term):
    metrics, port = run[1], run[6]
    np.testing.assert_allclose(float(port[term].detach()), float(metrics[term]), rtol=1e-4)


@pytest.mark.parametrize("role", ["encoder", "pose_encoder"])
def test_batchnorm_statistics_match_jax(run, role):
    backbone, _, params, new_bstats, _, state, _ = run
    ref = convert.bundle_state_dicts(params, new_bstats, backbone=backbone)[role]
    got = state.bundle.role(role).state_dict()
    keys = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=STATS_RTOL,
                                   atol=STATS_ATOL, err_msg=k)


@pytest.mark.parametrize("role", sorted(GRAD_RTOL))
def test_gradients_match_jax(run, role):
    backbone, ref, state = run[0], run[4][role], run[5]
    rtol = ENCODER_RTOL[backbone] if role == "encoder" else GRAD_RTOL[role]
    got = dict(state.bundle.role(role).named_parameters())
    assert set(ref) == set(got)
    for name, g in ref.items():
        ref_norm = np.linalg.norm(g.numpy())
        err = np.linalg.norm(got[name].grad.numpy() - g.numpy())
        assert err <= rtol * ref_norm, (name, err / ref_norm)


def test_drop_masks_come_from_the_generator():
    """Without injected draws the step takes LiteMono's keep masks from its
    generator, after the automask noise: the same seed gives the same
    masks, another seed others; D-HRNet, without stochastic depth, none."""
    cfg = Options(**(CFG | {"backbone": "LiteMono"}))
    state = TM.create_train_state(cfg, 0, steps_per_epoch=10, device="cpu")
    step = TM.MonoViFiStep(state.bundle, device="cpu")
    a = step.draw_drop_masks(B, torch.Generator().manual_seed(3))
    b = step.draw_drop_masks(B, torch.Generator().manual_seed(3))
    c = step.draw_drop_masks(B, torch.Generator().manual_seed(4))
    assert set(a) == {"drop_path_encoder"}
    assert a["drop_path_encoder"].shape == (18, 8 * B)
    assert torch.equal(a["drop_path_encoder"], b["drop_path_encoder"])
    assert not torch.equal(a["drop_path_encoder"], c["drop_path_encoder"])
    assert a["drop_path_encoder"][0].all()  # the first block's rate is 0
    dhr = TM.create_train_state(Options(**(CFG | {"backbone": "DHRNet"})), 0,
                                steps_per_epoch=10, device="cpu")
    assert TM.MonoViFiStep(dhr.bundle, device="cpu").draw_drop_masks(B) == {}


def test_dhrnet_encoder_gradients_are_rounding_sensitive():
    """Why D-HRNet's encoder leaves get ENCODER_RTOL 1e-1: multiplying the
    port's own encoder weights by 1 + 1e-6 * N(0, 1), a few f32 roundings,
    moves some leaf's gradient by more than 1% while the loss stays within
    1e-6; the whole step is the parity test's."""
    batch = make_batch()
    rng = jax.random.PRNGKey(2)
    r_n1, r_n2, _, _ = jax.random.split(rng, 4)
    noise = {"n1": np.asarray(jax.random.normal(r_n1, (2, 6 * B, H, W))),
             "n2": np.asarray(jax.random.normal(r_n2, (2, 3 * B, H, W)))}
    losses, grads = [], []
    for eps in (0.0, 1e-6):
        with torch_default_init():
            state = TM.create_train_state(Options(**(CFG | {"backbone": "DHRNet"})), 0,
                                          steps_per_epoch=10, device="cpu")
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in state.bundle.encoder.parameters():
                p.mul_(1 + eps * torch.randn(p.shape, generator=gen))
        step = TM.MonoViFiStep(state.bundle, device="cpu")
        loss, _ = step.loss_fn(batch, noise={k: torch.from_numpy(v.copy())
                                             for k, v in noise.items()})
        loss.backward()
        losses.append(float(loss))
        grads.append({n: p.grad for n, p in state.bundle.encoder.named_parameters()})
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
    worst = max(float((grads[1][n] - g).norm() / g.norm()) for n, g in grads[0].items())
    assert worst > 1e-2, worst
