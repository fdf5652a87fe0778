"""`encoder_remat`: the step with the encoder's activations recomputed in the
backward pass (torch.utils.checkpoint) against the same step without it,
for ResNet18 and for LiteMono with injected stochastic-depth masks, and
against the JAX package's step with `encoder_remat=True` (jax.checkpoint),
at the config of tests/test_torch_step.py (64x96, B=2, f32, tiny VFI,
affine, shared_encoder), on the CPU.

Tolerances (f32, CPU): remat against no remat, loss terms, gradients and
BatchNorm statistics rtol 1e-6: the recompute repeats the forward's
arithmetic on the same inputs and masks, so only the order in which
autograd accumulates the encoder features' gradient could differ. The
statistics move once (`num_batches_tracked` + 1): the recompute leaves
them alone. Against JAX, as tests/test_torch_step.py: loss terms rtol
1e-4, gradient leaves GRAD_RTOL per role (norm of the difference over the
norm of the JAX leaf), statistics atol 1e-5.
"""

import dataclasses

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
from mono_vifi_tpu_torch.training import monovifi as TM

from tests.test_torch_backbones import jax_trees, np_sd
from tests.test_torch_parallel import torch_default_init
from tests.test_torch_step import CFG, GRAD_RTOL, B, H, W, make_batch

TERMS = ("loss", "loss_base", "loss_dc", "loss_sadc")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _noise(step, seed=2):
    rng = np.random.default_rng(seed)
    noise = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for k, s in step.noise_shapes(B, H, W).items()}
    enc = step.b.encoder
    if getattr(enc, "num_drop_paths", 0):
        n_img = step.encoder_batches(B)["encoder"]
        masks = rng.random((enc.num_drop_paths, n_img)) >= 0.2
        assert not masks.all()
        noise["drop_path_encoder"] = torch.from_numpy(masks)
    return noise


def _step(cfg: Options, noise=None):
    """One loss + backward from seed 0 -> (state, metrics, noise)."""
    state = TM.create_train_state(cfg, 0, steps_per_epoch=10, device="cpu")
    step = TM.MonoViFiStep(state.bundle, device="cpu")
    noise = _noise(step) if noise is None else noise
    loss, metrics = step.loss_fn(make_batch(), noise=noise)
    loss.backward()
    return state, {k: float(v.detach()) for k, v in metrics.items()}, noise


@pytest.fixture(scope="module", params=["ResNet18", "LiteMono"])
def pair(request):
    cfg = Options(**(CFG | {"backbone": request.param}))
    off = _step(cfg)
    on = _step(dataclasses.replace(cfg, encoder_remat=True), off[2])
    return off, on


@pytest.mark.parametrize("term", TERMS)
def test_remat_loss_terms_equal_no_remat(pair, term):
    (_, ref, _), (_, got, _) = pair
    np.testing.assert_allclose(got[term], ref[term], rtol=1e-6)


def test_remat_gradients_equal_no_remat(pair):
    (off, _, _), (on, _, _) = pair
    for (name, p), q in zip(off.bundle.named_parameters(), on.bundle.parameters()):
        if p.grad is None:
            assert q.grad is None, name
            continue
        torch.testing.assert_close(q.grad, p.grad, rtol=1e-6, atol=1e-9, msg=name)


def test_remat_batchnorm_statistics_move_once(pair):
    (off, _, _), (on, _, _) = pair
    got, ref = on.bundle.state_dict(), off.bundle.state_dict()
    tracked = [k for k in ref if k.endswith("num_batches_tracked")]
    assert tracked
    for k in tracked:
        assert int(got[k]) == int(ref[k]) == 1, k
    for k in ref:
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(got[k], ref[k], rtol=1e-6, atol=0, msg=k)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX step with encoder_remat=True (jax.checkpoint around the
    fused encoder pass) and the port's remat step on the same weights,
    batch and automask noise (torch's default init: see
    tests/test_torch_parallel.py torch_default_init)."""
    cfg = CFG | {"encoder_remat": True}
    with torch_default_init():
        state = TM.create_train_state(Options(**cfg), 0, steps_per_epoch=10, device="cpu")
    params, bstats = jax_trees("ResNet18", state.bundle)
    vfi = jconvert.convert_ifrnet(np_sd(state.bundle.vfi_train))["params"]
    jcfg = JOptions(**cfg, vfi_test_scale="tiny")
    jstep = JM.MonoViFiStep(JM.ModelBundle(jcfg), jmake_optimizer(jcfg, 10))
    batch = make_batch()
    rng = jax.random.PRNGKey(2)
    r_n1, r_n2, _, _ = jax.random.split(rng, 4)
    noise = {"n1": np.asarray(jax.random.normal(r_n1, (2, 6 * B, H, W))),
             "n2": np.asarray(jax.random.normal(r_n2, (2, 3 * B, H, W)))}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def lf(p):
        return jstep.loss_fn(p, bstats, vfi, jbatch, rng, train=True)

    (_, (new_bstats, metrics)), grads = jax.jit(jax.value_and_grad(lf, has_aux=True))(params)
    step = TM.MonoViFiStep(state.bundle, device="cpu")
    loss, port_metrics = step.loss_fn(
        batch, noise={k: torch.from_numpy(v.copy()) for k, v in noise.items()})
    loss.backward()
    return (metrics, convert.bundle_state_dicts(params, jax.tree.map(np.asarray, new_bstats)),
            convert.bundle_state_dicts(jax.tree.map(np.asarray, grads)), state, port_metrics)


def test_remat_step_matches_jax_remat_step(jax_run):
    metrics, ref_sd, ref_grads, state, port = jax_run
    for term in TERMS:
        np.testing.assert_allclose(float(port[term].detach()), float(metrics[term]), rtol=1e-4,
                                   err_msg=term)
    for role in ("encoder", "pose_encoder"):
        got = state.bundle.role(role).state_dict()
        for k, v in ref_sd[role].items():
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-5, err_msg=k)
    for role, rtol in GRAD_RTOL.items():
        named = dict(state.bundle.role(role).named_parameters())
        for name, g in ref_grads[role].items():
            err = np.linalg.norm(named[name].grad.numpy() - g.numpy())
            assert err <= rtol * np.linalg.norm(g.numpy()), (role, name)
