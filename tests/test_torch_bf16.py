"""bf16 compute of the port against the JAX package's, on the CPU (64x96,
batch 2, tiny VFI, affine, shared_encoder): the same weights and inputs run
in f32 and in bf16 in each package, and each package's bf16 result is held
against its own f32 result. The port's distance may be at most 1.5x the JAX
package's (plus a floor of 1e-3 of the f32 value for a term that JAX
happens to hit almost exactly), and each side's distance is bounded.

Port bf16 is not compared with JAX bf16 directly: with train-mode
BatchNorm the two round in other places and end ~0.4 apart at the deepest
scale while each stays within ~0.5 of its f32 result.

Bounds: each encoder scale within 10% of the largest |f32| value at that
scale (the deepest scale in train mode reads ~5% for the port and ~6% for
JAX); each loss term within 5% of its f32 value.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mono_vifi_tpu import convert as jconvert
from mono_vifi_tpu.config import Options as JOptions
from mono_vifi_tpu.training import monovifi as JM
from mono_vifi_tpu_torch.config import Options
from mono_vifi_tpu_torch.training import monovifi as TM

from tests.test_torch_step import CFG, B, H, W, make_batch

RATIO, FLOOR = 1.5, 1e-3


def _port_state(dtype):
    state = TM.create_train_state(Options(**(CFG | {"compute_dtype": dtype})), 0,
                                  steps_per_epoch=10, device="cpu")
    return state, TM.MonoViFiStep(state.bundle, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs files in parallel processes, and
    a process whose eight OpenMP threads wait on busy cores spins (this
    file took ~10x longer under load with eight than with two)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """The port's f32 random weights as JAX trees (the JAX package's own
    torch -> Flax converter), with BatchNorm statistics drawn from a seed."""
    b = _port_state("float32")[0].bundle
    rng = np.random.default_rng(8)
    for m in b.modules():
        if hasattr(m, "running_mean"):
            m.running_mean.copy_(torch.from_numpy(
                (0.1 * rng.standard_normal(m.running_mean.shape)).astype(np.float32)))
            m.running_var.copy_(torch.from_numpy(
                rng.uniform(0.5, 1.5, m.running_var.shape).astype(np.float32)))
    sd = {r: {k: v.numpy() for k, v in b.role(r).state_dict().items()}
          for r in list(b.trainable_roles()) + ["vfi_train"]}
    roles = {
        "encoder": jconvert.convert_depth_encoder(sd["encoder"], 18),
        "depth": jconvert.convert_depth_decoder(sd["depth"]),
        "depth_mf": jconvert.convert_depth_decoder(sd["depth_mf"]),
        "fusion_module": jconvert.convert_fusion_module(sd["fusion_module"]),
        "pose_encoder": jconvert.convert_pose_encoder(sd["pose_encoder"], 18),
        "pose": jconvert.convert_pose_decoder(sd["pose"]),
    }
    params = {r: v["params"] for r, v in roles.items()}
    bstats = {r: v["batch_stats"] for r, v in roles.items() if v["batch_stats"]}
    return sd, params, bstats, jconvert.convert_ifrnet(sd["vfi_train"])["params"]


def _port_bundle(sd, dtype):
    state, step = _port_state(dtype)
    for role, d in sd.items():
        state.bundle.role(role).load_state_dict({k: torch.from_numpy(v) for k, v in d.items()})
    return state, step


def _jax_bundle(dtype):
    return JM.ModelBundle(JOptions(**(CFG | {"compute_dtype": dtype}), vfi_test_scale="tiny"))


def _dist(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))))


@pytest.mark.parametrize("train", [True, False], ids=["batch-stats", "running-stats"])
def test_bf16_encoder_is_as_close_to_f32_as_jax(weights, train):
    sd, params, bstats, _ = weights
    x = np.random.default_rng(4).random((2 * B, H, W, 3)).astype(np.float32)
    port, ref = {}, {}
    for dt in ("float32", "bfloat16"):
        enc = _port_bundle(sd, dt)[0].bundle.encoder.train(train)
        with torch.no_grad():
            port[dt] = [f.float().permute(0, 2, 3, 1).numpy()
                        for f in enc(torch.from_numpy(x).permute(0, 3, 1, 2))]
        v = {"params": params["encoder"], "batch_stats": bstats["encoder"]}
        fn = jax.jit(lambda v, x, e=_jax_bundle(dt).encoder: e.apply(
            v, x, train=train, mutable=["batch_stats"] if train else False))
        out = fn(v, jnp.asarray(x))
        ref[dt] = [np.asarray(f, np.float32) for f in (out[0] if train else out)]
    for i in range(5):
        d_port = _dist(port["bfloat16"][i], port["float32"][i])
        d_jax = _dist(ref["bfloat16"][i], ref["float32"][i])
        scale = float(np.abs(port["float32"][i]).max())
        assert d_port <= 0.1 * scale and d_jax <= 0.1 * scale, (i, d_port, d_jax, scale)
        assert d_port <= max(RATIO * d_jax, FLOOR * scale), (i, d_port, d_jax)
        assert d_port > 0  # the bf16 path really rounds


def test_bf16_step_loss_terms_are_as_close_to_f32_as_jax(weights):
    sd, params, bstats, vfi = weights
    batch = make_batch()
    rng = jax.random.PRNGKey(2)
    r_n1, r_n2, _, _ = jax.random.split(rng, 4)
    noise = {"n1": np.asarray(jax.random.normal(r_n1, (2, 6 * B, H, W))),
             "n2": np.asarray(jax.random.normal(r_n2, (2, 3 * B, H, W)))}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    terms = ("loss", "loss_base", "loss_dc", "loss_sadc")
    port, ref = {}, {}
    for dt in ("float32", "bfloat16"):
        _, step = _port_bundle(sd, dt)
        with torch.no_grad():
            _, m = step.loss_fn(batch, noise={k: torch.from_numpy(v.copy())
                                              for k, v in noise.items()})
        port[dt] = {t: float(m[t]) for t in terms}
        jstep = JM.MonoViFiStep(_jax_bundle(dt), None)
        _, (_, m) = jax.jit(lambda p: jstep.loss_fn(p, bstats, vfi, jbatch, rng, train=True))(
            params)
        ref[dt] = {t: float(m[t]) for t in terms}
    for t in terms:
        f32 = abs(port["float32"][t])
        d_port = abs(port["bfloat16"][t] - port["float32"][t])
        d_jax = abs(ref["bfloat16"][t] - ref["float32"][t])
        assert d_port <= 0.05 * f32 and d_jax <= 0.05 * f32, (t, d_port, d_jax, f32)
        assert d_port <= max(RATIO * d_jax, FLOOR * f32), (t, d_port, d_jax)
