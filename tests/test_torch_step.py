"""The port's whole training step against the JAX package's
`MonoViFiStep.loss_fn` on the same weights, batch and automask noise, at
the config of tests/test_train_step.py (64x96, B=2, f32, tiny VFI, affine,
shared_encoder), on the CPU. Also: the port imports neither JAX nor the JAX
package, and its entry points refuse to run without a card unless told to.

Tolerances (f32, CPU): loss terms rtol 1e-4. Gradient leaves: the norm of
the difference over the norm of the JAX leaf, per role (GRAD_RTOL). The
decoders and the fusion convs agree to ~3e-6. The pose path's gradient is
a difference of neighbouring taps, which jumps where f32 rounding of the
pose moves a coordinate across a pixel (the smooth test images keep the
jumps small): ~5e-3 for the pose decoder. The two ResNets' leaves are
reached through BatchNorm backward at small batch, which subtracts the
batch mean of the cotangent and amplifies those differences: ~2e-3 (depth
encoder) and ~1.3e-2 (pose encoder). BatchNorm running statistics atol
1e-5; one clipped AdamW update from the same gradients to two f32 ulps
(the two libraries order the update's arithmetic differently).
"""

import ast
import pathlib
import subprocess
import sys

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
from tests.test_torch_parallel import torch_default_init

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, H, W = 2, 64, 96
CFG = dict(
    height=H, width=W, batch_size=B, use_affine=True, compute_dtype="float32",
    fuse_model_type="shared_encoder", vfi_train_scale="tiny",
)


def make_batch(seed=3):
    rng = np.random.default_rng(seed)

    def rand(*s):
        return rng.random(s).astype(np.float32)

    def smooth(*s):
        # low-frequency images: the sampling grid's gradient (a difference of
        # neighbouring taps) then barely changes when rounding in the pose
        # moves a coordinate across a pixel boundary
        lo = rng.random((s[0], H // 8 + 1, W // 8 + 1, s[3]))
        ys, xs = np.linspace(0, H // 8, H), np.linspace(0, W // 8, W)
        y0, x0 = np.floor(ys).astype(int).clip(0, H // 8 - 1), np.floor(xs).astype(int).clip(0, W // 8 - 1)
        wy, wx = (ys - y0)[None, :, None, None], (xs - x0)[None, None, :, None]
        top = lo[:, y0][:, :, x0] * (1 - wx) + lo[:, y0][:, :, x0 + 1] * wx
        bot = lo[:, y0 + 1][:, :, x0] * (1 - wx) + lo[:, y0 + 1][:, :, x0 + 1] * wx
        return (top * (1 - wy) + bot * wy).astype(np.float32)

    K = np.zeros((B, 4, 4), np.float32)
    K[:, 0, 0], K[:, 1, 1] = 0.58 * W, 1.92 * H
    K[:, 0, 2], K[:, 1, 2] = 0.5 * W, 0.5 * H
    K[:, 2, 2] = K[:, 3, 3] = 1
    batch = {k: smooth(B, H, W, 3) for k in (
        "color_n1", "color_0", "color_p1", "color_aug_n1", "color_aug_0",
        "color_aug_p1", "color_affine_n1", "color_affine_0", "color_affine_p1",
        "color_affine_aug_0",
    )}
    w, h = round(W / 1.5), round(H / 1.5)
    batch.update(
        K=K, inv_K=np.linalg.pinv(K).astype(np.float32),
        Rc=np.tile(np.eye(3, dtype=np.float32), (B, 1, 1)),
        ratio_local=np.full((B, 1), 1.5, np.float32),
        angle=np.array([3.0, -2.0], np.float32),
        box=np.tile(np.array([2, 1, w, h], np.float32), (B, 1)),
        valid_mask_rec=(rand(B, H, W, 1) > 0.1).astype(np.float32),
        valid_mask_cons=(rand(B, H, W, 1) > 0.1).astype(np.float32),
    )
    return batch


def _port_state():
    """The port's state from seed 0 with torch's default init (see
    tests/test_torch_parallel.py torch_default_init)."""
    with torch_default_init():
        state = TM.create_train_state(Options(**CFG), 0, steps_per_epoch=10, device="cpu")
    return state, TM.MonoViFiStep(state.bundle, device="cpu")


@pytest.fixture(scope="module")
def setup():
    """The port's random weights, carried into the JAX package's trees by
    its own torch -> Flax converter, and the JAX step built on them."""
    state, _ = _port_state()
    b = state.bundle
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
    vfi = jconvert.convert_ifrnet(sd["vfi_train"])["params"]
    jcfg = JOptions(**CFG, vfi_test_scale="tiny")
    tx = jmake_optimizer(jcfg, 10)
    step = JM.MonoViFiStep(JM.ModelBundle(jcfg), tx)
    batch = make_batch()
    rng = jax.random.PRNGKey(2)
    r_n1, r_n2, _, _ = jax.random.split(rng, 4)
    noise = {
        "n1": np.asarray(jax.random.normal(r_n1, (2, 6 * B, H, W))),
        "n2": np.asarray(jax.random.normal(r_n2, (2, 3 * B, H, W))),
    }
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def lf(p):
        return step.loss_fn(p, bstats, vfi, jbatch, rng, train=True)

    return dict(params=params, bstats=bstats, batch=batch, noise=noise, lf=lf, tx=tx)


def _port_loss(setup):
    state, step = _port_state()
    noise = {k: torch.from_numpy(v.copy()) for k, v in setup["noise"].items()}
    loss, metrics = step.loss_fn(setup["batch"], noise=noise)
    return state, loss, metrics


@pytest.fixture(scope="module")
def run(setup):
    """One loss + gradient evaluation in each package: (JAX metrics, JAX
    updated batch stats, JAX gradients as port state_dicts, port state
    holding its gradients, port metrics)."""
    (_, (bstats, metrics)), grads = jax.jit(jax.value_and_grad(setup["lf"], has_aux=True))(
        setup["params"]
    )
    state, loss, port_metrics = _port_loss(setup)
    loss.backward()
    return (metrics, jax.tree.map(np.asarray, bstats),
            convert.bundle_state_dicts(jax.tree.map(np.asarray, grads)), state, port_metrics)


@pytest.mark.parametrize("term", ["loss", "loss_base", "loss_dc", "loss_sadc"])
def test_loss_terms_match_jax(run, term):
    metrics, _, _, _, port = run
    np.testing.assert_allclose(float(port[term]), float(metrics[term]), rtol=1e-4)


@pytest.mark.parametrize("role", ["encoder", "pose_encoder"])
def test_batchnorm_statistics_match_jax(setup, run, role):
    _, new_bstats, _, state, _ = run
    ref = convert.bundle_state_dicts(setup["params"], new_bstats)[role]
    got = state.bundle.role(role).state_dict()
    for name, v in ref.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[name].numpy(), v.numpy(), atol=1e-5, err_msg=name)


GRAD_RTOL = {"depth": 1e-4, "depth_mf": 1e-4, "fusion_module": 1e-4, "pose": 1e-2,
             "encoder": 1e-2, "pose_encoder": 3e-2}


@pytest.mark.parametrize("role", sorted(GRAD_RTOL))
def test_gradients_match_jax(run, role):
    _, _, ref_all, state, _ = run
    ref = ref_all[role]
    got = dict(state.bundle.role(role).named_parameters())
    assert set(ref) == set(got)
    for name, g in ref.items():
        ref_norm = np.linalg.norm(g.numpy())
        err = np.linalg.norm(got[name].grad.numpy() - g.numpy())
        assert err <= GRAD_RTOL[role] * ref_norm, (name, err / ref_norm)


def test_clipped_adamw_update_matches_optax(setup):
    """Same gradients in, same parameters out: global-norm clip 5, then the
    first AdamW update, against the JAX package's optax chain."""
    rng = np.random.default_rng(7)
    params = setup["params"]
    grads = jax.tree.map(
        lambda p: (0.05 * rng.standard_normal(p.shape)).astype(np.float32), params
    )
    tx = setup["tx"]
    updates, _ = jax.jit(tx.update)(grads, tx.init(params), params)
    new_params = jax.tree.map(lambda p, u: np.asarray(p + u), params, updates)

    state, _ = _port_state()
    for role, sd in convert.bundle_state_dicts(grads).items():
        named = dict(state.bundle.role(role).named_parameters())
        for name, g in sd.items():
            named[name].grad = g
    gnorm = TM.apply_gradients(state, state.bundle.cfg.clip_grad)
    assert float(gnorm) > 5.0  # the clip is exercised
    for role, sd in convert.bundle_state_dicts(new_params).items():
        named = dict(state.bundle.role(role).named_parameters())
        for name, v in sd.items():
            np.testing.assert_allclose(
                named[name].detach().numpy(), v.numpy(), rtol=2.4e-7, atol=1e-9,
                err_msg=f"{role}.{name}",
            )
    assert state.step == 1


@pytest.mark.parametrize("optimizer,sched", [("adamw", "step"), ("adam", "cos"), ("sgd", "step")])
def test_optimizers_and_schedules_match_optax(optimizer, sched):
    """Each optimizer and LR schedule of the JAX package's optim.py: three
    updates of a small parameter set, with an LR boundary crossed."""
    from mono_vifi_tpu.training.optim import lr_schedule as jlr_schedule
    from mono_vifi_tpu_torch.training.optim import lr_schedule, make_optimizer

    kw = dict(optimizer=optimizer, lr_sche_type=sched, learning_rate=1e-2,
              decay_step=(1,), num_epochs=2, clip_grad=0.0)
    spe = 2
    jsched = jlr_schedule(JOptions(**kw), spe)
    tsched = lr_schedule(Options(**kw), spe)
    for step in range(6):
        np.testing.assert_allclose(tsched(step), float(jsched(step)), rtol=1e-6)
    rng = np.random.default_rng(5)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    tx = jmake_optimizer(JOptions(**kw), spe)
    opt_state = tx.init(params)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    topt = make_optimizer(Options(**kw), tparams.values())
    jp = params
    for step in range(3):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        updates, opt_state = tx.update(grads, opt_state, jp)
        jp = jax.tree.map(lambda p, u: np.asarray(p + u), jp, updates)
        for g in topt.param_groups:
            g["lr"] = tsched(step)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(grads[k])
        topt.step()
    for k, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), jp[k], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode,affine", [("shared_all", False), ("separate_all", True)])
def test_sharing_modes_run(mode, affine):
    """The other two sharing modes (reference train.py:170-179) build the
    right roles and take a finite step; depth_mf aliases depth only under
    shared_all."""
    cfg = Options(**(CFG | dict(fuse_model_type=mode, use_affine=affine)))
    state = TM.create_train_state(cfg, 0, steps_per_epoch=10, device="cpu")
    b = state.bundle
    assert (b.role("depth_mf") is b.depth) == (mode == "shared_all")
    assert hasattr(b, "encoder_mf") == (mode == "separate_all")
    metrics = TM.MonoViFiStep(b, device="cpu").make_train_step()(
        state, make_batch(), torch.Generator().manual_seed(0)
    )
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert (float(metrics["loss_sadc"]) != 0.0) == affine


def test_uint8_batch_matches_dequantized_float():
    """dequantize_batch: a uint8 batch gives exactly the f32(u8)/255 values."""
    u8 = torch.randint(0, 256, (2, 5, 7, 3), dtype=torch.uint8)
    out = TM.prepare_batch({"color_0": u8, "K": torch.eye(4)[None]}, "cpu")
    assert out["color_0"].shape == (2, 3, 5, 7)
    torch.testing.assert_close(
        out["color_0"], u8.permute(0, 3, 1, 2).float() / 255.0, rtol=0, atol=0
    )
    assert out["K"].shape == (1, 4, 4)


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mono_vifi_tpu")


def _forbidden(name: str) -> bool:
    # exact module-name match: mono_vifi_tpu_torch is not mono_vifi_tpu
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_imports_no_jax_statically():
    files = sorted((ROOT / "mono_vifi_tpu_torch").rglob("*.py")) + [
        ROOT / "profile_torch_step.py", ROOT / "tests" / "test_torch_card.py",
        ROOT / "tests" / "test_torch_kernels_gpu.py",
    ]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_imports_no_jax_at_runtime():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "mono_vifi_tpu_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print('\\n'.join(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.split()
    assert "mono_vifi_tpu_torch.training.monovifi" in out
    assert not [m for m in out if _forbidden(m)]


def test_entry_points_refuse_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Options(**CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.create_train_state(cfg)
    state = TM.create_train_state(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.MonoViFiStep(state.bundle)
