"""The port's convergence smoke on the CPU: its synthetic scene
(mono_vifi_tpu_torch.synthetic_scene) equals tests/synthetic_scene.py bit
for bit, with and without the affine keys, as does the median-scaled
abs_rel; `convergence_smoke.run` returns the JAX tool's keys
(tools/convergence_smoke.py), and its entry point prints the JSON line
`python -m mono_vifi_tpu_torch.convergence_smoke` prints, on the CPU when
asked and raising without a card otherwise. Whether the loss falls is the
card's check (tests/test_torch_card.py) and tests/test_torch_train.py's at 40
CPU steps."""

import argparse
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mono_vifi_tpu_torch import convergence_smoke as C  # noqa: E402
from mono_vifi_tpu_torch import synthetic_scene as S  # noqa: E402
from tests import synthetic_scene as ref_scene  # noqa: E402

# the keys of tools/convergence_smoke.py's `run`, and with use_affine the SADC pair
JAX_KEYS = {"steps", "fast_warp", "compute_dtype", "use_affine", "loss_first10",
            "loss_last10", "abs_rel_initial", "abs_rel_final"}
AFFINE_KEYS = {"sadc_first10", "sadc_last10"}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs files in parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("affine", [False, True], ids=["plain", "affine"])
@pytest.mark.parametrize("size", [(2, 64, 96), (2, 96, 320)], ids=["64x96", "96x320"])
def test_scene_batch_equals_the_test_copy(size, affine):
    got, depth = S.make_scene_batch(*size, affine=affine)
    ref, ref_depth = ref_scene.make_scene_batch(*size, affine=affine)
    np.testing.assert_array_equal(depth, ref_depth)
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_median_scaled_abs_rel_equals_the_test_copy():
    rng = np.random.default_rng(0)
    pred = rng.uniform(0.5, 3.0, (3, 16, 24)).astype(np.float32)
    gt = rng.uniform(5.0, 60.0, (3, 16, 24)).astype(np.float32)
    assert S.median_scaled_abs_rel(pred, gt) == ref_scene.median_scaled_abs_rel(pred, gt)


def test_run_returns_the_jax_tools_keys_with_affine():
    out = C.run(steps=2, H=64, W=96, B=2, compute_dtype="float32", use_affine=True,
                fuse_model_type="shared_encoder", device="cpu")
    assert out.keys() == JAX_KEYS | AFFINE_KEYS
    assert (out["steps"], out["compute_dtype"], out["use_affine"]) == (2, "float32", True)
    assert all(math.isfinite(out[k]) for k in JAX_KEYS | AFFINE_KEYS
               if k not in ("steps", "fast_warp", "compute_dtype", "use_affine"))


def test_main_prints_the_json_line_on_the_cpu(capsys):
    C.main(["--steps", "2", "--size", "64x96", "--dtype", "float32", "--log-every", "1",
            "--device", "cpu"])
    captured = capsys.readouterr()
    out = json.loads(captured.out.strip().splitlines()[-1])
    assert out.pop("metric") == "convergence_smoke"
    assert out.keys() == JAX_KEYS
    assert out["use_affine"] is False and out["steps"] == 2
    assert "step 2: loss_base" in captured.err
    assert out["abs_rel_initial"] > 0 and out["abs_rel_final"] > 0


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        C.main(["--steps", "1"])


def jax_and_port_trajectories(steps: int, H: int, W: int, every: int, B: int = 2) -> dict:
    """tools/convergence_smoke.py's run in f32 (its init from seed 0, the
    VFI's from seed 1, fast_warp off: the port's arithmetic) with a row
    every `every` steps, and `convergence_smoke.run` from the same weights,
    carried over by the port's converter, on the same scene."""
    import jax
    import jax.numpy as jnp

    from mono_vifi_tpu.config import Options as JOptions
    from mono_vifi_tpu.ops.geometry import disp_to_depth
    from mono_vifi_tpu.training import monovifi as JM
    from mono_vifi_tpu.training.optim import make_optimizer
    from mono_vifi_tpu_torch import convert

    cfg = JOptions(height=H, width=W, batch_size=B, compute_dtype="float32", fast_warp=False,
                   fuse_model_type="shared_all", vfi_train_scale="tiny",
                   vfi_test_scale="tiny", learning_rate=2e-4, lr_sche_type="step",
                   decay_step=(10**6,), weights_init="scratch")
    # create_train_state's init, jitted (the same values as eager, faster)
    bundle = JM.ModelBundle(cfg)
    params, bstats = jax.jit(bundle.init_variables)(jax.random.PRNGKey(0))
    tx = make_optimizer(cfg, steps)
    state = JM.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=bstats,
                          opt_state=tx.init(params))
    vfi = jax.jit(lambda k: bundle.init_vfi(k, "train"))(jax.random.PRNGKey(1))
    init = [jax.tree.map(lambda a: np.array(a, copy=True), t)
            for t in (state.params, state.batch_stats, vfi)]
    np_batch, gt = ref_scene.make_scene_batch(B, H, W)
    batch = {k: jnp.asarray(v) for k, v in np_batch.items()}
    step_fn = jax.jit(JM.MonoViFiStep(bundle, tx).make_train_step(), donate_argnums=0)
    sf_disp = jax.jit(lambda p, bs: JM.single_frame_disp(bundle, p, bs, batch["color_0"]))

    def row(step, state):
        disp = np.asarray(sf_disp(state.params, state.batch_stats))
        depth = np.asarray(disp_to_depth(disp, cfg.min_depth, cfg.max_depth)[1])
        return [step, ref_scene.median_scaled_abs_rel(depth[..., 0], gt),
                float(disp.min()), float(disp.max())]

    rng = jax.random.PRNGKey(7)
    rows, losses = [row(0, state) + [None]], []
    for i in range(steps):
        state, metrics = step_fn(state, vfi, batch, jax.random.fold_in(rng, i))
        losses.append(float(metrics["loss_base"]))
        if (i + 1) % every == 0:
            rows.append(row(i + 1, state) + [float(np.mean(losses[-every:]))])
    port = C.run(steps=steps, H=H, W=W, B=B, compute_dtype="float32", trace_every=every,
                 device="cpu",
                 init=lambda b: convert.load_into_bundle(b, init[0], init[1], vfi_params=init[2]))
    k = max(steps // 10, 1)
    return {"steps": steps, "size": f"{H}x{W}", "batch": B,
            "jax": {"loss_first10": float(np.mean(losses[:k])) if steps else None,
                    "loss_last10": float(np.mean(losses[-k:])) if steps else None,
                    "trace": rows},
            "port": {"loss_first10": port["loss_first10"],
                     "loss_last10": port["loss_last10"], "trace": port["trace"]}}


def test_jax_and_port_start_from_the_same_depth():
    """From the JAX init carried into the port, both packages see the same
    depth before any step: abs_rel and the disparity's range agree to the
    f32 arithmetic of one forward (the long run's first row)."""
    got = jax_and_port_trajectories(steps=0, H=64, W=96, every=1)
    (j0,), (p0,) = got["jax"]["trace"], got["port"]["trace"]
    assert p0[0] == j0[0] == 0
    np.testing.assert_allclose(p0[1:4], j0[1:4], rtol=1e-4)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="JAX vs port convergence trajectories (f32, CPU)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--size", default="96x320")
    ap.add_argument("--every", type=int, default=25)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    H, W = (int(v) for v in args.size.split("x"))
    print(json.dumps(jax_and_port_trajectories(args.steps, H, W, args.every)))
