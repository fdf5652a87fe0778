"""Multi-card training of the port (mono_vifi_tpu_torch.parallel) on the CPU,
against the port at the global batch and the JAX package on a 2-device
`data` mesh. Each rank is a process of this file,

    python tests/test_torch_parallel.py <case> <rank> <world> <init_file> <job_dir>

joined in a gloo process group through a file rendezvous (or, for the
`torchrun` case, through the env rendezvous), as tests/test_multihost.py
starts the JAX package's processes. Rank r takes rows r*b:(r+1)*b of the
global batch, and the global random draws cut to its rows. Each rank has
RANK_TIMEOUT seconds; a rank that fails or outlives it fails the test, with
every rank's output. tests/test_torch_parallel_train.py and
tests/test_torch_parallel_launch.py run the other cases (LiteMono, VFI, the
trainers, the command line).

Tolerances (f32, CPU):
  - the global BatchNorm against the port's and the JAX package's
    BatchNorm on the whole batch: rtol 1e-5 and atol 1e-5 (f32 sums of
    140 products a channel, taken in another order; its variance is
    E[x^2] - E[x]^2, the port's one-card one is two-pass);
  - the ResNet18 step (64x96, global batch 2, tiny VFI, affine,
    shared_encoder) takes one SGD step at learning rate 1, so each
    parameter moves by its clipped gradient: against the port at the
    global batch, loss terms and gradient norm rtol 1e-5, each gradient
    leaf 1e-3 of its norm (BatchNorm backward at batch 2 amplifies the
    variance's rounding), running statistics atol 1e-6; against the JAX
    step, the tolerances of tests/test_torch_step.py (loss terms rtol
    1e-4, gradient leaves GRAD_RTOL, statistics atol 1e-5) and the
    gradient norm rtol 1e-3;
  - the ranks against each other: equal, bit for bit (the all-reduced
    gradients are the same on both, and so is every update).
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import socket
import subprocess
import sys
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))

from mono_vifi_tpu_torch import convert, parallel  # noqa: E402
from mono_vifi_tpu_torch.config import Options  # noqa: E402
from mono_vifi_tpu_torch.models.common import BatchNorm2d  # noqa: E402
from mono_vifi_tpu_torch.training import monovifi as TM  # noqa: E402

RANK_TIMEOUT = 120  # seconds a rank may take
TERMS = ("loss", "loss_base", "loss_dc", "loss_sadc")
STEP_GRAD_RTOL = 1e-3


@contextlib.contextmanager
def torch_default_init():
    """Build the port's bundles and VFI states with torch's default
    initializers, the port's random init before it took the JAX package's
    rule (mono_vifi_tpu_torch.models.init): the weights on which the
    parity tests here and in tests/test_torch_{backbones,backbones_step,
    step,remat}.py set their tolerances. From the JAX
    rule's init a few of them miss by 1-2x, different ones for different
    draws: there some leaves are ill-conditioned in f32, and the JAX
    package's jitted step disagrees with its own op-by-op run, and with
    another compilation of itself, as far as the port disagrees with it
    (tests/test_torch_step_init.py, which holds the step from the port's
    init); and D-HRNet's disparities saturate in both packages
    (tests/test_torch_init_dhrnet.py). The init itself is held to the JAX
    package's in tests/test_torch_init*.py. Defined here because this
    file's ranks import no JAX."""
    from mono_vifi_tpu_torch.training import factory, vfi

    with pytest.MonkeyPatch.context() as mp:
        for module in (factory, vfi):
            mp.setattr(module, "init_like_jax_", lambda m: m)
        yield


# ------------------------------------------------------------------ the ranks

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(case: str, job: dict, job_dir: pathlib.Path, world: int = 2,
                torchrun: bool = False) -> tuple:
    """Start `world` ranks of `case` on `job`. With `torchrun` the ranks get
    the env rendezvous (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT) instead of a file."""
    torch.save(job, job_dir / "job.pt")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    port = free_port()
    procs = []
    for r in range(world):
        renv = dict(env)
        if torchrun:
            renv.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, case, str(r), str(world),
             str(job_dir / "rendezvous"), str(job_dir)],
            cwd=ROOT, env=renv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return case, procs, job_dir


def wait_ranks(started) -> list[dict]:
    """Wait for the ranks -> each rank's output; fail with every rank's
    output if one failed or outlived RANK_TIMEOUT."""
    case, procs, job_dir = started
    outs = []
    try:
        for p in procs:
            try:
                out, _ = p.communicate(timeout=RANK_TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                out = p.communicate()[0] + f"\n[killed after {RANK_TIMEOUT} s]"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        pytest.fail(f"ranks of {case!r} failed (rc {[p.returncode for p in procs]}):\n"
                    + "\n".join(f"--- rank {r}:\n{o}" for r, o in enumerate(outs)))
    return [torch.load(job_dir / f"out_{r}.pt", weights_only=False)
            for r in range(len(procs))]


def run_ranks(case: str, job: dict, job_dir: pathlib.Path, world: int = 2,
              torchrun: bool = False) -> list[dict]:
    return wait_ranks(start_ranks(case, job, job_dir, world, torchrun))


def rows(x, rank: int, b: int):
    return x[rank * b:(rank + 1) * b]


def local_batch(batch: dict, rank: int, b: int) -> dict:
    return {k: rows(v, rank, b) for k, v in batch.items()}


def step_record(state, metrics) -> dict:
    """What a rank's step leaves: its metrics, each trainable parameter's
    gradient (all-reduced and clipped) and value, and every BatchNorm
    buffer."""
    b = state.bundle
    return {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": {f"{r}.{n}": p.grad.clone() for r, m in b.trainable_roles().items()
                  for n, p in m.named_parameters()},
        "params": {f"{r}.{n}": p.detach().clone() for r, m in b.trainable_roles().items()
                   for n, p in m.named_parameters()},
        "stats": {f"{r}.{n}": t.clone() for r, m in b.trainable_roles().items()
                  for n, t in m.named_buffers()},
    }


def depth_step(cfg: dict, batch: dict, noise: dict, b: int) -> dict:
    """One train step of a fresh state from seed 0 on this rank's rows of
    `batch` and of the global draws `noise` (all of them without a process
    group), with torch's default init (`torch_default_init`)."""
    with torch_default_init():
        state = TM.create_train_state(Options(**cfg), 0, steps_per_epoch=10, device="cpu")
    step = TM.MonoViFiStep(state.bundle, device="cpu")
    noise = step.local_noise({k: torch.as_tensor(v) for k, v in noise.items()}, b)
    metrics = step.make_train_step()(state, local_batch(batch, step.rank, b), noise=noise)
    return step_record(state, metrics)


def assert_step_close(got: dict, ref: dict, terms=TERMS, grad_rtol=STEP_GRAD_RTOL,
                      stats_atol=1e-6):
    for k in terms + ("grad_norm",):
        np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k], rtol=1e-5, err_msg=k)
    assert set(got["grads"]) == set(ref["grads"])
    for k, g in ref["grads"].items():
        err = torch.linalg.vector_norm(got["grads"][k] - g)
        assert err <= grad_rtol * torch.linalg.vector_norm(g) + 1e-12, (k, float(err))
        # the update is the optimizer's on those gradients (one SGD step at
        # learning rate 1 moves each parameter by its gradient)
        err = torch.linalg.vector_norm(got["params"][k] - ref["params"][k])
        assert err <= grad_rtol * torch.linalg.vector_norm(ref["params"][k]), k
    for k, v in ref["stats"].items():
        if k.endswith("num_batches_tracked"):
            assert torch.equal(got["stats"][k], v), k
        else:
            torch.testing.assert_close(got["stats"][k], v, rtol=0, atol=stats_atol,
                                       msg=lambda m, k=k: f"{k}: {m}")


def assert_ranks_equal(outs: list[dict]):
    for key in ("grads", "params", "stats"):
        for k, v in outs[0][key].items():
            assert all(torch.equal(o[key][k], v) for o in outs[1:]), (key, k)
    assert all(o["metrics"] == outs[0]["metrics"] for o in outs[1:])


# ---------------------------------------------------- 1. global BatchNorm

def _bn_case(job, rank, world):
    b = job["x"].shape[0] // world
    bn = BatchNorm2d(job["x"].shape[1])
    bn.load_state_dict(job["state"])
    x = rows(job["x"], rank, b).clone().requires_grad_(True)
    y = bn(x)
    (y * rows(job["dy"], rank, b)).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
            "state": bn.state_dict()}


@pytest.fixture(scope="module")
def bn_job():
    g = torch.Generator().manual_seed(0)
    C = 6
    x = torch.randn((4, C, 5, 7), generator=g) * torch.linspace(0.5, 3.0, C).view(1, C, 1, 1) \
        + torch.linspace(-1.0, 2.0, C).view(1, C, 1, 1)
    bn = BatchNorm2d(C)
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, C))
        bn.bias.copy_(torch.linspace(-0.2, 0.3, C))
        bn.running_mean.copy_(torch.linspace(0.1, 0.2, C))
        bn.running_var.copy_(torch.linspace(0.8, 1.3, C))
    return {"x": x, "dy": torch.randn(x.shape, generator=g), "state": bn.state_dict()}


def test_global_batchnorm_over_two_ranks(bn_job, tmp_path):
    """Two ranks, half the batch each: the outputs, the input gradient and
    the running statistics of the whole batch on every rank; the weight and
    bias gradients summed over the ranks (the loss here is the sum of the
    ranks' sums) are the whole batch's."""
    import jax
    import jax.numpy as jnp

    from mono_vifi_tpu.models.common import batch_norm

    outs = run_ranks("bn", bn_job, tmp_path)
    x, dy, sd = bn_job["x"], bn_job["dy"], bn_job["state"]

    bn = BatchNorm2d(x.shape[1])
    bn.load_state_dict(sd)
    xg = x.clone().requires_grad_(True)
    y = bn(xg)
    (y * dy).sum().backward()
    port = {"y": y.detach(), "dx": xg.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
            "mean": bn.running_mean, "var": bn.running_var}

    module = batch_norm(True, "bn")
    variables = {"params": {"scale": jnp.asarray(sd["weight"].numpy()),
                            "bias": jnp.asarray(sd["bias"].numpy())},
                 "batch_stats": {"mean": jnp.asarray(sd["running_mean"].numpy()),
                                 "var": jnp.asarray(sd["running_var"].numpy())}}
    xj = jnp.asarray(x.permute(0, 2, 3, 1).numpy())

    def f(params, xx):
        return module.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx,
                            mutable=["batch_stats"])

    yj, new = f(variables["params"], xj)
    _, vjp = jax.vjp(lambda p, xx: f(p, xx)[0], variables["params"], xj)
    gp, gx = vjp(jnp.asarray(dy.permute(0, 2, 3, 1).numpy()))
    def tensor(a, nhwc=False):
        a = np.array(a)
        return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)) if nhwc else a)

    jax_ref = {"y": tensor(yj, True), "dx": tensor(gx, True), "dw": tensor(gp["scale"]),
               "db": tensor(gp["bias"]), "mean": tensor(new["batch_stats"]["mean"]),
               "var": tensor(new["batch_stats"]["var"])}

    got = {"y": torch.cat([o["y"] for o in outs]), "dx": torch.cat([o["dx"] for o in outs]),
           "dw": sum(o["dw"] for o in outs), "db": sum(o["db"] for o in outs),
           "mean": outs[0]["state"]["running_mean"], "var": outs[0]["state"]["running_var"]}
    for ref in (port, jax_ref):
        for k, v in ref.items():
            torch.testing.assert_close(got[k], v, rtol=1e-5, atol=1e-5,
                                       msg=lambda m, k=k: f"{k}: {m}")
    for k, v in outs[0]["state"].items():
        assert torch.equal(outs[1]["state"][k], v), k
    assert int(outs[0]["state"]["num_batches_tracked"]) == 1


# ------------------------------------------------- 2. the ResNet18 step

def _depth_step_case(job, rank, world):
    return depth_step(job["cfg"], job["batch"], job["noise"], job["b"])


@pytest.fixture(scope="module")
def resnet18(tmp_path_factory):
    """One SGD step at learning rate 1 (each parameter moves by its clipped
    gradient) of the ResNet18 step: on 2 ranks, on the port at the global
    batch, and of the JAX package's make_train_step jitted over a 2-device
    `data` mesh (as __graft_entry__.dryrun_multichip lays it out), from the
    same weights, batch and automask noise."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from mono_vifi_tpu import convert as jconvert
    from mono_vifi_tpu.config import Options as JOptions
    from mono_vifi_tpu.training import monovifi as JM
    from mono_vifi_tpu.training.optim import make_optimizer as jmake_optimizer
    from tests.test_torch_backbones import jax_trees, np_sd
    from tests.test_torch_step import CFG, B, H, W, make_batch

    cfg = CFG | {"optimizer": "sgd", "learning_rate": 1.0}
    batch = make_batch()
    rng = jax.random.PRNGKey(2)
    r_n1, r_n2, _, _ = jax.random.split(rng, 4)
    noise = {"n1": np.asarray(jax.random.normal(r_n1, (2, 6 * B, H, W))),
             "n2": np.asarray(jax.random.normal(r_n2, (2, 3 * B, H, W)))}
    job = {"cfg": cfg | {"batch_size": B // 2}, "batch": batch, "noise": noise, "b": B // 2}
    ranks = start_ranks("depth_step", job, tmp_path_factory.mktemp("resnet18"))

    with torch_default_init():
        state = TM.create_train_state(Options(**cfg), 0, steps_per_epoch=10, device="cpu")
    params, bstats = jax_trees("ResNet18", state.bundle)
    vfi = jconvert.convert_ifrnet(np_sd(state.bundle.vfi_train))["params"]
    jcfg = JOptions(**cfg, vfi_test_scale="tiny")
    tx = jmake_optimizer(jcfg, 10)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    repl, data = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    jstate = jax.device_put(JM.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                          batch_stats=bstats, opt_state=tx.init(params)), repl)
    jstep = jax.jit(JM.MonoViFiStep(JM.ModelBundle(jcfg), tx).make_train_step())
    new, metrics = jstep(jstate, jax.device_put(vfi, repl),
                         jax.device_put({k: jnp.asarray(v) for k, v in batch.items()}, data), rng)
    p0 = convert.bundle_state_dicts(params, bstats)
    p1 = convert.bundle_state_dicts(jax.tree.map(np.asarray, new.params),
                                    jax.tree.map(np.asarray, new.batch_stats))
    stats = ("running_mean", "running_var", "num_batches_tracked")
    jax_ref = {"metrics": {k: float(v) for k, v in metrics.items()},
               "grads": {f"{r}.{k}": p0[r][k] - v for r in p1 for k, v in p1[r].items()
                         if not k.endswith(stats)},
               "stats": {f"{r}.{k}": v for r in p1 for k, v in p1[r].items()
                         if k.endswith(stats[:2])}}
    ref = depth_step(cfg, batch, noise, B)
    return wait_ranks(ranks), ref, jax_ref


def test_resnet18_step_ranks_agree(resnet18):
    assert_ranks_equal(resnet18[0])


def test_resnet18_step_equals_the_global_batch_step(resnet18):
    outs, ref, _ = resnet18
    assert_step_close(outs[0], ref)


def test_resnet18_step_equals_the_jax_step_on_a_data_mesh(resnet18):
    from tests.test_torch_step import GRAD_RTOL

    got, _, ref = resnet18[0][0], resnet18[1], resnet18[2]
    for k in TERMS:
        np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k], rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["metrics"]["grad_norm"], ref["metrics"]["grad_norm"],
                               rtol=1e-3)
    checked = set()
    for k, g in ref["grads"].items():
        role = k.split(".", 1)[0]
        err = torch.linalg.vector_norm(got["grads"][k] - g)
        assert err <= GRAD_RTOL[role] * torch.linalg.vector_norm(g), (k, float(err))
        checked.add(role)
    assert checked == set(GRAD_RTOL)
    for k, v in ref["stats"].items():
        torch.testing.assert_close(got["stats"][k], v, rtol=0, atol=1e-5,
                                   msg=lambda m, k=k: f"{k}: {m}")


# ------------------------------- 3. one card: no process group, no collective

def test_one_card_steps_make_no_collective(monkeypatch):
    """Without `distributed` and with one rank, no process group exists and
    neither step nor the BatchNorm calls a collective."""
    from mono_vifi_tpu_torch.training import vfi as TV

    def refuse(*args, **kwargs):
        raise AssertionError("a collective ran on the one-card path")

    for name in ("all_reduce", "broadcast", "barrier", "init_process_group"):
        monkeypatch.setattr(dist, name, refuse)
    cfg = Options(height=64, width=96, batch_size=2, use_affine=True, compute_dtype="float32",
                  vfi_train_scale="tiny", device="cpu", weights_init="scratch")
    assert parallel.init_distributed(cfg) == (0, 1)
    assert not parallel.active()
    from tests.test_torch_step import make_batch

    state = TM.create_train_state(cfg, 0, steps_per_epoch=10, device="cpu")
    metrics = TM.MonoViFiStep(state.bundle, device="cpu").make_train_step()(
        state, make_batch(), torch.Generator().manual_seed(0))
    assert np.isfinite(float(metrics["loss"]))
    vcfg = Options(height=64, width=96, vfi_scale="tiny", compute_dtype="float32")
    vstate = TV.create_vfi_state(vcfg, 0, steps_per_epoch=5, device="cpu")
    rng = np.random.default_rng(0)
    vbatch = {k: rng.random((2, 64, 96, 3), dtype=np.float32) for k in ("img0", "img1", "img2")}
    vbatch["embt"] = np.full((2,), 0.5, np.float32)
    vmetrics, _ = TV.make_vfi_train_step(5.0)(vstate, vbatch)
    assert np.isfinite(float(vmetrics["psnr"]))


# ------------------------------------------------------------------ a rank

CASES = {"bn": _bn_case, "depth_step": _depth_step_case}


def _rank_main(case: str, rank: int, world: int, init_file: str, job_dir: str) -> None:
    """One rank: join the group (unless the case starts from the env
    rendezvous), run the case, save its output."""
    from tests import test_torch_parallel_launch, test_torch_parallel_train

    cases = CASES | test_torch_parallel_train.CASES | test_torch_parallel_launch.CASES
    torch.set_num_threads(1)
    job = torch.load(os.path.join(job_dir, "job.pt"), weights_only=False)
    own_group = case not in test_torch_parallel_launch.ENV_CASES
    if own_group:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=RANK_TIMEOUT))
    try:
        out = cases[case](job, rank, world)
    finally:
        if own_group:
            dist.destroy_process_group()
    torch.save(out, os.path.join(job_dir, f"out_{rank}.pt"))


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
