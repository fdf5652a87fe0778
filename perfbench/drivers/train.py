"""Training mixes: the port's fused training step in a closed loop.

Parameters of a mix file (`traffic/<mix>.json`, "driver": "train"):
  pool           distinct uint8 batches made on the device from the seed;
                 step s takes batch s % pool
  checked_steps  steps taken in set-up through the window's own call, on
                 distinct batches, that the reference follows (3)
  trace_steps    steps of the window's end that the traced run profiles

The step is `MonoViFiStep.make_train_step()`'s `train_step`, called as
`Trainer.run_epoch` calls it: the noise generator reseeded from (seed, step)
before each step. The only synchronisations are at the window's ends.

Set-up builds the one training state and drives it through the checked
steps, reading the loss of each, the first gradient as AdamW holds it
(exp_avg / (1 - beta1) after step 1) and the parameters' change after the
last; the window continues from that state. Once the window has closed and
the peak memory is read, the state is freed and the plain reference takes
the same weights, batches and noise through the same steps, in the
configuration's precision (bf16 convolutions, f32 parameters), with cuDNN's
heuristics rather than its autotuner.
"""

from __future__ import annotations

import gc
import time

import torch

from perfbench import compare, weights
from perfbench.reference.config import Config
from perfbench.reference.training import factory as ref_factory
from perfbench.reference.training import monovifi as ref_step
from perfbench.reference.precision import operands

# KITTI eigen_zhou's training split: 39810 triplets
TRAIN_TRIPLETS = 39810


def noise_seed(seed: int, step: int) -> int:
    """The automask noise generator's seed at `step` (Trainer.noise_seed)."""
    return ((max(seed, 0) + 17) * 1_000_003 + step) % 2**63


def make_pool(seed: int, n: int, B: int, H: int, W: int, device) -> list[dict]:
    """`n` training batches of B uint8 NHWC frames of H x W in the data
    pipeline's format (mono_vifi_tpu_torch.bench.make_batch's), drawn on
    the device from `seed`, with a rotation angle per sample."""
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    K = torch.zeros((B, 4, 4), dtype=torch.float64)
    K[:, 0, 0], K[:, 1, 1] = 0.58 * W, 1.92 * H
    K[:, 0, 2], K[:, 1, 2] = 0.5 * W, 0.5 * H
    K[:, 2, 2] = K[:, 3, 3] = 1
    inv_K = torch.linalg.inv(K).float().to(device)
    K = K.float().to(device)
    w_box, h_box = round(W / 1.5), round(H / 1.5)
    keys = ("color_n1", "color_0", "color_p1", "color_aug_n1", "color_aug_0",
            "color_aug_p1", "color_affine_n1", "color_affine_0", "color_affine_p1",
            "color_affine_aug_0")
    pool = []
    for _ in range(n):
        frames = torch.randint(0, 256, (len(keys), B, H, W, 3), generator=gen,
                               device=device, dtype=torch.uint8)
        batch = dict(zip(keys, frames.unbind(0)))
        batch.update(
            K=K, inv_K=inv_K,
            Rc=torch.eye(3, device=device).expand(B, 3, 3).contiguous(),
            ratio_local=torch.full((B, 1), 1.5, device=device),
            angle=torch.rand((B,), generator=gen, device=device) * 10.0 - 5.0,
            box=torch.tensor([2, 1, w_box, h_box], dtype=torch.float32,
                             device=device).expand(B, 4).contiguous(),
            valid_mask_rec=torch.full((B, H, W, 1), 255, dtype=torch.uint8, device=device),
            valid_mask_cons=torch.full((B, H, W, 1), 255, dtype=torch.uint8, device=device),
        )
        pool.append(batch)
    return pool


def leaf_norms(named: dict[str, torch.Tensor]) -> dict[str, float]:
    """{leaf: f32 norm}, read to the host in one transfer."""
    names = list(named)
    norms = torch.stack([named[n].float().norm() for n in names]).cpu().tolist()
    return dict(zip(names, norms))


class Program:
    """The port's training state and step, built from the cell's
    configuration and the seed's weights."""

    def __init__(self, ctx):
        from mono_vifi_tpu_torch.config import Options
        from mono_vifi_tpu_torch.training import monovifi as M
        from mono_vifi_tpu_torch.training.factory import ModelBundle
        from mono_vifi_tpu_torch.training.optim import lr_schedule, make_optimizer

        ctx.phase("import")
        if ctx.device.type == "cuda":
            from mono_vifi_tpu_torch.ops.cuda import build

            build.load()
        ctx.phase("kernel_library")
        # cuDNN's autotuner on, as the training entry turns it on (train.run)
        torch.backends.cudnn.benchmark = True
        self.ctx = ctx
        opts = Options(**ctx.cell.config["options"], device=str(ctx.device))
        self.B, self.H, self.W = opts.batch_size, opts.height, opts.width
        self.w0 = initial_weights(ctx)
        ctx.phase("weights_drawn")
        with torch.device(ctx.device):
            bundle = ModelBundle(opts)
        weights.load(bundle, self.w0)
        ctx.phase("model_build")
        self.trainable = {n: p for n, p in bundle.named_parameters() if p.requires_grad}
        params = list(self.trainable.values())
        self.state = M.TrainState(
            step=0, bundle=bundle, optimizer=make_optimizer(opts, params),
            schedule=lr_schedule(opts, TRAIN_TRIPLETS // self.B), params=params)
        self.train_step = M.MonoViFiStep(bundle, device=ctx.device).make_train_step()
        self.pool = make_pool(ctx.seed, ctx.cell.traffic["pool"], self.B, self.H, self.W,
                              ctx.device)
        self.gen = torch.Generator(device=ctx.device)
        self.losses = []
        self.beta1 = opts.beta1
        ctx.phase("optimizer_and_batches")

    def step(self):
        """One step through the window's call; its loss is kept on the device."""
        s = self.state.step
        self.gen.manual_seed(noise_seed(self.ctx.seed, s))
        with self.ctx.spans.span("step_call"):
            metrics = self.train_step(self.state, self.pool[s % len(self.pool)], self.gen)
        self.losses.append(metrics["loss"])

    def checked_steps(self, n: int) -> dict:
        """Set-up: `n` steps through the window's call, with the readings the
        reference is compared on."""
        self.step()
        opt = self.state.optimizer
        # a leaf the update has not reached holds no moment: no gradient
        none = torch.zeros((), device=self.ctx.device)
        grad = leaf_norms({k: opt.state[p].get("exp_avg", none) / (1 - self.beta1)
                           for k, p in self.trainable.items()})
        self.ctx.sync()
        self.ctx.phase("first_step")
        for _ in range(n - 1):
            self.step()
        change = leaf_norms({k: p.detach() - self.w0[k] for k, p in self.trainable.items()})
        losses = torch.stack(self.losses).cpu().tolist()
        self.losses.clear()
        del self.w0
        self.ctx.phase("checked_steps")
        return {"losses": losses, "grad": grad, "change": change}

    def free(self):
        del self.state, self.train_step, self.trainable
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()


def reference_config(ctx) -> Config:
    return Config.from_keys(ctx.cell.config["options"])


def initial_weights(ctx) -> dict:
    """The seed's weights, named and shaped by the reference's modules."""
    with torch.device("meta"):
        shape = ref_factory.ModelBundle(reference_config(ctx))
    return weights.draw(shape, ctx.seed, ctx.device)


def reference_readings(ctx, pool, n: int, precision: str = "float32") -> dict:
    """The plain reference through the same `n` steps from the same
    weights, batches and noise, its convolutions and matrix products in the
    configuration's dtype or, with `precision` "float8", one below; -> the
    readings Program.checked_steps gives, and the
    reference's first gradient (`grad`) as the update took it."""
    cfg = reference_config(ctx)
    with torch.device(ctx.device):
        bundle = ref_factory.ModelBundle(cfg)
    w0 = weights.draw(bundle, ctx.seed, ctx.device)
    # the window is over: cuDNN's heuristics, not its autotuner, for f32
    torch.backends.cudnn.benchmark = False
    weights.load(bundle, w0)
    trainable = {k: p for k, p in bundle.named_parameters() if p.requires_grad}
    opt = ref_step.AdamW(trainable.values(), cfg)
    step = ref_step.MonoViFiStep(bundle)
    gen = torch.Generator(device=ctx.device)
    losses, grad = [], None
    with operands(precision):
        for s in range(n):
            gen.manual_seed(noise_seed(ctx.seed, s))
            metrics, grads = ref_step.train_step(step, opt, pool[s % len(pool)],
                                                 cfg.learning_rate, gen)
            losses.append(metrics["loss"])
            if s == 0:
                grad = leaf_norms(dict(zip(trainable, grads)))
    change = leaf_norms({k: p.detach() - w0[k] for k, p in trainable.items()})
    return {"losses": torch.stack(losses).cpu().tolist(), "grad": grad, "change": change}


def readings(prog: dict, ref: dict) -> dict[str, float]:
    """The compared numbers: the first step's loss (relative gap), the
    worst leaf's gap of the first gradient's norm, and the worst leaf's gap
    of the parameters' change over the checked steps, leaves that the
    reference's first gradient leaves unmoved left out. The later steps'
    losses (`_loss_gaps`) and the worst leaves' names are printed beside
    them."""
    loss_gaps = [compare.rel_gap(a, b) for a, b in zip(prog["losses"], ref["losses"])]
    grad, grad_leaf = compare.worst_leaf_gap(prog["grad"], ref["grad"])
    change, change_leaf = compare.worst_leaf_gap(
        prog["change"], ref["change"], compare.moved_leaves(ref["grad"]))
    return {"loss_gap_first": loss_gaps[0], "grad_gap": grad, "change_gap": change,
            "_loss_gaps": loss_gaps, "_grad_leaf": grad_leaf, "_change_leaf": change_leaf}


def run(ctx):
    """One run of the cell: set-up, the window, then the comparison."""
    prog = Program(ctx)
    mix = ctx.cell.traffic
    n_checked = mix["checked_steps"]
    checked = prog.checked_steps(n_checked)
    window = ctx.window(prog.step, mix["trace_steps"])
    losses = torch.stack(prog.losses).float()
    failed = int((~torch.isfinite(losses)).sum())
    ctx.read_memory_peak()
    closed = time.perf_counter()
    prog.free()
    pool = prog.pool
    del prog
    ref = reference_readings(ctx, pool, n_checked)
    return {
        "attempted": window.items, "failed": failed,
        "end_to_end": {"train_samples_per_s": window.timed_items * len(pool[0]["K"])
                       / window.timed_seconds},
        "readings": readings(checked, ref),
        "window": window,
        "check_s": time.perf_counter() - closed,
    }


def flops_per_item(cell) -> float:
    from perfbench.counts import flops

    return flops.train_step(cell.config["options"])


def calibration(ctx) -> dict[str, dict]:
    """The compared numbers of one seed for the program as the window runs
    it, for the control (the reference with float8 operands in the
    program's place) and for a planted fault (the program's step on half
    of each batch, its mean taken over that half); -> {name: readings}."""
    n = ctx.cell.traffic["checked_steps"]
    prog = Program(ctx)
    checked = prog.checked_steps(n)
    prog.free()
    half = Program(ctx)
    step, B = half.train_step, half.B

    def half_batch(state, batch, generator=None, noise=None):
        return step(state, {k: v[:B // 2] for k, v in batch.items()}, generator, noise)

    half.train_step = half_batch
    checked_half = half.checked_steps(n)
    half.free()
    pool = half.pool
    del prog, half
    ref = reference_readings(ctx, pool, n)
    control = reference_readings(ctx, pool, n, precision="float8")
    sides = {"program": checked, "control": control, "half_batch": checked_half,
             "reference": ref}
    return {"program": readings(checked, ref), "control": readings(control, ref),
            "half_batch": readings(checked_half, ref),
            "_leaves": {k: {"grad": v["grad"], "change": v["change"]} for k, v in sides.items()}}
