"""VFI training mixes: the port's IFRNet training step in a closed loop, the
first stage of every Mono-ViFI job.

Parameters of a mix file (`traffic/<mix>.json`, "driver": "train_vfi"):
  pool           distinct batches of triplets; step s takes batch s % pool
  checked_steps  steps taken in set-up through the window's own call, on
                 distinct batches, that the reference follows (3)
  trace_steps    steps of the window's end that the traced run profiles

The batches come from the seed's panning video (`drivers/video.py`
`make_video`, 8 px a frame): triplet k of the pool is frames k, k + 1,
k + 2, uploaded once, each cut on the device at its own crop of min(160, H)
x min(576, W), drawn from the seed as the KITTI VFI dataset draws its
training crop. A batch is what `device_prefetch` hands the VFI trainer:
NHWC f32 `img0`, `img1` (the middle frame), `img2` in [0, 1] and `embt`
0.5 of shape (B,).

The state is `training/vfi.py` `create_vfi_state` with the seed's weights
loaded over its own init, and the step `make_vfi_train_step(clip_grad)`,
both as `VFITrainer` builds and calls them. The only synchronisations are
at the window's ends. Set-up drives the state through the checked steps and
reads what the train driver reads, and the port's launches a step by kernel
and shape (`_launches_per_step`, printed beside the checks: the image warp's
two kernels; the decoders' feature warps run plain and launch nothing); once
the window has closed and the peak
memory is read, the state is freed and the plain reference
(`reference/training/vfi.py`) takes the same weights, batches and learning
rates through the same steps, in the configuration's precision (bf16
convolutions, f32 parameters), with cuDNN's heuristics rather than its
autotuner.
"""

from __future__ import annotations

import collections
import random
import time

import numpy as np
import torch

from perfbench import weights
from perfbench.counts.vfi import crop_hw
from perfbench.drivers import train
from perfbench.drivers.train import TRAIN_TRIPLETS, leaf_norms, readings
from perfbench.drivers.video import make_video
from perfbench.reference.config import Config
from perfbench.reference.models.ifrnet import IFRNet
from perfbench.reference.precision import operands
from perfbench.reference.training import vfi as ref_vfi
from perfbench.reference.training.monovifi import AdamW

PAN_PX = 8  # pixels the camera pans between frames


def make_pool(seed: int, n: int, B: int, H: int, W: int, crop, device) -> list[dict]:
    """`n` batches of B triplets of the seed's H x W video, each triplet at
    its own `crop` (h, w), cut on `device`."""
    frames = make_video(seed, n * B + 2, H, W, PAN_PX)
    video = torch.from_numpy(np.stack(frames)).to(device)
    rng = random.Random(seed)
    h, w = crop
    pool = []
    for i in range(n):
        cuts = [[], [], []]
        for k in range(i * B, (i + 1) * B):
            x, y = rng.randint(0, H - h), rng.randint(0, W - w)
            for t in range(3):
                cuts[t].append(video[k + t, x:x + h, y:y + w])
        batch = {f"img{t}": torch.stack(cuts[t]).contiguous() for t in range(3)}
        batch["embt"] = torch.full((B,), 0.5, device=device)
        pool.append(batch)
    return pool


def reference_config(ctx) -> Config:
    return Config.from_keys(ctx.cell.config["options"])


def reference_module(ctx, device) -> IFRNet:
    opts = ctx.cell.config["options"]
    dtype = getattr(torch, reference_config(ctx).compute_dtype)
    with torch.device(device):
        return IFRNet(opts["vfi_scale"], dtype)


def initial_weights(ctx) -> dict:
    """The seed's weights, named and shaped by the reference's IFRNet."""
    return weights.draw(reference_module(ctx, "meta"), ctx.seed, ctx.device)


def launch_shapes() -> collections.Counter:
    """A copy of the port's launches by kernel and first argument's shape."""
    from mono_vifi_tpu_torch.ops.cuda import LAUNCH_SHAPES

    return collections.Counter(LAUNCH_SHAPES)


def launches_per_step(before: collections.Counter, after: collections.Counter,
                      n: int) -> dict[str, float]:
    """The port's launches a step over `n` steps, by kernel and shape: the
    image warp's `bilinear_sample` and `bilinear_sample_bwd` at (2B, 3, h,
    w); a decoder's feature warp, were it to launch, at (2B, C, h', w')."""
    return {f"{k} {'x'.join(map(str, shape))}": c / n
            for (k, shape), c in (after - before).items()}


class Program(train.Program):
    """The port's VFI training state and step, built from the cell's
    configuration and the seed's weights; the checked steps and `free` are
    the train driver's."""

    def __init__(self, ctx):
        from mono_vifi_tpu_torch.config import Options
        from mono_vifi_tpu_torch.training.vfi import create_vfi_state, make_vfi_train_step

        ctx.phase("import")
        if ctx.device.type == "cuda":
            from mono_vifi_tpu_torch.ops.cuda import build

            build.load()
        ctx.phase("kernel_library")
        # cuDNN's autotuner on, as the VFI training entry turns it on
        torch.backends.cudnn.benchmark = True
        self.ctx = ctx
        opts = Options(**ctx.cell.config["options"], device=str(ctx.device))
        self.B = opts.batch_size
        self.w0 = initial_weights(ctx)
        ctx.phase("weights_drawn")
        self.state = create_vfi_state(opts, ctx.seed, TRAIN_TRIPLETS // self.B, ctx.device)
        weights.load(self.state.module, self.w0)
        self.trainable = dict(self.state.module.named_parameters())
        ctx.phase("model_build")
        self.train_step = make_vfi_train_step(opts.clip_grad)
        self.pool = make_pool(ctx.seed, ctx.cell.traffic["pool"], self.B, opts.height,
                              opts.width, crop_hw(ctx.cell.config["options"]), ctx.device)
        self.losses = []
        self.beta1 = opts.beta1
        ctx.phase("batches")

    def step(self):
        """One step through the window's call; its loss is kept on the device."""
        s = self.state.step
        with self.ctx.spans.span("step_call"):
            metrics, _ = self.train_step(self.state, self.pool[s % len(self.pool)])
        self.losses.append(metrics["loss"])


def reference_readings(ctx, pool, n: int, precision: str = "float32") -> dict:
    """The plain reference through the same `n` steps from the same
    weights, batches and learning rates, its convolutions in the
    configuration's dtype or, with `precision` "float8", one below; -> the
    readings Program.checked_steps gives, with the reference's first
    gradient (`grad`) as the update took it."""
    cfg = reference_config(ctx)
    opts = ctx.cell.config["options"]
    module = reference_module(ctx, ctx.device)
    w0 = weights.draw(module, ctx.seed, ctx.device)
    # the window is over: cuDNN's heuristics, not its autotuner
    torch.backends.cudnn.benchmark = False
    weights.load(module, w0)
    params = dict(module.named_parameters())
    opt = AdamW(params.values(), cfg)
    total = TRAIN_TRIPLETS // opts["batch_size"] * opts["num_epochs"]
    losses, grad = [], None
    with operands(precision):
        for s in range(n):
            lr = ref_vfi.cosine_lr(s, cfg.learning_rate, opts["eta_min"], total)
            loss, grads = ref_vfi.train_step(module, opt, pool[s % len(pool)], lr)
            losses.append(loss)
            if s == 0:
                grad = leaf_norms(dict(zip(params, grads)))
    change = leaf_norms({k: p.detach() - w0[k] for k, p in params.items()})
    return {"losses": torch.stack(losses).cpu().tolist(), "grad": grad, "change": change}


def run(ctx):
    """One run of the cell: set-up, the window, then the comparison."""
    prog = Program(ctx)
    mix = ctx.cell.traffic
    n_checked = mix["checked_steps"]
    before = launch_shapes()
    checked = prog.checked_steps(n_checked)
    launches = launches_per_step(before, launch_shapes(), n_checked)
    window = ctx.window(prog.step, mix["trace_steps"])
    losses = torch.stack(prog.losses).float()
    failed = int((~torch.isfinite(losses)).sum())
    ctx.read_memory_peak()
    closed = time.perf_counter()
    prog.free()
    pool, B = prog.pool, prog.B
    del prog
    ref = reference_readings(ctx, pool, n_checked)
    return {
        "attempted": window.items, "failed": failed,
        "end_to_end": {"train_samples_per_s": window.timed_items * B / window.timed_seconds},
        "readings": {**readings(checked, ref), "_launches_per_step": launches},
        "window": window,
        "check_s": time.perf_counter() - closed,
    }


def flops_per_item(cell) -> float:
    from perfbench.counts import vfi

    return vfi.train_step(cell.config["options"])


def half_batch(step):
    """The planted fault: `step` on the first half of each batch."""
    def train_step(state, batch):
        return step(state, {k: v[:v.shape[0] // 2] for k, v in batch.items()})
    return train_step


def unchanged_state(step):
    """The planted fault: the forward and its loss, and no update."""
    def train_step(state, batch):
        from mono_vifi_tpu_torch.training.monovifi import prepare_batch

        with torch.no_grad():
            b = prepare_batch(batch, state.params[0].device)
            out = state.module(b["img0"], b["img2"], b["embt"].reshape(-1, 1, 1, 1),
                               imgt=b["img1"])
        return {"loss": out["loss"]}, {}
    return train_step


FAULTS = {"half_batch": half_batch, "unchanged_state": unchanged_state}


def calibration(ctx) -> dict[str, dict]:
    """The compared numbers of one seed for the program as the window runs
    it, for the control (the reference with float8 operands in the
    program's place) and for each planted fault of `FAULTS` in the
    program's step; -> {name: readings}."""
    n = ctx.cell.traffic["checked_steps"]
    sides = {}
    prog = Program(ctx)
    sides["program"] = prog.checked_steps(n)
    prog.free()
    for name, plant in FAULTS.items():
        prog = Program(ctx)
        prog.train_step = plant(prog.train_step)
        sides[name] = prog.checked_steps(n)
        prog.free()
    pool = prog.pool
    del prog
    ref = reference_readings(ctx, pool, n)
    sides["control"] = reference_readings(ctx, pool, n, precision="float8")
    out = {k: readings(v, ref) for k, v in sides.items()}
    sides["reference"] = ref
    out["_leaves"] = {k: {"grad": v["grad"], "change": v["change"]} for k, v in sides.items()}
    return out
