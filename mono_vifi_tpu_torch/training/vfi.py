"""IFRNet VFI training step (counterpart of mono_vifi_tpu/training/vfi.py;
reference train_vfi.py:176-249): IFRNet's forward with the middle frame as
supervision (Charbonnier L1 + ternary census + 0.01 * geometry, computed in
models.ifrnet), backward, global-norm clip and the optimizer's update at
the schedule's rate.

The flows are trained through the two full-resolution image warps, whose
grid gradient is the `bilinear_sample_bwd` kernel on the card; the feature
warps are the plain differentiable warp, as on the JAX side (its VFI
IFRNet is built without `fast_warp`).

In a process group (mono_vifi_tpu_torch.parallel) each rank steps on its
rows of the global batch; the step's `train_step.grad_sync` averages the
gradients, the loss and the prediction's mean squared error over the ranks
before the PSNR is taken, so the metrics are the global batch's.

The step's phases and spans are the depth step's
(`training/monovifi.py` `run_train_step`): `train_step.forward`
(`zero_grad`, the forward, its loss and the prediction's error),
`train_step.backward`, `.clip` and `.update`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from mono_vifi_tpu_torch.config import Options
from mono_vifi_tpu_torch.models.ifrnet import IFRNet
from mono_vifi_tpu_torch.models.init import init_like_jax_
from mono_vifi_tpu_torch.training.factory import compute_dtype, resolve_device
from mono_vifi_tpu_torch.training.monovifi import prepare_batch, run_train_step
from mono_vifi_tpu_torch.training.optim import lr_schedule, make_optimizer


@dataclass
class VFITrainState:
    """Parameters live in `module`; `step` counts the updates taken (the
    fields `run_train_step` reads, as in `TrainState`)."""

    step: int
    module: IFRNet
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]  # update count -> learning rate
    params: list[torch.nn.Parameter]  # the optimizer's, in its order


def create_vfi_state(cfg: Options, seed: int = 0, steps_per_epoch: int = 1000,
                     device=None) -> VFITrainState:
    """IFRNet at `cfg.vfi_scale` in the compute dtype, random-init from
    `seed` by the JAX package's rule (`models.init.init_like_jax_`; the
    global RNG untouched) on `device` (CUDA unless given), and its optimizer
    and schedule."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = init_like_jax_(IFRNet(cfg.vfi_scale, compute_dtype(cfg)))
    module = module.to(device)
    params = list(module.parameters())
    return VFITrainState(step=0, module=module, optimizer=make_optimizer(cfg, params),
                         schedule=lr_schedule(cfg, steps_per_epoch), params=params)


def make_vfi_train_step(clip_grad: float):
    """-> train_step(state, batch) -> (metrics, aux). `batch` holds NHWC
    `img0`, `img1` (the middle frame), `img2` and `embt` (B,), as the VFI
    datasets collate them; the state's parameters and optimizer moments
    are updated in place. metrics: loss, psnr of the prediction (with 1e-12
    inside the log, as the JAX step), grad_norm before clipping; aux:
    imgt_pred, flow0, flow1 (NCHW). On the card the step replays CUDA
    graphs once its input signature repeats (`run_train_step`)."""
    def train_step(state: VFITrainState, batch):
        def forward(x):
            b = prepare_batch(x, state.params[0].device)
            out = state.module(b["img0"], b["img2"], b["embt"].reshape(-1, 1, 1, 1),
                               imgt=b["img1"])
            with torch.no_grad():
                mse = torch.mean((out["imgt_pred"] - b["img1"]) ** 2)
            aux = {k: out[k].detach() for k in ("imgt_pred", "flow0", "flow1")}
            return out["loss"], {"loss": out["loss"].detach(), "mse": mse}, aux

        def outputs(fwd, grad_norm):
            return {**fwd[1], "grad_norm": grad_norm}, fwd[2]

        metrics, aux = run_train_step(state, "vfi", (state.module,), forward, dict(batch),
                                      clip_grad, outputs)
        psnr = -10.0 * torch.log10(metrics.pop("mse") + 1e-12)
        return {"loss": metrics["loss"], "psnr": psnr, "grad_norm": metrics["grad_norm"]}, aux

    return train_step
