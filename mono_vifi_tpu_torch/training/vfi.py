"""IFRNet VFI training step (counterpart of mono_vifi_tpu/training/vfi.py;
reference train_vfi.py:176-249): IFRNet's forward with the middle frame as
supervision (Charbonnier L1 + ternary census + 0.01 * geometry, computed in
models.ifrnet), backward, global-norm clip and the optimizer's update at
the schedule's rate.

The flows are trained through the two full-resolution image warps, whose
grid gradient is the `bilinear_sample_bwd` kernel on the card; the feature
warps are the plain differentiable warp, as on the JAX side (its VFI
IFRNet is built without `fast_warp`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from mono_vifi_tpu_torch.config import Options
from mono_vifi_tpu_torch.models.ifrnet import IFRNet
from mono_vifi_tpu_torch.training.factory import compute_dtype, resolve_device
from mono_vifi_tpu_torch.training.monovifi import apply_gradients, prepare_batch
from mono_vifi_tpu_torch.training.optim import lr_schedule, make_optimizer


@dataclass
class VFITrainState:
    """Parameters live in `module`; `step` counts the updates taken (the
    fields `apply_gradients` reads, as in `TrainState`)."""

    step: int
    module: IFRNet
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]  # update count -> learning rate
    params: list[torch.nn.Parameter]  # the optimizer's, in its order


def create_vfi_state(cfg: Options, seed: int = 0, steps_per_epoch: int = 1000,
                     device=None) -> VFITrainState:
    """IFRNet at `cfg.vfi_scale` in the compute dtype, random-init from
    `seed` (torch's default initializers, the global RNG untouched) on
    `device` (CUDA unless given), and its optimizer and schedule."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = IFRNet(cfg.vfi_scale, compute_dtype(cfg))
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
    imgt_pred, flow0, flow1 (NCHW)."""
    def train_step(state: VFITrainState, batch):
        b = prepare_batch(batch, state.params[0].device)
        img1 = b["img1"]
        state.optimizer.zero_grad(set_to_none=True)
        out = state.module(b["img0"], b["img2"], b["embt"].reshape(-1, 1, 1, 1), imgt=img1)
        out["loss"].backward()
        grad_norm = apply_gradients(state, clip_grad)
        with torch.no_grad():
            psnr = -10.0 * torch.log10(torch.mean((out["imgt_pred"] - img1) ** 2) + 1e-12)
        metrics = {"loss": out["loss"].detach(), "psnr": psnr, "grad_norm": grad_norm}
        aux = {k: out[k].detach() for k in ("imgt_pred", "flow0", "flow1")}
        return metrics, aux

    return train_step
