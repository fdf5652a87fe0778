"""IFRNet's VFI training step in plain PyTorch (a frozen copy of the port's
`training/vfi.py` step; reference train_vfi.py:176-249): IFRNet's forward
with the middle frame as supervision (Charbonnier L1 + ternary census + 0.01
* geometry, computed in `models.ifrnet`), backward, then the hand-written
AdamW after the global-norm clip, at the cosine schedule's rate.

A batch is NHWC f32 `img0`, `img1` (the middle frame), `img2` in [0, 1] and
`embt` (B,), as the port's VFI datasets collate them.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.training.monovifi import AdamW, prepare_batch


def cosine_lr(step: int, base: float, eta_min: float, total_steps: int) -> float:
    """optax.cosine_decay_schedule(base, total_steps, alpha=eta_min / base) at
    the 0-based update count `step`: from `base` down to `eta_min`, then flat."""
    total = max(total_steps, 1)
    alpha = eta_min / base
    t = min(step, total) / total
    return base * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t)) + alpha)


def loss_fn(module, batch, device):
    """IFRNet's training loss on one batch -> (loss, the model's outputs)."""
    b = prepare_batch(batch, device)
    out = module(b["img0"], b["img2"], b["embt"].reshape(-1, 1, 1, 1), imgt=b["img1"])
    return out["loss"], out


def train_step(module, opt: AdamW, batch, lr: float):
    """One step: loss, backward, clip, AdamW at `lr`; -> (the loss, the
    clipped gradients as the update took them)."""
    for p in opt.params:
        p.grad = None
    loss, _ = loss_fn(module, batch, opt.params[0].device)
    loss.backward()
    grads = opt.step([p.grad for p in opt.params], lr)
    return loss.detach(), grads
