"""Optimizer and LR schedules (counterpart of mono_vifi_tpu/training/optim.py,
reference train.py:229-245): AdamW / Adam / SGD after global-norm gradient
clipping, with the schedule evaluated at the optimizer's 0-based update
count as optax does."""

from __future__ import annotations

import math

import torch

from mono_vifi_tpu_torch.config import Options


def lr_schedule(cfg: Options, steps_per_epoch: int):
    """step -> learning rate. 'step': x decay_rate from each boundary
    epoch * steps_per_epoch on (optax.piecewise_constant_schedule);
    'cos': cosine decay to eta_min over all steps (optax
    cosine_decay_schedule)."""
    base = cfg.learning_rate
    if cfg.lr_sche_type == "cos":
        total = max(steps_per_epoch * cfg.num_epochs, 1)
        alpha = cfg.eta_min / base

        def cos(step: int) -> float:
            t = min(step, total) / total
            return base * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t)) + alpha)

        return cos
    bounds = sorted(ep * steps_per_epoch for ep in cfg.decay_step)

    def piecewise(step: int) -> float:
        return base * cfg.decay_rate ** sum(step >= b for b in bounds)

    return piecewise


def make_optimizer(cfg: Options, params) -> torch.optim.Optimizer:
    """The update rule; its learning rate is set from `lr_schedule` before
    each step. torch's AdamW equals optax.adamw: both decay by lr * wd * p
    and use bias-corrected moments with eps outside the square root."""
    params = list(params)
    lr = cfg.learning_rate
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(cfg.beta1, cfg.beta2),
                                 eps=1e-8, weight_decay=cfg.weight_decay)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(cfg.beta1, cfg.beta2), eps=1e-8)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=cfg.momentum)
    raise ValueError(f"unknown optimizer {cfg.optimizer}")


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in f32 (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))


def clip_by_global_norm_(grads, max_norm: float, norm: torch.Tensor) -> None:
    """In place, as optax.clip_by_global_norm: g / norm * max_norm when
    norm >= max_norm, unchanged otherwise (no epsilon)."""
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
