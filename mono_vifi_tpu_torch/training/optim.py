"""Optimizer and LR schedules (counterpart of mono_vifi_tpu/training/optim.py,
reference train.py:229-245): AdamW / Adam / SGD after global-norm gradient
clipping, with the schedule evaluated at the optimizer's 0-based update
count as optax does."""

from __future__ import annotations

import math

import torch
from torch.utils._foreach_utils import _group_tensors_by_device_and_dtype

from mono_vifi_tpu_torch.config import Options

# Summed over `clip_by_global_norm_` calls: the leaves clipped and the
# (device, dtype) groups they took, one multi-tensor pass of each operation
# per group; groups == calls where every leaf went in one pass.
CLIP_COUNTS = {"calls": 0, "leaves": 0, "groups": 0}


def reset_clip_counts() -> None:
    for k in CLIP_COUNTS:
        CLIP_COUNTS[k] = 0


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
    """The update rule; its learning rate is set by `set_lr` from
    `lr_schedule` before each step. torch's AdamW equals optax.adamw: both
    decay by lr * wd * p and use bias-corrected moments with eps outside the
    square root.

    On the card AdamW and Adam are capturable, so a CUDA graph can hold the
    update (`training/graphs.py`): their learning rate is a 0-d device
    tensor, and the step counts and bias corrections stay on the device, in
    f32, where the host computed the corrections in double before. SGD has
    no capturable form."""
    params = list(params)
    lr = cfg.learning_rate
    if cfg.optimizer in ("adamw", "adam"):
        kw = {"lr": lr, "betas": (cfg.beta1, cfg.beta2), "eps": 1e-8}
        if params[0].device.type == "cuda":
            kw.update(lr=torch.full((), lr, device=params[0].device), capturable=True)
        opt = (torch.optim.AdamW(params, weight_decay=cfg.weight_decay, **kw)
               if cfg.optimizer == "adamw" else torch.optim.Adam(params, **kw))
        # the first step of each input signature runs uncaptured by design;
        # torch would warn that it does
        opt._warned_capturable_if_run_uncaptured = True
        return opt
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=cfg.momentum)
    raise ValueError(f"unknown optimizer {cfg.optimizer}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Every group's learning rate: written into a capturable group's 0-d
    device tensor, which a captured update reads when it replays (a host
    value, as `load_state_dict` leaves it from a file read onto the host,
    is replaced by one); a float elsewhere."""
    for group in optimizer.param_groups:
        cur, device = group["lr"], group["params"][0].device
        if not group.get("capturable"):
            group["lr"] = lr
        elif isinstance(cur, torch.Tensor) and cur.device == device:
            cur.fill_(lr)
        else:
            group["lr"] = torch.full((), lr, device=device)


def _groups(grads) -> list[list[torch.Tensor]]:
    """The leaves by (device, dtype), in order: a multi-tensor op takes its
    one-pass path only over tensors of one device and one dtype."""
    return [lists[0] for lists, _ in _group_tensors_by_device_and_dtype([list(grads)]).values()]


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in f32 (optax.global_norm):
    each leaf's norm in one multi-tensor pass per (device, dtype) group, then
    the norm of those norms; a device scalar, read by no host sync."""
    norms = [n for g in _groups(grads) for n in torch._foreach_norm(
        g, 2, dtype=torch.promote_types(g[0].dtype, torch.float32))]
    return torch.linalg.vector_norm(torch.stack(norms)).float()


def clip_by_global_norm_(grads, max_norm: float, norm: torch.Tensor) -> None:
    """In place, as optax.clip_by_global_norm: g / norm * max_norm when
    norm >= max_norm, unchanged otherwise (no epsilon). No branch on the
    host: every leaf is divided by `d` and multiplied by `m`, both 1 below
    max_norm (g / 1 * 1 is g bit for bit), one multi-tensor pass of each per
    (device, dtype) group instead of a launch per operation and leaf."""
    keep = norm < max_norm
    d = torch.where(keep, 1.0, norm)
    m = torch.where(keep, 1.0, max_norm)
    groups = _groups(grads)
    for g in groups:
        torch._foreach_div_(g, d)
        torch._foreach_mul_(g, m)
    CLIP_COUNTS["calls"] += 1
    CLIP_COUNTS["leaves"] += sum(map(len, groups))
    CLIP_COUNTS["groups"] += len(groups)
