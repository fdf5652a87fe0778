"""Spans at the port's layer boundaries, on the profiler's clock.

`span(name)` is a `torch.profiler.record_function` range while a profiler
runs (`torch.profiler.profile`: the trainer's `profile_steps`, a
benchmark's traced stretch), so a trace names what the host was doing beside
the device's operations. With no profiler running it is one shared no-op
context: no clock read, no allocation, no `record_function`. The profiler is
the recorder; there is no buffer of spans here.

The spans, by layer:

  trainer train.py `Trainer.run_epoch`: run_epoch.data_wait, run_epoch.step,
          run_epoch.log, run_epoch.checkpoint
  step    training/monovifi.py `make_train_step` and `apply_gradients`:
          train_step.forward, train_step.backward, train_step.grad_sync
          (in a process group), train_step.clip, train_step.update
  loss    `MonoViFiStep.loss_fn`, inside train_step.forward: forward.vfi,
          forward.pose, forward.rotate_crop, forward.encoder, forward.depth,
          forward.fusion, forward.photometric, forward.svdc,
          forward.affine_losses
  entry   single_frame_disp; multi_frame_disp.flow, multi_frame_disp.encoder,
          multi_frame_disp.fusion; evaluate_depth.py to_device_images

The port's counters are `ops.cuda.LAUNCHES` and `ops.cuda.LAUNCH_SHAPES`.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context naming the enclosed host work `name` in a running profiler's
    trace; the shared no-op context when none runs."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)
