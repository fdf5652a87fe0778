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
  step    training/monovifi.py `run_train_step` (the steps of
          `make_train_step` and training/vfi.py `make_vfi_train_step`) and
          `apply_gradients`: train_step.forward, train_step.backward,
          train_step.grad_sync (in a process group), train_step.clip,
          train_step.update (each around a graph's replay once the step
          replays, training/graphs.py)
  loss    `MonoViFiStep.loss_fn`, inside train_step.forward (where the
          step runs eager or captures): forward.vfi,
          forward.pose, forward.rotate_crop, forward.encoder, forward.depth,
          forward.fusion, forward.photometric, forward.svdc,
          forward.affine_losses
  entry   single_frame_disp; multi_frame_disp.flow, multi_frame_disp.encoder,
          multi_frame_disp.fusion (each around a graph's replay once the
          entry replays, training/graphs.py); evaluate_depth.py
          to_device_images
  models  models/ifrnet.py `IFRNet.forward`, inside forward.vfi,
          multi_frame_disp.flow and the VFI step's train_step.forward (where
          the entry or step runs eager or captures): ifrnet.encoder,
          ifrnet.decoders, ifrnet.image_warp, ifrnet.loss (given the middle
          frame); models/litemono.py, inside forward.encoder (the encoder)
          and forward.depth and forward.fusion (the decoders), where the
          step runs eager or captures: litemono.stem, litemono.cdc,
          litemono.xca, litemono.mlp, litemono.decoder

The port's counters are `ops.cuda.LAUNCHES` and `ops.cuda.LAUNCH_SHAPES`
(launches by kernel, and by kernel and shape), `training.optim.CLIP_COUNTS`
(the clip's calls, leaves and groups), `training.graphs.ENTRY_GRAPHS` and
`STEP_GRAPHS` (the eval entries' and the training steps' calls, eager,
captured or replayed) and
`ops.image.CONSTANT_COUNTS` (device constants made).
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
