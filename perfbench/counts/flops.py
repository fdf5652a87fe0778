"""Model FLOPs, counted once by torch.utils.flop_counter over the frozen
plain reference at the cell's shapes on the `meta` device (no arithmetic
runs). FlopCounterMode counts matrix products and convolutions, 2 FLOPs a
multiply-add, forward and backward; elementwise work, normalisation and
the samples and splats count nothing. The reference computes each of them
once, as the model defines it, so the count is the same whatever
implements it (a convolution moved into a hand-written kernel, or
recomputed in the backward pass, changes nothing here)."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference.config import Config
from perfbench.reference.training import factory, monovifi


def _count(fn) -> float:
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return float(counter.get_total_flops())


def train_step(options: dict, device="meta") -> float:
    """FLOPs of one training step at the configuration's batch and size: the
    trained nets' forward and backward (depth encoder and both decoders,
    fusion, pose encoder and decoder) and the frozen IFRNet's forward (two
    synthesis pairs and one only-flow pair)."""
    cfg = Config.from_keys(options)
    B, H, W = options["batch_size"], cfg.height, cfg.width
    with torch.device(device):
        bundle = factory.ModelBundle(cfg)
        step = monovifi.MonoViFiStep(bundle)
        img = torch.zeros((B, H, W, 3))
        batch = {k: img for k in ("color_n1", "color_0", "color_p1", "color_aug_n1",
                                  "color_aug_0", "color_aug_p1", "color_affine_n1",
                                  "color_affine_0", "color_affine_p1", "color_affine_aug_0")}
        batch.update(K=torch.eye(4).expand(B, 4, 4), inv_K=torch.eye(4).expand(B, 4, 4),
                     Rc=torch.eye(3).expand(B, 3, 3), ratio_local=torch.ones((B, 1)),
                     angle=torch.zeros((B,)), box=torch.ones((B, 4)),
                     valid_mask_rec=torch.ones((B, H, W, 1)),
                     valid_mask_cons=torch.ones((B, H, W, 1)))

    def fn():
        loss, _ = step.loss_fn(batch, None, None, train=True)
        loss.backward()

    return _count(fn)


def video_frame(options: dict, device="meta") -> float:
    """FLOPs of one video frame at batch 1: the single-frame forward
    (encoder, decoder) and the multi-frame one (the frozen IFRNet at
    `vfi_test_scale` for the flows, the encoder over the three frames, the
    fusion, the multi-frame decoder)."""
    cfg = Config.from_keys(options)
    with torch.device(device):
        bundle = factory.ModelBundle(cfg, for_training=False)
        img = torch.zeros((1, 3, cfg.height, cfg.width))

    def fn():
        monovifi.single_frame_disp(bundle, img)
        monovifi.multi_frame_disp(bundle, img, img, img)

    return _count(fn)
