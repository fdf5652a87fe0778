"""Model FLOPs of one IFRNet VFI training step, counted as `counts/flops.py`
counts the depth step: torch.utils.flop_counter over the plain reference
at the cell's batch and crop on the `meta` device (no arithmetic runs),
forward and backward, 2 FLOPs a multiply-add; convolutions and matrix
products only."""

from __future__ import annotations

import torch

from perfbench.counts.flops import _count
from perfbench.reference.config import Config
from perfbench.reference.models.ifrnet import IFRNet
from perfbench.reference.training import vfi


def crop_hw(options: dict) -> tuple[int, int]:
    """The training crop of a KITTI triplet, 160 x 576, cut to the frame
    where the frame is smaller (`data/vfi.py` `KITTIVFIDataset.crop_hw`)."""
    cfg = Config.from_keys(options)
    return min(160, cfg.height), min(576, cfg.width)


def train_step(options: dict, device="meta") -> float:
    """FLOPs of one step at the configuration's batch and crop: IFRNet at
    `vfi_scale` over the three frames with its loss, and the backward."""
    B = options["batch_size"]
    h, w = crop_hw(options)
    dtype = getattr(torch, Config.from_keys(options).compute_dtype)
    with torch.device(device):
        module = IFRNet(options["vfi_scale"], dtype)
        img = torch.zeros((B, h, w, 3))
        batch = {"img0": img, "img1": img, "img2": img, "embt": torch.full((B,), 0.5)}

    def fn():
        vfi.loss_fn(module, batch, device)[0].backward()

    return _count(fn)
