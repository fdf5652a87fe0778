"""ImageNet-pretrained encoder initialization, weights_init="pretrained"
(counterpart of mono_vifi_tpu/training/pretrained.py).

The reference starts the depth and pose encoders from ImageNet weights:
  - the ResNet depth encoder from torchvision's ImageNet state_dict
    (networks/monodepth2.py:28), here `weights_dir/resnet18.pth`, a file in
    torchvision's layout (conv1.weight, bn1.*, layer1.0.*, ..., fc.*);
  - the pose encoder from the same file, conv1's (64, 3, 7, 7) kernel tiled
    over the 6-channel two-frame input and halved (networks/posenet.py:47-50).
The port's modules use the reference key schema, so the file's keys load
with an `encoder.` prefix (fc.* is never read). A missing file is logged and
the module keeps its random init, as the reference does with
pretrained=False. The other backbones' ImageNet files (ResNet50, LiteMono,
D-HRNet) wait for their models (ROADMAP item 15).
"""

from __future__ import annotations

import logging
import os

import torch

from mono_vifi_tpu_torch.training.checkpoint import load_roles

log = logging.getLogger("mono_vifi_tpu_torch")

IMAGENET_FILES = {"ResNet18": "resnet18.pth"}


def pose_conv1_from_imagenet(w: torch.Tensor, num_input_images: int = 2) -> torch.Tensor:
    """Tile the ImageNet conv1 kernel across the stacked input frames and
    divide by their count (reference posenet.py:47-50)."""
    return torch.cat([w.float()] * num_input_images, 1) / num_input_images


def _load_imagenet(path: str, what: str):
    if not os.path.exists(path):
        log.warning("weights_init=pretrained but %s not found: %s keeps random init",
                    path, what)
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


def apply_pretrained(cfg, bundle) -> None:
    """Load ImageNet weights into the roles the reference pretrains:
    encoder (and encoder_mf), and pose_encoder."""
    if cfg.weights_init != "pretrained":
        return
    if cfg.backbone not in IMAGENET_FILES:
        raise NotImplementedError(
            f"pretrained {cfg.backbone} encoder: not ported yet (ROADMAP item 15)")
    raw = _load_imagenet(os.path.join(cfg.weights_dir, IMAGENET_FILES[cfg.backbone]),
                         f"the {cfg.backbone} encoder")
    if raw is not None:
        sd = {f"encoder.{k}": v for k, v in raw.items()}
        load_roles(bundle, {"encoder": sd, "encoder_mf": sd})
        log.info("loaded ImageNet weights into the depth encoder(s)")

    if hasattr(bundle, "pose_encoder"):
        raw = _load_imagenet(os.path.join(cfg.weights_dir, f"resnet{cfg.num_layers}.pth"),
                             "the pose encoder")
        if raw is not None:
            sd = {f"encoder.{k}": v for k, v in raw.items()}
            sd["encoder.conv1.weight"] = pose_conv1_from_imagenet(raw["conv1.weight"])
            load_roles(bundle, {"pose_encoder": sd})
            log.info("loaded ImageNet weights into the pose encoder")
