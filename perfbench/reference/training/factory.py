"""Model construction (reference train.py:142-227): encoder / depth /
[encoder_mf / depth_mf] / fusion_module / pose_encoder / pose, plus the
frozen IFRNets: `vfi_train` (synthesis in the training step) and `vfi_test`
(the multi-frame inference flows). Sharing modes (train.py:170-179):
  shared_all:     depth_mf IS depth (one module, one set of parameters)
  shared_encoder: encoder shared, depth_mf a separate copy of depth
  separate_all:   encoder_mf and depth_mf separate copies
Parameters are left as torch constructs them: the caller loads its own.
"""

from __future__ import annotations

import copy
import functools
import importlib
import pkgutil

import torch
import torch.nn as nn

from perfbench.reference import models
from perfbench.reference.config import Config
from perfbench.reference.models import fusion, ifrnet, posenet


@functools.cache
def backbones() -> dict:
    """{backbone name: build(cfg, scales, dtype) -> (encoder, decoder)},
    gathered from the `BACKBONES` of every module file under
    `reference/models/`: a new depth net joins by a file of its own. A name
    that two modules declare raises ValueError."""
    found, owner = {}, {}
    for info in sorted(pkgutil.iter_modules(models.__path__), key=lambda i: i.name):
        module = importlib.import_module(f"{models.__name__}.{info.name}")
        for name, build in getattr(module, "BACKBONES", {}).items():
            if name in found:
                raise ValueError(f"backbone {name} declared by both {owner[name]} "
                                 f"and {info.name}")
            found[name], owner[name] = build, info.name
    return found


def build_depth_net(cfg: Config, dtype) -> tuple[nn.Module, nn.Module]:
    """The depth encoder and decoder of `cfg.backbone` (JAX factory.py:33-65).
    The pose encoder is ResNet(cfg.num_layers) whatever the backbone."""
    known = backbones()
    if cfg.backbone not in known:
        raise ValueError(f"unknown backbone {cfg.backbone}; known: {', '.join(sorted(known))}")
    return known[cfg.backbone](cfg, tuple(range(cfg.num_scales)), dtype)


class ModelBundle(nn.Module):
    """All modules of one training run, or of one evaluation. Trainable
    roles are submodules; the frozen VFI networks have requires_grad off.

    An evaluation bundle (`for_training=False`) leaves out the pose roles and
    `vfi_train`. `vfi_test` is built at `cfg.vfi_test_scale`; at "large" in a
    training bundle it is `vfi_train` itself (evaluate_depth_mf.py:90-91)."""

    def __init__(self, cfg: Config, for_training: bool = True):
        super().__init__()
        if cfg.fuse_model_type not in ("shared_all", "shared_encoder", "separate_all"):
            raise ValueError(f"unknown fuse_model_type {cfg.fuse_model_type}")
        self.cfg = cfg
        self.dtype = dt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.encoder, self.depth = build_depth_net(cfg, dt)
        self.num_ch_enc = self.encoder.num_ch_enc
        if cfg.fuse_model_type != "shared_all":
            self.depth_mf = copy.deepcopy(self.depth)
        if cfg.fuse_model_type == "separate_all":
            self.encoder_mf = copy.deepcopy(self.encoder)
        self.fusion_module = fusion.FusionModule(self.num_ch_enc, cfg.backbone, dtype=dt)
        if for_training and cfg.use_pose_net:
            self.pose_encoder = posenet.PoseEncoder(cfg.num_layers, dt)
            self.pose = posenet.PoseDecoder(self.pose_encoder.num_ch_enc[-1], dtype=dt)
        if for_training:
            self.vfi_train = ifrnet.IFRNet(cfg.vfi_train_scale, dt).requires_grad_(False)
        if for_training and cfg.vfi_test_scale == cfg.vfi_train_scale == "large":
            self.vfi_test = self.vfi_train
        else:
            self.vfi_test = ifrnet.IFRNet(cfg.vfi_test_scale, dt).requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def role(self, name: str) -> nn.Module:
        """A role's module; depth_mf resolves to depth under shared_all."""
        if name == "depth_mf" and self.cfg.fuse_model_type == "shared_all":
            return self.depth
        return getattr(self, name)

    def trainable_roles(self) -> dict[str, nn.Module]:
        names = ["encoder", "depth", "depth_mf", "encoder_mf", "fusion_module",
                 "pose_encoder", "pose"]
        return {n: getattr(self, n) for n in names if hasattr(self, n)}
