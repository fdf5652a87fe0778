"""Model construction (counterpart of mono_vifi_tpu/training/factory.py).

Roles follow the reference trainer (train.py:142-227): encoder / depth /
[encoder_mf / depth_mf] / fusion_module / pose_encoder / pose, plus the
frozen IFRNets: `vfi_train` (synthesis in the training step) and `vfi_test`
(the multi-frame inference flows). Sharing modes (train.py:170-179):
  shared_all:     depth_mf IS depth (one module, one set of parameters)
  shared_encoder: encoder shared, depth_mf a separate copy of depth
  separate_all:   encoder_mf and depth_mf separate copies
"""

from __future__ import annotations

import copy

import torch
import torch.nn as nn

from mono_vifi_tpu_torch import parallel
from mono_vifi_tpu_torch.config import Options
from mono_vifi_tpu_torch.models import dhrnet, fusion, ifrnet, litemono, monodepth2, posenet
from mono_vifi_tpu_torch.models.init import init_like_jax_


def resolve_device(device=None) -> torch.device:
    """The entry points' device: CUDA unless the caller names another. With
    no card, CUDA (named or by default) raises instead of using the CPU. A
    rank of a process group gets the card it is bound to, `cuda:<i>`, for a
    bare `cuda`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None and parallel.active():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def compute_dtype(cfg: Options) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def build_depth_net(cfg: Options, dtype) -> tuple[nn.Module, nn.Module]:
    """The depth encoder and decoder of `cfg.backbone` (JAX factory.py:33-65).
    The pose encoder is ResNet(cfg.num_layers) whatever the backbone."""
    scales = tuple(range(cfg.num_scales))
    if cfg.backbone in ("ResNet18", "ResNet50"):
        encoder = monodepth2.DepthEncoder(18 if cfg.backbone == "ResNet18" else 50, dtype)
        return encoder, monodepth2.DepthDecoder(encoder.num_ch_enc, scales, dtype)
    if cfg.backbone == "LiteMono":
        encoder = litemono.DepthEncoder(height=cfg.height, width=cfg.width, dtype=dtype)
        return encoder, litemono.DepthDecoder(encoder.num_ch_enc, scales, dtype)
    if cfg.backbone == "DHRNet":
        encoder = dhrnet.DepthEncoder(dtype=dtype)
        return encoder, dhrnet.DepthDecoder(encoder.num_ch_enc, scales, dtype)
    raise ValueError(f"unknown backbone {cfg.backbone}")


class ModelBundle(nn.Module):
    """All modules of one training run, or of one evaluation. Trainable
    roles are submodules; the frozen VFI networks have requires_grad off.

    An evaluation bundle (`for_training=False`) leaves out the pose roles and
    `vfi_train`. `vfi_test` is built at `cfg.vfi_test_scale`; at "large" in a
    training bundle it is `vfi_train` itself (evaluate_depth_mf.py:90-91)."""

    def __init__(self, cfg: Options, for_training: bool = True):
        super().__init__()
        if cfg.fuse_model_type not in ("shared_all", "shared_encoder", "separate_all"):
            raise ValueError(f"unknown fuse_model_type {cfg.fuse_model_type}")
        self.cfg = cfg
        self.dtype = dt = compute_dtype(cfg)
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


def build_bundle(cfg: Options, seed: int = 0, device=None,
                 for_training: bool = True) -> ModelBundle:
    """Random-init every module from `seed` by the JAX package's rule
    (`models.init.init_like_jax_`), without touching the global RNG, and
    move the bundle to `device`."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        bundle = init_like_jax_(ModelBundle(cfg, for_training))
        # the multi-frame copies start equal to their originals, as in the
        # JAX package's init_variables
        for copy_role, role in (("depth_mf", "depth"), ("encoder_mf", "encoder")):
            if hasattr(bundle, copy_role):
                getattr(bundle, copy_role).load_state_dict(getattr(bundle, role).state_dict())
    return bundle.to(device)
