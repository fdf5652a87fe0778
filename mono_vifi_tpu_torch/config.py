"""Experiment configuration (the port's copy of mono_vifi_tpu/config.py;
reference options.py): every field of the JAX package's `Options` with its
name and default, a `key = value` config-file reader and the
configargparse-style parser (`-c file.txt`, then `--flag value` overrides;
booleans as strings, integer lists as several values).

The port adds one field, `device` (the training entry point's `--device`,
CUDA unless the caller names another). The JAX package's TPU fields parse
unchanged, so that its configs and flags are accepted as they are. What the
port does with each (mono_vifi_tpu_torch.parallel for the first two;
`check_port_options` refuses what cannot run):
  num_devices    ranks started on this host, one a card; 0: every visible
                 card (one process on the CPU); batch_size is per card
  distributed    one rank of a `torchrun` job (the env rendezvous)
  encoder_remat  the encoder's activations recomputed in the backward pass
  fast_warp      no effect: the port always runs its kernels on the card
  debug_nans     torch.autograd.set_detect_anomaly
  profile_steps  a torch.profiler trace of that many steps
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass
from typing import Sequence

import torch

# the `torch.distributed` env rendezvous, as `torchrun` sets it
ENV_RENDEZVOUS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclass
class Options:
    # paths
    config: str | None = None
    data_path: str = "kitti_data"
    data_path_pre: str | None = None
    log_dir: str = "logs"

    # training
    exp_name: str = "mdp"
    split: str = "eigen_zhou"
    eval_split: str = "eigen"
    num_layers: int = 18
    dataset: str = "kitti"
    jpg: bool = False
    height: int = 192
    width: int = 640
    disparity_smoothness: float = 1e-3
    num_scales: int = 1
    min_depth: float = 0.1
    max_depth: float = 100.0
    lamda: float = 0.2
    use_stereo: bool = False
    frame_ids: Sequence[int] = (0, -1, 1)

    # optimization
    optimizer: str = "adamw"
    lr_sche_type: str = "step"
    eta_min: float = 5e-6
    batch_size: int = 12
    learning_rate: float = 1e-4
    decay_rate: float = 0.1
    decay_step: Sequence[int] = (15,)
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.999
    momentum: float = 0.9
    clip_grad: float = 5.0
    num_epochs: int = 20
    seed: int = 1234
    resume: bool = False

    # ablation / model
    avg_reprojection: bool = False
    disable_automasking: bool = False
    no_ssim: bool = False
    weights_init: str = "pretrained"
    backbone: str = "ResNet18"
    vfi_scale: str = "small"
    fuse_model_type: str = "shared_encoder"
    use_affine: bool = False
    doj_mask: bool = False  # Cityscapes dynamic-object masks in the batch
    mask_dir: str = ""  # doj mask directory (reference: ./train_mask)
    use_smooth_dyn: bool = False  # doj-weighted smoothness on frame-0 targets

    # system
    num_workers: int = 16
    pretrained_path: str | None = None
    log_frequency: int = 500
    save_frequency: int = 500

    # fields of the JAX package's TPU driver (see the module docstring)
    num_devices: int = 0
    compute_dtype: str = "bfloat16"  # conv compute dtype; params stay f32
    weights_dir: str = "./weights"  # frozen VFI / ImageNet encoder weights
    profile_steps: int = 0  # >0: a torch.profiler trace of N steps
    debug_nans: bool = False  # torch.autograd.set_detect_anomaly
    encoder_remat: bool = False
    fast_warp: bool = True  # no effect in the port
    vfi_train_scale: str = "large"  # frozen training VFI (reference: large)
    vfi_test_scale: str = "small"  # frozen eval VFI
    distributed: bool = False

    # the port's own
    device: str = "cuda"

    @property
    def use_pose_net(self) -> bool:
        return not (self.use_stereo and tuple(self.frame_ids) == (0,))


def check_port_options(opts: Options) -> None:
    """Refuse the multi-card settings that cannot run here: more ranks on
    CUDA than visible cards (`num_devices`), and `distributed` without the
    `torch.distributed` env rendezvous (`ENV_RENDEZVOUS`). The entry points
    call it before they start any rank."""
    if opts.num_devices < 0:
        raise ValueError(f"num_devices={opts.num_devices}")
    cards = torch.cuda.device_count()
    if torch.device(opts.device).type == "cuda" and opts.num_devices > max(cards, 1):
        raise ValueError(f"num_devices={opts.num_devices}: {cards} CUDA cards visible")
    missing = [k for k in ENV_RENDEZVOUS if k not in os.environ]
    if opts.distributed and missing:
        raise ValueError(f"distributed=True needs the env rendezvous; missing {missing}")


_BOOL_FIELDS = {
    "jpg", "use_stereo", "resume", "avg_reprojection", "disable_automasking",
    "no_ssim", "use_affine", "debug_nans", "fast_warp", "encoder_remat",
    "doj_mask", "use_smooth_dyn", "distributed",
}
_LIST_INT_FIELDS = {"frame_ids", "decay_step"}


def _parse_value(name: str, raw: str, target_type):
    raw = raw.strip()
    if name in _BOOL_FIELDS:
        return raw.lower() in ("1", "true", "yes")
    if name in _LIST_INT_FIELDS:
        return tuple(int(v) for v in raw.replace(",", " ").split())
    if target_type is int:
        return int(raw)
    if target_type is float:
        return float(raw)
    return raw


def load_config_file(path: str) -> dict:
    """Parse a `key = value` config txt (reference configs/*/*.txt format)."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def parse_options(argv: Sequence[str] | None = None) -> Options:
    """-c config.txt plus --flag overrides, configargparse-style."""
    fields = {f.name: f for f in dataclasses.fields(Options)}
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("-c", "--config", default=None)
    ns, rest = pre.parse_known_args(argv)

    opts = Options()
    if ns.config:
        opts.config = ns.config
        for k, v in load_config_file(ns.config).items():
            if k not in fields:
                continue
            setattr(opts, k, _parse_value(k, v, type(getattr(opts, k))))

    parser = argparse.ArgumentParser(description="Mono-ViFI options")
    parser.add_argument("-c", "--config", default=None)
    for name, f in fields.items():
        if name == "config":
            continue
        default = getattr(opts, name)
        if name in _BOOL_FIELDS:
            parser.add_argument(f"--{name}", default=default, type=str)
        elif name in _LIST_INT_FIELDS:
            parser.add_argument(f"--{name}", nargs="+", type=int, default=default)
        else:
            t = str if f.default is None else type(f.default)
            parser.add_argument(f"--{name}", type=t, default=default)
    ns2 = parser.parse_args(rest)
    for name in fields:
        if name == "config":
            continue
        v = getattr(ns2, name)
        if name in _BOOL_FIELDS and isinstance(v, str):
            v = v.lower() in ("1", "true", "yes")
        if name in _LIST_INT_FIELDS and v is not None:
            v = tuple(v)
        setattr(opts, name, v)
    return opts
