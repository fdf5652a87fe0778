"""Experiment configuration: the fields of the JAX package's `Options`
(mono_vifi_tpu/config.py) that the training step reads, with the same names
and defaults. The config-file parser arrives with the training entry point.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence


@dataclass
class Options:
    # data geometry
    height: int = 192
    width: int = 640
    batch_size: int = 12
    num_layers: int = 18
    frame_ids: Sequence[int] = (0, -1, 1)
    use_stereo: bool = False

    # loss
    disparity_smoothness: float = 1e-3
    num_scales: int = 1
    min_depth: float = 0.1
    max_depth: float = 100.0
    lamda: float = 0.2
    avg_reprojection: bool = False
    disable_automasking: bool = False
    no_ssim: bool = False
    use_smooth_dyn: bool = False

    # optimization
    optimizer: str = "adamw"
    lr_sche_type: str = "step"
    eta_min: float = 5e-6
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

    # model
    backbone: str = "ResNet18"
    fuse_model_type: str = "shared_encoder"
    use_affine: bool = False
    compute_dtype: str = "bfloat16"  # conv compute dtype; params stay f32
    vfi_train_scale: str = "large"  # frozen training VFI (reference: large)
    vfi_test_scale: str = "small"  # frozen eval VFI

    @property
    def use_pose_net(self) -> bool:
        return not (self.use_stereo and tuple(self.frame_ids) == (0,))
