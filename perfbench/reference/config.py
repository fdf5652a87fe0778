"""The settings the reference reads, with the reference repository's
defaults (options.py); a configuration file's keys override them."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class Config:
    compute_dtype: str = "float32"  # or "bfloat16": convolutions in it, f32 parameters
    height: int = 192
    width: int = 640
    backbone: str = "ResNet18"
    num_layers: int = 18
    num_scales: int = 1
    fuse_model_type: str = "shared_encoder"
    use_affine: bool = False
    use_stereo: bool = False
    frame_ids: tuple = (0, -1, 1)
    vfi_train_scale: str = "large"
    vfi_test_scale: str = "small"
    min_depth: float = 0.1
    max_depth: float = 100.0
    disparity_smoothness: float = 1e-3
    lamda: float = 0.2
    avg_reprojection: bool = False
    disable_automasking: bool = False
    no_ssim: bool = False
    use_smooth_dyn: bool = False
    clip_grad: float = 5.0
    learning_rate: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.01

    @property
    def use_pose_net(self) -> bool:
        return not (self.use_stereo and tuple(self.frame_ids) == (0,))

    @classmethod
    def from_keys(cls, keys: dict) -> "Config":
        """The fields of `keys` this class has; other keys are ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in keys.items() if k in names}
        return cls(**kw)
