"""JAX parameter trees -> the port's state_dicts (the inverse of the
PyTorch -> Flax converter of the JAX package, kept as an own copy).

Inputs are the JAX package's `params` / `batch_stats` subtrees of one role,
as nested dicts of numpy arrays; outputs are state_dicts in the reference
PyTorch key schema, which the port's modules use. Layouts:
  - conv kernels HWIO -> OIHW
  - the spatially flipped kernel of the input-dilated conv that stands for
    ConvTranspose2d(4, 2, 1) -> torch's (in, out, kH, kW)
  - BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var
  - PReLU alpha -> weight
  - the fusion levels' 1x1 kernels (1, 1, 2*(cf+ce), F) -> (F, 2*(cf+ce), 1, 1)
Gradient trees convert the same way (pass no batch_stats).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def conv_kernel(k) -> torch.Tensor:
    """HWIO -> OIHW."""
    return _t(np.asarray(k, np.float32).transpose(3, 2, 0, 1))


def conv_transpose_kernel(k) -> torch.Tensor:
    """Flipped HWIO dilated-conv kernel -> torch ConvTranspose2d (I, O, kH, kW)."""
    return _t(np.flip(np.asarray(k, np.float32).transpose(2, 3, 0, 1), (2, 3)))


class _StateDict:
    def __init__(self, params: Mapping[str, Any], batch_stats: Mapping[str, Any] | None):
        self.params = params
        self.stats = batch_stats
        self.sd: dict[str, torch.Tensor] = {}

    @staticmethod
    def _get(tree, path: str):
        for k in path.split("/"):
            tree = tree[k]
        return tree

    def conv(self, flax_path: str, torch_prefix: str):
        node = self._get(self.params, flax_path)
        self.sd[f"{torch_prefix}.weight"] = conv_kernel(node["kernel"])
        if "bias" in node:
            self.sd[f"{torch_prefix}.bias"] = _t(node["bias"])

    def conv_transpose(self, flax_path: str, torch_prefix: str):
        node = self._get(self.params, flax_path)
        self.sd[f"{torch_prefix}.weight"] = conv_transpose_kernel(node["kernel"])
        self.sd[f"{torch_prefix}.bias"] = _t(node["bias"])

    def bn(self, flax_path: str, torch_prefix: str):
        node = self._get(self.params, flax_path)
        self.sd[f"{torch_prefix}.weight"] = _t(node["scale"])
        self.sd[f"{torch_prefix}.bias"] = _t(node["bias"])
        if self.stats is not None:
            st = self._get(self.stats, flax_path)
            self.sd[f"{torch_prefix}.running_mean"] = _t(st["mean"])
            self.sd[f"{torch_prefix}.running_var"] = _t(st["var"])
            self.sd[f"{torch_prefix}.num_batches_tracked"] = torch.tensor(0)

    def prelu(self, flax_path: str, torch_prefix: str):
        self.sd[f"{torch_prefix}.weight"] = _t(self._get(self.params, flax_path)["alpha"])


def _resnet18(b: _StateDict, fp: str, tp: str):
    b.conv(f"{fp}conv1", f"{tp}conv1")
    b.bn(f"{fp}bn1", f"{tp}bn1")
    for li in range(1, 5):
        for bi in range(2):
            f, t = f"{fp}layer{li}_{bi}/", f"{tp}layer{li}.{bi}."
            for ci in (1, 2):
                b.conv(f"{f}conv{ci}", f"{t}conv{ci}")
                b.bn(f"{f}bn{ci}", f"{t}bn{ci}")
            if "downsample_conv" in b._get(b.params, f"{fp}layer{li}_{bi}"):
                b.conv(f"{f}downsample_conv", f"{t}downsample.0")
                b.bn(f"{f}downsample_bn", f"{t}downsample.1")


def depth_encoder(params, batch_stats=None) -> dict:
    """DepthEncoder / PoseEncoder (ResNet18 under `encoder`)."""
    b = _StateDict(params, batch_stats)
    _resnet18(b, "encoder/", "encoder.")
    return b.sd


pose_encoder = depth_encoder


def depth_decoder(params, scales=(0,)) -> dict:
    b = _StateDict(params, None)
    idx = 0
    for i in range(4, -1, -1):
        for j in (0, 1):
            b.conv(f"upconv_{i}_{j}/conv/conv", f"decoder.{idx}.conv.conv")
            idx += 1
    for s in scales:
        b.conv(f"dispconv_{s}/conv", f"decoder.{idx}.conv")
        idx += 1
    return b.sd


def pose_decoder(params) -> dict:
    b = _StateDict(params, None)
    for i, name in enumerate(("squeeze", "pose_0", "pose_1", "pose_2")):
        b.conv(name, f"net.{i}")
    return b.sd


def _conv_prelu(b, fp, tp):
    b.conv(f"{fp}/conv", f"{tp}.0")
    b.prelu(f"{fp}/prelu", f"{tp}.1")


def ifrnet(params) -> dict:
    b = _StateDict(params, None)
    for p in range(1, 5):
        for j in (0, 1):
            _conv_prelu(b, f"encoder/pyramid{p}_{j}", f"encoder.pyramid{p}.{j}")
    for d in range(4, 0, -1):
        fp, tp = f"decoder{d}", f"decoder{d}.convblock"
        _conv_prelu(b, f"{fp}/conv0", f"{tp}.0")
        for ci in (1, 2, 3, 4):
            _conv_prelu(b, f"{fp}/resblock/conv{ci}", f"{tp}.1.conv{ci}")
        b.conv(f"{fp}/resblock/conv5", f"{tp}.1.conv5")
        b.prelu(f"{fp}/resblock/prelu", f"{tp}.1.prelu")
        b.conv_transpose(f"{fp}/up", f"{tp}.2")
    return b.sd


def fusion_module(params, num_levels: int = 5) -> dict:
    """fusion_conv is ordered from level L-1 down to 0."""
    b = _StateDict(params, None)
    for idx, level in enumerate(range(num_levels - 1, -1, -1)):
        b.conv(f"conv1x1_{level}/conv", f"fusion_conv.{idx}.conv.conv")
    return b.sd


def bundle_state_dicts(params, batch_stats=None, vfi_params=None,
                       scales=(0,), vfi_test_params=None) -> dict[str, dict]:
    """{role: state_dict} for every role present in the JAX `params` tree
    (and `vfi_train` / `vfi_test` from `vfi_params` / `vfi_test_params`)."""
    bs = batch_stats or {}
    out = {}
    for role in ("encoder", "encoder_mf", "pose_encoder"):
        if role in params:
            out[role] = depth_encoder(params[role], bs.get(role))
    for role in ("depth", "depth_mf"):
        if role in params:
            out[role] = depth_decoder(params[role], scales)
    if "pose" in params:
        out["pose"] = pose_decoder(params["pose"])
    if "fusion_module" in params:
        out["fusion_module"] = fusion_module(params["fusion_module"])
    if vfi_params is not None:
        out["vfi_train"] = ifrnet(vfi_params)
    if vfi_test_params is not None:
        out["vfi_test"] = ifrnet(vfi_test_params)
    return out


def load_into_bundle(bundle, params, batch_stats, vfi_params=None,
                     vfi_test_params=None) -> None:
    """Copy JAX weights into a ModelBundle, role by role (strict keys);
    roles an evaluation bundle leaves out (the pose roles) are skipped."""
    scales = tuple(range(bundle.cfg.num_scales))
    sds = bundle_state_dicts(params, batch_stats, vfi_params, scales, vfi_test_params)
    for role, sd in sds.items():
        if role == "depth_mf" or hasattr(bundle, role):
            bundle.role(role).load_state_dict(sd, strict=True)
