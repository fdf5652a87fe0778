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
  - Dense kernels (in, out) -> Linear weights (out, in); LayerNorm
    scale/bias -> weight/bias; LiteMono's position projection, a Dense
    (64, C) -> a 1x1 conv (C, 64, 1, 1)
Gradient trees convert the same way (pass no batch_stats).
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

from mono_vifi_tpu_torch.models.dhrnet import DECODER_ORDER


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


    def node(self, flax_path: str, torch_prefix: str):
        """A conv (a node holding a kernel) or a BatchNorm (holding a scale)."""
        if "kernel" in self._get(self.params, flax_path):
            self.conv(flax_path, torch_prefix)
        else:
            self.bn(flax_path, torch_prefix)

    def dense(self, flax_path: str, torch_prefix: str):
        """flax Dense kernel (in, out) -> torch Linear weight (out, in)."""
        node = self._get(self.params, flax_path)
        self.sd[f"{torch_prefix}.weight"] = _t(np.asarray(node["kernel"]).T)
        self.sd[f"{torch_prefix}.bias"] = _t(node["bias"])

    def layer_norm(self, flax_path: str, torch_prefix: str):
        node = self._get(self.params, flax_path)
        self.sd[f"{torch_prefix}.weight"] = _t(node["scale"])
        self.sd[f"{torch_prefix}.bias"] = _t(node["bias"])

    def vector(self, flax_path: str, torch_key: str):
        self.sd[torch_key] = _t(self._get(self.params, flax_path))


# names of a residual block's children: conv1..3, bn1..3 as they are
_BLOCK_CHILD = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}


def _residual_block(b: _StateDict, fp: str, tp: str):
    """BasicBlock or Bottleneck: every conv and BatchNorm of the block."""
    for name in b._get(b.params, fp):
        b.node(f"{fp}/{name}", f"{tp}.{_BLOCK_CHILD.get(name, name)}")


def _resnet(b: _StateDict, fp: str, tp: str):
    """A ResNet trunk of any depth (the blocks the tree holds)."""
    b.conv(f"{fp}conv1", f"{tp}conv1")
    b.bn(f"{fp}bn1", f"{tp}bn1")
    for name in b._get(b.params, fp.rstrip("/")):
        m = re.fullmatch(r"layer(\d)_(\d+)", name)
        if m:
            _residual_block(b, f"{fp}{name}", f"{tp}layer{m[1]}.{m[2]}")


def depth_encoder(params, batch_stats=None) -> dict:
    """DepthEncoder / PoseEncoder (a ResNet under `encoder`)."""
    b = _StateDict(params, batch_stats)
    _resnet(b, "encoder/", "encoder.")
    return b.sd


pose_encoder = depth_encoder


def litemono_encoder(params, batch_stats=None) -> dict:
    """LiteMono encoder (the inverse of the JAX package's
    convert_litemono_encoder; reference networks/LiteMono.py:296-444)."""
    b = _StateDict(params, batch_stats)
    for name, node in params.items():
        if name.startswith("stem1_"):
            k = name[len("stem1_"):]
            b.conv(f"{name}/conv", f"downsample_layers.0.{k}.conv")
            b.bn(f"{name}/bn", f"downsample_layers.0.{k}.bn_gelu.bn")
        elif name == "stem2":
            b.conv("stem2/conv", "stem2.0.conv")
        elif name.startswith("downsample"):
            b.conv(f"{name}/conv", f"downsample_layers.{name[-1]}.0.conv")
        elif name.startswith("stage"):
            i, j = name[len("stage"):].split("_")
            tp = f"stages.{i}.{j}"
            if "ddwconv" in node:  # a CDC block
                b.conv(f"{name}/ddwconv", f"{tp}.ddwconv.conv")
                b.bn(f"{name}/bn1", f"{tp}.bn1")
            else:  # the LGFI block
                if "pos_proj" in node:  # Dense (64, C) -> 1x1 conv (C, 64, 1, 1)
                    w = np.asarray(node["pos_proj"]["kernel"]).T[:, :, None, None]
                    b.sd[f"{tp}.pos_embd.token_projection.weight"] = _t(w)
                    b.vector(f"{name}/pos_proj/bias", f"{tp}.pos_embd.token_projection.bias")
                b.layer_norm(f"{name}/norm_xca", f"{tp}.norm_xca")
                b.vector(f"{name}/gamma_xca", f"{tp}.gamma_xca")
                b.vector(f"{name}/xca/temperature", f"{tp}.xca.temperature")
                b.dense(f"{name}/xca/qkv", f"{tp}.xca.qkv")
                b.dense(f"{name}/xca/proj", f"{tp}.xca.proj")
            b.layer_norm(f"{name}/mlp/norm", f"{tp}.norm")
            b.dense(f"{name}/mlp/pwconv1", f"{tp}.pwconv1")
            b.dense(f"{name}/mlp/pwconv2", f"{tp}.pwconv2")
            b.vector(f"{name}/mlp/gamma", f"{tp}.gamma")
    return b.sd


def litemono_decoder(params, scales=(0,)) -> dict:
    """ModuleList order upconv(2,0) .. upconv(0,1), then the dispconvs."""
    return _unet_decoder(params, 2, scales)


def hrnet(params, batch_stats=None) -> dict:
    """D-HRNet's encoder: HRNet under `encoder` (the inverse of the JAX
    package's convert_hrnet; reference networks/hrnet_encoder.py:294-498)."""
    b = _StateDict(params, batch_stats)
    for name in params["encoder"]:
        fp = f"encoder/{name}"
        if name in ("conv1", "conv2", "bn1", "bn2"):
            b.node(fp, f"encoder.{name}")
        elif name.startswith("layer1_"):
            _residual_block(b, fp, f"encoder.layer1.{name[len('layer1_'):]}")
        elif name.startswith("transition"):  # transition<t>_<i>[_<j>]: conv, bn
            tp = "encoder.transition" + ".".join(name[len("transition"):].split("_"))
            b.conv(f"{fp}/conv", f"{tp}.0")
            b.bn(f"{fp}/bn", f"{tp}.1")
        elif name.startswith("stage"):  # stage<s>_<m>
            tp = "encoder.stage" + ".".join(name[len("stage"):].split("_"))
            for child in params["encoder"][name]:
                parts = child.split("_")
                if child.startswith("branch"):  # branch<i>_<k>: a BasicBlock
                    _residual_block(b, f"{fp}/{child}",
                                    f"{tp}.branches.{child[len('branch'):].replace('_', '.')}")
                elif parts[-1] in ("conv", "bn"):  # fuse_<i>_<j>_conv / _bn
                    b.node(f"{fp}/{child}", f"{tp}.fuse_layers.{parts[1]}.{parts[2]}."
                           + ("0" if parts[-1] == "conv" else "1"))
                else:  # fuse_<i>_<j>_<k>: conv, bn
                    t = f"{tp}.fuse_layers.{parts[1]}.{parts[2]}.{parts[3]}"
                    b.conv(f"{fp}/{child}/conv", f"{t}.0")
                    b.bn(f"{fp}/{child}/bn", f"{t}.1")
    return b.sd


def dhrnet_decoder(params, scales=(0,)) -> dict:
    """D-HRNet decoder, in the reference's ModuleList order; it has the one
    disparity head of scale 0, whatever `scales` asks."""
    b = _StateDict(params, None)
    for idx, name in enumerate(DECODER_ORDER):
        if name.startswith("dispconv"):
            b.conv(f"{name}/conv", f"decoder.{idx}.conv")
        elif name.startswith("conv1x1"):  # flax nests ConvBlock1x1 one level less
            b.conv(f"{name}/conv", f"decoder.{idx}.conv.conv")
        else:
            b.conv(f"{name}/conv/conv", f"decoder.{idx}.conv.conv")
    return b.sd


def _unet_decoder(params, top: int, scales) -> dict:
    b = _StateDict(params, None)
    idx = 0
    for i in range(top, -1, -1):
        for j in (0, 1):
            b.conv(f"upconv_{i}_{j}/conv/conv", f"decoder.{idx}.conv.conv")
            idx += 1
    for s in scales:
        b.conv(f"dispconv_{s}/conv", f"decoder.{idx}.conv")
        idx += 1
    return b.sd


def depth_decoder(params, scales=(0,)) -> dict:
    """Monodepth2 decoder: upconv(4,0) .. upconv(0,1), then the dispconvs."""
    return _unet_decoder(params, 4, scales)


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


def fusion_module(params) -> dict:
    """fusion_conv is ordered from level L-1 down to 0; L is the number of
    levels in the tree."""
    b = _StateDict(params, None)
    num_levels = sum(1 for k in params if k.startswith("conv1x1_"))
    for idx, level in enumerate(range(num_levels - 1, -1, -1)):
        b.conv(f"conv1x1_{level}/conv", f"fusion_conv.{idx}.conv.conv")
    return b.sd


# each backbone's depth encoder and decoder converters
BACKBONES = {
    "ResNet18": (depth_encoder, depth_decoder),
    "ResNet50": (depth_encoder, depth_decoder),
    "LiteMono": (litemono_encoder, litemono_decoder),
    "DHRNet": (hrnet, dhrnet_decoder),
}


def bundle_state_dicts(params, batch_stats=None, vfi_params=None,
                       scales=(0,), vfi_test_params=None,
                       backbone: str = "ResNet18") -> dict[str, dict]:
    """{role: state_dict} for every role present in the JAX `params` tree
    (and `vfi_train` / `vfi_test` from `vfi_params` / `vfi_test_params`);
    the depth roles through `backbone`'s converters."""
    enc, dec = BACKBONES[backbone]
    bs = batch_stats or {}
    out = {}
    for role in ("encoder", "encoder_mf"):
        if role in params:
            out[role] = enc(params[role], bs.get(role))
    if "pose_encoder" in params:
        out["pose_encoder"] = pose_encoder(params["pose_encoder"], bs.get("pose_encoder"))
    for role in ("depth", "depth_mf"):
        if role in params:
            out[role] = dec(params[role], scales)
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
    sds = bundle_state_dicts(params, batch_stats, vfi_params, scales, vfi_test_params,
                             bundle.cfg.backbone)
    for role, sd in sds.items():
        if role == "depth_mf" or hasattr(bundle, role):
            bundle.role(role).load_state_dict(sd, strict=True)
