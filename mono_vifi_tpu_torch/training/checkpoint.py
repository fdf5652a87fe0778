"""Loading weights for evaluation (counterpart of the load side of
mono_vifi_tpu/training/checkpoint.py; reference train.py:1108-1176).

Two formats:
  - a reference `.pth` dict keyed by role (encoder / depth / encoder_mf /
    depth_mf / fusion_module / pose_encoder / pose / VFI). The port's modules
    use the reference key schema, so the state_dicts load as they are;
  - a weight-only `.pkl` snapshot of the JAX package (`save_weights`: numpy
    parameter trees per role, an optional `batch_stats`, and scalars), which
    goes through the port's Flax -> port converter. It is unpickled by an
    unpickler that admits numpy arrays and builtins only.

Loading is key-intersection tolerant like the reference (train.py:1149-1154):
roles the bundle lacks are ignored, and keys that are missing or of another
shape keep their init values, each named in a warning.
"""

from __future__ import annotations

import logging
import pickle

import torch

from mono_vifi_tpu_torch import convert

ROLES = ("encoder", "depth", "encoder_mf", "depth_mf", "fusion_module",
         "pose_encoder", "pose")

log = logging.getLogger("mono_vifi_tpu_torch")


def load_state_dict_tolerant(module: torch.nn.Module, sd, prefix: str) -> list[str]:
    """Copy the keys of `sd` that `module` has with the same shape; -> the
    module's keys that kept their values."""
    take, kept = {}, []
    for k, v in module.state_dict().items():
        if k not in sd:
            kept.append(f"{prefix}.{k} (missing)")
        elif tuple(sd[k].shape) != tuple(v.shape):
            kept.append(f"{prefix}.{k} (shape {tuple(sd[k].shape)} != {tuple(v.shape)})")
        else:
            take[k] = torch.as_tensor(sd[k])
    module.load_state_dict(take, strict=False)
    return kept


def load_roles(bundle, role_sds) -> list[str]:
    """Load {role: state_dict} into the bundle's modules (tolerant, see the
    module docstring); -> the keys that kept their init values."""
    kept = []
    for role, sd in role_sds.items():
        module = getattr(bundle, role, None)
        if sd is None or module is None:
            continue
        kept += load_state_dict_tolerant(module, sd, role)
    if kept:
        log.warning("%d keys kept their init values: %s%s", len(kept),
                    ", ".join(kept[:12]), " ..." if len(kept) > 12 else "")
    return kept


def multi_frame_roles(role_sds) -> dict:
    """Map a checkpoint's multi-frame roles onto the slots the multi-frame
    evaluation reads (evaluate_depth_mf.py:59-71)."""
    def first(*names):
        return next((role_sds[n] for n in names if role_sds.get(n) is not None), None)

    return {
        "encoder": first("encoder_mf", "encoder"),
        "depth": first("depth_mf", "depth"),
        "depth_mf": first("depth_mf", "depth"),
        "fusion_module": role_sds.get("fusion_module"),
    }


def load_reference_pth(path: str, bundle, multi_frame: bool = False) -> list[str]:
    """Load a reference `.pth` checkpoint's roles into `bundle`; with
    `multi_frame`, through `multi_frame_roles`."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    role_sds = {r: ckpt[r] for r in ROLES if r in ckpt}
    if multi_frame:
        role_sds = multi_frame_roles(role_sds)
    return load_roles(bundle, role_sds)


def load_vfi_pth(path: str, bundle) -> list[str]:
    """Load the frozen evaluation VFI from a reference IFRNet `.pth` (its
    `VFI` entry) into `bundle.vfi_test`."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return load_roles(bundle, {"vfi_test": ckpt["VFI"]})


_NUMPY_GLOBALS = {
    ("numpy", "ndarray"), ("numpy", "dtype"),
    ("numpy.core.multiarray", "_reconstruct"), ("numpy._core.multiarray", "_reconstruct"),
    ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
    ("numpy.core.numeric", "_frombuffer"), ("numpy._core.numeric", "_frombuffer"),
}
_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int", "float", "bool",
             "str", "bytes", "bytearray", "complex"}


class _NumpyUnpickler(pickle.Unpickler):
    """Admits numpy arrays, numpy scalars and builtin containers only."""

    def find_class(self, module, name):
        if (module, name) in _NUMPY_GLOBALS or (
            module == "numpy.dtypes" and name.endswith("DType")
        ) or (module == "builtins" and name in _BUILTINS):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refused to load {module}.{name}")


def load_weights_pkl(path: str) -> dict:
    """Read a JAX `save_weights` snapshot with the restricted unpickler."""
    with open(path, "rb") as f:
        return _NumpyUnpickler(f).load()


def load_jax_weights(path: str, bundle) -> list[str]:
    """Load a JAX weight-only `.pkl` snapshot into `bundle` (tolerant)."""
    payload = load_weights_pkl(path)
    params = {r: v for r, v in payload["params"].items() if r in ROLES}
    sds = convert.bundle_state_dicts(
        params, payload.get("batch_stats"), scales=tuple(range(bundle.cfg.num_scales))
    )
    return load_roles(bundle, sds)
