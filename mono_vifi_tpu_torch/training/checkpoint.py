"""Checkpoints of the port (counterpart of mono_vifi_tpu/training/checkpoint.py;
reference train.py:1108-1176).

Saving writes the reference's own `.pth` schema, which the loaders below
and the JAX package's `load_reference_pth` read:
  - `ckpt.pth`: a state_dict per trainable role (encoder / depth /
    depth_mf / encoder_mf / fusion_module / pose_encoder / pose, BatchNorm
    buffers included), `optimizer` (the optimizer's state_dict), `epoch`,
    `batch_idx`, `step_in_total`, `height`, `width`, `use_stereo`; a
    mid-epoch save every save_frequency batches gives step-granular resume
    together with the stateful sampler;
  - `models/model_{ep}.pth`: the role state_dicts and the scalars only.
Both are written to a temporary file that `os.replace` puts in place.

Loading takes two formats:
  - a reference `.pth` dict keyed by role (as above, or a released
    checkpoint, or a reference IFRNet file's `VFI` entry). The port's
    modules use the reference key schema, so the state_dicts load as they
    are;
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
import os
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


def load_vfi(path: str, bundle, role: str = "vfi_test") -> list[str]:
    """Load a frozen IFRNet into `bundle.<role>` (`vfi_test` or `vfi_train`)
    from a reference IFRNet `.pth` (its `VFI` entry) or a JAX weight-only
    `.pkl` holding `params["VFI"]`."""
    if path.endswith(".pth"):
        sd = torch.load(path, map_location="cpu", weights_only=True)["VFI"]
    else:
        sd = convert.ifrnet(load_weights_pkl(path)["params"]["VFI"])
    return load_roles(bundle, {role: sd})


def _scalars(cfg) -> dict:
    return {"height": cfg.height, "width": cfg.width, "use_stereo": cfg.use_stereo}


def _save(payload: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _role_state_dicts(bundle) -> dict:
    return {role: {k: v.detach().cpu() for k, v in m.state_dict().items()}
            for role, m in bundle.trainable_roles().items()}


def save_weights(path: str, bundle, cfg) -> None:
    """Per-epoch weight snapshot (reference models/model_{ep}.pth)."""
    _save(_role_state_dicts(bundle) | _scalars(cfg), path)


def save_checkpoint(path: str, state, cfg, epoch: int, batch_idx: int = 0) -> None:
    """The resumable checkpoint: weights, optimizer state and position."""
    _save(_role_state_dicts(state.bundle) | _scalars(cfg) | {
        "optimizer": state.optimizer.state_dict(),
        "epoch": epoch, "batch_idx": batch_idx, "step_in_total": int(state.step),
    }, path)


def load_checkpoint(path: str, state) -> tuple[int, int]:
    """Resume `state` from a `save_checkpoint` file: the role weights and
    BatchNorm buffers (tolerant), the optimizer state and the update count;
    -> (epoch, batch_idx) to resume at. The file is read onto the host and
    each tensor is copied to its parameter's device by the loads, so the
    optimizer's step counters stay on the host as a fresh optimizer keeps
    them."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    load_roles(state.bundle, {r: ckpt[r] for r in ROLES if r in ckpt})
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step_in_total"])
    return int(ckpt["epoch"]), int(ckpt["batch_idx"])


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
