"""Hand-written Hopper kernels of the port and their dispatch rules.

Each kernel has a wrapper beside a plain PyTorch version of the same
function. A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises -- there is no fallback. The one
exception is `plain_versions()`, a context that reference comparisons use to
run the plain versions on the card on purpose.

Every wrapper adds one to its entry of `LAUNCHES` where it launches its
kernel, and nowhere else, so a run can show which kernels it went through;
`LAUNCH_SHAPES` counts the same launches by kernel and the shape of the
kernel's first tensor argument. A CUDA graph (`training/graphs.py`) keeps
the launches made while it was captured (`recorded_launches`) and, at each
replay, counts them again through `launch` without calling the library
(`account`): the graph runs exactly those kernels with those arguments.
"""

from __future__ import annotations

import collections
import contextlib

import torch

KERNELS = ("bilinear_sample", "bilinear_sample_bwd", "ssim_l1_fwd", "ssim_l1_bwd",
           "bilinear_splat", "bilinear_sample_table")
LAUNCHES = {name: 0 for name in KERNELS}
LAUNCH_SHAPES: collections.Counter = collections.Counter()

_plain = False
_account_only = False  # inside `account`: count, launch nothing
_recording: list | None = None  # inside `recorded_launches`: the launches made


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCH_SHAPES.clear()


@contextlib.contextmanager
def plain_versions():
    """Run every wrapper's plain PyTorch version, also on CUDA tensors."""
    global _plain
    prev, _plain = _plain, True
    try:
        yield
    finally:
        _plain = prev


def use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel must run), False for a CPU tensor
    or inside `plain_versions()`; raises for any other device."""
    if t.device.type == "cpu" or _plain:
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {t.device}")
    return True


def check(t: torch.Tensor, name: str, dtypes, ndim: int, device) -> None:
    """Validate a tensor handed to a kernel: device, dtype, rank, layout."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {ndim}-D")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def launch(fn_name: str, kernel: str, *args, shape: tuple) -> None:
    """Call one C entry point of the kernel library on the current stream,
    raise on a non-zero CUDA error code, and count the launch (under
    `shape`, that of the kernel's first tensor argument). Inside `account`
    it only counts."""
    if not _account_only:
        from mono_vifi_tpu_torch.ops.cuda import build

        lib = build.load()
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
        if err != 0:
            raise RuntimeError(f"{fn_name} failed with CUDA error {err}")
        if _recording is not None:
            _recording.append((fn_name, kernel, args, tuple(shape)))
    LAUNCHES[kernel] += 1
    LAUNCH_SHAPES[kernel, tuple(shape)] += 1


@contextlib.contextmanager
def recorded_launches():
    """-> a list that collects each launch made inside, as (entry point,
    kernel, arguments, shape)."""
    global _recording
    prev, _recording = _recording, []
    try:
        yield _recording
    finally:
        _recording = prev


def account(launches) -> None:
    """Count `launches` (as `recorded_launches` lists them), each through
    the module's `launch` as it stands, so a wrapper put in its place sees
    them, without calling the kernel library."""
    global _account_only
    prev, _account_only = _account_only, True
    try:
        for fn_name, kernel, args, shape in launches:
            launch(fn_name, kernel, *args, shape=shape)
    finally:
        _account_only = prev
