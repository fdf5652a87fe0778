"""Hand-written Hopper kernels of the port and their dispatch rules.

Each kernel has a wrapper beside a plain PyTorch version of the same
function. A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises -- there is no fallback. The one
exception is `plain_versions()`, a context that reference comparisons use to
run the plain versions on the card on purpose.

Every wrapper adds one to its entry of `LAUNCHES` where it launches its
kernel, and nowhere else, so a run can show which kernels it went through.
"""

from __future__ import annotations

import contextlib

import torch

KERNELS = ("bilinear_taps", "ssim_l1_fwd", "ssim_l1_bwd", "bilinear_splat",
           "bilinear_sample_table")
LAUNCHES = {name: 0 for name in KERNELS}

_plain = False


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def launch(fn_name: str, kernel: str, *args) -> None:
    """Call one C entry point of the kernel library on the current stream,
    raise on a non-zero CUDA error code, and count the launch."""
    from mono_vifi_tpu_torch.ops.cuda import build

    lib = build.load()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, fn_name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed with CUDA error {err}")
    LAUNCHES[kernel] += 1
