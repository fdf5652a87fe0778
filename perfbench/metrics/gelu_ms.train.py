"""Device ms per step in GELU's forward and backward kernels (names
containing `gelu`, matched without regard to case), over the traced
stretch. `perfbench/trace.py`'s categories count them as "elementwise".

A traced run of `litemono_kitti_mr.train_mem` on an H100 (torch 2.11)
launches two: `vectorized_elementwise_kernel<8, GeluCUDAKernelImpl(...)
::{lambda(c10::BFloat16)#1}, ...>` and `vectorized_elementwise_kernel<8,
GeluBackwardCUDAKernelImpl(...)::{lambda(c10::BFloat16,
c10::BFloat16)#1}, ...>`.

It counts kernels rather than the port's `litemono.*` spans because a
replayed step runs no span inside its graphs."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    us = sum(b - a for name, a, b in tr.device_ops if "gelu" in name.lower())
    return us / 1e3 / tr.items if us else None
