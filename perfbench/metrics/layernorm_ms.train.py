"""Device ms per step in PyTorch's LayerNorm kernels, forward and backward
(the input's gradient and the gamma/beta gradient), over the traced
stretch: the kernels of ATen's layer_norm_kernel.cu, whose names contain
`layer_norm`, `LayerNorm` or `GammaBeta`, and its `RowwiseMoments` and
`ComputeInternalGradients` helpers, matched without regard to case. No
other norm in a step launches those helpers: BatchNorm's kernels are named
`batch_norm_*` and `bn_*`. `perfbench/trace.py`'s categories count
LayerNorm's forward as "elementwise" and its backward as "other".

A traced run of `litemono_kitti_mr.train_mem` on an H100 (torch 2.11)
launches four such kernels: `vectorized_layer_norm_kernel<float, float,
false>`, `layer_norm_grad_input_kernel_vectorized<float, float, false>` and
`GammaBetaBackwardCUDAKernelTemplate<float, float, 32u, 32u, 256u, false,
true, false>` and `<float, float, 32u, 1u, 32u, true, false, false>`.

It counts kernels rather than the port's `litemono.*` spans because a
replayed step runs no span inside its graphs."""

KEYS = ("layer_norm", "layernorm", "gammabeta", "rowwisemoments", "computeinternalgradients")


def read(run):
    tr = run.trace
    if tr is None:
        return None
    us = sum(b - a for name, a, b in tr.device_ops if any(k in name.lower() for k in KEYS))
    return us / 1e3 / tr.items if us else None
