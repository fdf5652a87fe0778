"""The readers of LiteMono's LayerNorm and GELU device time, on hand-built
traces: device ms per step in the kernels each names, nothing else, and
nothing where there is no trace or no such kernel."""

from __future__ import annotations

import pytest

from perfbench import harness, registry
from perfbench.spans import Spans
from perfbench.trace import Trace

CELL = "litemono_kitti_mr.train_mem"
NS = "void at::native::(anonymous namespace)::"
# the first, fourth and last two as a traced run of the cell on an H100
# printed them (torch 2.11); the other three, from the same kernel file,
# run at shapes the cell does not launch
LAYER_NORM = [
    NS + "vectorized_layer_norm_kernel<float, float, false>(int, float, float const*, "
         "float const*, float const*, float*, float*, float*)",
    NS + "RowwiseMomentsCUDAKernel<float, float>(long, float, float const*, float*, float*)",
    NS + "LayerNormForwardCUDAKernel<float, float>(long, float const*, float const*, "
         "float const*, float const*, float const*, float*)",
    NS + "layer_norm_grad_input_kernel_vectorized<float, float, false>(float const*, "
         "float const*, float const*, float const*, float const*, float*, int)",
    NS + "ComputeInternalGradientsCUDAKernel<float>(long, float const*, float const*, "
         "float const*, float*, float*)",
    NS + "GammaBetaBackwardCUDAKernelTemplate<float, float, 32u, 32u, 256u, false, true, "
         "false>(long, long, float const*, float const*, float const*, float const*, float*, "
         "float*)",
    NS + "GammaBetaBackwardCUDAKernelTemplate<float, float, 32u, 1u, 32u, true, false, "
         "false>(long, long, float const*, float const*, float const*, float const*, float*, "
         "float*)",
]
# as a traced run of the cell on an H100 printed them (torch 2.11)
GELU = [
    "void at::native::vectorized_elementwise_kernel<8, at::native::GeluCUDAKernelImpl("
    "at::TensorIteratorBase&, at::native::GeluType)::{lambda()#2}::operator()() const::"
    "{lambda()#4}::operator()() const::{lambda(c10::BFloat16)#1}, std::array<char*, 2ul> >"
    "(int, at::native::GeluCUDAKernelImpl, std::array<char*, 2ul>)",
    "void at::native::vectorized_elementwise_kernel<8, at::native::GeluBackwardCUDAKernelImpl("
    "at::TensorIteratorBase&, at::native::GeluType)::{lambda()#2}::operator()() const::"
    "{lambda()#4}::operator()() const::{lambda(c10::BFloat16, c10::BFloat16)#1}, "
    "std::array<char*, 3ul> >(int, at::native::GeluBackwardCUDAKernelImpl, std::array<char*, 3ul>)",
]
OTHERS = [
    "void at::native::batch_norm_backward_kernel<c10::BFloat16, float, float, int>(...)",
    "void at::native::batch_norm_collect_statistics_kernel<at::native::Var, c10::BFloat16, "
    "c10::BFloat16, float, int>(...)",
    "void at::native::batch_norm_transform_input_kernel<c10::BFloat16, float, float, true, "
    "int>(...)",
    "void at::native::reduce_kernel<128, 4, at::native::ReduceOp<c10::BFloat16, "
    "at::native::NormTwoOps<c10::BFloat16, float, c10::BFloat16, true>, unsigned int, "
    "c10::BFloat16, 4, 4> >(...)",
    "void cudnn::bn_fw_tr_1C11_kernel_NCHW<__nv_bfloat16, float, 512, true, 1>(...)",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<c10::BFloat16>,"
    " std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<c10::BFloat16>, "
    "std::array<char*, 3ul>)",
    "void at::native::vectorized_elementwise_kernel<4, at::native::sigmoid_kernel_cuda("
    "at::TensorIteratorBase&)::{lambda()#2}::operator()() const::{lambda(float)#1}, "
    "std::array<char*, 2ul> >(int, ...)",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128x64_warpgroup"
    "size1x1x1_execute_segment_k_off_kernel__5x_cudnn",
    "void cudnn::ops::nchwToNhwcKernel<__nv_bfloat16, __nv_bfloat16, float, false, true, "
    "(cudnnKernelDataType_t)0>(cudnn::ops::nchw2nhwc_params_t<float>, __nv_bfloat16 const*, "
    "__nv_bfloat16*)",
    "void at::native::conv_depthwise2d_forward_kernel<3, c10::BFloat16, int>(...)",
    "nvjet_tst_128x64_64x8_1x2_h_bz_coopA_TNT",
]


def read(metric, trace):
    window = harness.Window(t0=0.0, items=4, timed_items=2, timed_seconds=1.0, trace=trace)
    cell = registry.find_cell(CELL)
    return registry.reader(cell, metric)(harness.Run(Spans(), window, None))


def trace_of(names, us=1_000.0):
    """Two steps: each named kernel run once for `us` on the profiler's
    microsecond clock, one after another."""
    ops = [(n, i * us, (i + 1) * us) for i, n in enumerate(names)]
    return Trace(items=2, start_us=0.0, end_us=len(names) * us, device_ops=ops)


@pytest.mark.parametrize("metric, names", [("layernorm_ms.train", LAYER_NORM),
                                           ("gelu_ms.train", GELU)])
def test_reads_device_ms_per_step_of_its_kernels_alone(metric, names):
    # each of its kernels once at 1 ms, over two steps, beside all the others
    other = LAYER_NORM if metric == "gelu_ms.train" else GELU
    assert read(metric, trace_of(names + OTHERS + other)) == pytest.approx(len(names) / 2)
    assert read(metric, trace_of(names[::-1], us=3_000.0)) == pytest.approx(3 * len(names) / 2)


@pytest.mark.parametrize("metric", ["layernorm_ms.train", "gelu_ms.train"])
def test_reads_nothing_without_trace_or_kernel(metric):
    assert read(metric, None) is None
    assert read(metric, trace_of(OTHERS)) is None
    assert read(metric, Trace(items=3, start_us=0.0, end_us=10.0)) is None


def test_declared_for_the_litemono_cell_alone():
    bench = {m["name"]: m for m in registry.load_benchmark()["per_layer"]}
    for metric in ("layernorm_ms.train", "gelu_ms.train"):
        m = bench[metric]
        assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == (
            "ms", "lower", "device_trace", "models", "train_samples_per_s")
        assert m["workloads"] == [CELL]
