// Shared helpers of the port's hand-written Hopper kernels.
//
// Every kernel here is reached through a plain C entry point
// (`extern "C" int mv_*`) that the Python wrappers call through ctypes with
// device pointers and the current stream as integers. An entry point
// launches on the given stream, never synchronises or allocates, and returns
// cudaGetLastError() so that a refused launch raises in Python.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mv {

// dtype codes shared with the Python wrappers
enum Dtype { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// value conversion between storage types (bf16 -> bf16 is a plain copy)
template <typename To, typename From>
__device__ __forceinline__ To convert(From v) {
  return from_f32<To>(to_f32(v));
}
template <>
__device__ __forceinline__ __nv_bfloat16 convert<__nv_bfloat16, __nv_bfloat16>(
    __nv_bfloat16 v) {
  return v;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace mv
