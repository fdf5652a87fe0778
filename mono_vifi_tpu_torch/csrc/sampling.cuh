// Per-axis bases and separable weights of a bilinear sample, computed from a
// normalized coordinate in registers, shared by the kernels of warp.cu and
// fwarp.cu.
//
// Exactness: every product and sum is written with __fmul_rn / __fadd_rn /
// __fsub_rn in the order of ops/sampling.py (`_unnormalize`,
// `border_factors`, `zeros_factors`), so nvcc cannot contract them into fused
// multiply-adds, and the values equal the plain PyTorch version's bit for bit.
#pragma once

#include "common.cuh"

namespace mv {

// normalized coordinate -> pixel coordinate, ops/sampling.py `_unnormalize`
__device__ __forceinline__ float unnormalize(float g, int size, bool align) {
  if (align) {
    return __fmul_rn(__fmul_rn(__fadd_rn(g, 1.0f), 0.5f), (float)(size - 1));
  }
  return __fmul_rn(__fsub_rn(__fmul_rn(__fadd_rn(g, 1.0f), (float)size), 1.0f),
                   0.5f);
}

// one axis of ops/sampling.py `border_factors`: base in [0, n-2], weights
// (1 - w, w), and whether the unclamped coordinate lies inside [0, n-1]
// (where the clamp passes the gradient)
struct Axis {
  int base;
  float w0, w1;
  bool inside;
};

__device__ __forceinline__ Axis border_axis(float g, int n, bool align) {
  const float u = unnormalize(g, n, align);
  const float hi = (float)(n - 1);
  const float v = fminf(fmaxf(u, 0.0f), hi);
  const float b = fminf(fmaxf(floorf(v), 0.0f), (float)(n - 2));
  const float w = __fsub_rn(v, b);
  return {(int)b, __fsub_rn(1.0f, w), w, u >= 0.0f && u <= hi};
}

// one axis of ops/sampling.py `zeros_factors`: out-of-image taps weigh 0,
// and where clamping the base moved the tap pair each weight stays with its
// true row/column
__device__ __forceinline__ Axis zeros_axis(float g, int n, bool align) {
  const float u = unnormalize(g, n, align);
  const float f = floorf(u);
  const float w = __fsub_rn(u, f);
  const float omw = __fsub_rn(1.0f, w);
  const int i0 = __float2int_rz(f);
  const int b = clampi(i0, 0, max(n - 2, 0));
  const bool m0 = i0 >= 0 && i0 <= n - 1;
  const bool m1 = i0 + 1 >= 0 && i0 + 1 <= n - 1;
  const float w0 = __fadd_rn(m0 && i0 == b ? omw : 0.0f,
                             m1 && i0 + 1 == b ? w : 0.0f);
  const float w1 = __fadd_rn(m0 && i0 == b + 1 ? omw : 0.0f,
                             m1 && i0 + 1 == b + 1 ? w : 0.0f);
  return {b, w0, w1, false};
}

// the taps combined in f32 in the order of ops/sampling.py `combine_taps`:
// a0 * (c0 * t00 + c1 * t01) + a1 * (c0 * t10 + c1 * t11), each product and
// sum rounded on its own
__device__ __forceinline__ float combine(const Axis& ax, const Axis& ay,
                                         float t00, float t01, float t10,
                                         float t11) {
  const float top = __fadd_rn(__fmul_rn(ax.w0, t00), __fmul_rn(ax.w1, t01));
  const float bot = __fadd_rn(__fmul_rn(ax.w0, t10), __fmul_rn(ax.w1, t11));
  return __fadd_rn(__fmul_rn(ay.w0, top), __fmul_rn(ay.w1, bot));
}

}  // namespace mv
