// bilinear_splat: the image adjoint of bilinear sampling. Scatter-adds a
// cotangent (N, C, Ho, Wo) with separable weights (a0, a1) x (c0, c1) at the
// integer bases (ly, lx) into an f32 canvas (U, C, H, W); use k lands in
// plane ids[k] (or k without ids), so uses that share a source plane are
// summed by the same atomics.
//
// Replaces mono_vifi_tpu/ops/pallas/splat.py `_splat_band_kernel` (C > 1,
// via `_splat_core`) and `_splat_band_kernel1` (C == 1, via
// `_splat_core1`). The TPU kernels turned the scatter into one-hot MXU
// matmuls over row bands with windows, a per-image shift, an overlap-add
// and a guard cascade falling back to XLA's scatter; all of that existed
// because the TPU cannot scatter. On this card atomicAdd on f32 is exact
// for any taps, needs no window and no guard, and the per-unique sum of the
// fusion table's uses falls out of the atomics directly.
//
// What bounds it on an H100: bytes, plus the atomic throughput of L2. Per
// pixel and channel it reads one cotangent value and issues four f32
// atomics into a canvas that the smooth flows of the main path keep close
// together. Design: one thread per cotangent pixel and group of up to four
// channels; the pixel's bases and four weights are read once and reused
// across the group, neighbouring threads take neighbouring pixels so the
// cotangent reads are coalesced, and taps whose weight is exactly zero
// (outside the image in zeros mode) issue no atomic. The order of the atomic
// sums varies from run to run, so results are not bitwise reproducible.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChannelGroup = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    splat_kernel(const T* __restrict__ ct, const int* __restrict__ ly,
                 const int* __restrict__ lx, const float* __restrict__ a0,
                 const float* __restrict__ a1, const float* __restrict__ c0,
                 const float* __restrict__ c1, const int* __restrict__ ids,
                 float* __restrict__ canvas, int C, int P, int U, int H,
                 int W) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int n = blockIdx.z;
  const int c_begin = blockIdx.y * kChannelGroup;
  const int c_end = min(c_begin + kChannelGroup, C);
  const int64_t pix = (int64_t)n * P + p;
  const int y = mv::clampi(__ldg(ly + pix), 0, H - 2);
  const int x = mv::clampi(__ldg(lx + pix), 0, W - 2);
  const float wa0 = __ldg(a0 + pix), wa1 = __ldg(a1 + pix);
  const float wc0 = __ldg(c0 + pix), wc1 = __ldg(c1 + pix);
  const float w00 = wa0 * wc0, w01 = wa0 * wc1;
  const float w10 = wa1 * wc0, w11 = wa1 * wc1;
  // plane of this use; clamped so that a malformed id cannot write outside
  const int u = ids ? mv::clampi(__ldg(ids + n), 0, U - 1) : n;
  const int64_t plane = (int64_t)H * W;
  const int64_t off = (int64_t)y * W + x;
  for (int c = c_begin; c < c_end; ++c) {
    const float v = mv::to_f32(ct[((int64_t)n * C + c) * P + p]);
    float* dst = canvas + ((int64_t)u * C + c) * plane + off;
    if (w00 != 0.0f) atomicAdd(dst, v * w00);
    if (w01 != 0.0f) atomicAdd(dst + 1, v * w01);
    if (w10 != 0.0f) atomicAdd(dst + W, v * w10);
    if (w11 != 0.0f) atomicAdd(dst + W + 1, v * w11);
  }
}

template <typename T>
void launch(const void* ct, const int* ly, const int* lx, const float* a0,
            const float* a1, const float* c0, const float* c1, const int* ids,
            float* canvas, int N, int C, int P, int U, int H, int W,
            cudaStream_t stream) {
  dim3 grid((P + kThreads - 1) / kThreads,
            (C + kChannelGroup - 1) / kChannelGroup, N);
  splat_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(ct), ly, lx, a0, a1, c0, c1, ids, canvas, C, P, U,
      H, W);
}

}  // namespace

// ct (N, C, Ho, Wo) f32 or bf16; ly, lx (N, Ho, Wo) int32; a0, a1, c0, c1
// (N, Ho, Wo) f32; ids (N,) int32 or null; canvas (U, C, H, W) f32, zeroed
// by the caller.
extern "C" int mv_bilinear_splat(const void* ct, int ct_dtype, const int* ly,
                                 const int* lx, const float* a0,
                                 const float* a1, const float* c0,
                                 const float* c1, const int* ids,
                                 float* canvas, int N, int C, int Ho, int Wo,
                                 int U, int H, int W, void* stream) {
  const int P = Ho * Wo;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ct_dtype == mv::kF32) {
    launch<float>(ct, ly, lx, a0, a1, c0, c1, ids, canvas, N, C, P, U, H, W, s);
  } else if (ct_dtype == mv::kBF16) {
    launch<__nv_bfloat16>(ct, ly, lx, a0, a1, c0, c1, ids, canvas, N, C, P, U,
                          H, W, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
