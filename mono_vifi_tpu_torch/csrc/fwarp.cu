// bilinear_sample_table: border-mode bilinear sampling of N uses drawn from a
// table of U unique C-channel planes, out[k] = sample(table[ids[k]], grid[k]),
// gathered and combined in one pass.
//
// Replaces mono_vifi_tpu/ops/pallas/fwarp.py `_fwarp_kernel` (launched by
// `grid_sample_table_resident`). The TPU kernel kept whole (H, Wp) planes
// resident in VMEM, packed bf16 pairs into u32 lanes, padded widths to 128
// and walked data-dependent spans with fori_loops, because a TPU gather is
// rate-bound; it then wrote the taps out for XLA to combine. On this card a
// direct gather is exact for any coordinates, so none of that comes across.
//
// What bounds it on an H100: bytes. Per output pixel and channel it reads
// four neighbouring table values and writes one result; the arithmetic (six
// f32 products and three sums) is small beside that. The bytes that must
// move are the output, the six (N, Ho, Wo) coordinate and weight planes, and
// each table plane that ids uses, read once. Design, as in warp.cu: one
// thread per output pixel and group of up to eight channels, blockIdx.z the
// use k. The use's plane id is read once per block; the pixel's bases and
// four weights are read once and reused across the group. Gathering and
// combining in the same pass means the (N, C, 4, Ho, Wo) taps tensor of the
// unfused path (an index_select copy, then taps, then an f32 combine) is
// never written. Neighbouring threads take neighbouring output pixels, so
// the stores are coalesced, and the smooth flows of the fusion warp keep the
// gathers of a warp within a few cache lines of each other.
//
// The taps are combined in f32 in the order of ops/sampling.py combine_taps,
// a0 * (c0 * t00 + c1 * t01) + a1 * (c0 * t10 + c1 * t11), with each product
// and sum rounded on its own (no contraction into fused multiply-adds), so
// the result equals the plain PyTorch version bit for bit before the cast to
// the table's dtype.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChannelGroup = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sample_table_kernel(const T* __restrict__ table, const int* __restrict__ ids,
                        const int* __restrict__ ly, const int* __restrict__ lx,
                        const float* __restrict__ a0,
                        const float* __restrict__ a1,
                        const float* __restrict__ c0,
                        const float* __restrict__ c1, T* __restrict__ out,
                        int C, int H, int W, int P, int U) {
  const int k = blockIdx.z;
  // the use's table plane, once per block; clamped so that a malformed id
  // cannot read outside the table
  __shared__ int s_plane;
  if (threadIdx.x == 0) s_plane = ids ? mv::clampi(__ldg(ids + k), 0, U - 1) : k;
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int c_begin = blockIdx.y * kChannelGroup;
  const int c_end = min(c_begin + kChannelGroup, C);
  const int64_t pix = (int64_t)k * P + p;
  // bases arrive clamped to [0, H-2] x [0, W-2]; clamping again keeps a
  // malformed index from reading outside the plane
  const int y = mv::clampi(__ldg(ly + pix), 0, H - 2);
  const int x = mv::clampi(__ldg(lx + pix), 0, W - 2);
  const float wa0 = __ldg(a0 + pix), wa1 = __ldg(a1 + pix);
  const float wc0 = __ldg(c0 + pix), wc1 = __ldg(c1 + pix);
  const int64_t plane = (int64_t)H * W;
  const T* src = table + ((int64_t)s_plane * C + c_begin) * plane + (int64_t)y * W + x;
  T* dst = out + ((int64_t)k * C + c_begin) * P + p;
#pragma unroll
  for (int c = 0; c < kChannelGroup; ++c) {
    if (c_begin + c >= c_end) break;
    const T* s = src + c * plane;
    const float t00 = mv::to_f32(s[0]);
    const float t01 = mv::to_f32(s[1]);
    const float t10 = mv::to_f32(s[W]);
    const float t11 = mv::to_f32(s[W + 1]);
    const float top = __fadd_rn(__fmul_rn(wc0, t00), __fmul_rn(wc1, t01));
    const float bot = __fadd_rn(__fmul_rn(wc0, t10), __fmul_rn(wc1, t11));
    const float v = __fadd_rn(__fmul_rn(wa0, top), __fmul_rn(wa1, bot));
    dst[(int64_t)c * P] = mv::from_f32<T>(v);
  }
}

template <typename T>
void launch(const void* table, const int* ids, const int* ly, const int* lx,
            const float* a0, const float* a1, const float* c0, const float* c1,
            void* out, int N, int C, int H, int W, int P, int U,
            cudaStream_t stream) {
  dim3 grid((P + kThreads - 1) / kThreads,
            (C + kChannelGroup - 1) / kChannelGroup, N);
  sample_table_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(table), ids, ly, lx, a0, a1, c0, c1,
      static_cast<T*>(out), C, H, W, P, U);
}

}  // namespace

// table (U, C, H, W) f32 or bf16; ids (N,) int32 or null (use k reads plane
// k, N == U); ly, lx (N, Ho, Wo) int32; a0, a1, c0, c1 (N, Ho, Wo) f32;
// out (N, C, Ho, Wo) in the table's dtype.
extern "C" int mv_bilinear_sample_table(const void* table, int dtype,
                                        const int* ids, const int* ly,
                                        const int* lx, const float* a0,
                                        const float* a1, const float* c0,
                                        const float* c1, void* out, int N,
                                        int C, int H, int W, int Ho, int Wo,
                                        int U, void* stream) {
  const int P = Ho * Wo;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mv::kF32) {
    launch<float>(table, ids, ly, lx, a0, a1, c0, c1, out, N, C, H, W, P, U, s);
  } else if (dtype == mv::kBF16) {
    launch<__nv_bfloat16>(table, ids, ly, lx, a0, a1, c0, c1, out, N, C, H, W,
                          P, U, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
