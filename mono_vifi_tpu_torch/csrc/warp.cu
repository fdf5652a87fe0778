// bilinear_taps: the four border-clamped bilinear taps of an NCHW image at
// integer bases (ly, lx).
//
// Replaces mono_vifi_tpu/ops/pallas/warp.py `_warp_taps_kernel_packed` (bf16
// taps, u32 pair-packed) and `_warp_taps_kernel` (taps in any dtype), both
// launched by `_windowed_taps4`. As there, the kernel only fetches taps; the
// bilinear weights and the combine stay in PyTorch, so autograd carries the
// grid's gradient through the weights and the image gets none.
//
// What bounds it on an H100: bytes. Per output pixel and channel it reads
// four scattered image values and writes four taps; there is no arithmetic
// to speak of. The TPU kernel's windows, span guards and pair packing
// existed to turn a rate-bound gather into VMEM-resident selects; on this
// card a direct gather is exact for any coordinates, so none of it comes
// across. Design: one thread per output pixel and group of up to four
// channels. The pixel's two integer bases are read once and reused across
// the group; neighbouring threads take neighbouring output pixels, so the
// tap stores are coalesced, and the smooth flows of the main path keep the
// gathers of a warp within a few cache lines of each other.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChannelGroup = 4;

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads)
    taps_kernel(const Tin* __restrict__ img, const int* __restrict__ ly,
                const int* __restrict__ lx, Tout* __restrict__ out, int C,
                int H, int W, int P) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int b = blockIdx.z;
  const int c_begin = blockIdx.y * kChannelGroup;
  const int c_end = min(c_begin + kChannelGroup, C);
  const int64_t pix = (int64_t)b * P + p;
  // bases arrive clamped to [0, H-2] x [0, W-2]; clamping again keeps a
  // malformed index from reading outside the plane
  const int y = mv::clampi(__ldg(ly + pix), 0, H - 2);
  const int x = mv::clampi(__ldg(lx + pix), 0, W - 2);
  const int64_t off = (int64_t)y * W + x;
  const int64_t plane = (int64_t)H * W;
  for (int c = c_begin; c < c_end; ++c) {
    const Tin* src = img + ((int64_t)b * C + c) * plane + off;
    Tout* dst = out + ((int64_t)b * C + c) * 4 * P + p;
    dst[0] = mv::convert<Tout>(src[0]);
    dst[P] = mv::convert<Tout>(src[1]);
    dst[2 * (int64_t)P] = mv::convert<Tout>(src[W]);
    dst[3 * (int64_t)P] = mv::convert<Tout>(src[W + 1]);
  }
}

template <typename Tin, typename Tout>
void launch(const void* img, const int* ly, const int* lx, void* out, int B,
            int C, int H, int W, int P, cudaStream_t stream) {
  dim3 grid((P + kThreads - 1) / kThreads,
            (C + kChannelGroup - 1) / kChannelGroup, B);
  taps_kernel<Tin, Tout><<<grid, kThreads, 0, stream>>>(
      static_cast<const Tin*>(img), ly, lx, static_cast<Tout*>(out), C, H, W,
      P);
}

}  // namespace

// img (B, C, H, W) in f32 or bf16; ly, lx (B, Ho, Wo) int32;
// out (B, C, 4, Ho, Wo) in f32 or bf16, taps ordered (y0x0, y0x1, y1x0, y1x1).
extern "C" int mv_bilinear_taps(const void* img, int img_dtype, const int* ly,
                                const int* lx, void* out, int out_dtype, int B,
                                int C, int H, int W, int Ho, int Wo,
                                void* stream) {
  const int P = Ho * Wo;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (img_dtype == mv::kF32 && out_dtype == mv::kF32) {
    launch<float, float>(img, ly, lx, out, B, C, H, W, P, s);
  } else if (img_dtype == mv::kF32 && out_dtype == mv::kBF16) {
    launch<float, __nv_bfloat16>(img, ly, lx, out, B, C, H, W, P, s);
  } else if (img_dtype == mv::kBF16 && out_dtype == mv::kF32) {
    launch<__nv_bfloat16, float>(img, ly, lx, out, B, C, H, W, P, s);
  } else if (img_dtype == mv::kBF16 && out_dtype == mv::kBF16) {
    launch<__nv_bfloat16, __nv_bfloat16>(img, ly, lx, out, B, C, H, W, P, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
