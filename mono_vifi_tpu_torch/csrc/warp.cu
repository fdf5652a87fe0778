// bilinear_sample: bilinear sampling of an NCHW image at normalized
// coordinate planes, `border` or `zeros` padding, either align_corners, with
// the four taps rounded to a tap dtype and combined in f32 in one pass.
// bilinear_sample_bwd: its gradient to the coordinate planes (border mode).
//
// Replaces mono_vifi_tpu/ops/pallas/warp.py `_warp_taps_kernel_packed` (bf16
// taps, u32 pair-packed) and `_warp_taps_kernel` (taps in any dtype), both
// launched by `_windowed_taps4` under `grid_sample_windowed_planar` /
// `grid_sample_windowed_zeros`. The TPU kernels only fetched taps, and XLA
// fused the weights and the combine into their unpack. The gradient kernel
// is the port's own: the JAX side took the grid's gradient in XLA.
//
// What bounds them on an H100: bytes. Per output pixel and channel the
// forward reads four neighbouring image values and writes one result; the
// arithmetic (the weights once per pixel, six products and three sums per
// channel) is small beside that. The bytes that must move are those of
// F.grid_sample: the image, the two coordinate planes and the output; the
// backward reads the image, the planes and the cotangent and writes two
// planes. The TPU kernel's windows, span guards and pair packing existed to
// turn a rate-bound gather into VMEM-resident selects; on this card a direct
// gather is exact for any coordinates, so none of it comes across. Design:
// one thread per output pixel and group of up to four channels. The thread
// computes the integer bases and the separable weights in registers from the
// pixel's coordinates, then gathers, rounds and combines each channel's taps,
// so no (N, C, 4, Ho, Wo) taps tensor and no weight plane is written.
// Neighbouring threads take neighbouring output pixels, so the coordinate
// loads and output stores are coalesced, and the smooth flows of the main
// path keep the gathers of a warp within a few cache lines of each other.
// The backward re-gathers the taps, sums over all channels in registers and
// writes the two coordinate gradients directly.
//
// Exactness: the weights and the combine come from sampling.cuh, which rounds
// every product and sum on its own in the order of ops/sampling.py, so the
// forward equals the plain PyTorch version bit for bit. The backward sums the
// channels in its own order.
#include "sampling.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChannelGroup = 4;

using mv::Axis;
using mv::border_axis;
using mv::zeros_axis;

// a tap as the plain version sees it: rounded to the tap dtype, then f32
template <typename Ttap, typename Tin>
__device__ __forceinline__ float tap(const Tin* p) {
  return mv::to_f32(mv::convert<Ttap>(p[0]));
}

template <typename Tin, typename Ttap, bool kZeros>
__global__ void __launch_bounds__(kThreads)
    sample_kernel(const Tin* __restrict__ img, const float* __restrict__ gx,
                  const float* __restrict__ gy, Tin* __restrict__ out, int C,
                  int H, int W, int P, int align) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int b = blockIdx.z;
  const int c_begin = blockIdx.y * kChannelGroup;
  const int c_end = min(c_begin + kChannelGroup, C);
  const int64_t pix = (int64_t)b * P + p;
  const float u = __ldg(gx + pix), v = __ldg(gy + pix);
  const Axis ax = kZeros ? zeros_axis(u, W, align) : border_axis(u, W, align);
  const Axis ay = kZeros ? zeros_axis(v, H, align) : border_axis(v, H, align);
  const int64_t plane = (int64_t)H * W;
  const Tin* src = img + ((int64_t)b * C + c_begin) * plane +
                   (int64_t)ay.base * W + ax.base;
  Tin* dst = out + ((int64_t)b * C + c_begin) * P + p;
#pragma unroll
  for (int c = 0; c < kChannelGroup; ++c) {
    if (c_begin + c >= c_end) break;
    const Tin* s = src + c * plane;
    const float t00 = tap<Ttap>(s), t01 = tap<Ttap>(s + 1);
    const float t10 = tap<Ttap>(s + W), t11 = tap<Ttap>(s + W + 1);
    const float r = mv::combine(ax, ay, t00, t01, t10, t11);
    dst[(int64_t)c * P] = mv::from_f32<Tin>(r);
  }
}

// d out / d(gx, gy) for border mode, summed over all channels. The products
// follow autograd through combine_taps (cotangent times row weight, times
// tap, summed over channels per tap) and the chain rule through the clamp
// and the unnormalize, in its order.
template <typename Tin, typename Ttap>
__global__ void __launch_bounds__(kThreads)
    sample_grad_kernel(const Tin* __restrict__ img, const float* __restrict__ gx,
                       const float* __restrict__ gy, const Tin* __restrict__ ct,
                       float* __restrict__ dgx, float* __restrict__ dgy, int C,
                       int H, int W, int P, int align) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int b = blockIdx.y;
  const int64_t pix = (int64_t)b * P + p;
  const Axis ax = border_axis(__ldg(gx + pix), W, align);
  const Axis ay = border_axis(__ldg(gy + pix), H, align);
  const int64_t plane = (int64_t)H * W;
  const Tin* src = img + (int64_t)b * C * plane + (int64_t)ay.base * W + ax.base;
  const Tin* g = ct + (int64_t)b * C * P + p;
  // sums over channels of ct * a_i * t_ij (for the column weights) and of
  // ct * row_i (for the row weights)
  float s00 = 0.0f, s01 = 0.0f, s10 = 0.0f, s11 = 0.0f, sa0 = 0.0f, sa1 = 0.0f;
  for (int c = 0; c < C; ++c) {
    const Tin* s = src + c * plane;
    const float t00 = tap<Ttap>(s), t01 = tap<Ttap>(s + 1);
    const float t10 = tap<Ttap>(s + W), t11 = tap<Ttap>(s + W + 1);
    const float gc = mv::to_f32(g[(int64_t)c * P]);
    const float dtop = __fmul_rn(gc, ay.w0), dbot = __fmul_rn(gc, ay.w1);
    s00 = __fadd_rn(s00, __fmul_rn(dtop, t00));
    s01 = __fadd_rn(s01, __fmul_rn(dtop, t01));
    s10 = __fadd_rn(s10, __fmul_rn(dbot, t10));
    s11 = __fadd_rn(s11, __fmul_rn(dbot, t11));
    const float top = __fadd_rn(__fmul_rn(ax.w0, t00), __fmul_rn(ax.w1, t01));
    const float bot = __fadd_rn(__fmul_rn(ax.w0, t10), __fmul_rn(ax.w1, t11));
    sa0 = __fadd_rn(sa0, __fmul_rn(gc, top));
    sa1 = __fadd_rn(sa1, __fmul_rn(gc, bot));
  }
  // w1 = w and w0 = 1 - w, so d/dw = d/dw1 - d/dw0
  const float dwx = __fsub_rn(__fadd_rn(s01, s11), __fadd_rn(s00, s10));
  const float dwy = __fsub_rn(sa1, sa0);
  float rx, ry;
  if (align) {
    rx = __fmul_rn(__fmul_rn(dwx, (float)(W - 1)), 0.5f);
    ry = __fmul_rn(__fmul_rn(dwy, (float)(H - 1)), 0.5f);
  } else {
    rx = __fmul_rn(__fmul_rn(dwx, 0.5f), (float)W);
    ry = __fmul_rn(__fmul_rn(dwy, 0.5f), (float)H);
  }
  dgx[pix] = ax.inside ? rx : 0.0f;
  dgy[pix] = ay.inside ? ry : 0.0f;
}

template <typename Tin, typename Ttap>
void launch_fwd(const void* img, const float* gx, const float* gy, void* out,
                int B, int C, int H, int W, int P, int zeros, int align,
                cudaStream_t stream) {
  dim3 grid((P + kThreads - 1) / kThreads,
            (C + kChannelGroup - 1) / kChannelGroup, B);
  const Tin* i = static_cast<const Tin*>(img);
  Tin* o = static_cast<Tin*>(out);
  if (zeros) {
    sample_kernel<Tin, Ttap, true><<<grid, kThreads, 0, stream>>>(
        i, gx, gy, o, C, H, W, P, align);
  } else {
    sample_kernel<Tin, Ttap, false><<<grid, kThreads, 0, stream>>>(
        i, gx, gy, o, C, H, W, P, align);
  }
}

template <typename Tin, typename Ttap>
void launch_bwd(const void* img, const float* gx, const float* gy,
                const void* ct, float* dgx, float* dgy, int B, int C, int H,
                int W, int P, int align, cudaStream_t stream) {
  dim3 grid((P + kThreads - 1) / kThreads, B);
  sample_grad_kernel<Tin, Ttap><<<grid, kThreads, 0, stream>>>(
      static_cast<const Tin*>(img), gx, gy, static_cast<const Tin*>(ct), dgx,
      dgy, C, H, W, P, align);
}

}  // namespace

// img (B, C, H, W) f32 or bf16; gx, gy (B, Ho, Wo) f32 normalized
// coordinates; out (B, C, Ho, Wo) in the img dtype. tap_dtype: the dtype the
// taps are rounded to before the f32 combine. zeros: 0 border, 1 zeros.
extern "C" int mv_bilinear_sample(const void* img, int img_dtype,
                                  int tap_dtype, const float* gx,
                                  const float* gy, void* out, int B, int C,
                                  int H, int W, int Ho, int Wo, int zeros,
                                  int align, void* stream) {
  const int P = Ho * Wo;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (img_dtype == mv::kF32 && tap_dtype == mv::kF32) {
    launch_fwd<float, float>(img, gx, gy, out, B, C, H, W, P, zeros, align, s);
  } else if (img_dtype == mv::kF32 && tap_dtype == mv::kBF16) {
    launch_fwd<float, __nv_bfloat16>(img, gx, gy, out, B, C, H, W, P, zeros,
                                     align, s);
  } else if (img_dtype == mv::kBF16 && tap_dtype == mv::kF32) {
    launch_fwd<__nv_bfloat16, float>(img, gx, gy, out, B, C, H, W, P, zeros,
                                     align, s);
  } else if (img_dtype == mv::kBF16 && tap_dtype == mv::kBF16) {
    launch_fwd<__nv_bfloat16, __nv_bfloat16>(img, gx, gy, out, B, C, H, W, P,
                                             zeros, align, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// border mode only. img (B, C, H, W) f32 or bf16; gx, gy (B, Ho, Wo) f32;
// ct (B, C, Ho, Wo) in the img dtype; dgx, dgy (B, Ho, Wo) f32.
extern "C" int mv_bilinear_sample_bwd(const void* img, int img_dtype,
                                      int tap_dtype, const float* gx,
                                      const float* gy, const void* ct,
                                      float* dgx, float* dgy, int B, int C,
                                      int H, int W, int Ho, int Wo, int align,
                                      void* stream) {
  const int P = Ho * Wo;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (img_dtype == mv::kF32 && tap_dtype == mv::kF32) {
    launch_bwd<float, float>(img, gx, gy, ct, dgx, dgy, B, C, H, W, P, align, s);
  } else if (img_dtype == mv::kF32 && tap_dtype == mv::kBF16) {
    launch_bwd<float, __nv_bfloat16>(img, gx, gy, ct, dgx, dgy, B, C, H, W, P,
                                     align, s);
  } else if (img_dtype == mv::kBF16 && tap_dtype == mv::kF32) {
    launch_bwd<__nv_bfloat16, float>(img, gx, gy, ct, dgx, dgy, B, C, H, W, P,
                                     align, s);
  } else if (img_dtype == mv::kBF16 && tap_dtype == mv::kBF16) {
    launch_bwd<__nv_bfloat16, __nv_bfloat16>(img, gx, gy, ct, dgx, dgy, B, C,
                                             H, W, P, align, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
