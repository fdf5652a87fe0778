// ssim_l1_fwd / ssim_l1_bwd: the fused photometric map
//   out = mean_c [0.85 * clip((1 - SSIM) / 2, 0, 1) + 0.15 * |x - y|]
// (or mean_c |x - y| without SSIM) with reflect-padded 3x3 mean pools, and
// its gradient with respect to x.
//
// Replaces mono_vifi_tpu/ops/pallas/photometric.py `_fwd_kernel` (forward)
// and `_bwd_kernel` (gradient to x only, recomputing the pooled statistics
// and applying the adjoint of the reflect-padded pool).
//
// What bounds it on an H100: bytes. The forward reads two (N, C, H, W) f32
// planes and writes one (N, H, W) plane, with ~60 flops per pixel and
// channel against 24 bytes -- far below the card's ~20 flop/byte f32 ridge.
// The TPU kernel held a whole image in VMEM; here a block holds a 32x8 tile
// of the current channel plus a one-pixel reflect halo in shared memory, so
// each input value is read from device memory about (34*10)/(32*8) = 1.3
// times and every pool, SSIM term and the L1 term are formed in registers.
// The backward runs as two launches: the first recomputes the pooled
// statistics the same way and writes three per-pixel fields (gmu, dsig_x,
// dsig_xy); the second applies the pool adjoint, whose reflect fold gives
// rows/columns 1 and n-2 a second copy of the edge value, and combines.
#include "common.cuh"

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr float kC1 = 0.01f * 0.01f;
constexpr float kC2 = 0.03f * 0.03f;

__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
  return mv::clampi(i, 0, n - 1);
}

// load the (TY+2) x (TX+2) reflect-padded tile of one plane whose interior
// starts at (y0, x0)
__device__ __forceinline__ void load_tile(const float* __restrict__ plane,
                                          float (*s)[TX + 2], int H, int W,
                                          int y0, int x0) {
  const int t = threadIdx.y * TX + threadIdx.x;
  for (int i = t; i < (TY + 2) * (TX + 2); i += TX * TY) {
    const int ty = i / (TX + 2);
    const int tx = i - ty * (TX + 2);
    const int gy = reflect(y0 + ty - 1, H);
    const int gx = reflect(x0 + tx - 1, W);
    s[ty][tx] = __ldg(plane + (int64_t)gy * W + gx);
  }
}

struct Stats {
  float mu_x, mu_y, sig_x, sig_y, sig_xy;
};

// 3x3 mean pools around tile cell (ty+1, tx+1), summed rows first, then
// columns, as the reference pool does
__device__ __forceinline__ Stats pooled(const float (*sx)[TX + 2],
                                        const float (*sy)[TX + 2], int ty,
                                        int tx) {
  float cx[3], cy[3], cxx[3], cyy[3], cxy[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float x0 = sx[ty][tx + d], x1 = sx[ty + 1][tx + d],
                x2 = sx[ty + 2][tx + d];
    const float y0 = sy[ty][tx + d], y1 = sy[ty + 1][tx + d],
                y2 = sy[ty + 2][tx + d];
    cx[d] = x0 + x1 + x2;
    cy[d] = y0 + y1 + y2;
    cxx[d] = x0 * x0 + x1 * x1 + x2 * x2;
    cyy[d] = y0 * y0 + y1 * y1 + y2 * y2;
    cxy[d] = x0 * y0 + x1 * y1 + x2 * y2;
  }
  Stats s;
  s.mu_x = (cx[0] + cx[1] + cx[2]) / 9.0f;
  s.mu_y = (cy[0] + cy[1] + cy[2]) / 9.0f;
  s.sig_x = (cxx[0] + cxx[1] + cxx[2]) / 9.0f - s.mu_x * s.mu_x;
  s.sig_y = (cyy[0] + cyy[1] + cyy[2]) / 9.0f - s.mu_y * s.mu_y;
  s.sig_xy = (cxy[0] + cxy[1] + cxy[2]) / 9.0f - s.mu_x * s.mu_y;
  return s;
}

__global__ void __launch_bounds__(TX* TY)
    fwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
               float* __restrict__ out, int C, int H, int W, int use_ssim) {
  __shared__ float sx[TY + 2][TX + 2];
  __shared__ float sy[TY + 2][TX + 2];
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int ty = threadIdx.y, tx = threadIdx.x;
  const int64_t plane = (int64_t)H * W;
  float acc = 0.0f;
  for (int c = 0; c < C; ++c) {
    __syncthreads();
    load_tile(x + ((int64_t)n * C + c) * plane, sx, H, W, y0, x0);
    load_tile(y + ((int64_t)n * C + c) * plane, sy, H, W, y0, x0);
    __syncthreads();
    const float l1 = fabsf(sy[ty + 1][tx + 1] - sx[ty + 1][tx + 1]);
    float v = l1;
    if (use_ssim) {
      const Stats s = pooled(sx, sy, ty, tx);
      const float num = (2.0f * s.mu_x * s.mu_y + kC1) * (2.0f * s.sig_xy + kC2);
      const float den = (s.mu_x * s.mu_x + s.mu_y * s.mu_y + kC1) *
                        (s.sig_x + s.sig_y + kC2);
      const float ss = fminf(fmaxf((1.0f - num / den) / 2.0f, 0.0f), 1.0f);
      v = 0.85f * ss + 0.15f * l1;
    }
    acc += v;
  }
  const int gy = y0 + ty, gx = x0 + tx;
  if (gy < H && gx < W) out[(int64_t)n * plane + (int64_t)gy * W + gx] = acc / C;
}

// backward, launch 1: per-pixel fields gmu, dsig_x, dsig_xy (each N,C,H,W)
__global__ void __launch_bounds__(TX* TY)
    bwd_fields_kernel(const float* __restrict__ x, const float* __restrict__ y,
                      const float* __restrict__ ct, float* __restrict__ gmu,
                      float* __restrict__ dsx, float* __restrict__ dsxy, int C,
                      int H, int W) {
  __shared__ float sx[TY + 2][TX + 2];
  __shared__ float sy[TY + 2][TX + 2];
  const int n = blockIdx.z;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  const int ty = threadIdx.y, tx = threadIdx.x;
  const int gy = y0 + ty, gx = x0 + tx;
  const bool inside = gy < H && gx < W;
  const int64_t plane = (int64_t)H * W;
  const float g_ct =
      inside ? __ldg(ct + (int64_t)n * plane + (int64_t)gy * W + gx) / C : 0.0f;
  for (int c = 0; c < C; ++c) {
    __syncthreads();
    load_tile(x + ((int64_t)n * C + c) * plane, sx, H, W, y0, x0);
    load_tile(y + ((int64_t)n * C + c) * plane, sy, H, W, y0, x0);
    __syncthreads();
    if (!inside) continue;
    const Stats s = pooled(sx, sy, ty, tx);
    const float A = 2.0f * s.mu_x * s.mu_y + kC1;
    const float Bs = 2.0f * s.sig_xy + kC2;
    const float Dm = s.mu_x * s.mu_x + s.mu_y * s.mu_y + kC1;
    const float Ds = s.sig_x + s.sig_y + kC2;
    const float num = A * Bs;
    const float d = Dm * Ds;
    const float L = (1.0f - num / d) / 2.0f;
    const float gate = (L > 0.0f && L < 1.0f) ? 1.0f : 0.0f;
    const float g = 0.85f * g_ct * gate;
    const float dn = -g / (2.0f * d);
    const float dd = g * num / (2.0f * d * d);
    const float dmu_x = dn * 2.0f * s.mu_y * Bs + dd * 2.0f * s.mu_x * Ds;
    const float dsig_x = dd * Dm;
    const float dsig_xy = dn * 2.0f * A;
    const int64_t o = ((int64_t)n * C + c) * plane + (int64_t)gy * W + gx;
    gmu[o] = dmu_x - 2.0f * s.mu_x * dsig_x - s.mu_y * dsig_xy;
    dsx[o] = dsig_x;
    dsxy[o] = dsig_xy;
  }
}

// weights of rows p-1, p, p+1 in the adjoint of a reflect-padded 3-tap box:
// the reflect fold sends padded row -1 to row 1 and row n to row n-2
__device__ __forceinline__ void adjoint_weights(int p, int n, float w[3]) {
  w[0] = (p - 1 >= 0 ? 1.0f : 0.0f) + (p == 1 ? 1.0f : 0.0f);
  w[1] = 1.0f;
  w[2] = (p + 1 <= n - 1 ? 1.0f : 0.0f) + (p == n - 2 ? 1.0f : 0.0f);
}

// backward, launch 2: dx = L1 term + P^T(gmu) + 2x P^T(dsig_x) + y P^T(dsig_xy)
__global__ void bwd_combine_kernel(const float* __restrict__ x,
                                   const float* __restrict__ y,
                                   const float* __restrict__ ct,
                                   const float* __restrict__ gmu,
                                   const float* __restrict__ dsx,
                                   const float* __restrict__ dsxy,
                                   float* __restrict__ dx, int C, int H, int W,
                                   int use_ssim) {
  const int gx = blockIdx.x * blockDim.x + threadIdx.x;
  const int gy = blockIdx.y * blockDim.y + threadIdx.y;
  if (gx >= W || gy >= H) return;
  const int n = blockIdx.z / C;
  const int c = blockIdx.z - n * C;
  const int64_t plane = (int64_t)H * W;
  const int64_t base = ((int64_t)n * C + c) * plane;
  const int64_t o = base + (int64_t)gy * W + gx;
  const float xv = __ldg(x + o), yv = __ldg(y + o);
  const float g_ct = __ldg(ct + (int64_t)n * plane + (int64_t)gy * W + gx) / C;
  const float diff = yv - xv;
  const float sgn = diff > 0.0f ? 1.0f : (diff < 0.0f ? -1.0f : 0.0f);
  float out = (use_ssim ? -0.15f : -1.0f) * sgn * g_ct;
  if (use_ssim) {
    float wy[3], wx[3];
    adjoint_weights(gy, H, wy);
    adjoint_weights(gx, W, wx);
    float a_mu = 0.0f, a_sx = 0.0f, a_sxy = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int qy = gy - 1 + i;
      if (wy[i] == 0.0f) continue;
      float r_mu = 0.0f, r_sx = 0.0f, r_sxy = 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int qx = gx - 1 + j;
        if (wx[j] == 0.0f) continue;
        const int64_t q = base + (int64_t)qy * W + qx;
        r_mu += wx[j] * __ldg(gmu + q);
        r_sx += wx[j] * __ldg(dsx + q);
        r_sxy += wx[j] * __ldg(dsxy + q);
      }
      a_mu += wy[i] * r_mu;
      a_sx += wy[i] * r_sx;
      a_sxy += wy[i] * r_sxy;
    }
    out = out + a_mu / 9.0f;
    out = out + 2.0f * xv * (a_sx / 9.0f);
    out = out + yv * (a_sxy / 9.0f);
  }
  dx[o] = out;
}

}  // namespace

// x, y (N, C, H, W) f32; out (N, H, W) f32
extern "C" int mv_ssim_l1_fwd(const float* x, const float* y, float* out, int N,
                              int C, int H, int W, int use_ssim, void* stream) {
  dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, N);
  fwd_kernel<<<grid, dim3(TX, TY), 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, out, C, H, W, use_ssim);
  return (int)cudaGetLastError();
}

// x, y (N, C, H, W) f32; ct (N, H, W) f32; fields 3 x (N, C, H, W) f32
// scratch (unused without SSIM); dx (N, C, H, W) f32
extern "C" int mv_ssim_l1_bwd(const float* x, const float* y, const float* ct,
                              float* fields, float* dx, int N, int C, int H,
                              int W, int use_ssim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t numel = (int64_t)N * C * H * W;
  float* gmu = fields;
  float* dsx = fields + numel;
  float* dsxy = fields + 2 * numel;
  if (use_ssim) {
    dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, N);
    bwd_fields_kernel<<<grid, dim3(TX, TY), 0, s>>>(x, y, ct, gmu, dsx, dsxy,
                                                    C, H, W);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  dim3 grid2((W + TX - 1) / TX, (H + TY - 1) / TY, N * C);
  bwd_combine_kernel<<<grid2, dim3(TX, TY), 0, s>>>(x, y, ct, gmu, dsx, dsxy,
                                                    dx, C, H, W, use_ssim);
  return (int)cudaGetLastError();
}
