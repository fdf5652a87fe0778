// ssim_l1_fwd / ssim_l1_bwd: the fused photometric map
//   out = mean_c [0.85 * clip((1 - SSIM) / 2, 0, 1) + 0.15 * |x - y|]
// (or mean_c |x - y| without SSIM) with reflect-padded 3x3 mean pools, and
// its gradient with respect to x.
//
// Replaces mono_vifi_tpu/ops/pallas/photometric.py `_fwd_kernel` (forward)
// and `_bwd_kernel` (gradient to x only, recomputing the pooled statistics
// and applying the adjoint of the reflect-padded pool).
//
// What bounds them on an H100: bytes, in principle. The forward reads two
// (N, C, H, W) f32 planes and writes one (N, H, W) plane, with ~60 flops per
// pixel and channel against 24 bytes -- below the card's ~20 flop/byte f32
// ridge. The TPU kernels held a whole image in VMEM.
//
// Forward: a block holds a 32x8 tile of the current channel plus a
// one-pixel reflect halo in shared memory, so each input value is read from
// device memory about (34*10)/(32*8) = 1.3 times and every pool, SSIM term
// and the L1 term are formed in registers.
//
// Backward, one launch: it reads x, y and the (N, H, W) cotangent and writes
// dx, 16 bytes per pixel and channel; its bound is those bytes. What held
// the two-launch design back was everything else it moved and waited on:
// three per-pixel fields written to device memory and read back through a
// 3x3 stencil by a second launch, and a shared tile reloaded per channel
// behind two block barriers. Here nothing else is moved, and what is left
// to bound it is instruction issue (~150 instructions per pixel and
// channel). A warp takes a 16-row by 60-column strip of one (n, c) plane
// and slides down it, two columns a lane. Each step loads one halo row of x
// and y (through L1: neighbouring strips share two columns), forms the 3x3
// column sums, gets the next lane's by shuffle, computes the three
// per-pixel fields (gmu, dsig_x, dsig_xy) one row behind, their
// column-weighted sums for the pool's adjoint, and writes the dx row one
// row further behind. The last three halo rows and field rows live in
// registers (71 a thread): no shared memory, no block barrier, no field in
// device memory. The adjoint's reflect fold gives rows/columns 1 and n-2 a
// second copy of the edge field (adjoint_weights).
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

// ---------------------------------------------------------------- backward

constexpr int kStripCols = 60;  // output columns of a strip, two a lane
constexpr int kStripRows = 16;  // output rows of a strip
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr float kNinth = 1.0f / 9.0f;

// sums of x, y, x^2, y^2, xy over three values
struct Sums {
  float x, y, xx, yy, xy;
};

// the 3-sums down one column (the reference pool sums rows first)
__device__ __forceinline__ Sums column_sums(float a0, float a1, float a2,
                                            float b0, float b1, float b2) {
  return {a0 + a1 + a2, b0 + b1 + b2, a0 * a0 + a1 * a1 + a2 * a2,
          b0 * b0 + b1 * b1 + b2 * b2, a0 * b0 + a1 * b1 + a2 * b2};
}

// ... then across three columns
__device__ __forceinline__ Sums across(const Sums& p, const Sums& q,
                                       const Sums& r) {
  return {p.x + q.x + r.x, p.y + q.y + r.y, p.xx + q.xx + r.xx,
          p.yy + q.yy + r.yy, p.xy + q.xy + r.xy};
}

__device__ __forceinline__ Sums from_next_lane(const Sums& s) {
  return {__shfl_down_sync(kFullWarp, s.x, 1),
          __shfl_down_sync(kFullWarp, s.y, 1),
          __shfl_down_sync(kFullWarp, s.xx, 1),
          __shfl_down_sync(kFullWarp, s.yy, 1),
          __shfl_down_sync(kFullWarp, s.xy, 1)};
}

// the three fields of one pixel from its 3x3 sums and its ct / C: the
// adjoint of the clamped (1 - SSIM) / 2 with respect to the pooled
// statistics, folded onto P(x) (f[0] = gmu), P(x^2) (f[1] = dsig_x) and
// P(xy) (f[2] = dsig_xy).
__device__ __forceinline__ void ssim_fields(const Sums& s, float g_ct,
                                            float f[3]) {
  const float mu_x = s.x * kNinth, mu_y = s.y * kNinth;
  const float sig_x = s.xx * kNinth - mu_x * mu_x;
  const float sig_y = s.yy * kNinth - mu_y * mu_y;
  const float sig_xy = s.xy * kNinth - mu_x * mu_y;
  const float A = 2.0f * mu_x * mu_y + kC1;
  const float Bs = 2.0f * sig_xy + kC2;
  const float Dm = mu_x * mu_x + mu_y * mu_y + kC1;
  const float Ds = sig_x + sig_y + kC2;
  const float num = A * Bs;
  const float inv_d = __fdividef(1.0f, Dm * Ds);
  const float q = num * inv_d;
  const float L = (1.0f - q) * 0.5f;
  const float g = (L > 0.0f && L < 1.0f) ? 0.85f * g_ct : 0.0f;
  const float dn = -0.5f * g * inv_d;
  const float dd = 0.5f * g * q * inv_d;
  const float dmu_x = dn * 2.0f * mu_y * Bs + dd * 2.0f * mu_x * Ds;
  f[1] = dd * Dm;
  f[2] = dn * 2.0f * A;
  f[0] = dmu_x - 2.0f * mu_x * f[1] - mu_y * f[2];
}

// weights of rows p-1, p, p+1 in the adjoint of a reflect-padded 3-tap box:
// the reflect fold sends padded row -1 to row 1 and row n to row n-2
__device__ __forceinline__ void adjoint_weights(int p, int n, float w[3]) {
  w[0] = (p - 1 >= 0 ? 1.0f : 0.0f) + (p == 1 ? 1.0f : 0.0f);
  w[1] = 1.0f;
  w[2] = (p + 1 <= n - 1 ? 1.0f : 0.0f) + (p == n - 2 ? 1.0f : 0.0f);
}

// A warp takes a 16 x 60 output strip of one (n, c) plane and slides down
// its rows. Lane l owns halo columns 2l, 2l+1 (image columns x0-2+2l, +1),
// field columns 2l, 2l+1 (image columns x0-1+2l, +1) and output columns
// 2l, 2l+1 (image columns x0+2l, +1; lanes 0..29). What a lane needs of the
// next lane's columns (column sums, fields, centre values) comes by shuffle;
// the last three halo rows and field rows stay in registers as rings
// indexed by row % 3.
__global__ void __launch_bounds__(32)
    ssim_bwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ ct, float* __restrict__ dx, int C,
                    int H, int W) {
  const int lane = threadIdx.x;
  const int64_t plane = (int64_t)H * W;
  const int64_t nc = blockIdx.z;
  const float* xp = x + nc * plane;
  const float* yp = y + nc * plane;
  const float* ctp = ct + (nc / C) * plane;
  float* dxp = dx + nc * plane;
  const float inv_c = 1.0f / C;
  const int y0 = blockIdx.y * kStripRows, x0 = blockIdx.x * kStripCols;

  const int hx = x0 - 2 + 2 * lane;
  const int hx0 = reflect(hx, W), hx1 = reflect(hx + 1, W);
  const int qx = hx + 1;
  const bool field0 = qx >= 0 && qx < W, field1 = qx + 1 < W;
  const int px = hx + 2;
  const bool out0 = lane < kStripCols / 2 && px < W;
  const bool out1 = lane < kStripCols / 2 && px + 1 < W;
  float wx0[3], wx1[3];
  adjoint_weights(px, W, wx0);
  adjoint_weights(px + 1, W, wx1);

  const int rows = min(kStripRows, H - y0) + 4;  // halo rows the strip needs
  float rx[3][2], ry[3][2];  // halo rows r, by r % 3
  float v[3][3][2];          // field rows fr: column-weighted sums, by fr % 3
  for (int r0 = 0; r0 < rows; r0 += 3) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int r = r0 + k;  // r % 3 == k
      if (r >= rows) break;
      const int km2 = (k + 1) % 3, km1 = (k + 2) % 3;  // rows r-2, r-1

      // 1. halo row r: image row y0 + r - 2, reflected
      const int64_t ro = (int64_t)reflect(y0 + r - 2, H) * W;
      rx[k][0] = __ldg(xp + ro + hx0);
      rx[k][1] = __ldg(xp + ro + hx1);
      ry[k][0] = __ldg(yp + ro + hx0);
      ry[k][1] = __ldg(yp + ro + hx1);
      if (r < 2) continue;

      // 2. field row fr = r - 2 (image row qy) from halo rows r-2..r
      const Sums c0 = column_sums(rx[km2][0], rx[km1][0], rx[k][0],
                                  ry[km2][0], ry[km1][0], ry[k][0]);
      const Sums c1 = column_sums(rx[km2][1], rx[km1][1], rx[k][1],
                                  ry[km2][1], ry[km1][1], ry[k][1]);
      const Sums c2 = from_next_lane(c0), c3 = from_next_lane(c1);
      const int qy = y0 + r - 3;
      float f0[3] = {0.0f, 0.0f, 0.0f}, f1[3] = {0.0f, 0.0f, 0.0f};
      if (qy >= 0 && qy < H) {
        const float* ctr = ctp + (int64_t)qy * W + qx;
        if (field0) ssim_fields(across(c0, c1, c2), __ldg(ctr) * inv_c, f0);
        if (field1) ssim_fields(across(c1, c2, c3), __ldg(ctr + 1) * inv_c, f1);
      }

      // 3. its column-weighted sums around the output columns (field
      // columns 2l..2l+3)
      float(&vf)[3][2] = v[km2];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float g2 = __shfl_down_sync(kFullWarp, f0[j], 1);
        const float g3 = __shfl_down_sync(kFullWarp, f1[j], 1);
        vf[j][0] = wx0[0] * f0[j] + f1[j] + wx0[2] * g2;
        vf[j][1] = wx1[0] * f1[j] + g2 + wx1[2] * g3;
      }
      // the centre values of output row r - 4 (halo row r - 2, columns
      // 2l+2, 2l+3)
      const float xc0 = __shfl_down_sync(kFullWarp, rx[km2][0], 1);
      const float xc1 = __shfl_down_sync(kFullWarp, rx[km2][1], 1);
      const float yc0 = __shfl_down_sync(kFullWarp, ry[km2][0], 1);
      const float yc1 = __shfl_down_sync(kFullWarp, ry[km2][1], 1);
      if (r < 4) continue;

      // 4. output row py = y0 + r - 4 from field rows r-4..r-2:
      // dx = L1 term + P^T(gmu) + 2x P^T(dsig_x) + y P^T(dsig_xy)
      const int py = y0 + r - 4;
      const float(&vp)[3][2] = v[km1];
      const float(&vc)[3][2] = v[k];
      float wy[3];
      adjoint_weights(py, H, wy);
      const int64_t po = (int64_t)py * W + px;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (!(j ? out1 : out0)) continue;
        const float xj = j ? xc1 : xc0, yj = j ? yc1 : yc0;
        const float g_ct = __ldg(ctp + po + j) * inv_c;
        const float diff = yj - xj;
        const float sgn = diff > 0.0f ? 1.0f : (diff < 0.0f ? -1.0f : 0.0f);
        const float a_mu = wy[0] * vp[0][j] + vc[0][j] + wy[2] * vf[0][j];
        const float a_sx = wy[0] * vp[1][j] + vc[1][j] + wy[2] * vf[1][j];
        const float a_sxy = wy[0] * vp[2][j] + vc[2][j] + wy[2] * vf[2][j];
        float o = -0.15f * sgn * g_ct;
        o = o + a_mu * kNinth;
        o = o + 2.0f * xj * (a_sx * kNinth);
        o = o + yj * (a_sxy * kNinth);
        dxp[po + j] = o;
      }
    }
  }
}

// without SSIM: dx = -sign(y - x) * ct / C, one elementwise pass
__global__ void l1_bwd_kernel(const float* __restrict__ x,
                              const float* __restrict__ y,
                              const float* __restrict__ ct,
                              float* __restrict__ dx, int C, int64_t plane,
                              int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t n = i / (C * plane);
  const int64_t p = i - (i / plane) * plane;
  const float diff = __ldg(y + i) - __ldg(x + i);
  const float sgn = diff > 0.0f ? 1.0f : (diff < 0.0f ? -1.0f : 0.0f);
  dx[i] = -1.0f * sgn * (__ldg(ct + n * plane + p) / C);
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

// x, y (N, C, H, W) f32; ct (N, H, W) f32; dx (N, C, H, W) f32; one launch
extern "C" int mv_ssim_l1_bwd(const float* x, const float* y, const float* ct,
                              float* dx, int N, int C, int H, int W,
                              int use_ssim, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_ssim) {
    dim3 grid((W + kStripCols - 1) / kStripCols,
              (H + kStripRows - 1) / kStripRows, N * C);
    ssim_bwd_kernel<<<grid, 32, 0, s>>>(x, y, ct, dx, C, H, W);
  } else {
    const int64_t plane = (int64_t)H * W;
    const int64_t total = (int64_t)N * C * plane;
    const int threads = 256;
    l1_bwd_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                    s>>>(x, y, ct, dx, C, plane, total);
  }
  return (int)cudaGetLastError();
}
