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
// (N, C, H, W) f32 planes and writes one (N, H, W) plane, with ~55
// instructions per pixel and channel against 24 bytes; at the main path's
// shapes the instruction count comes within ~0.7x of the byte time. The TPU
// kernels held a whole image in VMEM.
//
// Forward, one launch: a warp takes a strip of 60 output columns by
// kFwdRows rows of one image n, two columns a lane, and slides down it.
// Each step loads one halo row of x and y for every channel (float2 loads
// in the interior, reflect indexing only at the image's edges), forms the
// 3-row column sums in the reference's order, gets the next lane's by
// shuffle, and adds the channel's SSIM and L1 terms into the pixel's two
// sums; the mean over C is taken before the row's single (float2) store.
// The last three halo rows of every channel live in registers as a ring:
// no shared memory, no barrier, each input value read from device memory
// once (the two columns neighbouring strips share come through L1/L2).
// The channels of a pixel are held in registers in chunks of up to four;
// a C with no divisor in 2..4 takes chunks of one, carrying the partial sum
// through the output. Without SSIM it is one elementwise pass. In one pass
// (C <= 4, the training step's C = 3) the map is bit-exact against the
// plain version: every product and sum is rounded on its own, in its order,
// with an IEEE division. That costs ~8% over fused multiply-adds and a fast
// division, and buys a training step whose minima over these maps pick the
// same pixels with the kernel as without it.
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

constexpr float kC1 = 0.01f * 0.01f;
constexpr float kC2 = 0.03f * 0.03f;

__device__ __forceinline__ int reflect(int i, int n) {
  i = i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
  return mv::clampi(i, 0, n - 1);
}

constexpr int kStripCols = 60;  // output columns of a strip, two a lane
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

// ----------------------------------------------------------------- forward

// output rows of a forward strip, and strips (warps) stacked in a block
constexpr int kFwdRows = 24;
constexpr int kFwdWarps = 2;

// The forward's arithmetic, each product, sum and quotient rounded on its
// own in the plain version's order (ops/losses.py: pools of rows then
// columns times 1/9, each moment term, the means over C as torch's sum
// times 1/C), so that its map is bit-exact (see the head of the file).
__device__ __forceinline__ float add3_rn(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(a, b), c);
}

__device__ __forceinline__ Sums column_sums_rn(float a0, float a1, float a2,
                                               float b0, float b1, float b2) {
  return {add3_rn(a0, a1, a2), add3_rn(b0, b1, b2),
          add3_rn(__fmul_rn(a0, a0), __fmul_rn(a1, a1), __fmul_rn(a2, a2)),
          add3_rn(__fmul_rn(b0, b0), __fmul_rn(b1, b1), __fmul_rn(b2, b2)),
          add3_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1), __fmul_rn(a2, b2))};
}

__device__ __forceinline__ Sums across_rn(const Sums& p, const Sums& q,
                                          const Sums& r) {
  return {add3_rn(p.x, q.x, r.x), add3_rn(p.y, q.y, r.y),
          add3_rn(p.xx, q.xx, r.xx), add3_rn(p.yy, q.yy, r.yy),
          add3_rn(p.xy, q.xy, r.xy)};
}

// clamped (1 - SSIM) / 2 of one pixel from its 3x3 sums
__device__ __forceinline__ float ssim_term(const Sums& s) {
  const float mu_x = __fmul_rn(s.x, kNinth), mu_y = __fmul_rn(s.y, kNinth);
  const float sig_x = __fsub_rn(__fmul_rn(s.xx, kNinth), __fmul_rn(mu_x, mu_x));
  const float sig_y = __fsub_rn(__fmul_rn(s.yy, kNinth), __fmul_rn(mu_y, mu_y));
  const float sig_xy = __fsub_rn(__fmul_rn(s.xy, kNinth), __fmul_rn(mu_x, mu_y));
  const float num = __fmul_rn(__fadd_rn(__fmul_rn(__fmul_rn(2.0f, mu_x), mu_y), kC1),
                              __fadd_rn(__fmul_rn(2.0f, sig_xy), kC2));
  const float den = __fmul_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(mu_x, mu_x), __fmul_rn(mu_y, mu_y)), kC1),
      __fadd_rn(__fadd_rn(sig_x, sig_y), kC2));
  return fminf(fmaxf(__fmul_rn(__fsub_rn(1.0f, __fdiv_rn(num, den)), 0.5f), 0.0f), 1.0f);
}

// 0.85 * mean_c SSIM term + 0.15 * mean_c L1 term, from the two sums
__device__ __forceinline__ float combine_means(float s, float l, float inv_c) {
  return __fadd_rn(__fmul_rn(0.85f, __fmul_rn(s, inv_c)),
                   __fmul_rn(0.15f, __fmul_rn(l, inv_c)));
}

// the values of image columns q, q+1 of one row (q even), reflected into
// [0, W) at the image's edges
__device__ __forceinline__ float2 load_pair(const float* __restrict__ row,
                                            int q, int W, bool vec) {
  if (vec && q >= 0 && q + 1 < W)
    return __ldg(reinterpret_cast<const float2*>(row + q));
  return make_float2(__ldg(row + reflect(q, W)), __ldg(row + reflect(q + 1, W)));
}

// A warp takes a kFwdRows x 60 output strip of image n and slides down its
// rows. Lane l holds image columns q = x0-2+2l and q+1 of every channel and
// computes output columns q+1 (valid on lanes 1..30) and q+2 (lanes
// 0..29), the next lane's columns coming by shuffle. Channels run in chunks
// of KC (C a multiple of KC), each chunk a pass down the strip whose sums
// stay in registers; a later chunk adds to what the earlier ones stored.
template <int KC>
__global__ void __launch_bounds__(32 * kFwdWarps)
    ssim_fwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    float* __restrict__ out, int C, int H, int W) {
  const int lane = threadIdx.x & 31;
  const int y0 = (blockIdx.y * kFwdWarps + (threadIdx.x >> 5)) * kFwdRows;
  if (y0 >= H) return;  // a whole warp: there is no block barrier
  const int x0 = blockIdx.x * kStripCols;
  const int64_t plane = (int64_t)H * W;
  const int n = blockIdx.z;
  float* outp = out + (int64_t)n * plane;
  const int q = x0 - 2 + 2 * lane;
  // float2 loads and stores stay aligned
  const bool vec = (W & 1) == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                     reinterpret_cast<uintptr_t>(out)) & 7) == 0;
  // lane l stores columns x0+2l, x0+2l+1 (its q+2 and the next lane's q+1)
  const int sx = x0 + 2 * lane;
  const bool st0 = lane < kStripCols / 2 && sx < W;
  const bool st1 = lane < kStripCols / 2 && sx + 1 < W;
  const float inv_c = 1.0f / C;
  const int rows = min(kFwdRows, H - y0) + 2;  // halo rows the strip needs

  for (int cb = 0; cb < C; cb += KC) {
    const float* xp = x + ((int64_t)n * C + cb) * plane;
    const float* yp = y + ((int64_t)n * C + cb) * plane;
    float2 rx[3][KC], ry[3][KC];  // halo rows r of each channel, by r % 3
    for (int r0 = 0; r0 < rows; r0 += 3) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int r = r0 + k;
        if (r >= rows) break;
        const int km2 = (k + 1) % 3, km1 = (k + 2) % 3;  // rows r-2, r-1

        // halo row r: image row y0 + r - 1, reflected
        const int64_t ro = (int64_t)reflect(y0 + r - 1, H) * W;
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          rx[k][c] = load_pair(xp + c * plane + ro, q, W, vec);
          ry[k][c] = load_pair(yp + c * plane + ro, q, W, vec);
        }
        if (r < 2) continue;

        // output row y0 + r - 2 from halo rows r-2..r: columns q+1, q+2,
        // the sums of their SSIM terms (s) and L1 terms (l) over the chunk
        float s0 = 0.0f, s1 = 0.0f, l0 = 0.0f, l1 = 0.0f;
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const Sums c0 = column_sums_rn(rx[km2][c].x, rx[km1][c].x, rx[k][c].x,
                                         ry[km2][c].x, ry[km1][c].x, ry[k][c].x);
          const Sums c1 = column_sums_rn(rx[km2][c].y, rx[km1][c].y, rx[k][c].y,
                                         ry[km2][c].y, ry[km1][c].y, ry[k][c].y);
          const Sums c2 = from_next_lane(c0), c3 = from_next_lane(c1);
          const float x2 = __shfl_down_sync(kFullWarp, rx[km1][c].x, 1);
          const float y2 = __shfl_down_sync(kFullWarp, ry[km1][c].x, 1);
          s0 = __fadd_rn(s0, ssim_term(across_rn(c0, c1, c2)));
          l0 = __fadd_rn(l0, fabsf(__fsub_rn(ry[km1][c].y, rx[km1][c].y)));
          s1 = __fadd_rn(s1, ssim_term(across_rn(c1, c2, c3)));
          l1 = __fadd_rn(l1, fabsf(__fsub_rn(y2, x2)));
        }
        // one pass (C = KC, the training step's C = 3): the plain version's
        // means; several: each chunk's weighted sum added to what the
        // earlier ones stored, and the mean taken at the last (not
        // bit-exact)
        const bool one = KC == C;
        const float v0 = one ? combine_means(s0, l0, inv_c) : 0.85f * s0 + 0.15f * l0;
        const float v1 = one ? combine_means(s1, l1, inv_c) : 0.85f * s1 + 0.15f * l1;
        // lane l stores its q+2 and the next lane's q+1
        const float w1 = __shfl_down_sync(kFullWarp, v0, 1);
        float* o = outp + (int64_t)(y0 + r - 2) * W + sx;
        float2 v = make_float2(v1, w1);
        if (cb > 0) {
          if (st0) v.x += o[0];
          if (st1) v.y += o[1];
        }
        if (!one && cb + KC == C) v = make_float2(v.x * inv_c, v.y * inv_c);
        if (st1 && vec) {
          *reinterpret_cast<float2*>(o) = v;
        } else {
          if (st0) o[0] = v.x;
          if (st1) o[1] = v.y;
        }
      }
    }
  }
}

// without SSIM: out = mean_c |y - x|, one elementwise pass
__global__ void l1_fwd_kernel(const float* __restrict__ x,
                              const float* __restrict__ y,
                              float* __restrict__ out, int C, int64_t plane,
                              int64_t total) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int64_t n = i / plane, p = i - n * plane;
  const float* xp = x + n * C * plane + p;
  const float* yp = y + n * C * plane + p;
  float s = 0.0f;
  for (int c = 0; c < C; ++c) s += fabsf(__ldg(yp + c * plane) - __ldg(xp + c * plane));
  out[i] = s * (1.0f / C);  // torch's mean: the sum times 1/C
}

// ---------------------------------------------------------------- backward

constexpr int kStripRows = 16;  // output rows of a backward strip

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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_ssim) {
    dim3 grid((W + kStripCols - 1) / kStripCols,
              (H + kFwdRows * kFwdWarps - 1) / (kFwdRows * kFwdWarps), N);
    const int threads = 32 * kFwdWarps;
    if (C % 4 == 0) {
      ssim_fwd_kernel<4><<<grid, threads, 0, s>>>(x, y, out, C, H, W);
    } else if (C % 3 == 0) {
      ssim_fwd_kernel<3><<<grid, threads, 0, s>>>(x, y, out, C, H, W);
    } else if (C % 2 == 0) {
      ssim_fwd_kernel<2><<<grid, threads, 0, s>>>(x, y, out, C, H, W);
    } else {
      ssim_fwd_kernel<1><<<grid, threads, 0, s>>>(x, y, out, C, H, W);
    }
  } else {
    const int64_t plane = (int64_t)H * W;
    const int64_t total = (int64_t)N * plane;
    const int threads = 256;
    l1_fwd_kernel<<<(unsigned)((total + threads - 1) / threads), threads, 0,
                    s>>>(x, y, out, C, plane, total);
  }
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
