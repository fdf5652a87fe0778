// bilinear_splat: the image adjoint of bilinear sampling. Scatter-adds a
// cotangent (N, C, Ho, Wo) with separable weights (a0, a1) x (c0, c1) at the
// integer bases (ly, lx) into (U, C, H, W) planes; use k lands in plane
// ids[k] (or k without ids), so uses that share a source plane are summed
// together.
//
// Replaces mono_vifi_tpu/ops/pallas/splat.py `_splat_band_kernel` (C > 1,
// via `_splat_core`) and `_splat_band_kernel1` (C == 1, via
// `_splat_core1`). The TPU kernels turned the scatter into one-hot MXU
// matmuls over row bands with windows, a per-image shift, an overlap-add
// and a guard cascade falling back to XLA's scatter; all of that existed
// because the TPU cannot scatter.
//
// What bounds it on an H100: bytes, if the scatter cost nothing more. Per
// pixel and channel it reads one cotangent value, and each output cell is
// written once; at the main path's level 0 (60 uses of 64 channels onto 30
// planes at 96x320) that is 516 MB, 0.154 ms. The scatter is what costs:
// four f32 global atomics per pixel and channel (472 M at level 0) bound the
// first design by their read-modify-write traffic through L2 and device
// memory, and shared-memory f32 atomics, tried in their place, cost about
// twice the rest of the kernel again.
//
// Design, C > 1: bin the pixel pairs by output tile, then give each block
// one output tile and sum without float atomics. Four launches: (1) count,
// per pixel pair (two neighbouring cotangent pixels of one use), the 8 x 32
// tiles of plane ids[use] that its eight taps touch (one for most pairs
// under a smooth flow, at most eight), with one atomic per bin and warp
// (a plane's counters share a few cache lines, on which an atomic a pair
// would queue); (2) one block scans the counts into each bin's start;
// (3) fill the bins with the pairs' indices, a warp's pairs in lane order;
// (4) a block per (tile, channel group, plane) sorts the taps of its bin's
// pairs by cell (a counting sort with integer shared atomics) and then,
// eight channels at a time, loads the pairs' cotangent values into shared
// memory (the next eight's loads in flight meanwhile) while each thread
// sums its own cell's taps in registers and writes the cell once, in the
// output dtype. No global atomic touches the output, no pass zero-fills or
// casts it, and any flow takes the same path: a pair whose taps spread over
// several tiles is in each of their bins, and the taps outside a block's
// tile get weight zero there. Device memory moves the cotangent once per
// bin of its pair (~1.2x under smooth flows), the output once, and the tap
// planes once per channel group. What is left to bound it is shared memory:
// each cell reads ~8 taps' values per channel at scattered addresses.
//
// C == 1: nothing to amortize the binning over; a thread per pixel adds its
// taps straight into a zero-filled f32 canvas with global atomics, a
// neighbour's coincident taps combined by shuffle first.
//
// Taps whose weight is exactly zero (outside the image in zeros mode) add
// nothing. The bins and the direct path's canvas fill through atomics, so
// the order of the sums, and the last bits of the result, vary from run to
// run.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
// the binned path's output tile: 2^kLth x 2^kLtw = 8 x 32 cells, one a
// thread of the tile kernel (ops/cuda/splat.py's TILE_H, TILE_W)
constexpr int kLth = 3, kLtw = 5;
constexpr int kTileH = 1 << kLth, kTileW = 1 << kLtw;
static_assert(kTileH * kTileW == kThreads, "a tile has a cell a thread");

// the output tiles of one pixel's taps: rows y/kTileH, (y+1)/kTileH by
// columns x/kTileW, (x+1)/kTileW
struct TileSpan {
  int r0, r1, c0, c1;
  __device__ bool has(int r, int c) const {
    return (r == r0 || r == r1) && (c == c0 || c == c1);
  }
};

__device__ __forceinline__ TileSpan tile_span(int y, int x) {
  return {y >> kLth, (y + 1) >> kLth, x >> kLtw, (x + 1) >> kLtw};
}

// one slot of a pair's bins: the lanes of the warp that name the same bin
// add to it with one atomic, the lowest of them for all; with kFill each
// lane writes the pair at the bin's cursor plus its rank among them, so a
// bin holds a warp's pairs in lane order
template <bool kFill>
__device__ __forceinline__ void emit(int* __restrict__ bins,
                                     int* __restrict__ list, int bin, int g) {
  const unsigned peers = __match_any_sync(0xffffffffu, bin);
  if (bin < 0) return;
  const int lane = threadIdx.x & 31, leader = __ffs(peers) - 1;
  const int rank = __popc(peers & ((1u << lane) - 1));
  int base = 0;
  if (lane == leader) base = atomicAdd(bins + bin, __popc(peers));
  if (kFill) list[__shfl_sync(peers, base, leader) + rank] = g;
}

// (1) and (3): thread per pixel pair; each tile of plane ids[use] that the
// pair's taps touch gets the pair once, counted (kFill false) or written
// at the bin's cursor (kFill true). Every lane of a warp passes the eight
// slots (-1: no bin), so that the lanes naming one bin meet in each.
template <bool kFill>
__global__ void __launch_bounds__(kThreads)
    splat_bin_kernel(const int* __restrict__ ly, const int* __restrict__ lx,
                     const int* __restrict__ ids, int* __restrict__ bins,
                     int* __restrict__ list, int N, int P, int U, int H, int W,
                     int tiles_x, int tiles) {
  const int ppu = (P + 1) / 2;  // pairs of a use
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool in = g < (int64_t)N * ppu;
  const int n = in ? (int)(g / ppu) : 0;
  const int p = 2 * (int)(g - (int64_t)n * ppu);
  const int u = ids ? mv::clampi(__ldg(ids + n), 0, U - 1) : n;
  const int ub = u * tiles;
  const int64_t i = (int64_t)n * P + p;
  TileSpan a = {0, 0, 0, 0}, b = {0, 0, 0, 0};
  if (in) a = tile_span(mv::clampi(__ldg(ly + i), 0, H - 2),
                        mv::clampi(__ldg(lx + i), 0, W - 2));
  const bool two = in && p + 1 < P;
  if (two) b = tile_span(mv::clampi(__ldg(ly + i + 1), 0, H - 2),
                         mv::clampi(__ldg(lx + i + 1), 0, W - 2));
  auto bin = [&](bool ok, int r, int c) { return ok ? ub + r * tiles_x + c : -1; };
  const bool ac = a.c1 != a.c0, ar = a.r1 != a.r0;
  const bool bc = b.c1 != b.c0, br = b.r1 != b.r0;
  emit<kFill>(bins, list, bin(in, a.r0, a.c0), (int)g);
  emit<kFill>(bins, list, bin(in && ac, a.r0, a.c1), (int)g);
  emit<kFill>(bins, list, bin(in && ar, a.r1, a.c0), (int)g);
  emit<kFill>(bins, list, bin(in && ar && ac, a.r1, a.c1), (int)g);
  emit<kFill>(bins, list, bin(two && !a.has(b.r0, b.c0), b.r0, b.c0), (int)g);
  emit<kFill>(bins, list, bin(two && bc && !a.has(b.r0, b.c1), b.r0, b.c1), (int)g);
  emit<kFill>(bins, list, bin(two && br && !a.has(b.r1, b.c0), b.r1, b.c0), (int)g);
  emit<kFill>(bins, list, bin(two && br && bc && !a.has(b.r1, b.c1), b.r1, b.c1), (int)g);
}

// (2) one block: starts[b] = cursor[b] = sum of counts[0..b)
__global__ void __launch_bounds__(kScanThreads)
    splat_scan_kernel(const int* __restrict__ counts, int* __restrict__ starts,
                      int* __restrict__ cursor, int nb) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (nb + kScanThreads - 1) / kScanThreads;
  const int b0 = min(nb, t * per), b1 = min(nb, b0 + per);
  int sum = 0;
  for (int b = b0; b < b1; ++b) sum += counts[b];
  // inclusive scan of the threads' sums: within the warp, then the warps
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int o = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += o;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int run = incl - sum + (warp ? warp_sums[warp - 1] : 0);
  for (int b = b0; b < b1; ++b) {
    starts[b] = cursor[b] = run;
    run += counts[b];
  }
}

// a pixel pair's cotangent values for one channel, as stored (one register
// for bf16), and as f32
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
};

__device__ __forceinline__ float2 load_pair(const float* __restrict__ p, bool two,
                                            bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float2*>(p));
  return make_float2(__ldg(p), two ? __ldg(p + 1) : 0.0f);
}
__device__ __forceinline__ __nv_bfloat162 load_pair(const __nv_bfloat16* __restrict__ p,
                                                    bool two, bool vec) {
  if (vec) return *reinterpret_cast<const __nv_bfloat162*>(p);
  return __halves2bfloat162(p[0], two ? p[1] : __float2bfloat16_rn(0.0f));
}
__device__ __forceinline__ float2 to_float2(float2 v) { return v; }
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}

// one pixel's taps inside a tile: the cell of tap (0, 0) in the tile and
// the four weights, zero for taps outside the tile
struct Taps {
  int cell;
  float w[4];  // taps (0,0), (0,1), (1,0), (1,1)
};

__device__ __forceinline__ Taps tile_taps(int64_t i, const int* __restrict__ ly,
                                          const int* __restrict__ lx,
                                          const float* __restrict__ a0,
                                          const float* __restrict__ a1,
                                          const float* __restrict__ c0,
                                          const float* __restrict__ c1, int H,
                                          int W, int ty0, int tx0, int th,
                                          int tw) {
  const int y = mv::clampi(__ldg(ly + i), 0, H - 2) - ty0;
  const int x = mv::clampi(__ldg(lx + i), 0, W - 2) - tx0;
  const float wa0 = __ldg(a0 + i), wa1 = __ldg(a1 + i);
  const float wc0 = __ldg(c0 + i), wc1 = __ldg(c1 + i);
  const bool r0 = y >= 0 && y < th, r1 = y + 1 >= 0 && y + 1 < th;
  const bool k0 = x >= 0 && x < tw, k1 = x + 1 >= 0 && x + 1 < tw;
  return {y * tw + x,
          {r0 && k0 ? wa0 * wc0 : 0.0f, r0 && k1 ? wa0 * wc1 : 0.0f,
           r1 && k0 ? wa1 * wc0 : 0.0f, r1 && k1 ? wa1 * wc1 : 0.0f}};
}

constexpr int kCells = kTileH * kTileW;  // of a tile
constexpr int kBatch = 512;  // pairs of a bin sorted at a time
constexpr int kPerThread = (kBatch + kThreads - 1) / kThreads;
constexpr int kChunk = 8;  // channels summed at a time
// dynamic shared memory of a block: the batch's taps (weight, pixel), its
// cotangent values (pixel-major) and the pairs' cotangent offsets
constexpr int kTileSmem = 8 * kBatch * sizeof(float2) +
                          2 * kBatch * kChunk * sizeof(float) + kBatch * sizeof(int);

// (4) grid (tiles of a plane, channel groups, planes). The block sorts the
// taps of a batch of its bin's pairs by cell (a counting sort with integer
// shared atomics: per cell the (weight, pixel) of every tap landing there),
// then, eight channels at a time, loads the pairs' cotangent values into
// shared memory, pixel-major (a tap reads its eight channels in two 16-byte
// loads), and has each thread sum its own cell's taps in registers: no
// float atomics, and each output cell written once, in the output dtype. A
// bin of more than kBatch pairs (taps converging from far, or a scattered
// flow) takes several batches per chunk.
template <typename T, typename O>
__global__ void __launch_bounds__(kThreads, 3)
    splat_tile_kernel(const T* __restrict__ ct, const int* __restrict__ ly,
                      const int* __restrict__ lx, const float* __restrict__ a0,
                      const float* __restrict__ a1, const float* __restrict__ c0,
                      const float* __restrict__ c1,
                      const int* __restrict__ list, const int* __restrict__ starts,
                      const int* __restrict__ counts, O* __restrict__ out, int C,
                      int P, int H, int W, int tiles_x, int cg) {
  __shared__ int cell_start[kCells + 1];
  __shared__ int cell_cur[kCells];
  __shared__ int warp_sums[kThreads / 32];
  extern __shared__ float4 dyn[];
  float2* taps = reinterpret_cast<float2*>(dyn);  // 8 * kBatch
  auto vals = reinterpret_cast<float4 (*)[kChunk / 4]>(taps + 8 * kBatch);  // 2 * kBatch
  int* pair_src = reinterpret_cast<int*>(vals + 2 * kBatch);  // kBatch

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  constexpr int th = kTileH, tw = kTileW;
  const int tile = blockIdx.x, u = blockIdx.z;
  const int ty0 = (tile / tiles_x) << kLth, tx0 = (tile % tiles_x) << kLtw;
  const int c_begin = blockIdx.y * cg, k = min(cg, C - c_begin);
  const int bin = u * gridDim.x + tile;
  const int s = __ldg(starts + bin), m = __ldg(counts + bin);
  const int nbatch = (m + kBatch - 1) / kBatch;
  const int ppu = (P + 1) / 2;
  const bool even = (P & 1) == 0 &&
                    (reinterpret_cast<uintptr_t>(ct) & (2 * sizeof(T) - 1)) == 0;

  // the cell lists of batch b (ends with a barrier)
  auto sort_taps = [&](int b) {
    const int e0 = b * kBatch, ne = min(kBatch, m - e0);
    cell_cur[t] = 0;
    __syncthreads();
    Taps tp[kPerThread][2];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int e = t + j * kThreads;
      tp[j][0].w[0] = tp[j][0].w[1] = tp[j][0].w[2] = tp[j][0].w[3] = 0.0f;
      tp[j][1] = tp[j][0];
      if (e >= ne) continue;
      const int g = __ldg(list + s + e0 + e);
      const int n = g / ppu, p = 2 * (g - n * ppu);
      const int64_t i = (int64_t)n * P + p;
      pair_src[e] = (n * C + c_begin) * P + p;
      tp[j][0] = tile_taps(i, ly, lx, a0, a1, c0, c1, H, W, ty0, tx0, th, tw);
      if (p + 1 < P)
        tp[j][1] = tile_taps(i + 1, ly, lx, a0, a1, c0, c1, H, W, ty0, tx0, th, tw);
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int d = 0; d < 4; ++d)
          if (tp[j][q].w[d] != 0.0f)
            atomicAdd(cell_cur + tp[j][q].cell + (d >> 1) * tw + (d & 1), 1);
    }
    __syncthreads();
    // exclusive scan of the counts, one cell a thread
    const int count = cell_cur[t];
    int incl = count;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int o = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += o;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int start = incl - count;
    for (int w = 0; w < warp; ++w) start += warp_sums[w];
    cell_start[t] = cell_cur[t] = start;
    if (t == kThreads - 1) cell_start[kCells] = start + count;
    __syncthreads();
    // one tap type at a time, so that a cell's list runs in tap-type order
    // and neighbouring cells' i-th taps are mostly neighbouring pixels
#pragma unroll
    for (int d = 0; d < 4; ++d) {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int e = t + j * kThreads;
        if (e >= ne) continue;
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (tp[j][q].w[d] != 0.0f) {
            const int slot =
                atomicAdd(cell_cur + tp[j][q].cell + (d >> 1) * tw + (d & 1), 1);
            taps[slot] = make_float2(tp[j][q].w[d], __int_as_float(2 * e + q));
          }
      }
      __syncthreads();
    }
  };
  // pixel px's channels 4h..4h+3 sit in vals[px][h ^ swz(px)]: eight
  // consecutive pixels' 16-byte reads then fall in distinct banks
  auto swz = [](int px) { return (px >> 2) & 1; };

  // the cotangent values of the batch's pairs for channels cc..cc+7, into
  // registers (the thread's pairs e = t + j * kThreads)
  typename Pair<T>::type v[kPerThread][kChunk];
  auto load_chunk = [&](int b, int cc) {
    const int ne = min(kBatch, m - b * kBatch);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int e = t + j * kThreads;
      if (e >= ne) continue;
      const int src = pair_src[e];
      const bool two = (P & 1) == 0 || src % P != P - 1;
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
        v[j][c] = cc + c < k ? load_pair(ct + src + (int64_t)(cc + c) * P, two, even)
                             : typename Pair<T>::type{};
    }
  };
  // ... and from registers into shared memory, pixel-major (ends with a
  // barrier)
  auto store_chunk = [&](int b) {
    const int ne = min(kBatch, m - b * kBatch);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int e = t + j * kThreads;
      if (e >= ne) continue;
#pragma unroll
      for (int q = 0; q < kChunk / 4; ++q) {
        const float2 w0 = to_float2(v[j][4 * q]), w1 = to_float2(v[j][4 * q + 1]);
        const float2 w2 = to_float2(v[j][4 * q + 2]), w3 = to_float2(v[j][4 * q + 3]);
        vals[2 * e][q ^ swz(2 * e)] = make_float4(w0.x, w1.x, w2.x, w3.x);
        vals[2 * e + 1][q ^ swz(2 * e + 1)] = make_float4(w0.y, w1.y, w2.y, w3.y);
      }
    }
    __syncthreads();
  };

  // one batch (the usual case): sorted once, and the next chunk's loads in
  // flight while this chunk is summed
  if (nbatch == 1) {
    sort_taps(0);
    load_chunk(0, 0);
  }
  O* dst = out + ((int64_t)u * C + c_begin) * H * W;
  const int y = ty0 + (t >> kLtw), x = tx0 + (t & (tw - 1));
  for (int cc = 0; cc < k; cc += kChunk) {
    float sum[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) sum[c] = 0.0f;
    for (int b = 0; b < nbatch; ++b) {
      if (nbatch > 1) {
        sort_taps(b);
        load_chunk(b, cc);
      }
      store_chunk(b);
      if (nbatch == 1 && cc + kChunk < k) load_chunk(0, cc + kChunk);
      const int end = cell_start[t + 1];
      for (int i = cell_start[t]; i < end; ++i) {
        const float2 tap = taps[i];
        const int px = __float_as_int(tap.y);
#pragma unroll
        for (int q = 0; q < kChunk / 4; ++q) {
          const float4 a = vals[px][q ^ swz(px)];
          sum[4 * q] += a.x * tap.x;
          sum[4 * q + 1] += a.y * tap.x;
          sum[4 * q + 2] += a.z * tap.x;
          sum[4 * q + 3] += a.w * tap.x;
        }
      }
      __syncthreads();
    }
    if (y < H && x < W) {
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (cc + c >= k) break;
        dst[((int64_t)(cc + c) * H + y) * W + x] = mv::from_f32<O>(sum[c]);
      }
    }
  }
}

// One channel: nothing to amortize the binning over, so each cotangent
// pixel adds its taps straight into the canvas (zero-filled by the caller)
// with global atomics. Neighbouring threads take neighbouring pixels; where
// a pixel's bases are its left neighbour's plus one column (the common case
// under a smooth flow), the neighbour's right-hand taps reach it by shuffle
// and are added with its own left-hand ones: about two atomics a pixel
// instead of four.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    splat_direct_kernel(const T* __restrict__ ct, const int* __restrict__ ly,
                        const int* __restrict__ lx, const float* __restrict__ a0,
                        const float* __restrict__ a1, const float* __restrict__ c0,
                        const float* __restrict__ c1, const int* __restrict__ ids,
                        float* __restrict__ out, int N, int C, int P, int U,
                        int H, int W) {
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool in = g < (int64_t)N * P;
  const int lane = threadIdx.x & 31;
  const int n = in ? (int)(g / P) : 0;
  const int u = ids ? mv::clampi(__ldg(ids + n), 0, U - 1) : n;
  // taps relative to the plane's origin: a tile as large as the plane
  const Taps tp = in ? tile_taps(g, ly, lx, a0, a1, c0, c1, H, W, 0, 0, H, W)
                     : Taps{-2, {0.0f, 0.0f, 0.0f, 0.0f}};
  // the canvas cell of tap (0, 0), over all planes: equal keys, equal cells
  const int64_t key = in ? (int64_t)u * C * H * W + tp.cell : -2;
  const int64_t left = __shfl_up_sync(0xffffffffu, key, 1);
  const int64_t right = __shfl_down_sync(0xffffffffu, key, 1);
  const bool from_left = lane > 0 && in && left + 1 == key;
  const bool to_right = lane < 31 && in && right == key + 1;
  const int64_t p = g - (int64_t)n * P;
  for (int c = 0; c < C; ++c) {
    const float v = in ? mv::to_f32(ct[((int64_t)n * C + c) * P + p]) : 0.0f;
    const float r0 = v * tp.w[1], r1 = v * tp.w[3];  // the right-hand taps
    const float l0 = __shfl_up_sync(0xffffffffu, r0, 1);
    const float l1 = __shfl_up_sync(0xffffffffu, r1, 1);
    if (!in) continue;
    float* d = out + ((int64_t)u * C + c) * H * W + tp.cell;
    // a sum that is exactly zero would leave the cell as it is
    const float t0 = v * tp.w[0] + (from_left ? l0 : 0.0f);
    const float t1 = v * tp.w[2] + (from_left ? l1 : 0.0f);
    if (t0 != 0.0f) atomicAdd(d, t0);
    if (t1 != 0.0f) atomicAdd(d + W, t1);
    if (!to_right) {
      if (r0 != 0.0f) atomicAdd(d + 1, r0);
      if (r1 != 0.0f) atomicAdd(d + W + 1, r1);
    }
  }
}

// the tile kernel's launch; its dynamic shared memory exceeds the default
// 48 KiB, which is raised once per instance (a failure is returned)
template <typename T, typename O>
cudaError_t launch_tiles(dim3 grid, cudaStream_t s, const void* ct, const int* ly,
                         const int* lx, const float* a0, const float* a1,
                         const float* c0, const float* c1, const int* list,
                         const int* starts, const int* counts, void* out, int C,
                         int P, int H, int W, int tiles_x, int cg) {
  static const cudaError_t smem = cudaFuncSetAttribute(
      splat_tile_kernel<T, O>, cudaFuncAttributeMaxDynamicSharedMemorySize, kTileSmem);
  if (smem != cudaSuccess) return smem;
  splat_tile_kernel<T, O><<<grid, kThreads, kTileSmem, s>>>(
      static_cast<const T*>(ct), ly, lx, a0, a1, c0, c1, list, starts, counts,
      static_cast<O*>(out), C, P, H, W, tiles_x, cg);
  return cudaGetLastError();
}

}  // namespace

// cg > 0: the binned path. Bins of the pairs' indices in `scratch`
// (int32): counts, starts and cursors of the U * tiles bins, then the list,
// of at most 8 entries a pair: 3 * U * tiles + 8 * N * ceil(Ho * Wo / 2)
// ints; tiles of 8 x 32 cells and groups of cg channels, as
// ops/cuda/splat.py's `splat_channel_group` chooses them; out (U, C, H, W)
// f32 or bf16, every cell written. cg == 0: the direct path; out f32, zero-filled
// by the caller, scratch unused. ct (N, C, Ho, Wo) f32 or bf16 (fewer than
// 2^31 values); ly, lx (N, Ho, Wo) int32; a0, a1, c0, c1 (N, Ho, Wo) f32;
// ids (N,) int32 or null.
extern "C" int mv_bilinear_splat(const void* ct, int ct_dtype, const int* ly,
                                 const int* lx, const float* a0,
                                 const float* a1, const float* c0,
                                 const float* c1, const int* ids, void* out,
                                 int out_dtype, int* scratch, int N, int C,
                                 int Ho, int Wo, int U, int H, int W, int cg,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int P = Ho * Wo;
  const int64_t pairs = (int64_t)N * ((P + 1) / 2);
  const unsigned pair_blocks = (unsigned)((pairs + kThreads - 1) / kThreads);
  const unsigned pixel_blocks = (unsigned)(((int64_t)N * P + kThreads - 1) / kThreads);
  if (N < 1 || U < 1 || (ct_dtype != mv::kF32 && ct_dtype != mv::kBF16))
    return (int)cudaErrorInvalidValue;
  if (cg == 0) {
    if (out_dtype != mv::kF32) return (int)cudaErrorInvalidValue;
    if (ct_dtype == mv::kF32) {
      splat_direct_kernel<float><<<pixel_blocks, kThreads, 0, s>>>(
          static_cast<const float*>(ct), ly, lx, a0, a1, c0, c1, ids,
          static_cast<float*>(out), N, C, P, U, H, W);
    } else {
      splat_direct_kernel<__nv_bfloat16><<<pixel_blocks, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(ct), ly, lx, a0, a1, c0, c1, ids,
          static_cast<float*>(out), N, C, P, U, H, W);
    }
    return (int)cudaGetLastError();
  }
  if (cg < 0 || (out_dtype != mv::kF32 && out_dtype != mv::kBF16))
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (W + kTileW - 1) >> kLtw;
  const int tiles = ((H + kTileH - 1) >> kLth) * tiles_x;
  const int nb = U * tiles;
  int* counts = scratch;
  int* starts = counts + nb;
  int* cursor = starts + nb;
  int* list = cursor + nb;
  cudaMemsetAsync(counts, 0, sizeof(int) * nb, s);
  splat_bin_kernel<false><<<pair_blocks, kThreads, 0, s>>>(
      ly, lx, ids, counts, nullptr, N, P, U, H, W, tiles_x, tiles);
  splat_scan_kernel<<<1, kScanThreads, 0, s>>>(counts, starts, cursor, nb);
  splat_bin_kernel<true><<<pair_blocks, kThreads, 0, s>>>(
      ly, lx, ids, cursor, list, N, P, U, H, W, tiles_x, tiles);

  const dim3 grid(tiles, (C + cg - 1) / cg, U);
  cudaError_t err;
  if (ct_dtype == mv::kF32 && out_dtype == mv::kF32) {
    err = launch_tiles<float, float>(grid, s, ct, ly, lx, a0, a1, c0, c1, list,
                                     starts, counts, out, C, P, H, W, tiles_x, cg);
  } else if (ct_dtype == mv::kF32) {
    err = launch_tiles<float, __nv_bfloat16>(grid, s, ct, ly, lx, a0, a1, c0, c1,
                                             list, starts, counts, out, C, P, H, W,
                                             tiles_x, cg);
  } else if (out_dtype == mv::kF32) {
    err = launch_tiles<__nv_bfloat16, float>(grid, s, ct, ly, lx, a0, a1, c0, c1,
                                             list, starts, counts, out, C, P, H, W,
                                             tiles_x, cg);
  } else {
    err = launch_tiles<__nv_bfloat16, __nv_bfloat16>(grid, s, ct, ly, lx, a0, a1,
                                                     c0, c1, list, starts, counts,
                                                     out, C, P, H, W, tiles_x, cg);
  }
  return (int)err;
}
