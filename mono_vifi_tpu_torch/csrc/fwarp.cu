// bilinear_sample_table: bilinear sampling (align_corners=True, border
// padding) of N uses drawn from a table of U unique C-channel planes,
// out[k] = sample(table[ids[k]], gx[k], gy[k]), gathered and combined in one
// pass: the fusion warp's forward.
//
// Replaces mono_vifi_tpu/ops/pallas/fwarp.py `_fwarp_kernel` (launched by
// `grid_sample_table_resident`). The TPU kernel kept whole (H, Wp) planes
// resident in VMEM, packed bf16 pairs into u32 lanes, padded widths to 128
// and walked data-dependent spans with fori_loops, because a TPU gather is
// rate-bound; it then wrote the taps out for XLA to combine. On this card a
// direct gather is exact for any coordinates, so none of that comes across.
//
// What bounds it on an H100: in principle bytes. The bytes that must move
// are the output, the two (N, Ho, Wo) coordinate planes, the ids and each
// table plane that ids uses, read once; the arithmetic (six f32 products and
// three sums per output) is small beside that. In practice it is bound by
// the latency of its scattered 2- or 4-byte gathers: four per output value,
// each waiting on L1/L2, with only as many in flight as registers allow
// (measured on the card: the same kernel with perfectly coalesced loads is
// barely faster, and batching more channels' gathers a thread loses more to
// occupancy than it gains). What the design does:
//  - the bases and weights are computed in registers from the coordinates
//    (sampling.cuh, as bilinear_sample does), so 8 bytes a pixel of
//    coordinates are read and no factor plane is built;
//  - a thread takes two neighbouring output pixels and a slice of 8 channels;
//    the store width is chosen once per thread, so that the channel loop has
//    no branch and one batch of gathers is in flight while the previous
//    results are combined and stored, two results as one 4-byte (bf16) or
//    8-byte (f32) store;
//  - where some plane is read by two uses and the table is larger than a
//    third of the L2, a block owns one plane and walks its uses in ascending
//    k (each warp finds them with a ballot over ids), so that the second use
//    finds the plane in L2 (the training step's fusion warp at levels 0 and
//    1), with two channels' gathers in flight a thread where planes are
//    large; else a block takes one use (the deep levels' small tables stay
//    in L2 anyway, and the multi-frame path reads each plane once), which
//    gives twice the blocks;
//  - a block is 256 threads: pixel pairs along x (32 to 256, the fewest that
//    cover the plane's pairs) and channel slices along y, so a plane of 60
//    pairs runs 64 x 4 threads, not 256 threads of which 60 are busy.
// Gathering and combining in the same pass means the (N, C, 4, Ho, Wo) taps
// tensor of the unfused path is never written.
//
// Exactness: the weights and the combine come from sampling.cuh, which rounds
// every product and sum on its own in the order of ops/sampling.py, so the
// result equals the plain PyTorch version bit for bit before the cast to the
// table's dtype.
#include "sampling.cuh"

namespace {

constexpr int kThreads = 256;
// channels a thread takes
constexpr int kSlice = 8;

// two neighbouring results as one 4-byte (bf16) or 8-byte (f32) store
__device__ __forceinline__ void store2(float* dst, float r0, float r1) {
  *reinterpret_cast<float2*>(dst) = make_float2(r0, r1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float r0, float r1) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(r0, r1);
}

// Channels [c, c + n) (n = kBatch when kFull, else n < kBatch) of one use
// at pixels p0, p0 + 1 (when kTwo): all the batch's gathers are issued
// before the first combine, so that they are in flight together; kPair
// (implies kTwo) stores both results at once, else each on its own.
template <typename T, int kBatch, bool kPair, bool kTwo, bool kFull>
__device__ __forceinline__ void batch(const T* s0, const T* s1, T* dst,
                                      int64_t plane, int P, int W, int n,
                                      const mv::Axis& ax0, const mv::Axis& ay0,
                                      const mv::Axis& ax1, const mv::Axis& ay1) {
  float t[kBatch][8];
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    if (kFull || j < n) {
      const T* a = s0 + j * plane;
      const T* b = s1 + j * plane;
      t[j][0] = mv::to_f32(a[0]);
      t[j][1] = mv::to_f32(a[1]);
      t[j][2] = mv::to_f32(a[W]);
      t[j][3] = mv::to_f32(a[W + 1]);
      if (kTwo) {
        t[j][4] = mv::to_f32(b[0]);
        t[j][5] = mv::to_f32(b[1]);
        t[j][6] = mv::to_f32(b[W]);
        t[j][7] = mv::to_f32(b[W + 1]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    if (kFull || j < n) {
      const float r0 = mv::combine(ax0, ay0, t[j][0], t[j][1], t[j][2], t[j][3]);
      T* d = dst + (int64_t)j * P;
      if (kPair) {
        store2(d, r0, mv::combine(ax1, ay1, t[j][4], t[j][5], t[j][6], t[j][7]));
      } else {
        d[0] = mv::from_f32<T>(r0);
        if (kTwo) {
          d[1] = mv::from_f32<T>(
              mv::combine(ax1, ay1, t[j][4], t[j][5], t[j][6], t[j][7]));
        }
      }
    }
  }
}

template <typename T, int kBatch, bool kPair, bool kTwo>
__device__ __forceinline__ void channels(const T* s0, const T* s1, T* dst,
                                         int64_t plane, int P, int W, int n,
                                         const mv::Axis& ax0,
                                         const mv::Axis& ay0,
                                         const mv::Axis& ax1,
                                         const mv::Axis& ay1) {
  int c = 0;
  for (; c + kBatch <= n; c += kBatch) {
    batch<T, kBatch, kPair, kTwo, true>(s0 + c * plane, s1 + c * plane,
                                        dst + (int64_t)c * P, plane, P, W,
                                        kBatch, ax0, ay0, ax1, ay1);
  }
  if (c < n) {
    batch<T, kBatch, kPair, kTwo, false>(s0 + c * plane, s1 + c * plane,
                                         dst + (int64_t)c * P, plane, P, W,
                                         n - c, ax0, ay0, ax1, ay1);
  }
}

// Use k of plane `src` (C planes of H x W): pixels p0 and p0 + 1 (if `two`),
// channels [c_begin, c_end). The store width is chosen once: both results in
// one store when every channel's pair is aligned (P even and the first one
// aligned), else two stores (or one, at a plane's ragged end).
template <typename T, int kBatch>
__device__ __forceinline__ void sample_use(const T* __restrict__ src,
                                           const float* __restrict__ gx,
                                           const float* __restrict__ gy,
                                           T* __restrict__ out, int k, int p0,
                                           bool two, int c_begin, int c_end,
                                           int C, int H, int W, int P) {
  const int64_t pix = (int64_t)k * P + p0;
  const float u0 = __ldg(gx + pix), v0 = __ldg(gy + pix);
  const float u1 = two ? __ldg(gx + pix + 1) : u0;
  const float v1 = two ? __ldg(gy + pix + 1) : v0;
  const mv::Axis ax0 = mv::border_axis(u0, W, true);
  const mv::Axis ay0 = mv::border_axis(v0, H, true);
  const mv::Axis ax1 = mv::border_axis(u1, W, true);
  const mv::Axis ay1 = mv::border_axis(v1, H, true);
  const int64_t plane = (int64_t)H * W;
  const T* s0 = src + c_begin * plane + (int64_t)ay0.base * W + ax0.base;
  const T* s1 = src + c_begin * plane + (int64_t)ay1.base * W + ax1.base;
  T* dst = out + ((int64_t)k * C + c_begin) * P + p0;
  const int n = c_end - c_begin;
  if (two && P % 2 == 0 && ((uintptr_t)dst & (2 * sizeof(T) - 1)) == 0) {
    channels<T, kBatch, true, true>(s0, s1, dst, plane, P, W, n, ax0, ay0,
                                    ax1, ay1);
  } else if (two) {
    channels<T, kBatch, false, true>(s0, s1, dst, plane, P, W, n, ax0, ay0,
                                     ax1, ay1);
  } else {
    channels<T, kBatch, false, false>(s0, s1, dst, plane, P, W, n, ax0, ay0,
                                      ax1, ay1);
  }
}

// grid (pair tiles, slice tiles, U planes with kByPlane, else N uses);
// block (px, 256 / px): pixel pairs along x, channel slices along y.
// kByPlane (ids given): a block owns a plane and walks its uses; else a
// block takes one use. kBatch: channels whose gathers a thread has in
// flight together.
template <typename T, bool kByPlane, int kBatch>
__global__ void __launch_bounds__(kThreads)
    sample_table_kernel(const T* __restrict__ table, const int* __restrict__ ids,
                        const float* __restrict__ gx,
                        const float* __restrict__ gy, T* __restrict__ out,
                        int N, int C, int H, int W, int P, int U) {
  const int p0 = 2 * (blockIdx.x * blockDim.x + threadIdx.x);
  const int c_begin = (blockIdx.y * blockDim.y + threadIdx.y) * kSlice;
  const int c_end = min(c_begin + kSlice, C);
  // no early return: every lane of a warp takes part in the ballots below
  const bool live = p0 < P && c_begin < C;
  const bool two = p0 + 1 < P;
  // ids are clamped so that a malformed one cannot read outside the table
  if (!kByPlane) {  // use z, of plane ids[z] (or z)
    const int k = blockIdx.z;
    const int u = ids ? mv::clampi(__ldg(ids + k), 0, U - 1) : k;
    if (live) {
      sample_use<T, kBatch>(table + (int64_t)u * C * H * W, gx, gy, out, k,
                            p0, two, c_begin, c_end, C, H, W, P);
    }
    return;
  }
  // the uses of plane z (ids given) in ascending order, 32 ids at a time
  const int u = blockIdx.z;
  const T* src = table + (int64_t)u * C * H * W;
  const int lane = (threadIdx.y * blockDim.x + threadIdx.x) & 31;
  for (int start = 0; start < N; start += 32) {
    const int k = start + lane;
    const bool mine = k < N && mv::clampi(__ldg(ids + k), 0, U - 1) == u;
    unsigned mask = __ballot_sync(0xffffffffu, mine);
    while (mask) {
      const int j = __ffs(mask) - 1;
      mask &= mask - 1;
      if (live) {
        sample_use<T, kBatch>(src, gx, gy, out, start + j, p0, two, c_begin,
                              c_end, C, H, W, P);
      }
    }
  }
}

// planes of at least this many output pixels batch two channels' gathers
// (more loads in flight a thread); smaller ones one (more blocks resident)
constexpr int kBatchPixels = 4096;

template <typename T, bool kByPlane, int kBatch>
void launch(const T* table, const int* ids, const float* gx, const float* gy,
            T* out, int N, int C, int H, int W, int P, int U,
            cudaStream_t stream) {
  const int pairs = (P + 1) / 2;
  int px = 32;
  while (px < kThreads && px < pairs) px *= 2;
  const int py = kThreads / px;
  const int slices = (C + kSlice - 1) / kSlice;
  dim3 grid((pairs + px - 1) / px, (slices + py - 1) / py, kByPlane ? U : N);
  sample_table_kernel<T, kByPlane, kBatch><<<grid, dim3(px, py), 0, stream>>>(
      table, ids, gx, gy, out, N, C, H, W, P, U);
}

template <typename T>
void launch(const void* table, const int* ids, const float* gx,
            const float* gy, void* out, int N, int C, int H, int W, int P,
            int U, int by_plane, cudaStream_t stream) {
  const T* t = static_cast<const T*>(table);
  T* o = static_cast<T*>(out);
  const bool wide = P >= kBatchPixels;
  if (by_plane && ids) {
    if (wide) {
      launch<T, true, 2>(t, ids, gx, gy, o, N, C, H, W, P, U, stream);
    } else {
      launch<T, true, 1>(t, ids, gx, gy, o, N, C, H, W, P, U, stream);
    }
  } else if (wide) {
    launch<T, false, 2>(t, ids, gx, gy, o, N, C, H, W, P, U, stream);
  } else {
    launch<T, false, 1>(t, ids, gx, gy, o, N, C, H, W, P, U, stream);
  }
}

}  // namespace

// table (U, C, H, W) f32 or bf16; ids (N,) int32 or null (use k reads plane
// k, N == U); gx, gy (N, Ho, Wo) f32 normalized coordinates; out (N, C, Ho,
// Wo) in the table's dtype; by_plane: 1 for a block a plane (with ids).
extern "C" int mv_bilinear_sample_table(const void* table, int dtype,
                                        const int* ids, const float* gx,
                                        const float* gy, void* out, int N,
                                        int C, int H, int W, int Ho, int Wo,
                                        int U, int by_plane, void* stream) {
  const int P = Ho * Wo;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == mv::kF32) {
    launch<float>(table, ids, gx, gy, out, N, C, H, W, P, U, by_plane, s);
  } else if (dtype == mv::kBF16) {
    launch<__nv_bfloat16>(table, ids, gx, gy, out, N, C, H, W, P, U, by_plane,
                          s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
