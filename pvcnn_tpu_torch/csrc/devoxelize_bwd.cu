// K5: trilinear devoxelize backward, the grid gradient of K2's gather
//
//   dgrid[b, v, c] = sum over points n and corners k with bin_k(n) == v of
//                    w_k(n) * g[b, n, c]
//
// Replaces the TPU kernels pvcnn_tpu/ops/pallas/sorted_scatter.py:
// _sorted_scatter and pvcnn_tpu/ops/pallas/packed_scatter.py:_packed_scatter,
// which pvcnn_tpu/ops/devoxelize.py:_devox_bwd runs as one-hot MXU products
// over rows sorted by base bin (or corner-packed rows).
//
// Design, as the TPU's _sorted_scatter: sort the N base bins of a cloud, not
// its 8N corner bins, and walk the 8 corner offsets from them. Two kernels,
// both launched by the wrapper's glue and the kernel proper:
//
// Glue, devoxelize_bwd_sort_kernel: one block per cloud sorts its points
// stably by base bin (the clamped lo corner, as K2's corners() computes it)
// with the counting sort K1 shares (counting_sort.cuh: a histogram, a scan,
// and a placement in point order by warp turns), so the order is the same
// every run. It writes the sorted points (x, y, z and the point's index as
// int bits: one 16-byte load per run entry) and the bounds of every bin's
// run. The counters live in shared memory up to R = 37, else in the bounds
// buffer itself.
//
// Kernel, devoxelize_bwd_kernel: a lane group per output bin v, lanes over
// channels (each g row read whole and coalesced, float4 where C % 4 == 0).
// Lane k < 8 of the group looks up the run of base bin v - off_k (off_k =
// bx*R^2 + by*R + bz, the corner's bits); the group walks the 8 runs in
// corner order, then in the sort's order, recomputes each point's weight
// w_k with _corners' roundings ((g_x * g_y) * g_z, g = 1 - f, f = x -
// floor(x)) and counts the point only where its corner k is a true corner
// (f > 0 on each axis of k's bits): a collapsed corner (f = 0, also every
// point on the R-1 plane) has weight exactly 0 and lies on another bin. No
// atomics: the sum order is fixed, so dgrid is reproducible bit for bit.
// A block takes 32 consecutive bins of one cloud. The channel-major output
// [B, C, R^3] (the rows branch) goes through a shared bins x channels tile
// stored bins-fastest, 128 bytes per warp store; the channel-last output
// [B, R^3, C] (the NDHWC branch) is stored row by row. Both layouts run
// the same sums, so they agree bit for bit.
//
// Bound. Bytes: the grid gradient written once (B * R^3 * C floats, 268 MB
// at B = 32, R = 32, C = 64) against the N * C cotangent read and the
// coordinates. A g row is read once by each of its (up to 8) corner bins,
// mostly from L1/L2: the bins of one block share their runs.
//
// bf16 mode (pvcnn_devoxelize_bwd_bf16, counted as devoxelize_bwd_bf16): the
// same sort on a bf16 cotangent. As the JAX backward
// (pvcnn_tpu/ops/devoxelize.py:366-395: w8.astype(g.dtype) * g, summed by
// the f32 scatter kernel, cast to g.dtype), each weight is rounded to bf16,
// each term w * g is rounded to bf16 (the product of two bf16 is exact in
// f32, then rounded), the terms add in f32 in the fixed order, and the sum
// is rounded to bf16 once. Into either layout it runs
// devoxelize_bwd_bricks_kernel<TC, BZ, kChannelsFirst>: the channel-major
// grid [B, C, R^3] (the rows branch of every default bf16 step) and the
// channel-last one [B, R^3, C] (the NDHWC branch). The walk above was slow
// in bf16 (8.8% of its bound into the channel-major grid at ShapeNet 1x,
// 11% into the channel-last one at S3DIS PVCNN's opt-in step):
// 32 bins a block, 31 waves of blocks at R = 32, every bin's 8 bounds
// loads and shuffles whether its runs are empty or not, a g row read once
// per corner bin that holds it, 64 bytes a warp store. Here a block of 512
// threads takes one (cloud, brick of 512 output bins: 16 z x 8 y x 4 x
// where R % 16 == 0, bricks.cuh) and walks its chunks of TC channels (8,
// 16 or 32; more blocks share a brick's chunks only where the bricks fill
// under two waves):
//   1. the runs of the brick's base bins and of its -1 halo (17 x 9 x 5:
//      every base bin whose corners reach the brick) into shared memory,
//      two bounds loads a halo bin;
//   2. one warp scans the halo's (x, y) rows: a row's base bins are
//      consecutive, so its points are one stretch of sorted slots, and the
//      rows' stretches, end to end, number the block's points (the runs
//      become staged positions);
//   3. the first `staged` points (the wrapper's plan: as many as two
//      blocks an SM leave room for) are staged once: their 8 corner
//      weights rounded to bf16 (0xffff, a NaN's bits, for a collapsed
//      corner) and their index; the bins with a term are listed;
//   4. per chunk, the staged points' g rows (TC channels) by 16-byte
//      cp.async (2-byte loads where C % 8 != 0 or g is not aligned): a g
//      row is read from device memory once a brick and chunk. Points past
//      `staged` (a denser brick than the plan) are read where they lie;
//   5. TC / 8 consecutive lanes take a listed bin, 8 channels a lane, and
//      walk its 8 corner runs, k = 0..7, each in the sort's order, into a
//      bf16 tile in shared memory. Lanes over channels keep a warp's lanes
//      busy where few bins of a brick hold points (R = 32); the list
//      skips the empty bins, whose tile entries stay zero;
//   6. the tile goes out. Channel-major: the tile is [TC][512] and goes
//      out as 16-byte stores, two neighbouring lanes a 32-byte sector of a
//      z-run (2-byte stores where R % 8 != 0). Channel-last: the tile is
//      [512][TC], a lane's 8 sums one 16-byte shared store, and a thread
//      per (bin, 8 channels) stores 16 bytes of the bin's row, so a bin's
//      TC / 8 neighbouring threads write its chunk, 2 TC contiguous bytes,
//      in whole sectors where TC >= 16 (2-byte stores where C % 8 != 0 or
//      out is not 16-byte aligned). Every bin of the brick is stored, the
//      unlisted ones as zeros. The tile has no pad: neighbouring bins'
//      rows are neighbouring 2 TC bytes, so the 8 lanes of a 16-byte
//      access phase touch 128 contiguous bytes in stage 6, and in stage 5
//      wherever the listed bins are consecutive (a 16-byte pad a row would
//      put two neighbouring bins of one phase on the same banks).
// Both layouts run stages 1-5 alike, so the channel-last output is the
// channel-major output transposed, bit for bit.
// The term is one instruction for two channels: fma.rn.bf16x2 of the
// rounded weight (twice) and the g pair with a -0 addend, RN(w * g) in
// bf16 (no flush of subnormals: bf16 fma has no .ftz). It equals
// round_bf16(w * g in f32) bit for bit: the exact product of two bf16 has
// at most 16 significant bits, so it is exact in f32 unless it is below
// 2^-126, and there f32's rounding to a multiple of 2^-149 never lands on
// a midpoint of bf16's 2^-133 grid that the exact product was not on (the
// significand would have to be within 1 of an odd multiple of 2^16, but
// it is at most 255 x 255); a -0 product stays -0, a NaN stays a NaN, and
// the f32 sum never holds -0, so every output keeps the bits of the walk
// that rounded each f32 product (the bf16 walk this kernel replaced in
// both layouts; the GPU tests hold the layouts to each other and to the
// plain version on subnormals, zeros, NaN). A collapsed corner adds +0
// rather than branching, which keeps those bits too.
#include <cuda_bf16.h>

#include "bricks.cuh"
#include "common.cuh"
#include "counting_sort.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBinsPerBlock = 32;

__device__ __forceinline__ int clamp_index(int i, int r) {
  return min(max(i, 0), r - 1);
}

// the flat bin of a point's clamped lo corner (K2's corners(), slot 0)
__device__ __forceinline__ int base_bin(float x, float y, float z, int R) {
  const int x0 = clamp_index(static_cast<int>(floorf(x)), R);
  const int y0 = clamp_index(static_cast<int>(floorf(y)), R);
  const int z0 = clamp_index(static_cast<int>(floorf(z)), R);
  return (x0 * R + y0) * R + z0;
}

struct SortItem {
  float4 point;                      // x, y, z and the index as int bits
  int key;                           // the base bin
};

__global__ void __launch_bounds__(pvcnn::kSortThreads)
devoxelize_bwd_sort_kernel(const float* __restrict__ coords,  // [B, N, 3]
                           float4* __restrict__ sorted,       // [B, N]
                           int* __restrict__ bounds,          // [B, R^3 + 1]
                           int N, int R, int shared_counts) {
  extern __shared__ int s_counts[];
  const int R3 = R * R * R;
  const int64_t b = blockIdx.x;
  const float* pts = coords + b * N * 3;
  float4* out = sorted + b * N;
  pvcnn::counting_sort<4>(
      N, R3, shared_counts, s_counts, bounds + b * (R3 + 1),
      [&](int i) {
        const float x = __ldg(pts + 3 * i), y = __ldg(pts + 3 * i + 1),
                    z = __ldg(pts + 3 * i + 2);
        return SortItem{make_float4(x, y, z, __int_as_float(i)),
                        base_bin(x, y, z, R)};
      },
      [&](const SortItem& item, int, int slot) { out[slot] = item.point; });
}

// corner k's weight of the point p, in _corners' roundings; false where
// corner k collapsed onto lo (f = 0 on an axis of k's bits: weight 0)
__device__ __forceinline__ bool corner_weight(float4 p, int k, float* w) {
  const float fx = __fsub_rn(p.x, floorf(p.x));
  const float fy = __fsub_rn(p.y, floorf(p.y));
  const float fz = __fsub_rn(p.z, floorf(p.z));
  const bool bx = k & 4, by = k & 2, bz = k & 1;
  if ((bx && !(fx > 0.f)) || (by && !(fy > 0.f)) || (bz && !(fz > 0.f))) {
    return false;
  }
  const float wx = bx ? fx : __fsub_rn(1.f, fx);
  const float wy = by ? fy : __fsub_rn(1.f, fy);
  const float wz = bz ? fz : __fsub_rn(1.f, fz);
  *w = __fmul_rn(__fmul_rn(wx, wy), wz);
  return true;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// vector c of a channel-last output row
__device__ __forceinline__ void store_vec(float* row, int c, float v) {
  row[c] = v;
}
__device__ __forceinline__ void store_vec(float* row, int c, float4 v) {
  reinterpret_cast<float4*>(row)[c] = v;
}

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ void fma(T& acc, float w, T g) {
    acc = fmaf(w, g, acc);
  }
  static __device__ __forceinline__ float at(const T& a, int) { return a; }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ void fma(T& acc, float w, T g) {
    acc.x = fmaf(w, g.x, acc.x);
    acc.y = fmaf(w, g.y, acc.y);
    acc.z = fmaf(w, g.z, acc.z);
    acc.w = fmaf(w, g.w, acc.w);
  }
  static __device__ __forceinline__ float at(const T& a, int j) {
    return j == 0 ? a.x : j == 1 ? a.y : j == 2 ? a.z : a.w;
  }
};

// G lanes per bin, M vectors of V values per lane and pass over the
// channels (T: a vector as loaded and summed, float or float4)
template <int V, int G, int M, bool kChannelsFirst>
__global__ void __launch_bounds__(pvcnn::kThreads)
devoxelize_bwd_kernel(const float* __restrict__ g,          // [B, N, C]
                      const float4* __restrict__ sorted,    // [B, N]
                      const int* __restrict__ bounds,       // [B, R^3 + 1]
                      float* __restrict__ out,  // [B, C, R^3] or [B, R^3, C]
                      int N, int C, int R) {
  using T = typename Vec<V>::T;
  constexpr int kCT = G * M * V;                  // channels per pass
  constexpr int kGroups = pvcnn::kThreads / G;    // lane groups per block
  constexpr int kStride = kCT + 1;                // odd: no bank conflicts
  __shared__ float tile[kChannelsFirst ? kBinsPerBlock * kStride : 1];
  const int R3 = R * R * R;
  const int64_t b = blockIdx.y;
  const int v0 = blockIdx.x * kBinsPerBlock;
  const int grp = threadIdx.x / G, li = threadIdx.x % G;
  const int first = (threadIdx.x & 31) - li;      // the group's first lane
  const int* bnd = bounds + b * (R3 + 1);
  const float4* pts = sorted + b * N;
  const int nv = C / V;                           // vectors per row
  const T* gb = reinterpret_cast<const T*>(g + b * N * C);

  for (int c0 = 0; c0 < nv; c0 += G * M) {        // passes, in vectors
    for (int t = grp; t < kBinsPerBlock; t += kGroups) {
      const int v = v0 + t;
      // lane k < 8 of the group: the run of corner k's base bin v - off_k
      int start = 0, end = 0;
      if (li < 8 && v < R3) {
        const int ux = v / (R * R) - (li >> 2);
        const int uy = (v / R) % R - ((li >> 1) & 1);
        const int uz = v % R - (li & 1);
        if (ux >= 0 && uy >= 0 && uz >= 0) {
          const int u = (ux * R + uy) * R + uz;
          start = __ldg(bnd + u);
          end = __ldg(bnd + u + 1);
        }
      }
      T acc[M];
#pragma unroll
      for (int m = 0; m < M; ++m) acc[m] = T{};
#pragma unroll 1
      for (int k = 0; k < 8; ++k) {
        const int s = __shfl_sync(kFull, start, first + k);
        const int e = __shfl_sync(kFull, end, first + k);
        for (int j = s; j < e; ++j) {
          const float4 p = __ldg(pts + j);
          float w;
          if (!corner_weight(p, k, &w)) continue;
          const T* row = gb + static_cast<int64_t>(__float_as_int(p.w)) * nv;
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const int c = c0 + m * G + li;
            if (c < nv) Vec<V>::fma(acc[m], w, __ldg(row + c));
          }
        }
      }
      if constexpr (kChannelsFirst) {
#pragma unroll
        for (int m = 0; m < M; ++m) {
#pragma unroll
          for (int q = 0; q < V; ++q) {
            tile[t * kStride + (m * G + li) * V + q] = Vec<V>::at(acc[m], q);
          }
        }
      } else if (v < R3) {
        float* o = out + (b * R3 + v) * C;
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int c = c0 + m * G + li;
          if (c < nv) store_vec(o, c, acc[m]);
        }
      }
    }
    if constexpr (kChannelsFirst) {
      // the tile, bins fastest: a warp stores 32 bins of one channel
      __syncthreads();
      const int cs = min(kCT, (nv - c0) * V);     // channels in this pass
      for (int e = threadIdx.x; e < cs * kBinsPerBlock; e += blockDim.x) {
        const int cl = e / kBinsPerBlock, t = e % kBinsPerBlock;
        if (v0 + t < R3) {
          store(out + (b * C + c0 * V + cl) * R3 + v0 + t,
                tile[t * kStride + cl]);
        }
      }
      __syncthreads();
    }
  }
}

template <typename In>
struct ArgsOf {
  const In* g;
  const float4* sorted;
  const int* bounds;
  In* out;
  int B, N, C, R;
  cudaStream_t stream;
};
using Args = ArgsOf<float>;

template <int V, int G, int M, bool kChannelsFirst>
void launch(const Args& a) {
  const int r3 = a.R * a.R * a.R;
  const dim3 grid((r3 + kBinsPerBlock - 1) / kBinsPerBlock, a.B);
  devoxelize_bwd_kernel<V, G, M, kChannelsFirst>
      <<<grid, pvcnn::kThreads, 0, a.stream>>>(a.g, a.sorted, a.bounds, a.out,
                                               a.N, a.C, a.R);
}

// rows of up to 32 vectors take 8 lanes per bin (4 bins per warp: each run
// lookup serves more channels per instruction where most bins are empty);
// wider rows a whole warp, 256 channels per pass
template <int V, bool kChannelsFirst>
void launch_for(const Args& a) {
  const int nv = a.C / V;
  if (nv <= 8) {
    launch<V, 8, 1, kChannelsFirst>(a);
  } else if (nv <= 16) {
    launch<V, 8, 2, kChannelsFirst>(a);
  } else if (nv <= 32) {
    launch<V, 8, 4, kChannelsFirst>(a);
  } else {
    launch<V, 32, 8 / V, kChannelsFirst>(a);
  }
}

// ---- the bf16 mode: a block a brick -----------------------------------------

constexpr unsigned kNoCorner = 0xffffu;  // a collapsed corner's staged weight
constexpr int kMaxBrickBytes = 225 * 1024;      // dynamic, beside 1 KB static

// the bytes of shared memory before the staged points: each halo bin's
// staged positions (first, end), each row's position minus its first slot
// and each row's position (rows + 1), rounded up to 16 bytes
template <class Geo>
constexpr int kHeadBytes =
    ((2 * Geo::kHaloBins + 2 * Geo::kRows + 1) * 4 + 15) / 16 * 16;
// a row of the channel-major tile of sums: 512 bins and 16 bytes, so that
// the rows of a bin's lanes (one apart) fall 8 banks apart
constexpr int kTilePitch = 528;
// the chunk's tile of bf16 sums: channel-major [TC][kTilePitch] (channel
// 8 q + i at row i * kLanes + q: the lanes of a bin store into other
// banks), or channel-last [512][TC] (a bin's TC channels in order)
template <int TC, bool kChannelsFirst>
constexpr int kTileElems = kChannelsFirst ? TC * kTilePitch : 512 * TC;

// RN_bf16(a * b) for two bf16 pairs: fma with a -0 addend (exact a * b + -0
// rounded once; a -0 product stays -0)
__device__ __forceinline__ unsigned mul_bf16x2(unsigned a, unsigned b) {
  unsigned d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}

// acc[i] += bf16(w * g[i]) for the 8 bf16 channels of g, w2 = (w, w); none
// where !use (adding +0 keeps every sum's bits: a sum from +0 never holds
// -0, and a product of a NaN or an infinity never enters)
__device__ __forceinline__ void add_terms(float* acc, unsigned w2, uint4 g,
                                          bool use) {
  const unsigned p[4] = {use ? mul_bf16x2(w2, g.x) : 0u,
                         use ? mul_bf16x2(w2, g.y) : 0u,
                         use ? mul_bf16x2(w2, g.z) : 0u,
                         use ? mul_bf16x2(w2, g.w) : 0u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] = __fadd_rn(acc[2 * i], bricks::lo_bf16(p[i]));
    acc[2 * i + 1] = __fadd_rn(acc[2 * i + 1], bricks::hi_bf16(p[i]));
  }
}

__device__ __forceinline__ void copy16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0));
}

// TC channels a chunk, 8 a lane: a bin's TC / 8 lanes walk its runs
// together (kLanes, consecutive threads), a block's 512 threads take the
// brick's listed bins 512 / kLanes at a time
template <int TC, int BZ, bool kChannelsFirst>
__global__ void __launch_bounds__(512, 2)
devoxelize_bwd_bricks_kernel(
    const __nv_bfloat16* __restrict__ g,   // [B, N, C]
    const float4* __restrict__ sorted,     // [B, N]
    const int* __restrict__ bounds,        // [B, R^3 + 1]
    __nv_bfloat16* __restrict__ out,       // [B, C, R^3] or [B, R^3, C]
    int N, int C, int R, int staged, int vec_g, int vec_out) {
  using Geo = bricks::Brick<BZ>;
  constexpr int kHY = Geo::kHY, kHZ = Geo::kHZ, kRows = Geo::kRows;
  constexpr int kLanes = TC / 8;                  // lanes a bin
  constexpr int kThreads = Geo::kBins;            // 512
  constexpr int kPerRound = kThreads / kLanes;    // bins a round
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_pos = reinterpret_cast<int*>(smem);      // [halo] a run's first
  int* s_end = s_pos + Geo::kHaloBins;            // [halo] and end position
  int* s_off = s_end + Geo::kHaloBins;            // [rows] position - slot
  int* s_pre = s_off + kRows;                     // [rows + 1] row position
  // the chunk's bf16 sums (kTileElems)
  unsigned short* s_tile =
      reinterpret_cast<unsigned short*>(smem + kHeadBytes<Geo>);
  uint4* s_w = reinterpret_cast<uint4*>(
      s_tile + kTileElems<TC, kChannelsFirst>);
  uint4* s_g = s_w + staged;                      // [staged][kLanes]
  int* s_idx = reinterpret_cast<int*>(s_g + staged * kLanes);  // [staged]
  __shared__ unsigned short s_bins[Geo::kBins];  // the bins with a term
  __shared__ int s_nbins;
  const int tid = threadIdx.x;
  const bricks::Origin o = Geo::origin(blockIdx.x, R);
  const int64_t b = blockIdx.z;
  const int64_t R3 = static_cast<int64_t>(R) * R * R;
  const int* bnd = bounds + b * (R3 + 1);
  const float4* pts = sorted + b * N;
  const __nv_bfloat16* gb = g + b * N * C;
  if (tid == 0) s_nbins = 0;

  // 1. the runs (slots) of the halo's base bins, o - 1 .. o + extent - 1
  for (int h = tid; h < Geo::kHaloBins; h += kThreads) {
    const int ux = o.x - 1 + h / (kHY * kHZ), uy = o.y - 1 + h / kHZ % kHY,
              uz = o.z - 1 + h % kHZ;
    int lo = 0, hi = 0;
    if (min(ux, min(uy, uz)) >= 0 && max(ux, max(uy, uz)) < R) {
      const int u = (ux * R + uy) * R + uz;
      lo = __ldg(bnd + u);
      hi = __ldg(bnd + u + 1);
    }
    s_pos[h] = lo;
    s_end[h] = hi;
  }
  __syncthreads();

  // 2. a row's in-grid base bins are consecutive, so its points are one
  // stretch of slots; one warp numbers the rows' stretches end to end
  if (tid < 32) {
    const int z_first = o.z == 0 ? 1 : 0;         // the in-grid hz
    const int z_last = min(Geo::kZ, R - o.z);
    constexpr int kPer = (kRows + 31) / 32;
    int len[kPer], first[kPer], sum = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = kPer * tid + i;
      const int ux = o.x - 1 + r / kHY, uy = o.y - 1 + r % kHY;
      len[i] = first[i] = 0;
      if (r < kRows && min(ux, uy) >= 0 && max(ux, uy) < R) {
        first[i] = s_pos[r * kHZ + z_first];
        len[i] = s_end[r * kHZ + z_last] - first[i];
      }
      sum += len[i];
    }
    int x = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (tid >= d) x += y;
    }
    int at = x - sum;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = kPer * tid + i;
      if (r < kRows) {
        s_pre[r] = at;
        s_off[r] = at - first[i];
        at += len[i];
      }
    }
    if (tid == 31) s_pre[kRows] = x;
  }
  __syncthreads();
  // the runs as staged positions
  for (int h = tid; h < Geo::kHaloBins; h += kThreads) {
    const int off = s_off[h / kHZ];
    s_pos[h] += off;
    s_end[h] += off;
  }
  const int total = s_pre[kRows];
  const int S = min(total, staged);

  // 3. the first S points: their corner weights rounded to bf16, and index
  for (int s = tid; s < S; s += kThreads) {
    int lo = 0, hi = kRows;                       // s_pre[lo] <= s < s_pre[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (s_pre[mid] <= s) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    const float4 p = __ldg(pts + s - s_off[lo]);
    unsigned w16[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float w;
      w16[k] = corner_weight(p, k, &w) ? bricks::bf16_bits(w) : kNoCorner;
    }
    s_w[s] = make_uint4(w16[0] | w16[1] << 16, w16[2] | w16[3] << 16,
                        w16[4] | w16[5] << 16, w16[6] | w16[7] << 16);
    s_idx[s] = __float_as_int(p.w);
  }
  __syncthreads();

  // the bins that have a term, listed once for every chunk (any order: a
  // bin's sum is its own); the tile's other entries stay zero
  {
    const int lz = tid % BZ, ly = tid / BZ % 8, lx = tid / (8 * BZ);
    bool has = false;
    if (total > 0 && max(o.x + lx, max(o.y + ly, o.z + lz)) < R) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int h = ((lx + 1 - (k >> 2)) * kHY + ly + 1 - ((k >> 1) & 1)) *
                          kHZ + lz + 1 - (k & 1);
        has |= s_end[h] > s_pos[h];
      }
    }
    if (has) s_bins[atomicAdd(&s_nbins, 1)] = tid;
    for (int i = tid; i < kTileElems<TC, kChannelsFirst> / 8;
         i += kThreads) {
      reinterpret_cast<uint4*>(s_tile)[i] = make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();
  const int nbins = s_nbins;

  // 4-6 for each of the block's chunks of channels (every gridDim.y-th)
  const unsigned short* s_w16 = reinterpret_cast<const unsigned short*>(s_w);
  const int q = tid % kLanes;                     // the lane's 8 channels
  for (int c0 = blockIdx.y * TC; c0 < C; c0 += gridDim.y * TC) {
    // 4. the staged points' g rows' chunk, 8 channels a copy
    for (int it = tid; it < S * kLanes; it += kThreads) {
      const int c = c0 + 8 * (it % kLanes);
      const __nv_bfloat16* row =
          gb + static_cast<int64_t>(s_idx[it / kLanes]) * C;
      if (vec_g) {
        copy16(s_g + it, row + (c < C ? c : 0), c < C);
      } else {
        s_g[it] = bricks::load8(row, c, C, false);
      }
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
    __syncthreads();

    // 5. each bin walks its 8 corner runs, k = 0..7, each in the sort's
    // order (the staged positions, then any past them), into the tile
#pragma unroll 1
    for (int j = tid / kLanes; j < nbins; j += kPerRound) {
      const int bin = s_bins[j];
      const int lz = bin % BZ, ly = bin / BZ % 8, lx = bin / (8 * BZ);
      float acc[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.f;
#pragma unroll 1
      for (int k = 0; k < 8; ++k) {
        const int r = (lx + 1 - (k >> 2)) * kHY + ly + 1 - ((k >> 1) & 1);
        const int h = r * kHZ + lz + 1 - (k & 1);
        const int first = s_pos[h], end = s_end[h];
#pragma unroll 2
        for (int pos = first; pos < min(end, S); ++pos) {
          const unsigned wb = s_w16[pos * 8 + k];
          add_terms(acc, wb | wb << 16, s_g[pos * kLanes + q],
                    wb != kNoCorner);
        }
        for (int pos = max(first, S); pos < end; ++pos) {  // past staged
          const float4 p = __ldg(pts + pos - s_off[r]);
          float w = 0.f;
          const bool use = corner_weight(p, k, &w);
          const unsigned wb = bricks::bf16_bits(w);
          const __nv_bfloat16* row =
              gb + static_cast<int64_t>(__float_as_int(p.w)) * C;
          add_terms(acc, wb | wb << 16,
                    bricks::load8(row, c0 + 8 * q, C, vec_g), use);
        }
      }
      if constexpr (kChannelsFirst) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s_tile[(i * kLanes + q) * kTilePitch + bin] =
              bricks::bf16_bits(acc[i]);
        }
      } else {
        *reinterpret_cast<uint4*>(s_tile + bin * TC + 8 * q) = make_uint4(
            bricks::pack_bf16(acc[0], acc[1]),
            bricks::pack_bf16(acc[2], acc[3]),
            bricks::pack_bf16(acc[4], acc[5]),
            bricks::pack_bf16(acc[6], acc[7]));
      }
    }
    __syncthreads();

    // 6. the tile out
    if constexpr (kChannelsFirst) {
      // 16 bytes (8 bins of a z-run, channel c) a store where R % 8 == 0
      // and out is 16-byte aligned (a warp's neighbouring lanes fill whole
      // sectors), else 2 bytes a bin
      for (int it = tid; it < TC * Geo::kBins / 8; it += kThreads) {
        const int row = it / (Geo::kBins / 8);
        const int bin = it % (Geo::kBins / 8) * 8;
        const int c = c0 + 8 * (row % kLanes) + row / kLanes;
        const int lz = bin % BZ, ly = bin / BZ % 8, lx = bin / (8 * BZ);
        const int x = o.x + lx, y = o.y + ly, z = o.z + lz;
        if (c >= C || max(x, max(y, z)) >= R) continue;
        const unsigned short* src = s_tile + row * kTilePitch + bin;
        unsigned short* dst = reinterpret_cast<unsigned short*>(out) +
                              (b * C + c) * R3 + (x * R + y) * R + z;
        if (vec_out) {
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(src);
        } else {
          for (int i = 0; i < 8 && z + i < R; ++i) dst[i] = src[i];
        }
      }
    } else {
      // 16 bytes (a bin's 8 channels) a store where C % 8 == 0 and out is
      // 16-byte aligned, else 2 bytes a channel: a bin's kLanes
      // neighbouring threads store its chunk of its row
      for (int it = tid; it < Geo::kBins * kLanes; it += kThreads) {
        const int bin = it / kLanes, c = c0 + 8 * (it % kLanes);
        const int lz = bin % BZ, ly = bin / BZ % 8, lx = bin / (8 * BZ);
        const int x = o.x + lx, y = o.y + ly, z = o.z + lz;
        if (c >= C || max(x, max(y, z)) >= R) continue;
        bricks::store8(out + (b * R3 + (x * R + y) * R + z) * C, c, C,
                       *reinterpret_cast<const uint4*>(
                           s_tile + bin * TC + (c - c0)),
                       vec_out);
      }
    }
    __syncthreads();                              // s_g and s_tile are read
  }
}

template <int TC, int BZ, bool kChannelsFirst>
int launch_bricks(const ArgsOf<__nv_bfloat16>& a, int staged) {
  using Geo = bricks::Brick<BZ>;
  const size_t bytes = kHeadBytes<Geo> + kTileElems<TC, kChannelsFirst> * 2 +
                       static_cast<size_t>(staged) * (16 * (1 + TC / 8) + 4);
  if (staged < 0 || bytes > kMaxBrickBytes || a.B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = bricks::allow_shared<
      devoxelize_bwd_bricks_kernel<TC, BZ, kChannelsFirst>>(
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_g = a.C % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(a.g) % 16 == 0;
  // the stores' 16-byte pieces: 8 bins of a z-run, or 8 channels of a row
  const int vec_out = (kChannelsFirst ? a.R : a.C) % 8 == 0 &&
                      reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  const int bricks = Geo::count(a.R);
  const dim3 grid(bricks,
                  bricks::chunk_split(static_cast<int64_t>(bricks) * a.B,
                                      (a.C + TC - 1) / TC, 3),
                  a.B);
  devoxelize_bwd_bricks_kernel<TC, BZ, kChannelsFirst>
      <<<grid, Geo::kBins, bytes, a.stream>>>(
          a.g, a.sorted, a.bounds, a.out, a.N, a.C, a.R, staged, vec_g,
          vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <bool kChannelsFirst>
int launch_bricks_for(const ArgsOf<__nv_bfloat16>& a, int tc, int staged) {
  const bool z16 = a.R % 16 == 0;
  switch (tc) {
    case 8:
      return z16 ? launch_bricks<8, 16, kChannelsFirst>(a, staged)
                 : launch_bricks<8, 8, kChannelsFirst>(a, staged);
    case 16:
      return z16 ? launch_bricks<16, 16, kChannelsFirst>(a, staged)
                 : launch_bricks<16, 8, kChannelsFirst>(a, staged);
    case 32:
      return z16 ? launch_bricks<32, 16, kChannelsFirst>(a, staged)
                 : launch_bricks<32, 8, kChannelsFirst>(a, staged);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

PVCNN_EXPORT int pvcnn_devoxelize_bwd_sort(const void* coords, void* sorted,
                                           void* bounds, int B, int N, int R,
                                           void* stream) {
  if (B == 0) return 0;
  const int r3 = R * R * R;
  const bool shared = pvcnn::counts_fit_shared(r3);
  const size_t bytes = shared ? (static_cast<size_t>(r3) + 1) * sizeof(int)
                              : 0;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        devoxelize_bwd_sort_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  devoxelize_bwd_sort_kernel<<<B, pvcnn::kSortThreads, bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coords), static_cast<float4*>(sorted),
      static_cast<int*>(bounds), N, R, shared);
  return static_cast<int>(cudaGetLastError());
}

PVCNN_EXPORT int pvcnn_devoxelize_bwd(const void* g, const void* sorted,
                                      const void* bounds, void* out, int B,
                                      int N, int C, int R, int channels_first,
                                      void* stream) {
  if (static_cast<int64_t>(B) * C * R == 0) return 0;
  const Args a{static_cast<const float*>(g),
               static_cast<const float4*>(sorted),
               static_cast<const int*>(bounds), static_cast<float*>(out),
               B, N, C, R, static_cast<cudaStream_t>(stream)};
  const bool vec4 = C % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (channels_first) {
    vec4 ? launch_for<4, true>(a) : launch_for<1, true>(a);
  } else {
    vec4 ? launch_for<4, false>(a) : launch_for<1, false>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// the bf16 mode: a bf16 cotangent g [B, N, C] -> the bf16 grid gradient,
// channel-major [B, C, R^3] with channels_first, else channel-last [B, R^3,
// C]: a block a brick, tc channels a block (8, 16 or 32), the first
// `staged` points of a brick's halo staged in shared memory; sorted and
// bounds from pvcnn_devoxelize_bwd_sort
PVCNN_EXPORT int pvcnn_devoxelize_bwd_bf16(const void* g, const void* sorted,
                                           const void* bounds, void* out,
                                           int B, int N, int C, int R,
                                           int channels_first, int tc,
                                           int staged, void* stream) {
  if (static_cast<int64_t>(B) * C * R == 0) return 0;
  const ArgsOf<__nv_bfloat16> a{
      static_cast<const __nv_bfloat16*>(g),
      static_cast<const float4*>(sorted), static_cast<const int*>(bounds),
      static_cast<__nv_bfloat16*>(out), B, N, C, R,
      static_cast<cudaStream_t>(stream)};
  return channels_first ? launch_bricks_for<true>(a, tc, staged)
                        : launch_bricks_for<false>(a, tc, staged);
}
