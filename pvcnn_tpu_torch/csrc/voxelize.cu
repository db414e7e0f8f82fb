// K1: avg_voxelize scatter-mean, and its sum mode (scatter_sum).
//
// Replaces the TPU kernels pvcnn_tpu/ops/pallas/scatter.py:_onehot_scatter_add
// and :_onehot_scatter_slots, which compute per cloud
// out[v] = sum_{n: idx[n] == v} values[n] as one-hot MXU matmuls (the counts
// ride as an appended ones column, pvcnn_tpu/ops/voxelize.py:122-129). A
// one-hot matmul is the TPU's way around a serialized scatter; on the H100 it
// would spend N * bins * C multiply-adds on zeros. Here each cloud's points
// are sorted stably by bin, and each bin's run of the sorted order is summed
// in point order, then divided by max(count, 1) in the mean mode. No
// atomics: the sum order is fixed by the stable sort, so the output is
// bitwise reproducible run to run. Empty bins write 0 in the same pass.
//
// Sum mode (mean = 0) skips the divide: out[v] = the bin's run sum. It is the
// backward of the row gather take_rows (grouping, FPS gather, three-NN
// interpolation), which the JAX package routes through the same one-hot
// kernel (pvcnn_tpu/ops/gather_utils.py -> ops/voxelize.py:_scatter_sum); it
// is counted apart as the `scatter_sum` kernel.
//
// Two kernels in one call of the exported launcher:
//
// Glue, the sort: a stable counting sort of the int32 bin ids, a cloud
// split over `parts` blocks (ops/voxelize.py:_sort_plan: enough that the
// blocks fill the SMs, at least 1,024 points a block). One block a cloud
// (avg_voxelize_sort_kernel) runs the counting sort K5 shares
// (counting_sort.cuh: a histogram, a scan, and a stable placement by warp
// turns). More run it as three launches: each block counts its contiguous
// chunk of points (avg_voxelize_sort_count_kernel), one block a cloud
// scans the counts in (bin, block) order into each block's first slot of
// each bin and the bounds (avg_voxelize_sort_scan_kernel), and each block
// places its chunk in point order from those slots, by the same warp turns
// (avg_voxelize_sort_place_kernel). A stable sort's permutation is unique,
// so both give the same bits. The sort writes the int32 permutation and
// every bin's run bounds [B, bins + 1]; the differences of the bounds are
// the bins' counts (the mean's backward saves them). Counters live in
// shared memory up to 51,199 bins (the channel-major mode reaches 32,768,
// the sum mode 8,192), else in global memory (the bounds buffer, or the
// chunks' counts). Ids outside [0, bins) are dropped. One block a cloud
// placed PVCNN2's 32 x 32,768 ids on 32 SMs, half of K1's time there.
//
// Kernel, avg_voxelize_bins_kernel<V, G, M, channels_first>: a group of G
// lanes takes one bin and reads its run's two bounds (no search; an empty
// bin costs that read and its share of the zero store). Its lanes hold
// consecutive vectors of a row, float4 (V = 4) where C % 4 == 0 and the rows
// are 16-byte aligned, else single floats, so each run row is read as C
// contiguous floats; the run is walked once per pass of G * M * V channels.
// The channel-major output [B, C, bins] (avg_voxelize for the rows branch)
// goes through a shared 32-bin x channels tile stored bins-fastest, so a
// warp stores 32 bins of one channel (128 bytes), as K5's does; the
// bin-major output [B, bins, C] (scatter_sum; avg_voxelize for the NDHWC
// branch) is stored row by row. Both layouts run the same sums, so they
// agree bit for bit.
//
// Bound. Bytes: the N * C input read once, every output element written once
// (B * bins * C floats), the ids and the permutation read once. At R = 32
// the grid dominates: 268 MB at B = 32, C = 64, 37.7 MB at C = 9.
//
// bf16 mode (pvcnn_avg_voxelize_bf16, counted as avg_voxelize_bf16): the
// same sort and kernel on bf16 values, the mean into the rows branch's
// channel-major grid or the NDHWC branch's bin-major one (rows of C % 4 ==
// 0 stored 4 values, 8 bytes, a lane). The kernel is a template on the value type
// (kernel<In, Out, ...>): bf16 rows are read 4 values (8 bytes) a lane
// where C % 4 == 0, summed in f32 in the same order, divided by the count
// in f32 and rounded to bf16 once, as the JAX package's f32 one-hot sums
// (pvcnn_tpu/ops/voxelize.py:122-129: means.astype(features.dtype)). The
// fp32 instantiations are the fp32 kernel's code.
//
// bf16 sum mode (pvcnn_scatter_sum_bf16, counted as scatter_sum_bf16): the
// take_rows backward of bf16 activations, whose cotangent is bf16 (grouping,
// FPS gather and three-NN interpolation of bf16 features). The same sort and
// the bin-major kernel on bf16 values, summed in f32 in stable-sorted point
// order and rounded to bf16 once, as the JAX package's one-hot kernel sums
// bf16 values in f32 (pvcnn_tpu/ops/pallas/scatter.py:131-140) and
// take_rows rounds the sums to the cotangent's dtype
// (pvcnn_tpu/ops/gather_utils.py:49). Rows of C % 4 == 0 are read and
// written 4 values (8 bytes) a lane.
//
// Long runs (the bf16 sum mode): a lane group walks a bin's run alone, so
// one long run held a block (the FP module after a group-all level sends
// every row of a cloud to one bin: 384 rows of 1,024 channels in
// PointNet++'s FP1, one warp a cloud). A run longer than the plan's
// long_run rows (ops/voxelize.py:_sort_plan) is skipped by the bin walk
// and cut into pieces of long_run rows by avg_voxelize_long_runs_kernel,
// whose lane groups walk them side by side, kGroups pieces a round; the
// thread of each channel adds the pieces' f32 sums in piece order and
// rounds once. Runs of long_run rows or fewer are walked as before, in
// the same order, to the same bits. The fp32 instantiations keep their
// code; the means' runs are never cut (long_run 0; voxel runs are short,
// and the second kernel costs its grid's scan of the bounds).
#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"
#include "counting_sort.cuh"

namespace {

struct BinId {
  int key;
};

__global__ void __launch_bounds__(pvcnn::kSortThreads)
avg_voxelize_sort_kernel(const int* __restrict__ ids,  // [B, N]
                         int* __restrict__ perm,       // [B, N]
                         int* __restrict__ bounds,     // [B, bins + 1]
                         int N, int bins, int shared_counts) {
  extern __shared__ int s_counts[];
  const int64_t b = blockIdx.x;
  const int* id = ids + b * N;
  int* p = perm + b * N;
  pvcnn::counting_sort<8>(
      N, bins, shared_counts, s_counts, bounds + b * (bins + 1),
      [&](int i) {
        const int u = __ldg(id + i);
        return BinId{u >= 0 && u < bins ? u : -1};
      },
      [&](const BinId&, int i, int slot) { p[slot] = i; });
}

// The sort split over `parts` blocks a cloud (grid (parts, B)), each
// block a contiguous chunk of the cloud's points: three launches.

// the first point of chunk p of n points cut into `parts`
__device__ __forceinline__ int chunk_at(int n, int parts, int p) {
  return static_cast<int>(static_cast<int64_t>(n) * p / parts);
}

// 1. each block's histogram of its chunk: hist [B][parts][bins]
__global__ void __launch_bounds__(pvcnn::kSortThreads)
avg_voxelize_sort_count_kernel(const int* __restrict__ ids,   // [B, N]
                               int* __restrict__ hist, int N, int bins,
                               int parts, int shared_counts) {
  extern __shared__ int s_counts[];
  const int p = blockIdx.x;
  const int64_t b = blockIdx.y;
  int* h = hist + (b * parts + p) * bins;
  int* cnt = shared_counts ? s_counts : h;
  for (int i = threadIdx.x; i < bins; i += pvcnn::kSortThreads) cnt[i] = 0;
  __syncthreads();
  const int* id = ids + b * N;
  const int end = chunk_at(N, parts, p + 1);
  for (int i = chunk_at(N, parts, p) + threadIdx.x; i < end;
       i += pvcnn::kSortThreads) {
    const int u = __ldg(id + i);
    if (u >= 0 && u < bins) atomicAdd(cnt + u, 1);
  }
  if (shared_counts) {
    __syncthreads();
    for (int i = threadIdx.x; i < bins; i += pvcnn::kSortThreads) {
      h[i] = cnt[i];
    }
  }
}

// 2. one block a cloud: the exclusive scan of the counts in (bin, block)
// order makes hist[b][p][u] the first slot of block p's points of bin u
// and bounds[b][u] the first of bin u (bounds[b][bins]: the points kept)
__global__ void __launch_bounds__(pvcnn::kSortThreads)
avg_voxelize_sort_scan_kernel(int* __restrict__ hist,
                              int* __restrict__ bounds,  // [B, bins + 1]
                              int bins, int parts) {
  constexpr unsigned kFull = 0xffffffffu;
  __shared__ int s_warp[pvcnn::kSortWarps];
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* h = hist + b * parts * bins;
  int* bnd = bounds + b * (bins + 1);
  // a run of `per` bins a thread, all their blocks' counts
  const int per = (bins + pvcnn::kSortThreads - 1) / pvcnn::kSortThreads;
  const int lo = min(bins, tid * per), hi = min(bins, lo + per);
  int sum = 0;
  for (int u = lo; u < hi; ++u) {
    for (int q = 0; q < parts; ++q) sum += h[q * bins + u];
  }
  int x = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = s_warp[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  int run = x - sum + (warp > 0 ? s_warp[warp - 1] : 0);
  for (int u = lo; u < hi; ++u) {
    bnd[u] = run;
    for (int q = 0; q < parts; ++q) {
      const int c = h[q * bins + u];
      h[q * bins + u] = run;
      run += c;
    }
  }
  if (tid == 0) bnd[bins] = s_warp[pvcnn::kSortWarps - 1];
}

// 3. each block places its chunk in point order from its first slots (in
// shared memory where they fit)
__global__ void __launch_bounds__(pvcnn::kSortThreads)
avg_voxelize_sort_place_kernel(const int* __restrict__ ids,
                               int* __restrict__ perm,      // [B, N]
                               int* __restrict__ hist, int N, int bins,
                               int parts, int shared_counts) {
  extern __shared__ int s_counts[];
  const int p = blockIdx.x;
  const int64_t b = blockIdx.y;
  int* h = hist + (b * parts + p) * bins;
  int* cursor = shared_counts ? s_counts : h;
  if (shared_counts) {
    for (int i = threadIdx.x; i < bins; i += pvcnn::kSortThreads) {
      cursor[i] = h[i];
    }
    __syncthreads();
  }
  const int* id = ids + b * N;
  int* out = perm + b * N;
  pvcnn::place_in_order<8>(
      chunk_at(N, parts, p), chunk_at(N, parts, p + 1), cursor,
      [&](int i) {
        const int u = __ldg(id + i);
        return BinId{u >= 0 && u < bins ? u : -1};
      },
      [&](const BinId&, int i, int slot) { out[slot] = i; });
}

// a row's V values of type E as the f32 accumulator type: S is the stored
// vector (float, float4; one bf16, four bf16 in 8 bytes)
template <typename E, int V>
struct Load;
template <>
struct Load<float, 1> {
  using S = float;
  static __device__ __forceinline__ float get(const S* p) { return __ldg(p); }
};
template <>
struct Load<float, 4> {
  using S = float4;
  static __device__ __forceinline__ float4 get(const S* p) {
    return __ldg(p);
  }
};
template <>
struct Load<__nv_bfloat16, 1> {
  using S = unsigned short;
  static __device__ __forceinline__ float get(const S* p) {
    return __uint_as_float(static_cast<unsigned>(__ldg(p)) << 16);
  }
};
template <>
struct Load<__nv_bfloat16, 4> {
  using S = uint2;
  static __device__ __forceinline__ float4 get(const S* p) {
    const uint2 u = __ldg(p);
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  }
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// vector c of a bin-major output row: V f32 values stored as Out (a bf16
// vector of 4 as 8 bytes, each value rounded once)
__device__ __forceinline__ void store_vec(float* row, int c, float v) {
  row[c] = v;
}
__device__ __forceinline__ void store_vec(float* row, int c, float4 v) {
  reinterpret_cast<float4*>(row)[c] = v;
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* row, int c,
                                          float v) {
  row[c] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* row, int c,
                                          float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  reinterpret_cast<uint2*>(row)[c] =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                 *reinterpret_cast<const unsigned*>(&hi));
}

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ void add(T& a, T b) { a += b; }
  static __device__ __forceinline__ T div(T a, float d) { return a / d; }
  static __device__ __forceinline__ float at(const T& a, int) { return a; }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ void add(T& a, T b) {
    a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
  }
  static __device__ __forceinline__ T div(T a, float d) {
    return make_float4(a.x / d, a.y / d, a.z / d, a.w / d);
  }
  static __device__ __forceinline__ float at(const T& a, int j) {
    return j == 0 ? a.x : j == 1 ? a.y : j == 2 ? a.z : a.w;
  }
};

// bf16: the cut runs' bookkeeping in dynamic shared memory (k1_cut),
// after kGroups x kCT f32 piece sums: first[kBins + 1] (the block's first
// item of each bin: a run
// longer than long_run rows of bin t is items first[t] .., a piece of
// long_run rows each), then the bin and last-piece flag of each group's
// item of a round
template <int kGroups, int kCT, int kBins>
struct Cut {
  static constexpr int kFirst = kGroups * kCT;
  static constexpr int kItemBin = kFirst + kBins + 1;
  static constexpr int kItemLast = kItemBin + kGroups;
  static constexpr int kBytes = 4 * (kItemLast + kGroups);
};

// G lanes per bin, M vectors of V values per lane and pass over the
// channels; out [B, C, bins] with kChannelsFirst, else [B, bins, C]. With
// kSkipLong (the bf16 bin-major sums where runs are cut) a run longer than
// long_run rows is left to avg_voxelize_long_runs_kernel.
template <typename In, typename Out, int V, int G, int M, bool kChannelsFirst,
          bool kSkipLong = false>
__global__ void __launch_bounds__(pvcnn::kThreads)
avg_voxelize_bins_kernel(const In* __restrict__ feats,      // [B, N, C]
                         const int* __restrict__ perm,      // [B, N]
                         const int* __restrict__ bounds,    // [B, bins + 1]
                         Out* __restrict__ out,    // see kChannelsFirst
                         int N, int C, int bins, int mean, int long_run) {
  using T = typename Vec<V>::T;
  using S = typename Load<In, V>::S;
  constexpr int kCT = G * M * V;                  // channels per pass
  constexpr int kGroups = pvcnn::kThreads / G;    // lane groups per block
  constexpr int kBins = kChannelsFirst ? 32 : kGroups;   // bins per block
  constexpr int kStride = kCT + 1;                // odd: no bank conflicts
  __shared__ float tile[kChannelsFirst ? kBins * kStride : 1];
  const int64_t b = blockIdx.y;
  const int v0 = blockIdx.x * kBins;
  const int grp = threadIdx.x / G, li = threadIdx.x % G;
  const int* bnd = bounds + b * (bins + 1);
  const int* p = perm + b * N;
  const int nv = C / V;                           // vectors per row
  const S* f = reinterpret_cast<const S*>(feats + b * N * C);
  for (int c0 = 0; c0 < nv; c0 += G * M) {        // passes, in vectors
    for (int t = grp; t < kBins; t += kGroups) {
      const int v = v0 + t;
      int start = 0, end = 0;
      if (v < bins) {
        start = __ldg(bnd + v);
        end = __ldg(bnd + v + 1);
      }
      const int count = end - start;
      const float denom = static_cast<float>(mean && count > 1 ? count : 1);
      // a cut run: avg_voxelize_long_runs_kernel walks its pieces
      const bool cut = kSkipLong && count > long_run;
      T acc[M];
#pragma unroll
      for (int m = 0; m < M; ++m) acc[m] = T{};
#pragma unroll 4
      for (int j = start; j < (cut ? start : end); ++j) {
        const S* row = f + static_cast<int64_t>(__ldg(p + j)) * nv;
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int c = c0 + m * G + li;
          if (c < nv) Vec<V>::add(acc[m], Load<In, V>::get(row + c));
        }
      }
      if constexpr (kChannelsFirst) {
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const T mean_m = Vec<V>::div(acc[m], denom);
#pragma unroll
          for (int q = 0; q < V; ++q) {
            tile[t * kStride + (m * G + li) * V + q] = Vec<V>::at(mean_m, q);
          }
        }
      } else if (v < bins && !cut) {
        Out* o = out + (b * bins + v) * C;
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int c = c0 + m * G + li;
          if (c < nv) store_vec(o, c, Vec<V>::div(acc[m], denom));
        }
      }
    }
    if constexpr (kChannelsFirst) {
      // the tile, bins fastest: a warp stores 32 bins of one channel
      __syncthreads();
      const int cs = min(kCT, (nv - c0) * V);     // channels in this pass
      for (int e = threadIdx.x; e < cs * kBins; e += blockDim.x) {
        const int cl = e / kBins, t = e % kBins;
        if (v0 + t < bins) {
          store(out + (b * C + c0 * V + cl) * bins + v0 + t,
                tile[t * kStride + cl]);
        }
      }
      __syncthreads();
    }
  }
}

// The bf16 bin-major mode's runs longer than long_run rows, after the bin
// walk skipped them: the same grid of blocks of kBins bins, each of which
// finds its cut runs (none: it returns) and cuts each into pieces of
// long_run rows, kGroups pieces a round, a lane group a piece; the thread
// of each channel adds the pieces' f32 sums in piece order and stores a
// bin's sum, rounded once, at its last piece.
template <typename In, typename Out, int V, int G, int M>
__global__ void __launch_bounds__(pvcnn::kThreads)
avg_voxelize_long_runs_kernel(const In* __restrict__ feats,  // [B, N, C]
                              const int* __restrict__ perm,  // [B, N]
                              const int* __restrict__ bounds,
                              Out* __restrict__ out,         // [B, bins, C]
                              int N, int C, int bins, int mean,
                              int long_run) {
  using T = typename Vec<V>::T;
  using S = typename Load<In, V>::S;
  constexpr int kCT = G * M * V;
  constexpr int kGroups = pvcnn::kThreads / G;
  constexpr int kBins = kGroups;
  using K = Cut<kGroups, kCT, kBins>;
  extern __shared__ float k1_cut[];               // K::kBytes
  const int64_t b = blockIdx.y;
  const int v0 = blockIdx.x * kBins;
  const int grp = threadIdx.x / G, li = threadIdx.x % G;
  const int* bnd = bounds + b * (bins + 1);
  const int* p = perm + b * N;
  const int nv = C / V;
  const S* f = reinterpret_cast<const S*>(feats + b * N * C);
  int* first = reinterpret_cast<int*>(k1_cut + K::kFirst);
  int* item_bin = reinterpret_cast<int*>(k1_cut + K::kItemBin);
  int* item_last = reinterpret_cast<int*>(k1_cut + K::kItemLast);
  if (threadIdx.x < kBins) {
    const int v = v0 + threadIdx.x;
    const int count = v < bins ? __ldg(bnd + v + 1) - __ldg(bnd + v) : 0;
    first[threadIdx.x + 1] =
        count > long_run ? (count + long_run - 1) / long_run : 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    first[0] = 0;
    for (int t = 1; t <= kBins; ++t) first[t] += first[t - 1];
  }
  __syncthreads();
  const int items = first[kBins];
  if (items == 0) return;
  constexpr int kPer = (kCT + pvcnn::kThreads - 1) / pvcnn::kThreads;
  for (int c0 = 0; c0 < nv; c0 += G * M) {        // passes, in vectors
    const int cs = min(kCT, (nv - c0) * V);       // channels in this pass
    float carry[kPer] = {};
    for (int r0 = 0; r0 < items; r0 += kGroups) {
      const int k = r0 + grp;
      if (k < items) {
        int t = 0;
        while (first[t + 1] <= k) ++t;
        const int v = v0 + t;
        const int start = __ldg(bnd + v) + (k - first[t]) * long_run;
        const int end = min(__ldg(bnd + v + 1), start + long_run);
        T acc[M];
#pragma unroll
        for (int m = 0; m < M; ++m) acc[m] = T{};
#pragma unroll 4
        for (int j = start; j < end; ++j) {
          const S* row = f + static_cast<int64_t>(__ldg(p + j)) * nv;
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const int c = c0 + m * G + li;
            if (c < nv) Vec<V>::add(acc[m], Load<In, V>::get(row + c));
          }
        }
#pragma unroll
        for (int m = 0; m < M; ++m) {
#pragma unroll
          for (int q = 0; q < V; ++q) {
            k1_cut[grp * kCT + (m * G + li) * V + q] = Vec<V>::at(acc[m], q);
          }
        }
        if (li == 0) {
          item_bin[grp] = t;
          item_last[grp] = k + 1 == first[t + 1];
        }
      }
      __syncthreads();
      const int in_round = min(kGroups, items - r0);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int cl = threadIdx.x + j * pvcnn::kThreads;
        if (cl >= cs) continue;
        for (int q = 0; q < in_round; ++q) {
          carry[j] += k1_cut[q * kCT + cl];
          if (!item_last[q]) continue;
          const int v = v0 + item_bin[q];
          const int count = __ldg(bnd + v + 1) - __ldg(bnd + v);
          store(out + (b * bins + v) * C + c0 * V + cl,
                carry[j] / static_cast<float>(mean ? count : 1));
          carry[j] = 0.f;
        }
      }
      __syncthreads();
    }
  }
}

template <typename In, typename Out>
struct ArgsOf {
  const In* feats;
  const int* perm;
  const int* bounds;
  Out* out;
  int B, N, C, bins, mean;
  cudaStream_t stream;
  int long_run;       // bf16: runs longer than this are cut (0: none)
};
using Args = ArgsOf<float, float>;

template <int V, int G, int M, bool kChannelsFirst, typename In, typename Out>
void launch(const ArgsOf<In, Out>& a) {
  constexpr int kGroups = pvcnn::kThreads / G;
  constexpr int kBins = kChannelsFirst ? 32 : kGroups;
  const dim3 grid((a.bins + kBins - 1) / kBins, a.B);
  if constexpr (!kChannelsFirst && !std::is_same<In, float>::value) {
    if (a.long_run > 0) {
      avg_voxelize_bins_kernel<In, Out, V, G, M, false, true>
          <<<grid, pvcnn::kThreads, 0, a.stream>>>(a.feats, a.perm, a.bounds,
                                                   a.out, a.N, a.C, a.bins,
                                                   a.mean, a.long_run);
      avg_voxelize_long_runs_kernel<In, Out, V, G, M>
          <<<grid, pvcnn::kThreads, Cut<kGroups, G * M * V, kBins>::kBytes,
             a.stream>>>(a.feats, a.perm, a.bounds, a.out, a.N, a.C, a.bins,
                         a.mean, a.long_run);
      return;
    }
  }
  avg_voxelize_bins_kernel<In, Out, V, G, M, kChannelsFirst>
      <<<grid, pvcnn::kThreads, 0, a.stream>>>(a.feats, a.perm, a.bounds,
                                               a.out, a.N, a.C, a.bins,
                                               a.mean, a.long_run);
}

// Channel-major: rows of up to 32 vectors take 8 lanes per bin (the 32 bins
// of the tile, one per group), wider rows a whole warp, 256 channels per
// pass. Bin-major: rows of up to 16 vectors take 4 lanes per bin (64 bins a
// block), wider rows a whole warp (rows wider than 32 * M vectors take more
// walks).
template <int V, typename In, typename Out>
void launch_channels_first(const ArgsOf<In, Out>& a) {
  const int nv = a.C / V;
  if (nv <= 8) {
    launch<V, 8, 1, true>(a);
  } else if (nv <= 16) {
    launch<V, 8, 2, true>(a);
  } else if (nv <= 32) {
    launch<V, 8, 4, true>(a);
  } else {
    launch<V, 32, 8 / V, true>(a);
  }
}

template <int V, typename In, typename Out>
void launch_bin_major(const ArgsOf<In, Out>& a) {
  const int nv = a.C / V;
  if (nv <= 4) {
    launch<V, 4, 1, false>(a);
  } else if (nv <= 8) {
    launch<V, 4, 2, false>(a);
  } else if (nv <= 16) {
    launch<V, 4, 4, false>(a);
  } else if (nv <= 32) {
    launch<V, 32, 1, false>(a);
  } else if (nv <= 64) {
    launch<V, 32, 2, false>(a);
  } else {
    launch<V, 32, 4, false>(a);
  }
}

}  // namespace

namespace {

// raise a sort kernel's dynamic shared memory past 48 KB where it asks
template <typename Kernel>
int allow(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

}  // namespace

// The sort: perm [B, N] and bounds [B, bins + 1] of the int32 ids [B, N].
// parts (ops/voxelize.py:_sort_plan) blocks a cloud: 1, one block sorting
// a cloud alone (avg_voxelize_sort_kernel); more, each block a chunk of
// the cloud, counted into hist [B][parts][bins] (int32 scratch), scanned
// a cloud and placed (the three kernels above).
PVCNN_EXPORT int pvcnn_avg_voxelize_sort(const void* ids, void* perm,
                                         void* bounds, void* hist, int B,
                                         int N, int bins, int parts,
                                         void* stream) {
  if (B == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const bool shared = pvcnn::counts_fit_shared(bins);
  const size_t bytes =
      shared ? (static_cast<size_t>(bins) + 1) * sizeof(int) : 0;
  const auto* id = static_cast<const int*>(ids);
  auto* pm = static_cast<int*>(perm);
  auto* bd = static_cast<int*>(bounds);
  int err;
  if (parts <= 1) {
    err = allow(avg_voxelize_sort_kernel, bytes);
    if (err != 0) return err;
    avg_voxelize_sort_kernel<<<B, pvcnn::kSortThreads, bytes, st>>>(
        id, pm, bd, N, bins, shared);
    return static_cast<int>(cudaGetLastError());
  }
  if (hist == nullptr || parts > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* h = static_cast<int*>(hist);
  if ((err = allow(avg_voxelize_sort_count_kernel, bytes)) != 0 ||
      (err = allow(avg_voxelize_sort_place_kernel, bytes)) != 0) {
    return err;
  }
  const dim3 grid(parts, B);
  avg_voxelize_sort_count_kernel<<<grid, pvcnn::kSortThreads, bytes, st>>>(
      id, h, N, bins, parts, shared);
  avg_voxelize_sort_scan_kernel<<<B, pvcnn::kSortThreads, 0, st>>>(
      h, bd, bins, parts);
  avg_voxelize_sort_place_kernel<<<grid, pvcnn::kSortThreads, bytes, st>>>(
      id, pm, h, N, bins, parts, shared);
  return static_cast<int>(cudaGetLastError());
}

// ids: where not null, the int32 bin ids [B, N], sorted first into perm
// and bounds (the glue and the kernel in one call; hist and parts as
// pvcnn_avg_voxelize_sort's); else perm and bounds hold its output.
PVCNN_EXPORT int pvcnn_avg_voxelize(const void* feats, const void* ids,
                                    void* perm, void* bounds, void* hist,
                                    void* out, int B, int N, int C, int bins,
                                    int parts, int channels_first, int mean,
                                    void* stream) {
  if (ids != nullptr) {
    const int err = pvcnn_avg_voxelize_sort(ids, perm, bounds, hist, B, N,
                                            bins, parts, stream);
    if (err != 0) return err;
  }
  if (static_cast<int64_t>(B) * C * bins == 0) return 0;
  const Args a{static_cast<const float*>(feats), static_cast<const int*>(perm),
               static_cast<const int*>(bounds), static_cast<float*>(out),
               B, N, C, bins, mean, static_cast<cudaStream_t>(stream), 0};
  const bool vec4 = C % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(feats) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (channels_first) {
    vec4 ? launch_channels_first<4>(a) : launch_channels_first<1>(a);
  } else {
    vec4 ? launch_bin_major<4>(a) : launch_bin_major<1>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// the bf16 mode: bf16 feats [B, N, C] -> the bf16 means, channel-major
// [B, C, bins] with channels_first, else bin-major [B, bins, C]; ids and
// the sort as pvcnn_avg_voxelize's
PVCNN_EXPORT int pvcnn_avg_voxelize_bf16(const void* feats, const void* ids,
                                         void* perm, void* bounds, void* hist,
                                         void* out, int B, int N, int C,
                                         int bins, int parts,
                                         int channels_first, void* stream) {
  if (ids != nullptr) {
    const int err = pvcnn_avg_voxelize_sort(ids, perm, bounds, hist, B, N,
                                            bins, parts, stream);
    if (err != 0) return err;
  }
  if (static_cast<int64_t>(B) * C * bins == 0) return 0;
  const ArgsOf<__nv_bfloat16, __nv_bfloat16> a{
      static_cast<const __nv_bfloat16*>(feats), static_cast<const int*>(perm),
      static_cast<const int*>(bounds), static_cast<__nv_bfloat16*>(out),
      B, N, C, bins, 1, static_cast<cudaStream_t>(stream), 0};
  if (channels_first) {
    const bool vec4 =
        C % 4 == 0 && reinterpret_cast<uintptr_t>(feats) % 8 == 0;
    vec4 ? launch_channels_first<4>(a) : launch_channels_first<1>(a);
  } else {
    const bool vec4 = C % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(feats) % 8 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 8 == 0;
    vec4 ? launch_bin_major<4>(a) : launch_bin_major<1>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// the bf16 sum mode: bf16 values [B, N, C] -> the bf16 bin-major sums
// [B, bins, C]; ids, the sort and long_run as pvcnn_avg_voxelize_bf16's
PVCNN_EXPORT int pvcnn_scatter_sum_bf16(const void* values, const void* ids,
                                        void* perm, void* bounds, void* hist,
                                        void* out, int B, int N, int C,
                                        int bins, int parts, int long_run,
                                        void* stream) {
  if (ids != nullptr) {
    const int err = pvcnn_avg_voxelize_sort(ids, perm, bounds, hist, B, N,
                                            bins, parts, stream);
    if (err != 0) return err;
  }
  if (static_cast<int64_t>(B) * C * bins == 0) return 0;
  const ArgsOf<__nv_bfloat16, __nv_bfloat16> a{
      static_cast<const __nv_bfloat16*>(values),
      static_cast<const int*>(perm), static_cast<const int*>(bounds),
      static_cast<__nv_bfloat16*>(out), B, N, C, bins, 0,
      static_cast<cudaStream_t>(stream), long_run};
  const bool vec4 = C % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(values) % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 8 == 0;
  vec4 ? launch_bin_major<4>(a) : launch_bin_major<1>(a);
  return static_cast<int>(cudaGetLastError());
}

PVCNN_EXPORT const char* pvcnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
