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
// Glue, avg_voxelize_sort_kernel: one block per cloud sorts the int32 bin
// ids with the counting sort K5 shares (counting_sort.cuh: a histogram, a
// scan, and a stable placement by warp turns). It writes the int32
// permutation and every bin's run bounds [B, bins + 1]; the differences of
// the bounds are the bins' counts (the mean's backward saves them). Its
// counters live in shared memory up to 51,199 bins (the channel-major mode
// reaches 32,768, the sum mode 8,192), else in the bounds buffer. Ids
// outside [0, bins) are dropped.
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

// G lanes per bin, M vectors of V floats per lane and pass over the
// channels; out [B, C, bins] with kChannelsFirst, else [B, bins, C]
template <int V, int G, int M, bool kChannelsFirst>
__global__ void __launch_bounds__(pvcnn::kThreads)
avg_voxelize_bins_kernel(const float* __restrict__ feats,   // [B, N, C]
                         const int* __restrict__ perm,      // [B, N]
                         const int* __restrict__ bounds,    // [B, bins + 1]
                         float* __restrict__ out,  // see kChannelsFirst
                         int N, int C, int bins, int mean) {
  using T = typename Vec<V>::T;
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
  const T* f = reinterpret_cast<const T*>(feats + b * N * C);

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
      T acc[M];
#pragma unroll
      for (int m = 0; m < M; ++m) acc[m] = T{};
#pragma unroll 4
      for (int j = start; j < end; ++j) {
        const T* row = f + static_cast<int64_t>(__ldg(p + j)) * nv;
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int c = c0 + m * G + li;
          if (c < nv) Vec<V>::add(acc[m], __ldg(row + c));
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
      } else if (v < bins) {
        T* o = reinterpret_cast<T*>(out + (b * bins + v) * C);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int c = c0 + m * G + li;
          if (c < nv) o[c] = Vec<V>::div(acc[m], denom);
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
          out[(b * C + c0 * V + cl) * bins + v0 + t] = tile[t * kStride + cl];
        }
      }
      __syncthreads();
    }
  }
}

struct Args {
  const float* feats;
  const int* perm;
  const int* bounds;
  float* out;
  int B, N, C, bins, mean;
  cudaStream_t stream;
};

template <int V, int G, int M, bool kChannelsFirst>
void launch(const Args& a) {
  constexpr int kBins = kChannelsFirst ? 32 : pvcnn::kThreads / G;
  const dim3 grid((a.bins + kBins - 1) / kBins, a.B);
  avg_voxelize_bins_kernel<V, G, M, kChannelsFirst>
      <<<grid, pvcnn::kThreads, 0, a.stream>>>(a.feats, a.perm, a.bounds,
                                               a.out, a.N, a.C, a.bins,
                                               a.mean);
}

// Channel-major: rows of up to 32 vectors take 8 lanes per bin (the 32 bins
// of the tile, one per group), wider rows a whole warp, 256 channels per
// pass. Bin-major: rows of up to 16 vectors take 4 lanes per bin (64 bins a
// block), wider rows a whole warp (rows wider than 32 * M vectors take more
// walks).
template <int V>
void launch_channels_first(const Args& a) {
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

template <int V>
void launch_bin_major(const Args& a) {
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

PVCNN_EXPORT int pvcnn_avg_voxelize_sort(const void* ids, void* perm,
                                         void* bounds, int B, int N, int bins,
                                         void* stream) {
  if (B == 0) return 0;
  const bool shared = pvcnn::counts_fit_shared(bins);
  const size_t bytes =
      shared ? (static_cast<size_t>(bins) + 1) * sizeof(int) : 0;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        avg_voxelize_sort_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  avg_voxelize_sort_kernel<<<B, pvcnn::kSortThreads, bytes,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<int*>(perm),
      static_cast<int*>(bounds), N, bins, shared);
  return static_cast<int>(cudaGetLastError());
}

// ids: where not null, the int32 bin ids [B, N], sorted first into perm
// and bounds (the glue and the kernel in one call); else perm and bounds
// hold pvcnn_avg_voxelize_sort's output.
PVCNN_EXPORT int pvcnn_avg_voxelize(const void* feats, const void* ids,
                                    void* perm, void* bounds, void* out,
                                    int B, int N, int C, int bins,
                                    int channels_first, int mean,
                                    void* stream) {
  if (ids != nullptr) {
    const int err =
        pvcnn_avg_voxelize_sort(ids, perm, bounds, B, N, bins, stream);
    if (err != 0) return err;
  }
  if (static_cast<int64_t>(B) * C * bins == 0) return 0;
  const Args a{static_cast<const float*>(feats), static_cast<const int*>(perm),
               static_cast<const int*>(bounds), static_cast<float*>(out),
               B, N, C, bins, mean, static_cast<cudaStream_t>(stream)};
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

PVCNN_EXPORT const char* pvcnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
