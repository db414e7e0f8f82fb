// K1: avg_voxelize scatter-mean, and its sum mode (scatter_sum).
//
// Replaces the TPU kernels pvcnn_tpu/ops/pallas/scatter.py:_onehot_scatter_add
// and :_onehot_scatter_slots, which compute per cloud
// out[v] = sum_{n: idx[n] == v} values[n] as one-hot MXU matmuls (the counts
// ride as an appended ones column, pvcnn_tpu/ops/voxelize.py:122-129). A
// one-hot matmul is the TPU's way around a serialized scatter; on the H100 it
// would spend N * bins * C multiply-adds on zeros. Here the caller stably
// sorts each cloud's flat bin ids (glue outside the kernel, as the JAX package
// sorts outside its sorted kernels), and the kernel sums each bin's run of
// the sorted order in point order, then divides by max(count, 1) in the mean
// mode. No atomics: the sum order is fixed by the stable sort, so the output
// is bitwise reproducible run to run. Empty bins write 0 in the same pass.
//
// Sum mode (mean = 0) skips the divide: out[v] = the bin's run sum. It is the
// backward of the row gather take_rows (grouping, FPS gather, three-NN
// interpolation), which the JAX package routes through the same one-hot
// kernel (pvcnn_tpu/ops/gather_utils.py -> ops/voxelize.py:_scatter_sum); it
// is counted apart as the `scatter_sum` kernel.
//
// Bound. Bytes: the N * C input read once, every output element written once
// (B * bins * C floats), the sorted ids and the permutation read once. Two
// mappings, one per output layout, each with coalesced stores:
//
// Channel-major output [B, C, bins] (avg_voxelize for the rows branch): one
// thread per (cloud, group of 8 channels, bin), bins fastest, so each
// channel's store is coalesced. The thread binary-searches its bin's run and
// sums it for each of its channels (one thread per bin for all C channels
// left too few threads at R = 16, C = 128). It still takes the layout as a
// runtime flag, as first written for both layouts: compiled for the
// channel-major layout alone it ran slower at C = 64.
//
// Bin-major output [B, bins, C] (scatter_sum; avg_voxelize for the NDHWC
// branch). With the bins fastest, neighbouring lanes stored C floats apart,
// every row read was another point's, and each thread searched and walked
// its run once per group of 8 channels (that mapping took 3.4x index_add_'s
// time at the PVCNN2 shapes). Here the channels are fastest. A group of G
// lanes takes one bin; its lanes hold consecutive vectors of the row, float4
// (V = 4) when C % 4 == 0 and the rows are 16-byte aligned, else single
// floats, so each run row is read as C contiguous floats and each output row
// is one contiguous store. A warp's 32 / G bins are consecutive, so their
// runs are too: the warp finds the first run's start with a 32-way search (3
// dependent loads for 32,768 ids, against 15 for one lane's binary search),
// and the other bounds in the 32 sorted ids that follow (a bin with a longer
// run falls back to one lane's search). The run is walked once, in the
// stable sort's point order, for all of a lane's channels (rows wider than
// 32 * M vectors take more walks). A bin that holds many rows is walked
// serially by its group.
#include "common.cuh"

#include <climits>

namespace {

constexpr int kGroup = 8;   // channels per thread, channel-major mapping

__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(pvcnn::kThreads)
avg_voxelize_kernel(const float* __restrict__ feats,       // [B, N, C]
                    const int* __restrict__ sorted_idx,    // [B, N]
                    const long long* __restrict__ perm,    // [B, N]
                    float* __restrict__ out,               // see channels_first
                    int B, int N, int C, int R3, int channels_first,
                    int mean) {
  const int groups = (C + kGroup - 1) / kGroup;
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= static_cast<int64_t>(B) * groups * R3) return;
  const int v = static_cast<int>(t % R3);          // bins fastest
  const int64_t bg = t / R3;
  const int c0 = static_cast<int>(bg % groups) * kGroup;
  const int b = static_cast<int>(bg / groups);
  const int* idx = sorted_idx + static_cast<int64_t>(b) * N;
  const int start = lower_bound(idx, N, v);
  const int end = start + lower_bound(idx + start, N - start, v + 1);
  const long long* p = perm + static_cast<int64_t>(b) * N;
  const float* f = feats + static_cast<int64_t>(b) * N * C;
  const int count = end - start;
  const float denom = static_cast<float>(mean && count > 1 ? count : 1);
  // out[b][c][v] (channels_first) or out[b][v][c]
  float* o = channels_first ? out + static_cast<int64_t>(b) * C * R3 + v
                            : out + (static_cast<int64_t>(b) * R3 + v) * C;
  const int64_t stride_c = channels_first ? R3 : 1;
  const int c1 = min(C, c0 + kGroup);
  for (int c = c0; c < c1; ++c) {
    float sum = 0.f;
    for (int j = start; j < end; ++j) {
      sum += __ldg(f + __ldg(p + j) * C + c);
    }
    o[c * stride_c] = sum / denom;
  }
}

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ void add(T& a, T b) { a += b; }
  static __device__ __forceinline__ T div(T a, float d) { return a / d; }
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
};

constexpr unsigned kFull = 0xffffffffu;

// lower_bound by a whole warp: each round the 32 lanes test 32 evenly spaced
// pivots and a ballot narrows the range 32-fold (3 dependent loads for
// 32,768 ids where a one-lane search takes 15). All lanes get the result.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ a,
                                                int n, int key, int lane) {
  int lo = 0, hi = n;                    // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int pos = lo + lane * step;
    const bool less = pos < hi && __ldg(a + pos) < key;
    const int k = __popc(__ballot_sync(kFull, less));
    if (k == 0) {
      hi = lo;
    } else {
      hi = min(hi, lo + k * step);
      lo += (k - 1) * step + 1;
    }
  }
  return lo;
}

template <int V, int G, int M>
__global__ void __launch_bounds__(pvcnn::kThreads)
avg_voxelize_rows_kernel(const float* __restrict__ feats,     // [B, N, C]
                         const int* __restrict__ sorted_idx,  // [B, N]
                         const long long* __restrict__ perm,  // [B, N]
                         float* __restrict__ out,             // [B, bins, C]
                         int B, int N, int C, int bins, int mean) {
  using T = typename Vec<V>::T;
  constexpr int kBinsPerWarp = 32 / G;
  const int warps_per_cloud = (bins + kBinsPerWarp - 1) / kBinsPerWarp;
  const int64_t warp_id =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  if (warp_id >= static_cast<int64_t>(B) * warps_per_cloud) return;
  const int b = static_cast<int>(warp_id / warps_per_cloud);
  const int v0 = static_cast<int>(warp_id % warps_per_cloud) * kBinsPerWarp;
  const int lane = threadIdx.x & 31;
  const int* idx = sorted_idx + static_cast<int64_t>(b) * N;

  // The starts of bins v0 .. v0 + kBinsPerWarp (each the end of the bin
  // before): v0's by the warp's search, the others from the 32 ids after it
  // where they lie there, else (a long run) by lane i's own search.
  const int s0 = warp_lower_bound(idx, N, v0, lane);
  const int seen = s0 + lane < N ? __ldg(idx + s0 + lane) : INT_MAX;
  int bound = s0;
#pragma unroll
  for (int i = 1; i <= kBinsPerWarp; ++i) {
    const int k = __popc(__ballot_sync(kFull, seen < v0 + i));
    if (lane == i) bound = s0 + k;
  }
  if (lane >= 1 && lane <= kBinsPerWarp && bound == s0 + 32) {
    bound = s0 + 32 + lower_bound(idx + s0 + 32, N - s0 - 32,
                                  min(v0 + lane, bins));
  }
  const int g = lane / G, li = lane % G;
  const int start = __shfl_sync(kFull, bound, g);
  const int end = __shfl_sync(kFull, bound, g + 1);
  const int v = v0 + g;
  if (v >= bins) return;

  // group g sums bin v's run; lane li holds vectors li, li + G, ... of a row
  const int nv = C / V;                            // vectors per row
  const long long* p = perm + static_cast<int64_t>(b) * N;
  const T* f =
      reinterpret_cast<const T*>(feats + static_cast<int64_t>(b) * N * C);
  T* o = reinterpret_cast<T*>(out + (static_cast<int64_t>(b) * bins + v) * C);
  const int count = end - start;
  const float denom = static_cast<float>(mean && count > 1 ? count : 1);
  for (int c0 = 0; c0 < nv; c0 += G * M) {
    T acc[M];
#pragma unroll
    for (int k = 0; k < M; ++k) acc[k] = T{};
#pragma unroll 4
    for (int j = start; j < end; ++j) {
      const T* row = f + __ldg(p + j) * nv;
#pragma unroll
      for (int k = 0; k < M; ++k) {
        const int c = c0 + k * G + li;
        if (c < nv) Vec<V>::add(acc[k], __ldg(row + c));
      }
    }
#pragma unroll
    for (int k = 0; k < M; ++k) {
      const int c = c0 + k * G + li;
      if (c < nv) o[c] = Vec<V>::div(acc[k], denom);
    }
  }
}

struct RowsArgs {
  const float* feats;
  const int* sorted_idx;
  const long long* perm;
  float* out;
  int B, N, C, bins, mean;
  cudaStream_t stream;
};

template <int V, int G, int M>
void launch_rows(const RowsArgs& a) {
  constexpr int kBinsPerWarp = 32 / G;
  const int64_t warps =
      static_cast<int64_t>(a.B) * ((a.bins + kBinsPerWarp - 1) / kBinsPerWarp);
  avg_voxelize_rows_kernel<V, G, M><<<pvcnn::blocks_for(warps * 32),
                                      pvcnn::kThreads, 0, a.stream>>>(
      a.feats, a.sorted_idx, a.perm, a.out, a.B, a.N, a.C, a.bins, a.mean);
}

// G lanes per bin, M vectors per lane and walk of the run: rows of up to 16
// vectors take 4 lanes per bin (8 bins per warp: fewer searches where most
// bins are empty, as at R = 32), wider rows a whole warp (rows wider than
// 32 * M vectors take more walks)
template <int V>
void launch_rows_for(const RowsArgs& a) {
  const int nv = a.C / V;
  if (nv <= 4) {
    launch_rows<V, 4, 1>(a);
  } else if (nv <= 8) {
    launch_rows<V, 4, 2>(a);
  } else if (nv <= 16) {
    launch_rows<V, 4, 4>(a);
  } else if (nv <= 32) {
    launch_rows<V, 32, 1>(a);
  } else if (nv <= 64) {
    launch_rows<V, 32, 2>(a);
  } else {
    launch_rows<V, 32, 4>(a);
  }
}

}  // namespace

PVCNN_EXPORT int pvcnn_avg_voxelize(const void* feats, const void* sorted_idx,
                                    const void* perm, void* out, int B, int N,
                                    int C, int R3, int channels_first,
                                    int mean, void* stream) {
  if (static_cast<int64_t>(B) * C * R3 == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const float*>(feats);
  const auto* si = static_cast<const int*>(sorted_idx);
  const auto* pm = static_cast<const long long*>(perm);
  auto* o = static_cast<float*>(out);
  if (channels_first) {
    const int64_t total =
        static_cast<int64_t>(B) * ((C + kGroup - 1) / kGroup) * R3;
    avg_voxelize_kernel<<<pvcnn::blocks_for(total), pvcnn::kThreads, 0, s>>>(
        f, si, pm, o, B, N, C, R3, 1, mean);
  } else {
    const RowsArgs a{f, si, pm, o, B, N, C, R3, mean, s};
    if (C % 4 == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0) {
      launch_rows_for<4>(a);
    } else {
      launch_rows_for<1>(a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

PVCNN_EXPORT const char* pvcnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
