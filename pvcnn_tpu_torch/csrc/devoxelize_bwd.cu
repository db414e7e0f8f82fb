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

// G lanes per bin, M vectors of V floats per lane and pass over the channels
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
        T* o = reinterpret_cast<T*>(out + (b * R3 + v) * C);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int c = c0 + m * G + li;
          if (c < nv) o[c] = acc[m];
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
          out[(b * C + c0 * V + cl) * R3 + v0 + t] = tile[t * kStride + cl];
        }
      }
      __syncthreads();
    }
  }
}

struct Args {
  const float* g;
  const float4* sorted;
  const int* bounds;
  float* out;
  int B, N, C, R;
  cudaStream_t stream;
};

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
