// K5: trilinear devoxelize backward, the corner scatter-add
//
//   dgrid[b, c, idx8[b, n, k]] += w8[b, n, k] * g[b, n, c]   (8 corners)
//
// Replaces the TPU kernels pvcnn_tpu/ops/pallas/sorted_scatter.py:
// _sorted_scatter and pvcnn_tpu/ops/pallas/packed_scatter.py:_packed_scatter,
// which pvcnn_tpu/ops/devoxelize.py:_devox_bwd runs as one-hot MXU products
// over sorted or corner-packed rows.
//
// Design: K1's sort-then-sum-runs (csrc/voxelize.cu) with 8 weighted
// entries per point. The caller computes the corner bins and weights exactly
// as the forward does (pvcnn_tpu_torch/ops/devoxelize.py:_corners; the
// collapsed corner where frac = 0 keeps its weight 0) and stably sorts each
// cloud's 8N corner bins (glue, as K1 sorts). One thread per (cloud, bin,
// group of 8 channels) binary-searches its bin's run in the sorted keys and
// sums w * g over the run in sorted order, then writes every bin of its
// channels, empty ones as 0. No atomics: the sum order is fixed by the
// stable sort, so dgrid is reproducible bit for bit.
//
// Bound. Memory: the grid gradient is written once (B * R^3 * C floats,
// 268 MB at B = 32, R = 32, C = 64) against the N * C cotangent read and the
// sorted keys, order and weights (12 bytes per corner entry). Threads of a
// warp hold neighbouring bins, so in the channel-major layout the PVConv
// branch uses ([B, C, R^3]) each channel's store is coalesced.
#include "common.cuh"

namespace {

constexpr int kGroup = 8;   // channels per thread

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
devoxelize_bwd_kernel(const float* __restrict__ g,          // [B, N, C]
                      const int* __restrict__ sorted_bin,   // [B, 8N]
                      const long long* __restrict__ perm,   // [B, 8N]: n*8+k
                      const float* __restrict__ w8,         // [B, 8N]
                      float* __restrict__ out, int B, int N, int C, int R3,
                      int64_t stride_v, int64_t stride_c) {
  const int groups = (C + kGroup - 1) / kGroup;
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= static_cast<int64_t>(B) * groups * R3) return;
  const int v = static_cast<int>(t % R3);          // bins fastest
  const int64_t bg = t / R3;
  const int c0 = static_cast<int>(bg % groups) * kGroup;
  const int b = static_cast<int>(bg / groups);
  const int e = 8 * N;                              // entries per cloud
  const int* keys = sorted_bin + static_cast<int64_t>(b) * e;
  const int start = lower_bound(keys, e, v);
  const int end = start + lower_bound(keys + start, e - start, v + 1);
  const long long* p = perm + static_cast<int64_t>(b) * e;
  const float* w = w8 + static_cast<int64_t>(b) * e;
  const float* gb = g + static_cast<int64_t>(b) * N * C;
  const int nc = min(C - c0, kGroup);
  float acc[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) acc[i] = 0.f;
  for (int j = start; j < end; ++j) {
    const long long entry = __ldg(p + j);
    const float wj = __ldg(w + entry);
    const float* row = gb + (entry >> 3) * C + c0;
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      if (i < nc) acc[i] = fmaf(wj, __ldg(row + i), acc[i]);
    }
  }
  float* o = out + static_cast<int64_t>(b) * R3 * C + v * stride_v +
             c0 * stride_c;
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    if (i < nc) o[i * stride_c] = acc[i];
  }
}

}  // namespace

PVCNN_EXPORT int pvcnn_devoxelize_bwd(const void* g, const void* sorted_bin,
                                      const void* perm, const void* w8,
                                      void* out, int B, int N, int C, int R3,
                                      int64_t stride_v, int64_t stride_c,
                                      void* stream) {
  const int64_t total =
      static_cast<int64_t>(B) * ((C + kGroup - 1) / kGroup) * R3;
  if (total == 0) return 0;
  devoxelize_bwd_kernel<<<pvcnn::blocks_for(total), pvcnn::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int*>(sorted_bin),
      static_cast<const long long*>(perm), static_cast<const float*>(w8),
      static_cast<float*>(out), B, N, C, R3, stride_v, stride_c);
  return static_cast<int>(cudaGetLastError());
}
