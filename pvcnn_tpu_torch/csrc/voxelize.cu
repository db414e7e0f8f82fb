// K1: avg_voxelize scatter-mean, and its sum mode (scatter_sum).
//
// Replaces the TPU kernels pvcnn_tpu/ops/pallas/scatter.py:_onehot_scatter_add
// and :_onehot_scatter_slots, which compute per cloud
// out[v] = sum_{n: idx[n] == v} values[n] as one-hot MXU matmuls (the counts
// ride as an appended ones column, pvcnn_tpu/ops/voxelize.py:122-129).
//
// Design. A one-hot matmul is the TPU's way around a serialized scatter; on
// the H100 it would spend N * bins * C multiply-adds on zeros. Here the
// caller stably sorts each cloud's flat bin ids (glue outside the kernel, as
// the JAX package sorts outside its sorted kernels), and one thread per
// (cloud, bin, group of 8 channels) binary-searches its bin's run in the
// sorted ids, then for each of its channels sums the run's feature values in
// point order and divides by max(count, 1). (One thread per bin for all C
// channels left too few threads at R = 16, C = 128; one per channel repeated
// the search C times.) No atomics: the sum order is fixed by the stable sort, so
// the output is bitwise reproducible run to run. Empty bins write 0.
//
// Sum mode (mean = 0) skips the divide: out[v] = the bin's run sum. It is
// the backward of the row gather take_rows (grouping, FPS gather, three-NN
// interpolation), which the JAX package routes through the same one-hot
// kernel (pvcnn_tpu/ops/gather_utils.py -> ops/voxelize.py:_scatter_sum);
// it is counted apart as the `scatter_sum` kernel.
//
// Bound. Memory: every output element is written once (B * R^3 * C floats,
// 25-67 MB at the ShapeNet shapes) while the N * C input is read once and
// the sorted ids (8 KB per cloud) stay in L1/L2 for the binary searches. In
// the channel-major layout ([B, C, R^3], what the conv consumes) the
// threads of a warp hold neighbouring bins, so each channel's store is
// coalesced; the bin-major layout ([B, R^3, C]) writes 8 channels of a row
// per thread.
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

}  // namespace

PVCNN_EXPORT int pvcnn_avg_voxelize(const void* feats, const void* sorted_idx,
                                    const void* perm, void* out, int B, int N,
                                    int C, int R3, int channels_first,
                                    int mean, void* stream) {
  const int64_t total =
      static_cast<int64_t>(B) * ((C + kGroup - 1) / kGroup) * R3;
  if (total == 0) return 0;
  avg_voxelize_kernel<<<pvcnn::blocks_for(total), pvcnn::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feats), static_cast<const int*>(sorted_idx),
      static_cast<const long long*>(perm), static_cast<float*>(out), B, N, C,
      R3, channels_first, mean);
  return static_cast<int>(cudaGetLastError());
}

PVCNN_EXPORT const char* pvcnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
