// K2: trilinear devoxelize forward gather.
//
// Replaces the TPU kernel pvcnn_tpu/ops/pallas/sorted_gather.py:_sorted_gather
// (out[r] = sum_k w[k, r] * grid[idx[r] + off_k] over rows sorted by base bin,
// one in-VMEM one-hot matmul per bin tile), fed by
// pvcnn_tpu/ops/devoxelize.py:_sorted_gather_fwd, which sorts the rows,
// gathers the weights and un-permutes the result around it.
//
// Design. On the H100 a gather is a plain load, so neither the sort nor the
// one-hot product is needed. One thread per output element (cloud, point,
// channel) computes the point's 8 corners and trilinear weights from
// norm_coords itself (the math of pvcnn_tpu/ops/devoxelize.py:_corners,
// fused) and sums the 8 weighted grid values. The collapse rule is kept
// bit-for-bit: hi = lo + (frac > 0), so a corner on the grid's last plane
// (or an exact grid hit) collapses onto lo with weight exactly 0. Corner
// indices are clamped to [0, R-1], which is the identity for coordinates
// from normalize_coords and keeps any other input inside the grid.
//
// Bound. Memory latency: 8 scattered grid reads per output element. The
// grid's layout is given by strides, so the same kernel reads the bin-major
// rows of the public op ([B, R^3, C], channel fastest: neighbouring threads
// read one contiguous row) and the channel-major grid the PVConv voxel
// branch produces ([B, C, R^3]) without a transposing copy. The output
// [B, N, C] is written contiguously.
#include "common.cuh"

namespace {

__device__ __forceinline__ int clamp_index(int i, int r) {
  return min(max(i, 0), r - 1);
}

__global__ void __launch_bounds__(pvcnn::kThreads)
trilinear_devoxelize_kernel(const float* __restrict__ grid,
                            const float* __restrict__ coords,  // [B, N, 3]
                            float* __restrict__ out,           // [B, N, C]
                            int B, int N, int C, int R, int64_t stride_b,
                            int64_t stride_v, int64_t stride_c) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t total = static_cast<int64_t>(B) * N * C;
  if (t >= total) return;
  const int c = static_cast<int>(t % C);
  const int64_t bn = t / C;                       // b * N + n
  const int b = static_cast<int>(bn / N);
  const float* p = coords + bn * 3;
  const float x = __ldg(p), y = __ldg(p + 1), z = __ldg(p + 2);
  const float lx = floorf(x), ly = floorf(y), lz = floorf(z);
  const float fx = x - lx, fy = y - ly, fz = z - lz;
  const float gx = 1.f - fx, gy = 1.f - fy, gz = 1.f - fz;
  const int x0 = clamp_index(static_cast<int>(lx), R);
  const int y0 = clamp_index(static_cast<int>(ly), R);
  const int z0 = clamp_index(static_cast<int>(lz), R);
  const int x1 = clamp_index(x0 + (fx > 0.f), R);
  const int y1 = clamp_index(y0 + (fy > 0.f), R);
  const int z1 = clamp_index(z0 + (fz > 0.f), R);
  const int r2 = R * R;
  const float* g = grid + b * stride_b + c * stride_c;
  auto at = [&](int xi, int yi, int zi) {
    return __ldg(g + static_cast<int64_t>(xi * r2 + yi * R + zi) * stride_v);
  };
  // corner order and weight products as pvcnn_tpu/ops/devoxelize.py:_corners
  float acc = (gx * gy * gz) * at(x0, y0, z0);
  acc += (gx * gy * fz) * at(x0, y0, z1);
  acc += (gx * fy * gz) * at(x0, y1, z0);
  acc += (gx * fy * fz) * at(x0, y1, z1);
  acc += (fx * gy * gz) * at(x1, y0, z0);
  acc += (fx * gy * fz) * at(x1, y0, z1);
  acc += (fx * fy * gz) * at(x1, y1, z0);
  acc += (fx * fy * fz) * at(x1, y1, z1);
  out[t] = acc;
}

}  // namespace

PVCNN_EXPORT int pvcnn_trilinear_devoxelize(const void* grid,
                                            const void* coords, void* out,
                                            int B, int N, int C, int R,
                                            int64_t stride_b, int64_t stride_v,
                                            int64_t stride_c, void* stream) {
  const int64_t total = static_cast<int64_t>(B) * N * C;
  if (total == 0) return 0;
  trilinear_devoxelize_kernel<<<pvcnn::blocks_for(total), pvcnn::kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grid), static_cast<const float*>(coords),
      static_cast<float*>(out), B, N, C, R, stride_b, stride_v, stride_c);
  return static_cast<int>(cudaGetLastError());
}
