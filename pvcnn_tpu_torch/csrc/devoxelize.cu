// K2: trilinear devoxelize forward gather, out[b, n, :] = sum over the 8
// corners of the point's cell of w_k * grid[b, corner_k, :].
//
// Replaces the TPU kernel pvcnn_tpu/ops/pallas/sorted_gather.py:_sorted_gather
// (out[r] = sum_k w[k, r] * grid[idx[r] + off_k] over rows sorted by base bin,
// one in-VMEM one-hot matmul per bin tile), fed by
// pvcnn_tpu/ops/devoxelize.py:_sorted_gather_fwd, which sorts the rows,
// gathers the weights and un-permutes the result around it. On the H100 a
// gather is a plain load, so neither the sort nor the one-hot product is
// needed: both mappings compute each point's 8 corners and weights from
// norm_coords themselves (the math of pvcnn_tpu/ops/devoxelize.py:_corners).
// The collapse rule is kept bit-for-bit: hi = lo + (frac > 0), so a corner
// on the grid's last plane (or an exact grid hit) collapses onto lo with
// weight exactly 0. Corner indices are clamped to [0, R-1], the identity for
// coordinates from normalize_coords. Both mappings sum the 8 terms in the
// same order with the same weight products (`blend`), so they agree bit for
// bit.
//
// Bound. Bytes: the grid read once at most (B * C * R^3 floats), the output
// [B, N, C] written once. What costs is how many 32-byte sectors each
// warp-wide load and store touches, and whether the sectors a load shares
// with other points are still in L1 or L2 when those points load them.
//
// Channel-last grid [B, R^3, C] (the NDHWC branch): one thread per (cloud,
// point, channel), channel fastest, so a warp's corner load is one
// contiguous row segment. Near its bound at the S3DIS PVCNN shapes.
//
// Channel-major grid [B, C, R^3] (the rows branch of every default path).
// With the channel fastest, a warp's 32 lanes would read 32 channel planes
// R^3 * 4 bytes apart (128 KB at R = 32), a sector each per corner, and
// recompute the corners C times (that mapping took 3.9x grid_sample's time
// at the S3DIS PVCNN shapes). Here a
// warp takes 32 consecutive points, a lane each: the lane computes its
// point's 8 corners and weights once, into registers, then walks the
// channels one plane at a time, so all resident warps load from the same
// plane together and share its sectors in L1 (the z0/z1 corners of a lane
// share a sector). Loading several planes at once was slower at R = 32 on
// the H100: they crowd each other out of L1. A lane's sums go to
// its row of a per-warp shared tile [32][TC + 1] (odd stride: no bank
// conflicts); after TC channels the warp stores the tile row by row, TC * 4
// bytes of a point's output row per store lane group. Storing each
// lane's own row instead (4-byte or 16-byte pieces 4C bytes apart, partial
// sectors left in L2) was slower still. Where B * N / 32 warps are too
// few to fill the card (PVCNN2's coarse levels), the channel tiles are split
// over more warps.
//
// bf16 mode (pvcnn_trilinear_devoxelize_bf16, counted as
// trilinear_devoxelize_bf16): either mapping on a bf16 grid, a template on
// the grid's type. Coordinates and weights stay f32, the 8
// terms sum in f32 in the same order, and the output is rounded to bf16
// once, as the JAX package's sorted gather (f32 weights and sum,
// pvcnn_tpu/ops/devoxelize.py:219-231: out.astype(grid.dtype)). The fp32
// instantiations are the fp32 kernel's code.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

// channel-major mapping: a warp takes 32 points and tiles of TC channels;
// the channel tiles are split over more warps until there are kMinWarps
constexpr int kWarps = pvcnn::kThreads / 32;
constexpr int64_t kMinWarps = 4096;

__device__ __forceinline__ int clamp_index(int i, int r) {
  return min(max(i, 0), r - 1);
}

// A point's 8 flat corner offsets and weights, in the order of
// pvcnn_tpu/ops/devoxelize.py:_corners (x, y, z bits 000, 001, ..., 111).
__device__ __forceinline__ void corners(const float* __restrict__ p, int R,
                                        int off[8], float w[8]) {
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
  off[0] = x0 * r2 + y0 * R + z0;  w[0] = gx * gy * gz;
  off[1] = x0 * r2 + y0 * R + z1;  w[1] = gx * gy * fz;
  off[2] = x0 * r2 + y1 * R + z0;  w[2] = gx * fy * gz;
  off[3] = x0 * r2 + y1 * R + z1;  w[3] = gx * fy * fz;
  off[4] = x1 * r2 + y0 * R + z0;  w[4] = fx * gy * gz;
  off[5] = x1 * r2 + y0 * R + z1;  w[5] = fx * gy * fz;
  off[6] = x1 * r2 + y1 * R + z0;  w[6] = fx * fy * gz;
  off[7] = x1 * r2 + y1 * R + z1;  w[7] = fx * fy * fz;
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __uint_as_float(
      static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)))
      << 16);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// sum_k w[k] * g[off[k] * stride], in corner order
template <typename T>
__device__ __forceinline__ float blend(const T* __restrict__ g,
                                       int64_t stride, const int off[8],
                                       const float w[8]) {
  float acc = w[0] * load(g + off[0] * stride);
#pragma unroll
  for (int k = 1; k < 8; ++k) acc += w[k] * load(g + off[k] * stride);
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(pvcnn::kThreads)
trilinear_devoxelize_kernel(const T* __restrict__ grid,       // [B, R^3, C]
                            const float* __restrict__ coords,  // [B, N, 3]
                            T* __restrict__ out,               // [B, N, C]
                            int B, int N, int C, int R) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t total = static_cast<int64_t>(B) * N * C;
  if (t >= total) return;
  const int c = static_cast<int>(t % C);
  const int64_t bn = t / C;                       // b * N + n
  const int b = static_cast<int>(bn / N);
  int off[8];
  float w[8];
  corners(coords + bn * 3, R, off, w);
  const int64_t r3 = static_cast<int64_t>(R) * R * R;
  store(out + t, blend(grid + b * r3 * C + c, C, off, w));
}

template <int TC, typename T>
__global__ void __launch_bounds__(pvcnn::kThreads)
trilinear_devoxelize_planes_kernel(
    const T* __restrict__ grid,         // [B, C, R^3]
    const float* __restrict__ coords,   // [B, N, 3]
    T* __restrict__ out,                // [B, N, C]
    int B, int N, int C, int R, int groups) {
  __shared__ float tiles[kWarps][32 * (TC + 1)];
  float* tile = tiles[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int64_t points = static_cast<int64_t>(B) * N;
  const int64_t point_warps = (points + 31) / 32;
  const int64_t warp =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  if (warp >= point_warps * groups) return;
  const int g = static_cast<int>(warp / point_warps);  // channel tiles g, g +
  const int64_t p0 = (warp - g * point_warps) * 32;    // groups, ...
  const int np = static_cast<int>(points - p0 < 32 ? points - p0 : 32);
  const int64_t bn = p0 + lane;                        // b * N + n
  const int64_t r3 = static_cast<int64_t>(R) * R * R;
  int off[8];
  float w[8];
  const T* gb = grid;
  if (lane < np) {
    corners(coords + bn * 3, R, off, w);
    gb += bn / N * r3 * C;
  }
  // the tile's store: 32 / TC rows per instruction, lane = channel in a row
  constexpr int kRows = 32 / TC;
  const int col = lane % TC, sub = lane / TC;
  T* o = out + p0 * C + col;
  for (int c0 = g * TC; c0 < C; c0 += groups * TC) {
    const int ct = min(TC, C - c0);
    if (lane < np) {
      // one channel plane at a time: its loads share L1 with the other
      // warps' loads of the same plane
#pragma unroll 1
      for (int j = 0; j < ct; ++j) {
        tile[lane * (TC + 1) + j] = blend(gb + (c0 + j) * r3, 1, off, w);
      }
    }
    __syncwarp();
    if (col < ct) {
      for (int p = sub; p < np; p += kRows) {
        store(o + p * static_cast<int64_t>(C) + c0, tile[p * (TC + 1) + col]);
      }
    }
    __syncwarp();
  }
}

template <int TC, typename T>
void launch_planes(const T* grid, const float* coords, T* out, int B, int N,
                   int C, int R, cudaStream_t stream) {
  // split the channel tiles over more warps where the points alone give
  // too few (the coarse levels of PVCNN2)
  const int64_t point_warps = (static_cast<int64_t>(B) * N + 31) / 32;
  const int tiles = (C + TC - 1) / TC;
  int groups = 1;
  while (point_warps * groups < kMinWarps && groups * 2 <= tiles) groups *= 2;
  trilinear_devoxelize_planes_kernel<TC, T><<<
      pvcnn::blocks_for(point_warps * groups * 32), pvcnn::kThreads, 0,
      stream>>>(grid, coords, out, B, N, C, R, groups);
}

}  // namespace

PVCNN_EXPORT int pvcnn_trilinear_devoxelize(const void* grid,
                                            const void* coords, void* out,
                                            int B, int N, int C, int R,
                                            int channels_first, void* stream) {
  const int64_t total = static_cast<int64_t>(B) * N * C;
  if (total == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* gp = static_cast<const float*>(grid);
  const auto* cp = static_cast<const float*>(coords);
  auto* op = static_cast<float*>(out);
  if (channels_first) {
    // a 16-channel tile leaves more of the SM's memory to L1, which pays
    // where a channel plane is 128 KB (R = 32); below, 32 channels per tile
    // halve the stores' instructions
    if (R >= 32) {
      launch_planes<16>(gp, cp, op, B, N, C, R, s);
    } else {
      launch_planes<32>(gp, cp, op, B, N, C, R, s);
    }
  } else {
    trilinear_devoxelize_kernel<<<pvcnn::blocks_for(total), pvcnn::kThreads,
                                  0, s>>>(gp, cp, op, B, N, C, R);
  }
  return static_cast<int>(cudaGetLastError());
}

// the bf16 mode: a bf16 grid, channel-major [B, C, R^3] with
// channels_first, else channel-last [B, R^3, C] -> bf16 [B, N, C]
PVCNN_EXPORT int pvcnn_trilinear_devoxelize_bf16(const void* grid,
                                                 const void* coords,
                                                 void* out, int B, int N,
                                                 int C, int R,
                                                 int channels_first,
                                                 void* stream) {
  const int64_t total = static_cast<int64_t>(B) * N * C;
  if (total == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* gp = static_cast<const __nv_bfloat16*>(grid);
  const auto* cp = static_cast<const float*>(coords);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (!channels_first) {
    trilinear_devoxelize_kernel<<<pvcnn::blocks_for(total), pvcnn::kThreads,
                                  0, s>>>(gp, cp, op, B, N, C, R);
  } else if (R >= 32) {
    launch_planes<16>(gp, cp, op, B, N, C, R, s);
  } else {
    launch_planes<32>(gp, cp, op, B, N, C, R, s);
  }
  return static_cast<int>(cudaGetLastError());
}
