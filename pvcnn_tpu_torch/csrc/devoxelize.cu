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
// contiguous row segment. Near its bound at the S3DIS PVCNN shapes in fp32.
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
// trilinear_devoxelize_bf16) on a bf16 grid. Coordinates and weights stay
// f32, the 8 terms sum in f32 in the same order, and the output is rounded
// to bf16 once, as the JAX package's sorted gather (f32 weights and sum,
// pvcnn_tpu/ops/devoxelize.py:219-231: out.astype(grid.dtype)).
//
// A channel-last bf16 grid takes trilinear_devoxelize_groups_kernel. The
// thread-per-channel mapping above took 24% of its bound there (S3DIS
// PVCNN's opt-in step): each point's corners and weights recomputed C
// times, 2-byte loads (64 bytes of a corner row a warp instruction) and
// 2-byte stores. Here ceil(C / 8) consecutive lanes take a point, 8
// channels a lane: each lane computes the point's corners and weights as
// corners() does, reads each corner's 8 channels by one 16-byte load (a
// point's lanes read its corner row in whole sectors; 2-byte loads where
// C % 8 != 0 or the grid is not 16-byte aligned), sums the 8 terms as
// blend() is compiled (below) and stores its 8 rounded channels by one
// 16-byte store. No staging: a channel-last corner is a contiguous row,
// so the loads are whole sectors as they come, and the sectors that
// neighbouring points share are still in L1 or L2 when they load them.
//
// A channel-major bf16 grid takes trilinear_devoxelize_bricks_kernel<TC,
// BZ>. The plane-by-plane mapping made 8 two-byte loads a channel and point
// that touched 4 or more 32-byte sectors (the y and x corners are 2R and
// 2R^2 bytes apart), 16 useful bytes for some 128 moved, and stored
// through 2-byte pieces. Here a block of 256 threads takes one (cloud,
// brick of 512 base bins: 16 z x 8 y x 4 x where R % 16 == 0, bricks.cuh)
// and walks its chunks of TC channels (8, 16 or 32; more blocks share a
// brick's chunks only where the bricks fill under two waves):
//   1. it reads the cloud's coordinates, 4 points a thread at a time, and
//      lists the points whose clamped base bin lies in its brick (the
//      corners() arithmetic; shared-memory atomics: the order of the list
//      changes no output), marking the 8-bin z-segments of the brick and
//      its +1 halo (17 x 9 x 5 bins: the hi corners) that their corners
//      read. No sort is needed. Past 8,192 points it lists them in passes;
//   2. per chunk, it stages the marked segments into shared memory
//      channel-last, [bin][TC + 8] (16 bytes of padding: the 16-byte reads
//      of neighbouring bins fall in other banks): a thread per (channel,
//      row, segment), one 16-byte load (8 bins) where R % 8 == 0 and the
//      grid is aligned, else 2-byte loads, 4 segments' loads in flight
//      before their stores. A brick that holds no base bin loads nothing;
//      a sparse one loads only the segments its points read;
//   3. a thread per (listed point, 8 channels) computes the point's
//      corners and weights as corners() does, reads each corner's 8
//      channels by one 16-byte shared load, sums them as blend() is
//      compiled (fma(w0, v0, w1 * v1), then an fma a corner: the
//      channel-last bf16 kernel's bits) and stores the 8 rounded channels
//      of its output row as one 16-byte store (2-byte stores where C % 8
//      != 0).
// Every block reads its cloud's coordinates (12 bytes a point) from L2:
// 64 bricks at R = 32 read them 64 times a chunk pass.
#include <cuda_bf16.h>

#include "bricks.cuh"
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

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// sum_k w[k] * g[off[k] * stride], in corner order
__device__ __forceinline__ float blend(const float* __restrict__ g,
                                       int64_t stride, const int off[8],
                                       const float w[8]) {
  float acc = w[0] * load(g + off[0] * stride);
#pragma unroll
  for (int k = 1; k < 8; ++k) acc += w[k] * load(g + off[k] * stride);
  return acc;
}

__global__ void __launch_bounds__(pvcnn::kThreads)
trilinear_devoxelize_kernel(const float* __restrict__ grid,   // [B, R^3, C]
                            const float* __restrict__ coords,  // [B, N, 3]
                            float* __restrict__ out,           // [B, N, C]
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

template <int TC>
__global__ void __launch_bounds__(pvcnn::kThreads)
trilinear_devoxelize_planes_kernel(
    const float* __restrict__ grid,     // [B, C, R^3]
    const float* __restrict__ coords,   // [B, N, 3]
    float* __restrict__ out,            // [B, N, C]
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
  const float* gb = grid;
  if (lane < np) {
    corners(coords + bn * 3, R, off, w);
    gb += bn / N * r3 * C;
  }
  // the tile's store: 32 / TC rows per instruction, lane = channel in a row
  constexpr int kRows = 32 / TC;
  const int col = lane % TC, sub = lane / TC;
  float* o = out + p0 * C + col;
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

template <int TC>
void launch_planes(const float* grid, const float* coords, float* out, int B,
                   int N, int C, int R, cudaStream_t stream) {
  // split the channel tiles over more warps where the points alone give
  // too few (the coarse levels of PVCNN2)
  const int64_t point_warps = (static_cast<int64_t>(B) * N + 31) / 32;
  const int tiles = (C + TC - 1) / TC;
  int groups = 1;
  while (point_warps * groups < kMinWarps && groups * 2 <= tiles) groups *= 2;
  trilinear_devoxelize_planes_kernel<TC><<<
      pvcnn::blocks_for(point_warps * groups * 32), pvcnn::kThreads, 0,
      stream>>>(grid, coords, out, B, N, C, R, groups);
}

// ---- the channel-last bf16 mode: lanes over 8-channel groups --------------

// 8 channels' sums of the 8 corners' rows u[k] with the weights w, as
// blend() is compiled (-fmad): w0 * v0 + w1 * v1 fuses the first product,
// fma(w0, v0, w1 * v1), then an fma a corner; pinned with __fmaf_rn /
// __fmul_rn, so that no contraction moves a bit. -> 8 bf16, low first.
__device__ __forceinline__ uint4 blend8(const uint4 u[8], const float w[8]) {
  unsigned r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lo = 0.f, hi = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const unsigned pr = i == 0 ? u[k].x : i == 1 ? u[k].y
                          : i == 2 ? u[k].z : u[k].w;
      const float vl = bricks::lo_bf16(pr), vh = bricks::hi_bf16(pr);
      if (k == 0) {
        lo = vl;
        hi = vh;
      } else if (k == 1) {
        lo = __fmaf_rn(w[0], lo, __fmul_rn(w[1], vl));
        hi = __fmaf_rn(w[0], hi, __fmul_rn(w[1], vh));
      } else {
        lo = __fmaf_rn(w[k], vl, lo);
        hi = __fmaf_rn(w[k], vh, hi);
      }
    }
    r[i] = bricks::pack_bf16(lo, hi);
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// `lanes` consecutive threads a point (ceil(C / 8), at most a block's),
// each taking the point's 8-channel groups q, q + lanes, ...; a block
// kThreads / lanes points of a cloud, blockIdx.y the clouds
__global__ void __launch_bounds__(pvcnn::kThreads)
trilinear_devoxelize_groups_kernel(
    const __nv_bfloat16* __restrict__ grid,   // [B, R^3, C]
    const float* __restrict__ coords,         // [B, N, 3]
    __nv_bfloat16* __restrict__ out,          // [B, N, C]
    int B, int N, int C, int R, int lanes, int vec_grid, int vec_out) {
  const int per_block = pvcnn::kThreads / lanes;
  const int slot = threadIdx.x / lanes;
  const int n = blockIdx.x * per_block + slot;
  if (slot >= per_block || n >= N) return;
  const int groups = (C + 7) / 8;
  const int64_t r3 = static_cast<int64_t>(R) * R * R;
  for (int64_t b = blockIdx.y; b < B; b += gridDim.y) {
    const int64_t bn = b * N + n;
    int off[8];
    float w[8];
    corners(coords + bn * 3, R, off, w);
    const __nv_bfloat16* gb = grid + b * r3 * C;
    for (int q = threadIdx.x % lanes; q < groups; q += lanes) {
      uint4 u[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        u[k] = bricks::load8(gb + static_cast<int64_t>(off[k]) * C, 8 * q, C,
                             vec_grid);
      }
      bricks::store8(out + bn * C, 8 * q, C, blend8(u, w), vec_out);
    }
  }
}

int launch_groups(const __nv_bfloat16* grid, const float* coords,
                  __nv_bfloat16* out, int B, int N, int C, int R,
                  cudaStream_t stream) {
  const int groups = (C + 7) / 8;
  const int lanes = groups < pvcnn::kThreads ? groups : pvcnn::kThreads;
  const int per_block = pvcnn::kThreads / lanes;
  const int vec_grid =
      C % 8 == 0 && reinterpret_cast<uintptr_t>(grid) % 16 == 0;
  const int vec_out =
      C % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 blocks((N + per_block - 1) / per_block, B < 65535 ? B : 65535);
  trilinear_devoxelize_groups_kernel<<<blocks, pvcnn::kThreads, 0, stream>>>(
      grid, coords, out, B, N, C, R, lanes, vec_grid, vec_out);
  return static_cast<int>(cudaGetLastError());
}

// ---- the channel-major bf16 mode: a block a brick --------------------------

constexpr int kBrickThreads = 256;
constexpr int kList = 8192;                 // points a pass lists at most
constexpr int kScan = 4;                    // points a thread tests at once
constexpr int kBatch = 4;                   // z-segments a thread stages at
                                            // once
constexpr int kSeg = 8;                     // bins a z-segment

template <int TC, int BZ>
__global__ void __launch_bounds__(kBrickThreads)
trilinear_devoxelize_bricks_kernel(
    const __nv_bfloat16* __restrict__ grid,   // [B, C, R^3]
    const float* __restrict__ coords,         // [B, N, 3]
    __nv_bfloat16* __restrict__ out,          // [B, N, C]
    int N, int C, int R, int vec_grid, int vec_out) {
  using Geo = bricks::Brick<BZ>;
  constexpr int kHY = Geo::kHY, kHZ = Geo::kHZ, kRows = Geo::kRows;
  constexpr int kSegs = (kHZ + kSeg - 1) / kSeg;  // z-segments a halo row
  constexpr int kGroups = TC / 8;             // 8-channel groups
  constexpr int kStride = TC + 8;             // a halo bin's bf16 values
  constexpr int kItems = TC * kRows * kSegs;  // (channel, row, segment)
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned short* s_grid = reinterpret_cast<unsigned short*>(smem);
  // [min(N, kList)] the pass's listed points
  int* s_list = reinterpret_cast<int*>(s_grid + Geo::kHaloBins * kStride);
  __shared__ unsigned char s_used[kRows * kSegs];   // segments to stage
  __shared__ int s_count;
  const int tid = threadIdx.x;
  const bricks::Origin o = Geo::origin(blockIdx.x, R);
  const int64_t b = blockIdx.z;
  const int64_t R3 = static_cast<int64_t>(R) * R * R;
  const float* pts = coords + b * N * 3;
  for (int n0 = 0; n0 < N; n0 += kList) {     // one pass up to 8,192 points
    __syncthreads();                          // the last pass is read
    if (tid == 0) s_count = 0;
    for (int i = tid; i < kRows * kSegs; i += kBrickThreads) s_used[i] = 0;
    __syncthreads();
    // 1. list the points whose clamped base bin lies in the brick, and
    // mark the halo z-segments their corners read
    const int n1 = min(N, n0 + kList);
    for (int i0 = n0 + tid; i0 < n1; i0 += kScan * kBrickThreads) {
      float p[kScan][3];
#pragma unroll
      for (int u = 0; u < kScan; ++u) {
        const int n = i0 + u * kBrickThreads;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          p[u][d] = n < n1 ? __ldg(pts + 3 * n + d) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kScan; ++u) {
        const int n = i0 + u * kBrickThreads;
        const float lx = floorf(p[u][0]), ly = floorf(p[u][1]),
                    lz = floorf(p[u][2]);
        const int x0 = clamp_index(static_cast<int>(lx), R);
        const int y0 = clamp_index(static_cast<int>(ly), R);
        const int z0 = clamp_index(static_cast<int>(lz), R);
        const int ax = x0 - o.x, ay = y0 - o.y, az = z0 - o.z;
        if (n >= n1 || min(ax, min(ay, az)) < 0 || ax >= Geo::kX ||
            ay >= Geo::kY || az >= Geo::kZ) {
          continue;
        }
        s_list[atomicAdd(&s_count, 1)] = n;
        const int ax1 = clamp_index(x0 + (p[u][0] - lx > 0.f), R) - o.x;
        const int ay1 = clamp_index(y0 + (p[u][1] - ly > 0.f), R) - o.y;
        const int az1 = clamp_index(z0 + (p[u][2] - lz > 0.f), R) - o.z;
        const int hx[2] = {ax, ax1}, hy[2] = {ay, ay1};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = hx[j >> 1] * kHY + hy[j & 1];
          s_used[r * kSegs + az / kSeg] = 1;
          s_used[r * kSegs + az1 / kSeg] = 1;
        }
      }
    }
    __syncthreads();
    const int listed = s_count;
    if (listed == 0) continue;
    for (int c0 = blockIdx.y * TC; c0 < C; c0 += gridDim.y * TC) {
      // 2. the marked z-segments of the brick and its +1 halo for channels
      // c0 .. c0 + TC - 1: a thread's kBatch segments, their loads issued
      // before their stores
      for (int it0 = tid; it0 < kItems; it0 += kBatch * kBrickThreads) {
        uint4 v[kBatch];
        bool ok[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int it = it0 + u * kBrickThreads;
          const int cl = it % TC, rs = it / TC;
          const int r = rs / kSegs, z = o.z + rs % kSegs * kSeg;
          const int gx = o.x + r / kHY, gy = o.y + r % kHY;
          ok[u] = it < kItems && s_used[rs] && gx < R && gy < R && z < R &&
                  c0 + cl < C;
          v[u] = make_uint4(0, 0, 0, 0);
          if (!ok[u]) continue;
          const __nv_bfloat16* src =
              grid + (b * C + c0 + cl) * R3 + (gx * R + gy) * R + z;
          if (vec_grid) {
            v[u] = __ldg(reinterpret_cast<const uint4*>(src));
          } else {
            const unsigned short* s16 =
                reinterpret_cast<const unsigned short*>(src);
            unsigned e[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) e[i] = z + i < R ? __ldg(s16 + i) : 0;
            v[u] = make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16,
                              e[4] | e[5] << 16, e[6] | e[7] << 16);
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (!ok[u]) continue;
          const int it = it0 + u * kBrickThreads;
          const int rs = it / TC, hz0 = rs % kSegs * kSeg;
          unsigned short* dst = s_grid +
                                ((rs / kSegs) * kHZ + hz0) * kStride +
                                it % TC;
          const unsigned w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
          for (int i = 0; i < kSeg; ++i) {
            if (hz0 + i < kHZ) {
              dst[i * kStride] = i % 2 ? w[i / 2] >> 16 : w[i / 2] & 0xffffu;
            }
          }
        }
      }
      __syncthreads();
      // 3. a thread per (listed point, 8 channels)
      for (int it = tid; it < listed * kGroups; it += kBrickThreads) {
        const int q = it % kGroups;
        if (c0 + 8 * q >= C) continue;
        const int n = s_list[it / kGroups];
        // corners(), on the halo: the same roundings and corner order
        const float* p = pts + 3 * n;
        const float x = __ldg(p), y = __ldg(p + 1), z = __ldg(p + 2);
        const float lx = floorf(x), ly = floorf(y), lz = floorf(z);
        const float fx = x - lx, fy = y - ly, fz = z - lz;
        const float gx = 1.f - fx, gy = 1.f - fy, gz = 1.f - fz;
        const int x0 = clamp_index(static_cast<int>(lx), R);
        const int y0 = clamp_index(static_cast<int>(ly), R);
        const int z0 = clamp_index(static_cast<int>(lz), R);
        const int x1 = clamp_index(x0 + (fx > 0.f), R) - o.x;
        const int y1 = clamp_index(y0 + (fy > 0.f), R) - o.y;
        const int z1 = clamp_index(z0 + (fz > 0.f), R) - o.z;
        const int hx[2] = {x0 - o.x, x1}, hy[2] = {y0 - o.y, y1},
                  hz[2] = {z0 - o.z, z1};
        const float w[8] = {gx * gy * gz, gx * gy * fz, gx * fy * gz,
                            gx * fy * fz, fx * gy * gz, fx * gy * fz,
                            fx * fy * gz, fx * fy * fz};
        // v[k]: corner k's 8 channels
        float v[8][8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int h = (hx[k >> 2] * kHY + hy[(k >> 1) & 1]) * kHZ +
                        hz[k & 1];
          const uint4 u =
              *reinterpret_cast<const uint4*>(s_grid + h * kStride + 8 * q);
          const unsigned pr[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            v[k][2 * i] = bricks::lo_bf16(pr[i]);
            v[k][2 * i + 1] = bricks::hi_bf16(pr[i]);
          }
        }
        // blend()'s sum as compiled (-fmad): w0 * v0 + w1 * v1 fuses the
        // first product, fma(w0, v0, w1 * v1), then fma by corner
        float acc[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i] = __fmaf_rn(w[0], v[0][i], __fmul_rn(w[1], v[1][i]));
#pragma unroll
          for (int k = 2; k < 8; ++k) {
            acc[i] = __fmaf_rn(w[k], v[k][i], acc[i]);
          }
        }
        __nv_bfloat16* dst = out + (b * N + n) * C + c0 + 8 * q;
        if (vec_out) {
          *reinterpret_cast<uint4*>(dst) = make_uint4(
              bricks::pack_bf16(acc[0], acc[1]),
              bricks::pack_bf16(acc[2], acc[3]),
              bricks::pack_bf16(acc[4], acc[5]),
              bricks::pack_bf16(acc[6], acc[7]));
        } else {
          unsigned short* d16 = reinterpret_cast<unsigned short*>(dst);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (c0 + 8 * q + i < C) d16[i] = bricks::bf16_bits(acc[i]);
          }
        }
      }
      __syncthreads();                        // s_grid is read
    }
  }
}

template <int TC, int BZ>
int launch_bricks(const __nv_bfloat16* grid, const float* coords,
                  __nv_bfloat16* out, int B, int N, int C, int R,
                  cudaStream_t stream) {
  using Geo = bricks::Brick<BZ>;
  const size_t bytes = Geo::kHaloBins * (TC + 8) * sizeof(__nv_bfloat16) +
                       static_cast<size_t>(N < kList ? N : kList) * sizeof(int);
  if (B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        bricks::allow_shared<trilinear_devoxelize_bricks_kernel<TC, BZ>>(
            static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec_grid =
      R % 8 == 0 && reinterpret_cast<uintptr_t>(grid) % 16 == 0;
  const int vec_out =
      C % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int bricks = Geo::count(R);
  const dim3 blocks(
      bricks,
      bricks::chunk_split(static_cast<int64_t>(bricks) * B,
                          (C + TC - 1) / TC, 2),
      B);
  trilinear_devoxelize_bricks_kernel<TC, BZ><<<blocks, kBrickThreads, bytes,
                                               stream>>>(
      grid, coords, out, N, C, R, vec_grid, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <int TC>
int launch_bricks_for(const __nv_bfloat16* grid, const float* coords,
                      __nv_bfloat16* out, int B, int N, int C, int R,
                      cudaStream_t stream) {
  return R % 16 == 0
             ? launch_bricks<TC, 16>(grid, coords, out, B, N, C, R, stream)
             : launch_bricks<TC, 8>(grid, coords, out, B, N, C, R, stream);
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
// channels_first (a block a brick, tc channels a block: 8, 16 or 32), else
// channel-last [B, R^3, C] (lanes over 8-channel groups; tc unused) -> bf16
// [B, N, C]
PVCNN_EXPORT int pvcnn_trilinear_devoxelize_bf16(const void* grid,
                                                 const void* coords,
                                                 void* out, int B, int N,
                                                 int C, int R,
                                                 int channels_first, int tc,
                                                 void* stream) {
  const int64_t total = static_cast<int64_t>(B) * N * C;
  if (total == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* gp = static_cast<const __nv_bfloat16*>(grid);
  const auto* cp = static_cast<const float*>(coords);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (channels_first) {
    switch (tc) {
      case 8: return launch_bricks_for<8>(gp, cp, op, B, N, C, R, s);
      case 16: return launch_bricks_for<16>(gp, cp, op, B, N, C, R, s);
      case 32: return launch_bricks_for<32>(gp, cp, op, B, N, C, R, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return launch_groups(gp, cp, op, B, N, C, R, s);
}
