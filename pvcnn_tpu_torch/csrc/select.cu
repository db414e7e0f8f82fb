// K7: ball query, and K8: three nearest neighbours.
//
// K7 replaces the TPU kernel pvcnn_tpu/ops/pallas/select.py:ball_query_pallas
// plus its caller's fill (pvcnn_tpu/ops/neighbors.py:69-74): per center, the
// first U point ids in index order with d² < r² (the reference CUDA scan);
// a slot past the hit count gets the first hit, or 0 when the center has no
// hit. K8 replaces select.py:three_nn_pallas: per query point, the 3
// smallest d² over the centers with ties to the lower index, idx [3] int32
// and d² [3]; when there are fewer than 3 centers the unfilled slots keep
// idx 0 and d² = fp32(1e40) = inf (select.py:136-137).
//
// The TPU kernels build a [tile, N] distance plane in VMEM and take U (or
// 3) successive minima of it, because a TPU cannot stop a scan early or
// branch per row. On the H100:
//
// K7: one thread per center, T centers of one cloud per block (the plan:
// pvcnn_tpu_torch/ops/neighbors.py:_ball_query_plan). A thread scans its
// points in index order and appends its hits to its own row of shared
// memory, so index order holds without a ballot. The points pass through
// shared memory in tiles of kBqTile, staged by cp.async as float4 (x, y, z,
// -) in a ring of 2 (a partial tile padded with points at infinity, which
// never hit) and read as broadcasts: one 16-byte load serves the warp, and
// a pair costs the load, 9 rounded operations and a bit of a 32-point hit
// mask (no branch per point; its set bits are appended after). Early stop is
// per thread; a warp leaves the tile once every lane holds U hits
// (__all_sync every 32 points), and the block stops staging tiles once
// every thread has (__syncthreads_and at each tile). Where a cloud's
// centers fill too few warps to fill the card, the point range is split
// over `splits` blocks per center tile: each split keeps its count and its
// first U hits, and ball_query_merge_kernel takes, per output slot, the
// hit of the split whose counts (read in split order) cover it, else the
// fill: deterministic, and equal to the unsplit scan. The block's rows
// leave shared memory a warp per center row, coalesced. Bound: operations,
// 9 per (center, point scanned), and the points scanned depend on the data
// (all N for a center with fewer than U hits).
//
// K8: one thread per query point, 256 queries of one cloud per block; the
// cloud's centers pass through shared memory in tiles of 1024 (every thread
// reads the same center: a broadcast). Each thread keeps its best three
// (d², idx) in registers and inserts on a strict `<` while scanning in
// index order, which keeps the lower index on a tie. Bound: operations, 9
// per (query, center).
//
// Both compute d² as (dx² + dy²) + dz² with every operation rounded on its
// own (no FMA contraction), the order of select.py:70, so a point at the
// radius edge or a near-tie gets the same answer as the plain version and
// the JAX package.
#include "common.cuh"

namespace {

constexpr int kBqTile = 256;      // points per shared-memory tile
constexpr int kBqMaxThreads = 256;
constexpr int kNnThreads = 256;
constexpr int kNnTile = 1024;

__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ unsigned bq_smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Points [len of tile] of a cloud into tile (float4 x, y, z, -) by 4-byte
// cp.async; slots len .. kBqTile - 1 (a partial tile) hold infinity.
__device__ __forceinline__ void bq_stage(float4* tile, const float* p,
                                         int len) {
  float* t = reinterpret_cast<float*>(tile);
  for (int e = threadIdx.x; e < 3 * len; e += blockDim.x) {
    const int i = e / 3;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     bq_smem_addr(t + 4 * i + (e - 3 * i))),
                 "l"(p + e));
  }
  const float inf = __int_as_float(0x7f800000);
  for (int i = len + threadIdx.x; i < kBqTile; i += blockDim.x) {
    tile[i] = make_float4(inf, inf, inf, 0.f);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Grid (center tiles, B, splits), T = blockDim.x threads. Dynamic shared
// memory: the ring [2][kBqTile] float4, then each thread's hits [T][U + 1]
// and counts [T]. With one split the block writes out [B, M, U] with the
// fill; with more, its count to part_cnt [splits, B, M] and its first
// min(count, U) hits to part_idx [splits, B, M, U].
__global__ void __launch_bounds__(kBqMaxThreads, 4)
ball_query_kernel(const float* __restrict__ centers,   // [B, M, 3]
                  const float* __restrict__ points,    // [B, N, 3]
                  int* __restrict__ out,               // [B, M, U]
                  int* __restrict__ part_idx, int* __restrict__ part_cnt,
                  int M, int N, int U, float r2, int per_split) {
  extern __shared__ __align__(16) float4 bq_smem[];
  float4* ring = bq_smem;
  int* hits = reinterpret_cast<int*>(ring + 2 * kBqTile);
  const int T = blockDim.x;
  int* counts = hits + T * (U + 1);
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int m0 = blockIdx.x * T;
  const int m = m0 + threadIdx.x;
  const bool active = m < M;
  float cx = 0.f, cy = 0.f, cz = 0.f;
  if (active) {
    const float* c = centers + (static_cast<int64_t>(b) * M + m) * 3;
    cx = c[0];
    cy = c[1];
    cz = c[2];
  }
  const int p_begin = split * per_split;
  const int p_end = min(N, p_begin + per_split);
  const float* p = points + (static_cast<int64_t>(b) * N + p_begin) * 3;
  const int tiles = max(0, (p_end - p_begin + kBqTile - 1) / kBqTile);
  int* mine = hits + threadIdx.x * (U + 1);
  int count = 0;
  bool done = !active;

  if (tiles > 0) bq_stage(ring, p, min(kBqTile, p_end - p_begin));
  for (int t = 0; t < tiles; ++t) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    // tile t has landed for every thread, and every thread has left tile
    // t - 1, whose buffer the next copies fill
    if (__syncthreads_and(done)) break;
    const int base = t * kBqTile;
    if (t + 1 < tiles) {
      bq_stage(ring + ((t + 1) & 1) * kBqTile, p + 3 * (base + kBqTile),
               min(kBqTile, p_end - p_begin - base - kBqTile));
    }
    const float4* tile = ring + (t & 1) * kBqTile;
    const int len = min(kBqTile, p_end - p_begin - base);
    for (int s = 0; s < len; s += 32) {
      if (__all_sync(0xffffffffu, done)) break;
      // the hits among 32 points as a mask (no branch per point), then
      // appended in index order
      unsigned hit = 0u;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float4 q = tile[s + j];
        hit |= static_cast<unsigned>(sq_dist(cx, cy, cz, q.x, q.y, q.z) < r2)
               << j;
      }
      if (done) hit = 0u;
      while (hit != 0u) {
        if (count < U) mine[count] = p_begin + base + s + __ffs(hit) - 1;
        ++count;
        hit &= hit - 1u;
      }
      done = count >= U || done;
    }
  }
  counts[threadIdx.x] = count;
  __syncthreads();

  // the block's rows, a warp per center row: slot s holds hit s, else the
  // fill (one split), or hit s of this split while s < count (several)
  const int lane = threadIdx.x & 31;
  const int rows = min(T, M - m0);
  const int64_t row0 = static_cast<int64_t>(b) * M + m0;
  for (int row = threadIdx.x >> 5; row < rows; row += T >> 5) {
    const int cnt = counts[row];
    const int* h = hits + row * (U + 1);
    if (gridDim.z == 1) {
      const int fill = cnt > 0 ? h[0] : 0;
      int* o = out + (row0 + row) * U;
      for (int s = lane; s < U; s += 32) o[s] = s < cnt ? h[s] : fill;
    } else {
      const int64_t pr = static_cast<int64_t>(split) * gridDim.y * M + row0 +
                         row;
      if (lane == 0) part_cnt[pr] = cnt;
      int* o = part_idx + pr * U;
      for (int s = lane; s < min(cnt, U); s += 32) o[s] = h[s];
    }
  }
}

// out[c][s] for the B * M centers c: hit s of the splits taken in order
// (split k holds min(count_k, U) of them), else the first hit, else 0.
__global__ void __launch_bounds__(pvcnn::kThreads)
ball_query_merge_kernel(const int* __restrict__ part_idx,
                        const int* __restrict__ part_cnt,
                        int* __restrict__ out, int64_t centers, int U,
                        int splits) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= centers * U) return;
  const int64_t c = i / U;
  const int s = static_cast<int>(i - c * U);
  int before = 0, first = -1, val = -1;
  for (int k = 0; k < splits && val < 0; ++k) {
    const int64_t pr = k * centers + c;
    const int cnt = min(__ldg(part_cnt + pr), U);
    if (first < 0 && cnt > 0) first = __ldg(part_idx + pr * U);
    if (s < before + cnt) val = __ldg(part_idx + pr * U + s - before);
    before += cnt;
  }
  out[i] = val >= 0 ? val : first >= 0 ? first : 0;
}

__global__ void __launch_bounds__(kNnThreads)
three_nn_kernel(const float* __restrict__ points,    // [B, N, 3] queries
                const float* __restrict__ centers,   // [B, M, 3]
                int* __restrict__ idx,               // [B, N, 3]
                float* __restrict__ d2,              // [B, N, 3]
                int N, int M) {
  __shared__ float cx[kNnTile], cy[kNnTile], cz[kNnTile];
  const int b = blockIdx.y;
  const int n = blockIdx.x * kNnThreads + threadIdx.x;
  const bool active = n < N;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* q = points + (static_cast<int64_t>(b) * N + n) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  const float* c = centers + static_cast<int64_t>(b) * M * 3;
  const float inf = __int_as_float(0x7f800000);
  float d0 = inf, d1 = inf, e2 = inf;
  int i0 = 0, i1 = 0, i2 = 0;
  for (int base = 0; base < M; base += kNnTile) {
    const int len = min(kNnTile, M - base);
    __syncthreads();
    for (int t = threadIdx.x; t < len; t += kNnThreads) {
      const int64_t q = static_cast<int64_t>(base + t) * 3;
      cx[t] = c[q];
      cy[t] = c[q + 1];
      cz[t] = c[q + 2];
    }
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < len; ++t) {
      const float d = sq_dist(qx, qy, qz, cx[t], cy[t], cz[t]);
      if (d < e2) {
        const int i = base + t;
        if (d < d1) {
          e2 = d1;
          i2 = i1;
          if (d < d0) {
            d1 = d0;
            i1 = i0;
            d0 = d;
            i0 = i;
          } else {
            d1 = d;
            i1 = i;
          }
        } else {
          e2 = d;
          i2 = i;
        }
      }
    }
  }
  if (active) {
    const int64_t off = (static_cast<int64_t>(b) * N + n) * 3;
    idx[off] = i0;
    idx[off + 1] = i1;
    idx[off + 2] = i2;
    d2[off] = d0;
    d2[off + 1] = d1;
    d2[off + 2] = e2;
  }
}

}  // namespace

// out [B, M, U]. The plan (pvcnn_tpu_torch/ops/neighbors.py:
// _ball_query_plan): threads (centers per block, a multiple of 32 up to
// 256) and splits of per_split points (a multiple of kBqTile); scratch
// holds part_idx [splits, B, M, U] then part_cnt [splits, B, M] where
// splits > 1.
PVCNN_EXPORT int pvcnn_ball_query(const void* centers, const void* points,
                                  void* out, void* scratch, int B, int M,
                                  int N, int U, float r2, int threads,
                                  int splits, int per_split, void* stream) {
  if (B == 0 || M == 0 || U == 0) return 0;
  if (threads < 32 || threads > kBqMaxThreads || threads % 32 != 0 ||
      splits < 1 || per_split < 1 || per_split % kBqTile != 0 ||
      static_cast<int64_t>(splits) * per_split < N ||
      static_cast<int64_t>(splits - 1) * per_split >= max(N, 1) ||
      (splits > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * kBqTile * sizeof(float4) +
                      sizeof(int) * threads * (U + 2);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ball_query_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t n_centers = static_cast<int64_t>(B) * M;
  int* part_idx = static_cast<int*>(scratch);
  int* part_cnt = splits > 1 ? part_idx + splits * n_centers * U : nullptr;
  const dim3 grid((M + threads - 1) / threads, B, splits);
  ball_query_kernel<<<grid, threads, smem, st>>>(
      static_cast<const float*>(centers), static_cast<const float*>(points),
      static_cast<int*>(out), part_idx, part_cnt, M, N, U, r2, per_split);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || splits == 1) return err;
  ball_query_merge_kernel<<<pvcnn::blocks_for(n_centers * U),
                            pvcnn::kThreads, 0, st>>>(
      part_idx, part_cnt, static_cast<int*>(out), n_centers, U, splits);
  return static_cast<int>(cudaGetLastError());
}

PVCNN_EXPORT int pvcnn_three_nn(const void* points, const void* centers,
                                void* idx, void* d2, int B, int N, int M,
                                void* stream) {
  if (B == 0 || N == 0) return 0;
  const dim3 grid((N + kNnThreads - 1) / kNnThreads, B);
  three_nn_kernel<<<grid, kNnThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const float*>(centers),
      static_cast<int*>(idx), static_cast<float*>(d2), N, M);
  return static_cast<int>(cudaGetLastError());
}
