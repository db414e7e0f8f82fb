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
// K7: one warp per center, 16 centers per block, scanning the cloud's
// points in index order 32 at a time out of shared-memory tiles of 1024
// points. __ballot_sync on d² < r² gives the hits of 32 points, __popc of
// the lower lanes each hit's slot; the warp stops once it holds U hits, and
// the block stops staging tiles once all its warps have (the TPU kernel
// always scans all N). Bound: operations, 9 per (center, point scanned),
// and the points scanned depend on the data (all N for a center with fewer
// than U hits).
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

constexpr int kBqWarps = 16;
constexpr int kBqTile = 1024;
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

__global__ void __launch_bounds__(kBqWarps * 32)
ball_query_kernel(const float* __restrict__ centers,   // [B, M, 3]
                  const float* __restrict__ points,    // [B, N, 3]
                  int* __restrict__ out,               // [B, M, U]
                  int M, int N, int U, float r2) {
  __shared__ float px[kBqTile], py[kBqTile], pz[kBqTile];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kBqWarps + (threadIdx.x >> 5);
  const bool active = m < M;
  float cx = 0.f, cy = 0.f, cz = 0.f;
  if (active) {
    const float* c = centers + (static_cast<int64_t>(b) * M + m) * 3;
    cx = c[0];
    cy = c[1];
    cz = c[2];
  }
  const float* p = points + static_cast<int64_t>(b) * N * 3;
  int* o = out + (static_cast<int64_t>(b) * M + m) * U;
  int count = 0, first = 0;       // warp-uniform: derived from ballots
  bool done = !active;
  for (int base = 0; base < N; base += kBqTile) {
    // a barrier too: no warp still reads the tile that is overwritten next
    if (__syncthreads_and(done)) break;
    const int len = min(kBqTile, N - base);
    for (int t = threadIdx.x; t < len; t += blockDim.x) {
      const int64_t q = static_cast<int64_t>(base + t) * 3;
      px[t] = p[q];
      py[t] = p[q + 1];
      pz[t] = p[q + 2];
    }
    __syncthreads();
    if (done) continue;
    for (int s = 0; s < len && count < U; s += 32) {
      const int t = s + lane;
      const bool hit = t < len && sq_dist(cx, cy, cz, px[t], py[t], pz[t]) < r2;
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (mask == 0u) continue;
      if (count == 0) first = base + s + __ffs(mask) - 1;
      const int slot = count + __popc(mask & ((1u << lane) - 1u));
      if (hit && slot < U) o[slot] = base + t;
      count += __popc(mask);
    }
    done = count >= U;
  }
  if (active) {
    const int fill = count > 0 ? first : 0;
    for (int s = count + lane; s < U; s += 32) o[s] = fill;
  }
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

PVCNN_EXPORT int pvcnn_ball_query(const void* centers, const void* points,
                                  void* out, int B, int M, int N, int U,
                                  float r2, void* stream) {
  if (B == 0 || M == 0 || U == 0) return 0;
  const dim3 grid((M + kBqWarps - 1) / kBqWarps, B);
  ball_query_kernel<<<grid, kBqWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(centers), static_cast<const float*>(points),
      static_cast<int*>(out), M, N, U, r2);
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
