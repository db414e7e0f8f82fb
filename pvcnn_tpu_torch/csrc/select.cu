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
// leave shared memory a warp per center row, coalesced. Where U + 2 ints a
// center do not fit 32 centers in a block's shared memory (U above 1,750),
// the plan takes the device-memory path (kDeviceHits): a thread appends its
// hits straight to its center's row of out (one split) or of part_idx
// (several), and only the counts stay in shared memory. Bound: operations,
// 9 per (center, point scanned), and the points scanned depend on the data
// (all N for a center with fewer than U hits).
//
// K8: a query point a thread, its best three (d², idx) in registers; a
// center is one 16-byte broadcast from shared memory. The centers are
// staged by cp.async as float4 through a ring of 2 stages (kNnStage
// centers, fewer for a short run), K7's staging. Where the queries fill
// too few warps, the block splits the centers into `runs` contiguous runs,
// each scanned by its own warps for the same queries (the plan:
// pvcnn_tpu_torch/ops/interpolate.py:_three_nn_plan). Each run keeps its
// own best three; the first run's threads then insert the others' in run
// order through shared memory, with the scan's strict `<`, which equals
// one scan in index order bit for bit. A pair costs its share of the
// broadcast, 8 rounded operations and a compare. On a short run it then
// branches around its insertion (about 12 instructions); on a long run
// (kChunk = 32) it only sets a bit of a hit mask, and the chunk's hits are
// inserted after, in index order, each d² computed again: a branch a pair,
// its reconvergence and the insertions that some lane of a warp takes cost
// more there than the candidates of a chunk cost twice. Several queries a
// thread, sharing each broadcast, measured no faster: the arithmetic and
// the branches, not the shared loads, bound the kernel.
// Bound: operations, 9 per (query, center).
//
// Both compute d² as (dx² + dy²) + dz² with every operation rounded on its
// own (no FMA contraction), the order of select.py:70, so a point at the
// radius edge or a near-tie gets the same answer as the plain version and
// the JAX package.
#include "common.cuh"

namespace {

constexpr int kBqTile = 256;      // points per shared-memory tile
constexpr int kBqMaxThreads = 256;
constexpr int kNnStage = 512;     // centers a ring stage holds, all runs
constexpr int kNnMaxThreads = 256;
constexpr int kNnMaxRuns = 8;

__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Points [len] of a cloud into tile (float4 x, y, z, -) by 4-byte
// cp.async; slots len .. cap - 1 hold points at infinity, which never hit
// a radius nor beat a third best. Commits no group.
__device__ __forceinline__ void stage_points(float4* tile, const float* p,
                                             int len, int cap) {
  float* t = reinterpret_cast<float*>(tile);
  for (int e = threadIdx.x; e < 3 * len; e += blockDim.x) {
    const int i = e / 3;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(t + 4 * i + (e - 3 * i))),
                 "l"(p + e));
  }
  const float inf = __int_as_float(0x7f800000);
  for (int i = len + threadIdx.x; i < cap; i += blockDim.x) {
    tile[i] = make_float4(inf, inf, inf, 0.f);
  }
}

__device__ __forceinline__ void bq_stage(float4* tile, const float* p,
                                         int len) {
  stage_points(tile, p, len, kBqTile);
  asm volatile("cp.async.commit_group;\n" ::);
}

// Grid (center tiles, B, splits), T = blockDim.x threads. Dynamic shared
// memory: the ring [2][kBqTile] float4, then each thread's hits [T][U + 1]
// (not with kDeviceHits) and counts [T]. With one split the block writes
// out [B, M, U] with the fill; with more, its count to part_cnt [splits, B,
// M] and its first min(count, U) hits to part_idx [splits, B, M, U].
template <bool kDeviceHits>
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
  int* counts = kDeviceHits ? hits : hits + T * (U + 1);
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
  const int64_t row0 = static_cast<int64_t>(b) * M + m0;
  // this split's row of the center in device memory (kDeviceHits)
  const int64_t own_row = gridDim.z == 1 ? row0 + threadIdx.x
      : static_cast<int64_t>(split) * gridDim.y * M + row0 + threadIdx.x;
  int* mine = kDeviceHits ? (gridDim.z == 1 ? out : part_idx) + own_row * U
                          : hits + threadIdx.x * (U + 1);
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
  // with kDeviceHits, a row's hits in device memory are visible to the
  // block's other warps after the barrier too
  __syncthreads();

  // the block's rows, a warp per center row: slot s holds hit s, else the
  // fill (one split), or hit s of this split while s < count (several)
  const int lane = threadIdx.x & 31;
  const int rows = min(T, M - m0);
  for (int row = threadIdx.x >> 5; row < rows; row += T >> 5) {
    const int cnt = counts[row];
    if (gridDim.z == 1) {
      int* o = out + (row0 + row) * U;
      if (kDeviceHits) {
        // hits 0 .. cnt - 1 are in place; the rest get the fill
        const int fill = cnt > 0 ? o[0] : 0;
        for (int s = cnt + lane; s < U; s += 32) o[s] = fill;
      } else {
        const int* h = hits + row * (U + 1);
        const int fill = cnt > 0 ? h[0] : 0;
        for (int s = lane; s < U; s += 32) o[s] = s < cnt ? h[s] : fill;
      }
    } else {
      const int64_t pr = static_cast<int64_t>(split) * gridDim.y * M + row0 +
                         row;
      if (lane == 0) part_cnt[pr] = cnt;
      if (!kDeviceHits) {
        const int* h = hits + row * (U + 1);
        int* o = part_idx + pr * U;
        for (int s = lane; s < min(cnt, U); s += 32) o[s] = h[s];
      }
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

// Insert (d, i) into a best three (d0 <= d1 <= d2) that it beats (d < d2),
// after every entry of equal d²: index order where entries arrive in it.
__device__ __forceinline__ void nn_insert(float& d0, float& d1, float& d2,
                                          int& i0, int& i1, int& i2, float d,
                                          int i) {
  if (d < d1) {
    d2 = d1;
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
    d2 = d;
    i2 = i;
  }
}

// Grid (query blocks, B), T = blockDim.x threads (a power of two) in
// runs = 2^runs_shift groups of G = T / runs (whole warps); shifts, not
// divisions, keep the prologue of the small calls short. Thread k of group
// g takes query blockIdx.x * G + k against the centers of run g,
// [g * per_run, min((g + 1) * per_run, M)), stage t holding its centers
// [t * S, min((t + 1) * S, per_run)). Dynamic shared memory: the ring
// [2][runs][S] float4 (S = kNnStage / runs centers, or the run in whole
// chunks where it is shorter), reused after the scan for the best threes
// of groups 1 .. runs - 1, [runs - 1][3][G] floats then as many ints. A
// chunk is kChunk centers: with kChunk = 4 each pair branches around its
// insertion; with kChunk = 32 a chunk's pairs only set the bits of a hit
// mask (d² below the third best at the chunk's start), and its set bits
// are then inserted in index order, each d² computed again.
template <int kChunk>
__global__ void __launch_bounds__(kNnMaxThreads)
three_nn_kernel(const float* __restrict__ points,    // [B, N, 3] queries
                const float* __restrict__ centers,   // [B, M, 3]
                int* __restrict__ idx,               // [B, N, 3]
                float* __restrict__ d2,              // [B, N, 3]
                int N, int M, int runs_shift, int per_run) {
  extern __shared__ __align__(16) float4 nn_smem[];
  const int runs = 1 << runs_shift;
  const int g_shift = 31 - __clz(blockDim.x) - runs_shift;
  const int G = 1 << g_shift;
  const int run = threadIdx.x >> g_shift;
  const int k = threadIdx.x & (G - 1);
  const int b = blockIdx.y;
  const int n = blockIdx.x * G + k;
  // centers a run a stage: a share of kNnStage, no more than the run
  const int S = min(kNnStage >> runs_shift,
                    (per_run + kChunk - 1) & ~(kChunk - 1));
  const float inf = __int_as_float(0x7f800000);
  // a query past N and the centers that pad a stage sit at infinity: no
  // d² they give beats a third best
  float qx = inf, qy = inf, qz = inf;
  if (n < N) {
    const float* q = points + (static_cast<int64_t>(b) * N + n) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  float e0 = inf, e1 = inf, e2 = inf;
  int j0 = 0, j1 = 0, j2 = 0;
  const float* c = centers + static_cast<int64_t>(b) * M * 3;
  const int tiles = (per_run + S - 1) / S;
  // the centers a run scans in stage t, in whole chunks (at most S)
  auto span = [&](int t) {
    return (min(S, per_run - t * S) + kChunk - 1) & ~(kChunk - 1);
  };
  // stage t: those centers of every run, padded with infinity where the
  // run ends, committed as one group
  auto stage = [&](int t) {
    float4* dst = nn_smem + (t & 1) * runs * S;
    for (int g = 0; g < runs; ++g) {
      const int begin = g * per_run + t * S;
      const int len = max(0, min(S, min(per_run - t * S, M - begin)));
      stage_points(dst + g * S, c + 3 * static_cast<int64_t>(begin), len,
                   span(t));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  stage(0);
  for (int t = 0; t < tiles; ++t) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    // stage t has landed for every thread, and every thread has left
    // stage t - 1, whose buffer the next copies fill
    __syncthreads();
    if (t + 1 < tiles) stage(t + 1);
    const float4* tile = nn_smem + ((t & 1) * runs + run) * S;
    const int base = run * per_run + t * S;
    // whole chunks: the slots past the run's centers hold infinity
    const int len = span(t);
    for (int s = 0; s < len; s += kChunk) {
      if constexpr (kChunk == 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 p = tile[s + u];
          const float d = sq_dist(qx, qy, qz, p.x, p.y, p.z);
          if (d < e2) nn_insert(e0, e1, e2, j0, j1, j2, d, base + s + u);
        }
      } else {
        unsigned hit = 0u;
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const float4 p = tile[s + u];
          const float d = sq_dist(qx, qy, qz, p.x, p.y, p.z);
          hit |= static_cast<unsigned>(d < e2) << u;
        }
        while (hit != 0u) {
          const int u = __ffs(hit) - 1;
          hit &= hit - 1u;
          const float4 p = tile[s + u];
          const float d = sq_dist(qx, qy, qz, p.x, p.y, p.z);
          if (d < e2) nn_insert(e0, e1, e2, j0, j1, j2, d, base + s + u);
        }
      }
    }
  }

  if (runs > 1) {
    // every thread has left the ring; groups 1 .. runs - 1 hand their best
    // threes to group 0, which inserts them in run order
    __syncthreads();
    float* md = reinterpret_cast<float*>(nn_smem);
    int* mi = reinterpret_cast<int*>(md + (runs - 1) * 3 * G);
    if (run > 0) {
      const int at = (run - 1) * 3 * G + k;
      md[at] = e0;
      md[at + G] = e1;
      md[at + 2 * G] = e2;
      mi[at] = j0;
      mi[at + G] = j1;
      mi[at + 2 * G] = j2;
    }
    __syncthreads();
    if (run > 0) return;
    for (int g = 1; g < runs; ++g) {
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const int at = ((g - 1) * 3 + s) * G + k;
        const float d = md[at];
        if (d < e2) nn_insert(e0, e1, e2, j0, j1, j2, d, mi[at]);
      }
    }
  }
  if (n < N) {
    const int64_t off = (static_cast<int64_t>(b) * N + n) * 3;
    idx[off] = j0;
    idx[off + 1] = j1;
    idx[off + 2] = j2;
    d2[off] = e0;
    d2[off + 1] = e1;
    d2[off + 2] = e2;
  }
}

template <int kChunk>
cudaError_t launch_three_nn(const float* points, const float* centers,
                            int* idx, float* d2, int B, int N, int M,
                            int runs, int per_run, int threads,
                            cudaStream_t st) {
  const int G = threads / runs;
  // the kernel's S; the merge needs at most (8 - 1) * 3 * 32 * 8 bytes
  const int S = min(kNnStage / runs, (per_run + kChunk - 1) & ~(kChunk - 1));
  const size_t ring = 2 * static_cast<size_t>(runs) * S * sizeof(float4);
  const size_t merge = static_cast<size_t>(runs - 1) * 3 * G *
                       (sizeof(float) + sizeof(int));
  const size_t smem = ring > merge ? ring : merge;
  const dim3 grid((N + G - 1) / G, B);
  three_nn_kernel<kChunk><<<grid, threads, smem, st>>>(
      points, centers, idx, d2, N, M, __builtin_ctz(runs), per_run);
  return cudaGetLastError();
}

}  // namespace

// out [B, M, U]. The plan (pvcnn_tpu_torch/ops/neighbors.py:
// _ball_query_plan): threads (centers per block, a multiple of 32 up to
// 256), splits of per_split points (a multiple of kBqTile) and
// device_hits (each center's hits in device memory, not shared memory);
// scratch holds part_idx [splits, B, M, U] then part_cnt [splits, B, M]
// where splits > 1.
PVCNN_EXPORT int pvcnn_ball_query(const void* centers, const void* points,
                                  void* out, void* scratch, int B, int M,
                                  int N, int U, float r2, int threads,
                                  int splits, int per_split, int device_hits,
                                  void* stream) {
  if (B == 0 || M == 0 || U == 0) return 0;
  if (threads < 32 || threads > kBqMaxThreads || threads % 32 != 0 ||
      splits < 1 || per_split < 1 || per_split % kBqTile != 0 ||
      static_cast<int64_t>(splits) * per_split < N ||
      static_cast<int64_t>(splits - 1) * per_split >= max(N, 1) ||
      (splits > 1 && scratch == nullptr) ||
      (device_hits != 0 && device_hits != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * kBqTile * sizeof(float4) +
                      sizeof(int) * threads * (device_hits ? 1 : U + 2);
  const auto kernel = device_hits ? ball_query_kernel<true>
                                  : ball_query_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t n_centers = static_cast<int64_t>(B) * M;
  int* part_idx = static_cast<int*>(scratch);
  int* part_cnt = splits > 1 ? part_idx + splits * n_centers * U : nullptr;
  const dim3 grid((M + threads - 1) / threads, B, splits);
  kernel<<<grid, threads, smem, st>>>(
      static_cast<const float*>(centers), static_cast<const float*>(points),
      static_cast<int*>(out), part_idx, part_cnt, M, N, U, r2, per_split);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || splits == 1) return err;
  ball_query_merge_kernel<<<pvcnn::blocks_for(n_centers * U),
                            pvcnn::kThreads, 0, st>>>(
      part_idx, part_cnt, static_cast<int*>(out), n_centers, U, splits);
  return static_cast<int>(cudaGetLastError());
}

// idx, d2 [B, N, 3]. The plan (pvcnn_tpu_torch/ops/interpolate.py:
// _three_nn_plan): runs of per_run centers (a power of two, at most
// kNnMaxRuns, together covering the M centers, none empty), threads a block
// (a power of two, runs groups of whole warps, at most kNnMaxThreads) and
// hit_masks (chunks of 32 centers scanned into hit masks, else quads with a
// branch a pair).
PVCNN_EXPORT int pvcnn_three_nn(const void* points, const void* centers,
                                void* idx, void* d2, int B, int N, int M,
                                int runs, int per_run, int threads,
                                int hit_masks, void* stream) {
  if (B == 0 || N == 0) return 0;
  if (runs < 1 || runs > kNnMaxRuns || (runs & (runs - 1)) != 0 ||
      threads < 32 * runs || threads > kNnMaxThreads ||
      (threads & (threads - 1)) != 0 || per_run < 1 ||
      static_cast<int64_t>(runs) * per_run < M ||
      static_cast<int64_t>(runs - 1) * per_run >= max(M, 1) ||
      (hit_masks != 0 && hit_masks != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto p = static_cast<const float*>(points);
  const auto c = static_cast<const float*>(centers);
  const auto i = static_cast<int*>(idx);
  const auto d = static_cast<float*>(d2);
  const auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      hit_masks
          ? launch_three_nn<32>(p, c, i, d, B, N, M, runs, per_run, threads,
                                st)
          : launch_three_nn<4>(p, c, i, d, B, N, M, runs, per_run, threads,
                               st));
}
