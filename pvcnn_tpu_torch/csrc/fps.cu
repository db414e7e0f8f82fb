// K6: furthest point sampling.
//
// Replaces the TPU kernel pvcnn_tpu/ops/pallas/fps.py:fps_indices_pallas:
// per cloud, coords [N, 3] -> M indices. Index 0 is the seed; each point's
// running distance to the chosen set starts at 1e38; step j updates it with
// the squared distance to the point chosen at step j - 1 and picks the
// argmax, ties to the lowest index (the reference CUDA kernel's strict `>`
// scan). The TPU kernel's point is that nothing round-trips to HBM across
// the M dependent steps: it keeps coords and distances in VMEM.
//
// Design. A cloud runs on a thread-block cluster of CS = 1, 2, 4 or 8
// blocks of T threads (the wrapper's plan, ops/sampling.py:_fps_plan, picks
// them per cloud size from measurements); its thread g of CS * T holds the
// points g, g + CS * T, ... (PPT of them) and their running distances in
// registers for the whole loop, and every block keeps a copy of the
// cloud's coordinates in shared memory where they fit. A step is:
//   1. the distance update of the thread's points and its argmax in index
//      order. The squared distance is (dx² + dy²) + dz² with every operation
//      rounded on its own (__fsub_rn / __fmul_rn / __fadd_rn: no FMA
//      contraction), the order of fps.py:69, so the indices equal the plain
//      version's and the JAX package's exactly;
//   2. the warp's farthest: distances are non-negative, so their bits order
//      as unsigned ints, and a candidate is the key (distance bits << 32 |
//      ~index), largest for the farthest point and, among equals, the
//      lowest index. __reduce_max_sync takes the warp's largest distance.
//      On one block, each lane that holds it folds its key into the step's
//      best with a shared-memory atomicMax. On a cluster, __reduce_min_sync
//      takes the lowest index among those lanes, and lane 0 stores the
//      warp's key into its slot in every block (distributed shared memory:
//      plain stores; a 64-bit atomicMax into another block's shared memory
//      gave wrong indices on an H100);
//   3. the one barrier of the step (__syncthreads, or barrier.cluster);
//   4. every thread takes the best key (on a cluster, each warp reduces the
//      slots: a lane's largest, then two __reduce_*_sync over the halves),
//      and the chosen point's coordinates from the shared copy, else from
//      global memory. Keys and slots rotate through three buffers: step
//      j + 1's best is cleared in step j, before its barrier, when every
//      thread has read step j - 2's.
// A cloud larger than the cluster's registers hold (ppt = 0) streams its
// coordinates from global memory every step (12 bytes a point, from L2) and
// keeps the distances in a global buffer [B, N]; the kernel takes any N.
//
// Bound. Operations: 10 fp32 operations per (point, step), B * N * (M - 1)
// of them, against a few MB of memory traffic. But the M steps depend on
// each other, each ending in the argmax and the exchange, so the floor is
// M - 1 of those: with chain_only the kernel runs the steps without the
// distance work (each thread's candidate is a hash of the last point), and
// its time is that chain floor.
#include "common.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;   // the index of no point
// the cloud's coordinates in shared memory up to this many bytes
constexpr size_t kMaxSharedCoords = 200 * 1024;
constexpr int kMaxSlots = 8 * 32;         // warps of a cluster

__device__ __forceinline__ float sq_dist(float x, float y, float z, float lx,
                                         float ly, float lz) {
  const float dx = __fsub_rn(x, lx);
  const float dy = __fsub_rn(y, ly);
  const float dz = __fsub_rn(z, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// PPT > 0: PPT points a thread in registers; PPT == 0: every step streams
// the points from coords and the distances through dist [B, N].
template <int PPT, int kMaxThreads, bool kChainOnly>
__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ coords,   // [B, N, 3]
           int* __restrict__ out,              // [B, M]
           float* __restrict__ dist_g,         // [B, N] where PPT == 0
           int N, int M, int shared_coords) {
  extern __shared__ float s_xyz[];             // x[N], y[N], z[N]
  __shared__ unsigned long long s_best[3];     // the steps' best keys
  __shared__ unsigned long long s_slot[3][kMaxSlots];  // clusters: per warp
  const cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t b = blockIdx.x / cs;
  const int T = blockDim.x, W = T >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = rank * T + threadIdx.x;         // the thread in its cloud
  const int stride = cs * T;
  const float* c = coords + b * N * 3;
  float* dg = dist_g + b * N;
  int* o = out + b * M;

  if (shared_coords) {
    for (int i = threadIdx.x; i < N; i += T) {
      s_xyz[i] = __ldg(c + 3 * i);
      s_xyz[N + i] = __ldg(c + 3 * i + 1);
      s_xyz[2 * N + i] = __ldg(c + 3 * i + 2);
    }
  }
  constexpr int kP = PPT > 0 ? PPT : 1;
  float px[kP], py[kP], pz[kP], dist[kP];
  if constexpr (PPT > 0) {
    // a slot past the cloud keeps distance -1: fminf leaves it there, and
    // it never beats a real point's (>= 0), so the step needs no bounds test
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = g + k * stride;
      px[k] = py[k] = pz[k] = 0.f;
      dist[k] = -1.f;
      if (i < N) {
        px[k] = __ldg(c + 3 * i);
        py[k] = __ldg(c + 3 * i + 1);
        pz[k] = __ldg(c + 3 * i + 2);
        dist[k] = 1e38f;
      }
    }
  } else {
    for (int i = g; i < N; i += stride) dg[i] = 1e38f;
  }
  float lx = __ldg(c), ly = __ldg(c + 1), lz = __ldg(c + 2);  // the seed
  if (threadIdx.x < 3) s_best[threadIdx.x] = 0ull;   // below every key
  if (g == 0 && M > 0) o[0] = 0;
  // the copies and cleared keys are in place, and every block of the
  // cluster runs before the first remote atomic
  if (cs > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }

  int slot = 0;                                 // j % 3
  for (int j = 1; j < M; ++j) {
    slot = slot == 2 ? 0 : slot + 1;
    float bd = -1.f;
    unsigned bi = kNone;
    if constexpr (kChainOnly) {
      if (g < N) {
        bd = __uint_as_float((__float_as_uint(lx) * 2654435761u + g) &
                             0x3fffffffu);
        bi = g;
      }
    } else if constexpr (PPT > 0) {
      int bk = -1;                   // the thread's best register slot
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        dist[k] = fminf(dist[k], sq_dist(px[k], py[k], pz[k], lx, ly, lz));
        if (dist[k] > bd) {          // indices rise with k: ties keep the first
          bd = dist[k];
          bk = k;
        }
      }
      if (bk >= 0) bi = g + bk * stride;
    } else {
      for (int i = g; i < N; i += stride) {
        const float d = fminf(dg[i], sq_dist(__ldg(c + 3 * i),
                                             __ldg(c + 3 * i + 1),
                                             __ldg(c + 3 * i + 2), lx, ly,
                                             lz));
        dg[i] = d;
        if (d > bd) {
          bd = d;
          bi = i;
        }
      }
    }
    const unsigned bits = bi == kNone ? 0u : __float_as_uint(bd);
    const unsigned top = __reduce_max_sync(kFull, bits);
    unsigned long long best;
    if (cs == 1) {
      if (bi != kNone && bits == top) {
        atomicMax(&s_best[slot], static_cast<unsigned long long>(bits) << 32 |
                                     ~bi);
      }
      if (threadIdx.x == 0) s_best[slot == 2 ? 0 : slot + 1] = 0ull;
      __syncthreads();
      best = s_best[slot];
    } else {
      const unsigned low = __reduce_min_sync(kFull, bits == top ? bi : kNone);
      if (lane == 0) {
        const unsigned long long key =
            static_cast<unsigned long long>(top) << 32 | ~low;
        for (int r = 0; r < cs; ++r) {
          *cluster.map_shared_rank(&s_slot[slot][rank * W + warp], r) = key;
        }
      }
      cluster.sync();
      unsigned long long k = 0ull;
      for (int s = lane; s < cs * W; s += 32) k = max(k, s_slot[slot][s]);
      const unsigned hi = __reduce_max_sync(kFull,
                                            static_cast<unsigned>(k >> 32));
      const unsigned lo = __reduce_max_sync(
          kFull, static_cast<unsigned>(k >> 32) == hi
                     ? static_cast<unsigned>(k) : 0u);
      best = static_cast<unsigned long long>(hi) << 32 | lo;
    }
    const unsigned index = ~static_cast<unsigned>(best);
    if (shared_coords) {
      lx = s_xyz[index];
      ly = s_xyz[N + index];
      lz = s_xyz[2 * N + index];
    } else {
      lx = __ldg(c + 3 * index);
      ly = __ldg(c + 3 * index + 1);
      lz = __ldg(c + 3 * index + 2);
    }
    if (g == 0) o[j] = static_cast<int>(index);
  }
}

template <int PPT, bool kChainOnly>
int launch(const float* coords, int* out, float* dist, int B, int N, int M,
           int cs, int threads, cudaStream_t stream) {
  constexpr int kMaxThreads = PPT <= 8 ? 1024 : 512;
  if (threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = fps_kernel<PPT, kMaxThreads, kChainOnly>;
  const size_t bytes = static_cast<size_t>(3) * N * sizeof(float);
  const bool shared = bytes <= kMaxSharedCoords;
  if (shared && bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * cs);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = shared ? bytes : 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, coords, out, dist, N, M, int{shared});
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <bool kChainOnly>
int launch_ppt(const float* c, int* o, float* d, int B, int N, int M, int cs,
               int threads, int ppt, cudaStream_t s) {
  switch (ppt) {
    case 0: return launch<0, kChainOnly>(c, o, d, B, N, M, cs, threads, s);
    case 1: return launch<1, kChainOnly>(c, o, d, B, N, M, cs, threads, s);
    case 2: return launch<2, kChainOnly>(c, o, d, B, N, M, cs, threads, s);
    case 4: return launch<4, kChainOnly>(c, o, d, B, N, M, cs, threads, s);
    case 8: return launch<8, kChainOnly>(c, o, d, B, N, M, cs, threads, s);
    case 16: return launch<16, kChainOnly>(c, o, d, B, N, M, cs, threads, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// cluster: blocks per cloud (1, 2, 4 or 8); threads: per block, a multiple
// of 32 (at most 1024, 512 where ppt = 16); ppt: points per thread in
// registers (1, 2, 4, 8 or 16, with ppt * threads * cluster >= N), or 0 to
// stream the points (dist: a float buffer [B, N]); chain_only: the chain
// floor's probe (no distance work; its indices mean nothing).
PVCNN_EXPORT int pvcnn_fps(const void* coords, void* out, void* dist, int B,
                           int N, int M, int cluster, int threads, int ppt,
                           int chain_only, void* stream) {
  if (B == 0 || M == 0) return 0;
  const bool cluster_ok =
      cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8;
  if (N <= 0 || !cluster_ok || threads <= 0 || threads % 32 != 0 ||
      (ppt > 0 && static_cast<int64_t>(ppt) * threads * cluster < N) ||
      (ppt == 0 && dist == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto c = static_cast<const float*>(coords);
  const auto o = static_cast<int*>(out);
  const auto d = static_cast<float*>(dist);
  const auto s = static_cast<cudaStream_t>(stream);
  return chain_only
             ? launch_ppt<true>(c, o, d, B, N, M, cluster, threads, ppt, s)
             : launch_ppt<false>(c, o, d, B, N, M, cluster, threads, ppt, s);
}
