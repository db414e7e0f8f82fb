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
// Design. One block per cloud. The cloud's coordinates sit in shared memory
// (12 bytes a point: 96 KB at N = 8192, so the launcher opts in to more
// than 48 KB), and each thread keeps the running distances of its PPT
// points (indices tid, tid + T, ...) in registers for the whole loop. A step
// is a distance update, a per-thread argmax in index order, a warp-shuffle
// argmax and a shared-memory argmax over the warps, comparing by value and
// then by the lower index. The squared distance is (dx² + dy²) + dz² with
// every operation rounded on its own (__fsub_rn / __fmul_rn / __fadd_rn:
// no FMA contraction), the order of fps.py:69, so the indices equal the
// plain version's and the JAX package's exactly.
//
// Bound. Operations: 10 fp32 operations per (point, step), B * N * M of
// them, against a few MB of HBM traffic. But the M steps depend on each
// other, and each ends in a block-wide argmax (two barriers and ten
// shuffles), so the floor is M block-argmax latencies, not the FLOP bound.
// Only B blocks run (32 of the H100's 132 SMs at batch 32): splitting a
// cloud over a thread-block cluster (distributed shared memory) is the
// known next step.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

__device__ __forceinline__ void take_better(float& bd, int& bi, float od,
                                            int oi) {
  if (od > bd || (od == bd && oi < bi)) {
    bd = od;
    bi = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& bd, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, bd, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    take_better(bd, bi, od, oi);
  }
}

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads)
fps_kernel(const float* __restrict__ coords,   // [B, N, 3]
           int* __restrict__ out,              // [B, M]
           int N, int M) {
  extern __shared__ float smem[];              // x[N], y[N], z[N]
  float* xs = smem;
  float* ys = smem + N;
  float* zs = smem + 2 * N;
  __shared__ float warp_d[32];
  __shared__ int warp_i[32];
  __shared__ int chosen;

  const int T = blockDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = T >> 5;
  const float* c = coords + static_cast<int64_t>(blockIdx.x) * N * 3;
  int* o = out + static_cast<int64_t>(blockIdx.x) * M;
  for (int i = threadIdx.x; i < N; i += T) {
    xs[i] = c[3 * i];
    ys[i] = c[3 * i + 1];
    zs[i] = c[3 * i + 2];
  }
  float dist[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) dist[k] = 1e38f;
  if (threadIdx.x == 0 && M > 0) o[0] = 0;
  __syncthreads();

  int last = 0;
  for (int j = 1; j < M; ++j) {
    const float lx = xs[last], ly = ys[last], lz = zs[last];
    float bd = -1.f;                 // below every distance
    int bi = N;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = threadIdx.x + k * T;
      if (i < N) {
        const float dx = __fsub_rn(xs[i], lx);
        const float dy = __fsub_rn(ys[i], ly);
        const float dz = __fsub_rn(zs[i], lz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                            __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        dist[k] = fminf(dist[k], d);
        if (dist[k] > bd) {          // indices rise with k: ties keep the first
          bd = dist[k];
          bi = i;
        }
      }
    }
    warp_argmax(bd, bi);
    if (lane == 0) {
      warp_d[warp] = bd;
      warp_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bd = lane < warps ? warp_d[lane] : -1.f;
      bi = lane < warps ? warp_i[lane] : N;
      warp_argmax(bd, bi);
      if (lane == 0) {
        chosen = bi;
        o[j] = bi;
      }
    }
    __syncthreads();
    last = chosen;
  }
}

template <int PPT>
int launch(const float* coords, int* out, int B, int N, int M, int threads,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(3) * N * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fps_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fps_kernel<PPT><<<B, threads, smem, stream>>>(coords, out, N, M);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Largest cloud: 16 points per thread at 1024 threads (192 KB of shared
// memory, ops/sampling.py:_FPS_MAX_POINTS); a larger N is refused.
PVCNN_EXPORT int pvcnn_fps(const void* coords, void* out, int B, int N, int M,
                           void* stream) {
  if (B == 0 || M == 0) return 0;
  if (N <= 0 || N > 16 * kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = N < kMaxThreads ? (N + 31) / 32 * 32 : kMaxThreads;
  const int ppt = (N + threads - 1) / threads;
  auto s = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const float*>(coords);
  auto o = static_cast<int*>(out);
  if (ppt <= 1) return launch<1>(c, o, B, N, M, threads, s);
  if (ppt <= 2) return launch<2>(c, o, B, N, M, threads, s);
  if (ppt <= 4) return launch<4>(c, o, B, N, M, threads, s);
  if (ppt <= 8) return launch<8>(c, o, B, N, M, threads, s);
  return launch<16>(c, o, B, N, M, threads, s);
}
