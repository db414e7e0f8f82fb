// K11: 3x3x3 conv3d weight gradient on channel-last (NDHWC) voxel grids.
//
// Replaces the TPU kernel pvcnn_tpu/ops/pallas/conv_wgrad.py:
// _conv3d_wgrad_impl, the custom weight gradient of the NDHWC voxel
// branch's stride-1 SAME conv (pvcnn_tpu/nn/conv3d.py:conv3d_same):
//
//   dW[tap, ci, co] = sum_b sum_v Xpad[b, v + tap, ci] * g[b, v, co]
//
// with tap = (kx, ky, kz), kx walking D (the first spatial axis), Xpad the
// grid zero-padded by 1 on each side, x [B, R, R, R, Ci] and g
// [B, R, R, R, Co]. The output is tap-major, [27 * Ci, Co] (the JAX kernel
// layout [k, k, k, Ci, Co] flattened); the wrapper turns it into torch's
// [Co, Ci, 3, 3, 3].
//
// Design. K4's split-K GEMM (csrc/conv3d_wgrad.cu) on channel-last inputs:
// M = 27 * Ci rows (tap, ci), N = Co columns, a reduction over the B * R^3
// voxels, split into voxel chunks of one cloud; block z writes its own
// [M, Co] slice of partial[B * chunks][M][Co] and the caller sums the slices
// in a fixed order, so dW is reproducible bit for bit (no atomics). The
// tile is csrc/fp32_tile.cuh's 128 x 64 (fp32 on the CUDA cores, no TF32).
// Each thread stages one row (tap, ci) of the A tile for the 16 voxels of a
// slice: a voxel's channels are contiguous, so the lanes of a warp read
// neighbouring channels of one shifted voxel (coalesced where Ci >= 32).
// Zero padding is a bounds check on the shifted voxel, never a padded copy
// of the grid (the pad + reshape prologue is what cost the TPU version its
// in-step A/B, pvcnn_tpu/nn/conv3d.py). A thread walks its slice's voxels
// with an incremental (x, y, z) counter instead of dividing by R for each.
// g is staged along its channels.
//
// Bound. 2 * 27 * Ci * Co * B * R^3 FLOPs against 67 TFLOP/s of fp32 FMA;
// x and g are read once per (row tile, column tile) pair from L2.
#include "fp32_tile.cuh"

namespace {

using pvcnn::multiply_slice;
using pvcnn::tile_col;
constexpr int kThreads = pvcnn::kTileThreads;
constexpr int kBM = pvcnn::kTileM;
constexpr int kBN = pvcnn::kTileN;
constexpr int kBK = pvcnn::kTileK;
constexpr int kPad = pvcnn::kTilePad;

__global__ void __launch_bounds__(kThreads)
conv3d_ndhwc_wgrad_kernel(const float* __restrict__ x,   // [B, R^3, Ci]
                          const float* __restrict__ g,   // [B, R^3, Co]
                          float* __restrict__ partial,   // [B*chunks, 27*Ci, Co]
                          int Ci, int Co, int R, int chunk, int chunks) {
  __shared__ __align__(16) float As[2][kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[2][kBK][kBN + kPad];

  const int tid = threadIdx.x;
  const int M = 27 * Ci;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int b = blockIdx.z / chunks;
  const int R3 = R * R * R;
  const int vbeg = (blockIdx.z % chunks) * chunk;
  const int vend = min(R3, vbeg + chunk);
  const float* xb = x + static_cast<int64_t>(b) * R3 * Ci;
  const float* gb = g + static_cast<int64_t>(b) * R3 * Co;

  // this thread's A row: tap (dx, dy, dz) in -1..1 and channel ci; the
  // shifted voxel's channel sits at v * Ci + off
  const int m = m0 + tid;
  const bool m_in = m < M;
  const int tap = m_in ? m / Ci : 0;
  const int ci = m - tap * Ci;
  const int dx = tap / 9 - 1, dy = (tap / 3) % 3 - 1, dz = tap % 3 - 1;
  const int off = ((dx * R + dy) * R + dz) * Ci + ci;
  // (cx, cy, cz): the next voxel to stage, advanced one voxel at a time
  int cx = vbeg / (R * R), cy = (vbeg / R) % R, cz = vbeg % R;

  const int nb = tid % kBN, kb = tid / kBN;
  const bool n_in = n0 + nb < Co;
  float a_next[16], b_next[8];

  auto load_slice = [&](int vs) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int v = vs + k;
      const bool in = m_in && v < vend &&
                      static_cast<unsigned>(cx + dx) < static_cast<unsigned>(R) &&
                      static_cast<unsigned>(cy + dy) < static_cast<unsigned>(R) &&
                      static_cast<unsigned>(cz + dz) < static_cast<unsigned>(R);
      a_next[k] = in ? __ldg(xb + static_cast<int64_t>(v) * Ci + off) : 0.f;
      if (++cz == R) {
        cz = 0;
        if (++cy == R) {
          cy = 0;
          ++cx;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int v = vs + kb + 2 * i;
      b_next[i] = (n_in && v < vend)
                      ? __ldg(gb + static_cast<int64_t>(v) * Co + n0 + nb) : 0.f;
    }
  };

  auto store_slice = [&](int buf) {
#pragma unroll
    for (int k = 0; k < 16; ++k) As[buf][k][tid] = a_next[k];
#pragma unroll
    for (int i = 0; i < 8; ++i) Bs[buf][kb + 2 * i][nb] = b_next[i];
  };

  const int tm = tid / 8;
  const int tn = tid % 8;
  float acc[8][8];
  pvcnn::zero_tile(acc);

  const int slices = (vend - vbeg + kBK - 1) / kBK;
  if (slices > 0) {
    load_slice(vbeg);
    store_slice(0);
  }
  __syncthreads();
  for (int s = 0; s < slices; ++s) {
    const int cur = s & 1;
    if (s + 1 < slices) load_slice(vbeg + (s + 1) * kBK);
    multiply_slice(As[cur], Bs[cur], tm, tn, acc);
    // the other buffer was last read in slice s - 1, before the barrier
    // that ended it
    if (s + 1 < slices) store_slice(cur ^ 1);
    __syncthreads();
  }

  float* out = partial + static_cast<int64_t>(blockIdx.z) * M * Co;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int mo = m0 + tm * 8 + i;
    if (mo >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tile_col(tn, j);
      if (n < Co) out[static_cast<int64_t>(mo) * Co + n] = acc[i][j];
    }
  }
}

}  // namespace

PVCNN_EXPORT int pvcnn_conv3d_ndhwc_wgrad(const void* x, const void* g,
                                          void* partial, int B, int Ci,
                                          int Co, int R, int chunk,
                                          void* stream) {
  if (B == 0 || R == 0 || Co == 0 || Ci == 0) return 0;
  const int r3 = R * R * R;
  const int chunks = (r3 + chunk - 1) / chunk;
  conv3d_ndhwc_wgrad_kernel<<<pvcnn::tile_grid(27 * Ci, Co, B * chunks),
                              kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<float*>(partial), Ci, Co, R, chunk, chunks);
  return static_cast<int>(cudaGetLastError());
}
