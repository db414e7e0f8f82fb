// K4: 3x3x3 conv3d weight gradient on flat voxel rows, with and without the
// input prologue.
//
// Replaces the TPU kernels pvcnn_tpu/ops/pallas/conv_rows.py:_run_wgrad (the
// raw-input conv's dW) and :_run_wgrad_act (dW against the prologue-activated
// input), which _act_bwd runs for every conv of the PVConv voxel branch:
//
//   dW[tap, ci, co] = sum_b sum_v a(x)[b, ci, v + tap] * g[b, co, v]
//   a(x) = leaky(x * scale[ci] + shift[ci], 0.1)   with the prologue, else x
//
// Out-of-grid taps contribute 0 (zero padding of the ACTIVATED input, as in
// the forward, csrc/conv3d.cu): the prologue applies to in-grid taps only.
// The output is tap-major, [27 * Ci, Co] (the JAX kernel layout
// [k, k, k, Ci, Co] flattened); the wrapper turns it into torch's
// [Co, Ci, 3, 3, 3].
//
// Design. A GEMM with M = 27 * Ci rows (tap, ci), N = Co columns and a
// reduction over K = B * R^3 voxels: outputs are few (110,592 at 64 -> 64)
// and the reduction long (1,048,576 at B = 32, R = 32), so a grid over
// output tiles alone would launch a dozen blocks on 132 SMs. The reduction
// is split instead (split-K without atomics): block z sums one voxel chunk
// of one cloud and writes its own [M, Co] slice of a partial buffer
// [B * chunks, M, Co]; the caller sums the slices in a fixed order, so dW
// is reproducible bit for bit. A block computes a 128 x 64 tile with 128
// threads, an 8 x 8 accumulator each, over 16-voxel slices that go through
// two shared-memory buffers (the next slice is loaded into registers while
// the current one is multiplied). Each thread stages one voxel of the slice
// for 16 of the tile's rows, so neighbouring threads read neighbouring
// voxels of one (ci, tap) row: coalesced. The rows' (ci, tap) offsets and
// prologue scale/shift are computed once per block into shared memory, so
// the prologue has no channel limit here. The prologue is applied when the
// prefetched registers are stored to shared memory, after the multiply:
// applied right after the loads, its arithmetic would wait on their
// latency before the multiply could start. fp32 on the CUDA cores, no TF32.
//
// The tile and its multiply are csrc/fp32_tile.cuh's, shared with K9-K11.
//
// Bound. Compute: 2 * 27 * Ci * Co * B * R^3 FLOPs (0.23 TFLOP at 64 -> 64,
// B = 32, R = 32) against 67 TFLOP/s of fp32 FMA; x and g are read once
// per (row tile, column tile) pair from L2.
#include "fp32_tile.cuh"

namespace {

using pvcnn::multiply_slice;
using pvcnn::tile_col;
constexpr int kThreads = pvcnn::kTileThreads;
constexpr int kBM = pvcnn::kTileM;   // rows (tap, ci) per block
constexpr int kBN = pvcnn::kTileN;   // output channels per block
constexpr int kBK = pvcnn::kTileK;   // voxels per slice
constexpr int kPad = pvcnn::kTilePad;

template <bool kPrologue>
__global__ void __launch_bounds__(kThreads)
conv3d_wgrad_kernel(const float* __restrict__ x,       // [B, Ci, R^3]
                    const float* __restrict__ g,       // [B, Co, R^3]
                    const float* __restrict__ pscale,  // [Ci] (kPrologue)
                    const float* __restrict__ pshift,  // [Ci] (kPrologue)
                    float* __restrict__ partial,       // [B*chunks, 27*Ci, Co]
                    int Ci, int Co, int R, int chunk, int chunks) {
  __shared__ __align__(16) float As[2][kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[2][kBK][kBN + kPad];
  __shared__ int row_off[kBM];    // ci * R^3 + tap offset, for rows < M
  __shared__ int row_tap[kBM];    // tx | ty << 2 | tz << 4, or -1 past M
  __shared__ float row_s[kBM], row_t[kBM];

  const int tid = threadIdx.x;
  const int M = 27 * Ci;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int b = blockIdx.z / chunks;
  const int R3 = R * R * R;
  const int vbeg = (blockIdx.z % chunks) * chunk;
  const int vend = min(R3, vbeg + chunk);
  const float* xb = x + static_cast<int64_t>(b) * Ci * R3;
  const float* gb = g + static_cast<int64_t>(b) * Co * R3;

  for (int i = tid; i < kBM; i += kThreads) {
    const int m = m0 + i;
    if (m < M) {
      const int tap = m / Ci;
      const int ci = m - tap * Ci;
      const int tx = tap / 9, ty = (tap / 3) % 3, tz = tap % 3;
      row_off[i] = ci * R3 + ((tx - 1) * R + (ty - 1)) * R + (tz - 1);
      row_tap[i] = tx | (ty << 2) | (tz << 4);
      row_s[i] = kPrologue ? __ldg(pscale + ci) : 1.f;
      row_t[i] = kPrologue ? __ldg(pshift + ci) : 0.f;
    } else {
      row_off[i] = 0;
      row_tap[i] = -1;
      row_s[i] = 1.f;
      row_t[i] = 0.f;
    }
  }
  __syncthreads();

  // staging: this thread's voxel column of the slice, and its rows
  const int kk = tid % kBK;           // voxel within the slice
  const int r_a = tid / kBK;          // A rows r_a + 8 * i, i < 16
  const int n_b = tid / kBK;          // B columns n_b + 8 * i, i < 8
  float a_next[16], b_next[8];
  int a_in = 0;                       // bit i: a_next[i] is an in-grid tap

  auto load_slice = [&](int vs) {
    const int v = vs + kk;
    const bool v_ok = v < vend;
    int vx = 0, vy = 0, vz = 0;
    if (v_ok) {
      vx = v / (R * R);
      vy = (v / R) % R;
      vz = v % R;
    }
    // bit d of mx: neighbour x + d - 1 is in the grid (likewise y, z)
    const int mx = v_ok ? ((vx > 0) | 2 | ((vx < R - 1) << 2)) : 0;
    const int my = (vy > 0) | 2 | ((vy < R - 1) << 2);
    const int mz = (vz > 0) | 2 | ((vz < R - 1) << 2);
    a_in = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int row = r_a + 8 * i;
      const int tp = row_tap[row];
      const bool in = tp >= 0 && ((mx >> (tp & 3)) & (my >> ((tp >> 2) & 3)) &
                                  (mz >> (tp >> 4)) & 1);
      a_next[i] = in ? __ldg(xb + row_off[row] + v) : 0.f;
      a_in |= static_cast<int>(in) << i;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = n0 + n_b + 8 * i;
      b_next[i] = (v_ok && n < Co)
                      ? __ldg(gb + static_cast<int64_t>(n) * R3 + v) : 0.f;
    }
  };

  auto store_slice = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int row = r_a + 8 * i;
      float val = a_next[i];
      if (kPrologue) {
        // out-of-grid taps stay 0: zero padding of the ACTIVATED input. No
        // fused multiply-add: the same roundings as x * s + t
        const float t = __fadd_rn(__fmul_rn(val, row_s[row]), row_t[row]);
        val = ((a_in >> i) & 1) ? (t > 0.f ? t : __fmul_rn(0.1f, t)) : 0.f;
      }
      As[buf][kk][row] = val;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) Bs[buf][kk][n_b + 8 * i] = b_next[i];
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
    const int m = m0 + tm * 8 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tile_col(tn, j);
      if (n < Co) out[static_cast<int64_t>(m) * Co + n] = acc[i][j];
    }
  }
}

}  // namespace

PVCNN_EXPORT int pvcnn_conv3d_wgrad(const void* x, const void* g,
                                    const void* pscale, const void* pshift,
                                    void* partial, int B, int Ci, int Co,
                                    int R, int chunk, int has_prologue,
                                    void* stream) {
  if (B == 0 || R == 0 || Co == 0 || Ci == 0) return 0;
  const int r3 = R * R * R;
  const int chunks = (r3 + chunk - 1) / chunk;
  const dim3 grid = pvcnn::tile_grid(27 * Ci, Co, B * chunks);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto xf = static_cast<const float*>(x);
  const auto gf = static_cast<const float*>(g);
  const auto sf = static_cast<const float*>(pscale);
  const auto tf = static_cast<const float*>(pshift);
  const auto pf = static_cast<float*>(partial);
  if (has_prologue) {
    conv3d_wgrad_kernel<true><<<grid, kThreads, 0, st>>>(
        xf, gf, sf, tf, pf, Ci, Co, R, chunk, chunks);
  } else {
    conv3d_wgrad_kernel<false><<<grid, kThreads, 0, st>>>(
        xf, gf, sf, tf, pf, Ci, Co, R, chunk, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}
