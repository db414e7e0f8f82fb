// K9 and K10: the dense layer on channel-last point rows, forward (with the
// BatchNorm-statistics epilogue) and weight gradient.
//
// K9 replaces the TPU kernel pvcnn_tpu/ops/pallas/dense_rows.py:_run_fwd
// (kernel body _fwd_kernel), which the fused train-mode SharedMLP runs for
// every layer whose input is one array:
//
//   y[r, co] = bias[co] + sum_ci a(x[r, ci]) * w[ci, co]
//   a(x) = (t > 0 ? t : slope * t), t = x * scale[ci] + shift[ci]
//          with the prologue, else x
//
// and, with a `partial` buffer, the per-channel sum and sum of squares of
// the BIASED y over the rows (the BatchNorm batch statistics of training).
// Each block reduces its tile's columns over its in-range rows and writes
// them to partial[row_tile][2][Co]; the caller sums the row tiles in a fixed
// order, so the statistics are reproducible bit for bit (no atomics). The
// same kernel with w^T, no prologue, a zero bias and no statistics is the
// layer's data gradient (_drs_bwd runs _run_fwd so), counted apart.
//
// K10 replaces pvcnn_tpu/ops/pallas/dense_rows.py:_run_wgrad (kernel body
// _wgrad_kernel): dw[ci, co] = sum_r a(x[r, ci]) * g[r, co], and
// d(bias)[co] = sum_r g[r, co] from the same pass, the prologue re-derived
// from the raw x as the TPU kernel does.
//
// Design. Both are fp32 GEMMs on the CUDA cores (no TF32) with one block
// shape (csrc/fp32_tile.cuh): a 128 x 64 output tile, 128 threads with an
// 8 x 8 accumulator each, and the reduction in slices of 16 through two
// shared-memory buffers (the next slice is loaded into registers while the
// current one is multiplied; one barrier per slice). Partial tiles are handled on every axis by bounds
// checks: Ci runs from 9 to 512 and Co from 64 to 1024 in the models, and
// nothing is padded in device memory. Loads coalesce along each operand's
// contiguous axis: K9 reads x along its channels (16 lanes per row) and w
// along Co; K10 reads x and g along their channels, one row per slice step.
// The prologue is applied when the prefetched registers are stored to
// shared memory, without fused multiply-adds (the two roundings of the plain
// x * s + t).
//
// K10 reduces over all rows (131,072 at B = 32 x 4096) into few outputs, so
// it splits the rows (split-K without atomics): block z sums one chunk of
// rows into its own [Ci, Co] slice of partial[chunks][Ci][Co], and the
// blocks of the first row of output tiles also write that chunk's d(bias)
// to dbias[chunks][Co]; the caller sums both in a fixed order. K4's design
// (csrc/conv3d_wgrad.cu) at k = 1.
//
// Bound. 2 * rows * Ci * Co FLOPs each against 67 TFLOP/s of fp32 FMA; the
// operands are read once per output tile from L2.
#include "fp32_tile.cuh"

namespace {

using pvcnn::multiply_slice;
using pvcnn::tile_col;
using pvcnn::tile_grid;
constexpr int kThreads = pvcnn::kTileThreads;
constexpr int kBM = pvcnn::kTileM;
constexpr int kBN = pvcnn::kTileN;
constexpr int kBK = pvcnn::kTileK;
constexpr int kPad = pvcnn::kTilePad;

// t > 0 ? t : slope * t with t = x * s + h, as two roundings
__device__ __forceinline__ float activate(float x, float s, float h,
                                          float slope) {
  const float t = __fadd_rn(__fmul_rn(x, s), h);
  return t > 0.f ? t : __fmul_rn(slope, t);
}

template <bool kPrologue, bool kStats>
__global__ void __launch_bounds__(kThreads)
dense_rows_fwd_kernel(const float* __restrict__ x,       // [rows, Ci]
                      const float* __restrict__ w,       // [Ci, Co]
                      const float* __restrict__ bias,    // [Co]
                      const float* __restrict__ pscale,  // [Ci] (kPrologue)
                      const float* __restrict__ pshift,  // [Ci] (kPrologue)
                      float slope,
                      float* __restrict__ y,             // [rows, Co]
                      float* __restrict__ partial,       // [tiles, 2, Co]
                      int rows, int Ci, int Co) {
  __shared__ __align__(16) float As[2][kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[2][kBK][kBN + kPad];
  __shared__ float red[kStats ? 4 : 1][2][kBN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // staging: x along its channels (column ka of the slice, rows ra + 8i),
  // w along Co (column nb, slice rows kb + 2i)
  const int ka = tid % kBK, ra = tid / kBK;
  const int nb = tid % kBN, kb = tid / kBN;
  float a_next[16], b_next[8];
  bool k_in = false;                  // the staged channel is < Ci
  float s = 1.f, h = 0.f;             // its prologue scale and shift

  auto load_slice = [&](int k0) {
    const int ci = k0 + ka;
    k_in = ci < Ci;
    if (kPrologue && k_in) {
      s = __ldg(pscale + ci);
      h = __ldg(pshift + ci);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = m0 + ra + 8 * i;
      a_next[i] = (k_in && r < rows)
                      ? __ldg(x + static_cast<int64_t>(r) * Ci + ci) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = k0 + kb + 2 * i;
      const int n = n0 + nb;
      b_next[i] = (k < Ci && n < Co)
                      ? __ldg(w + static_cast<int64_t>(k) * Co + n) : 0.f;
    }
  };

  auto store_slice = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      // rows past the end hold a(0), which may not be 0: they are never
      // written, nor counted in the statistics
      As[buf][ka][ra + 8 * i] =
          (kPrologue && k_in) ? activate(a_next[i], s, h, slope) : a_next[i];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) Bs[buf][kb + 2 * i][nb] = b_next[i];
  };

  const int tm = tid / 8;
  const int tn = tid % 8;
  float acc[8][8];
  pvcnn::zero_tile(acc);

  const int slices = (Ci + kBK - 1) / kBK;
  load_slice(0);
  store_slice(0);
  __syncthreads();
  for (int sl = 0; sl < slices; ++sl) {
    const int cur = sl & 1;
    if (sl + 1 < slices) load_slice((sl + 1) * kBK);
    multiply_slice(As[cur], Bs[cur], tm, tn, acc);
    // the other buffer was last read in slice sl - 1, before the barrier
    // that ended it
    if (sl + 1 < slices) store_slice(cur ^ 1);
    __syncthreads();
  }

  float bj[8], s1[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + tile_col(tn, j);
    bj[j] = n < Co ? __ldg(bias + n) : 0.f;
    s1[j] = 0.f;
    s2[j] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + tm * 8 + i;
    if (m >= rows) continue;
    float* yrow = y + static_cast<int64_t>(m) * Co;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tile_col(tn, j);
      if (n < Co) {
        const float val = acc[i][j] + bj[j];
        yrow[n] = val;
        s1[j] += val;
        s2[j] = fmaf(val, val, s2[j]);
      }
    }
  }
  if (kStats) {
    // the 4 row groups of a warp (lane bits 3 and 4), then the 4 warps in
    // order: a fixed summation order
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int off = 8; off < 32; off <<= 1) {
        s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], off);
        s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], off);
      }
    }
    if (lane < 8) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        red[warp][0][tile_col(tn, j)] = s1[j];
        red[warp][1][tile_col(tn, j)] = s2[j];
      }
    }
    __syncthreads();
    if (tid < kBN && n0 + tid < Co) {
      float* out = partial + static_cast<int64_t>(blockIdx.x) * 2 * Co + n0 + tid;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        out[q * Co] = ((red[0][q][tid] + red[1][q][tid]) + red[2][q][tid]) +
                      red[3][q][tid];
      }
    }
  }
}

template <bool kPrologue>
__global__ void __launch_bounds__(kThreads)
dense_rows_wgrad_kernel(const float* __restrict__ x,       // [rows, Ci]
                        const float* __restrict__ g,       // [rows, Co]
                        const float* __restrict__ pscale,  // [Ci] (kPrologue)
                        const float* __restrict__ pshift,  // [Ci] (kPrologue)
                        float slope,
                        float* __restrict__ partial,       // [chunks, Ci, Co]
                        float* __restrict__ dbias,         // [chunks, Co]
                        int rows, int Ci, int Co, int chunk) {
  __shared__ __align__(16) float As[2][kBK][kBM + kPad];
  __shared__ __align__(16) float Bs[2][kBK][kBN + kPad];
  __shared__ float red[2][kBN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;      // input channels
  const int n0 = blockIdx.y * kBN;      // output channels
  const int rbeg = blockIdx.z * chunk;
  const int rend = min(rows, rbeg + chunk);
  const bool with_db = blockIdx.x == 0;

  // staging: x row k0 + k along its channels (channel m0 + tid), g along
  // its channels (column nb, slice rows kb + 2i)
  const int ci = m0 + tid;
  const bool ci_in = ci < Ci;
  const float s = (kPrologue && ci_in) ? __ldg(pscale + ci) : 1.f;
  const float h = (kPrologue && ci_in) ? __ldg(pshift + ci) : 0.f;
  const int nb = tid % kBN, kb = tid / kBN;
  const bool n_in = n0 + nb < Co;
  float a_next[16], b_next[8];
  int a_in = 0;                         // bit k: a_next[k] is a real row
  float db = 0.f;

  auto load_slice = [&](int r0) {
    a_in = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const bool in = ci_in && r0 + k < rend;
      a_next[k] = in ? __ldg(x + static_cast<int64_t>(r0 + k) * Ci + ci) : 0.f;
      a_in |= static_cast<int>(in) << k;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = r0 + kb + 2 * i;
      b_next[i] = (n_in && r < rend)
                      ? __ldg(g + static_cast<int64_t>(r) * Co + n0 + nb) : 0.f;
    }
  };

  auto store_slice = [&](int buf) {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      // rows past the chunk stay 0 (the prologue would not map 0 to 0)
      As[buf][k][tid] = (kPrologue && ((a_in >> k) & 1))
                            ? activate(a_next[k], s, h, slope) : a_next[k];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      Bs[buf][kb + 2 * i][nb] = b_next[i];
      if (with_db) db += b_next[i];
    }
  };

  const int tm = tid / 8;
  const int tn = tid % 8;
  float acc[8][8];
  pvcnn::zero_tile(acc);

  const int slices = (rend - rbeg + kBK - 1) / kBK;
  if (slices > 0) {
    load_slice(rbeg);
    store_slice(0);
  }
  __syncthreads();
  for (int sl = 0; sl < slices; ++sl) {
    const int cur = sl & 1;
    if (sl + 1 < slices) load_slice(rbeg + (sl + 1) * kBK);
    multiply_slice(As[cur], Bs[cur], tm, tn, acc);
    if (sl + 1 < slices) store_slice(cur ^ 1);
    __syncthreads();
  }

  float* out = partial + static_cast<int64_t>(blockIdx.z) * Ci * Co;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + tm * 8 + i;
    if (m >= Ci) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tile_col(tn, j);
      if (n < Co) out[static_cast<int64_t>(m) * Co + n] = acc[i][j];
    }
  }
  if (with_db) {
    // even and odd slice rows of each column, summed in that order
    red[kb][nb] = db;
    __syncthreads();
    if (tid < kBN && n0 + tid < Co) {
      dbias[static_cast<int64_t>(blockIdx.z) * Co + n0 + tid] =
          red[0][tid] + red[1][tid];
    }
  }
}

}  // namespace

PVCNN_EXPORT int pvcnn_dense_rows_fwd(const void* x, const void* w,
                                      const void* bias, const void* pscale,
                                      const void* pshift, float slope,
                                      void* y, void* partial, int rows,
                                      int Ci, int Co, int has_prologue,
                                      void* stream) {
  if (rows == 0 || Co == 0) return 0;
  const auto xf = static_cast<const float*>(x);
  const auto wf = static_cast<const float*>(w);
  const auto bf = static_cast<const float*>(bias);
  const auto sf = static_cast<const float*>(pscale);
  const auto tf = static_cast<const float*>(pshift);
  const auto yf = static_cast<float*>(y);
  const auto pf = static_cast<float*>(partial);
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid = tile_grid(rows, Co, 1);
  const bool stats = partial != nullptr;
  if (has_prologue && stats) {
    dense_rows_fwd_kernel<true, true><<<grid, kThreads, 0, st>>>(
        xf, wf, bf, sf, tf, slope, yf, pf, rows, Ci, Co);
  } else if (has_prologue) {
    dense_rows_fwd_kernel<true, false><<<grid, kThreads, 0, st>>>(
        xf, wf, bf, sf, tf, slope, yf, pf, rows, Ci, Co);
  } else if (stats) {
    dense_rows_fwd_kernel<false, true><<<grid, kThreads, 0, st>>>(
        xf, wf, bf, sf, tf, slope, yf, pf, rows, Ci, Co);
  } else {
    dense_rows_fwd_kernel<false, false><<<grid, kThreads, 0, st>>>(
        xf, wf, bf, sf, tf, slope, yf, pf, rows, Ci, Co);
  }
  return static_cast<int>(cudaGetLastError());
}

PVCNN_EXPORT int pvcnn_dense_rows_wgrad(const void* x, const void* g,
                                        const void* pscale,
                                        const void* pshift, float slope,
                                        void* partial, void* dbias, int rows,
                                        int Ci, int Co, int chunk,
                                        int has_prologue, void* stream) {
  if (rows == 0 || Ci == 0 || Co == 0) return 0;
  const int chunks = (rows + chunk - 1) / chunk;
  const dim3 grid = tile_grid(Ci, Co, chunks);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto xf = static_cast<const float*>(x);
  const auto gf = static_cast<const float*>(g);
  const auto sf = static_cast<const float*>(pscale);
  const auto tf = static_cast<const float*>(pshift);
  const auto pf = static_cast<float*>(partial);
  const auto df = static_cast<float*>(dbias);
  if (has_prologue) {
    dense_rows_wgrad_kernel<true><<<grid, kThreads, 0, st>>>(
        xf, gf, sf, tf, slope, pf, df, rows, Ci, Co, chunk);
  } else {
    dense_rows_wgrad_kernel<false><<<grid, kThreads, 0, st>>>(
        xf, gf, sf, tf, slope, pf, df, rows, Ci, Co, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
