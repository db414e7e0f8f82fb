// K9 and K10: the dense layer on channel-last point rows, forward (with the
// BatchNorm-statistics epilogue) and data gradient, and weight gradient.
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
// the BIASED y over the rows (the BatchNorm batch statistics of training):
// each block sums its tile's columns over its in-range rows in a fixed order
// into partial[row_tile][2][Co], and the caller sums the row tiles in a
// fixed order, so the statistics are reproducible bit for bit (no atomics).
// The same kernel without prologue, bias or statistics, reading w in place
// as w^T, is the layer's data gradient (_drs_bwd runs _run_fwd so), counted
// apart.
//
// K10 replaces pvcnn_tpu/ops/pallas/dense_rows.py:_run_wgrad (kernel body
// _wgrad_kernel): dw[ci, co] = sum_r a(x[r, ci]) * g[r, co], and
// d(bias)[co] = sum_r g[r, co] from the same pass, the prologue re-derived
// from the raw x as the TPU kernel does.
//
// Design: one fp32 GEMM core (csrc/dense_gemm.cuh) for the three calls,
// which reads every operand in place in its layout: the forward's x and the
// dgrad's g k-contiguous, K10's x m-contiguous, the weight either way (the
// fused SharedMLP passes the Conv1d weight's [Ci, Co] view, k-contiguous in
// the forward and n-contiguous in the dgrad), K10's g n-contiguous. Staging
// is a cp.async ring; the prologue is applied to each staged A slice in
// shared memory once its copy has landed (two roundings, no FMA), and only
// to in-range entries: rows past the end stay 0, since a(0) may not be 0.
//
// K10 reduces over all rows (131,072 at B = 32 x 4096) into few outputs, so
// it splits the rows into `splits` chunks (split-K without atomics): one
// block per output tile and chunk, enough for about two waves of resident
// blocks (ops/dense_rows.py:_plan, from the SM count), each writing its
// [Ci, Co] partial and, in the first row of output tiles, its chunk's
// d(bias). dense_rows_fold_kernel then adds the chunks in order.
//
// Bound. 2 * rows * Ci * Co FLOPs against 67 TFLOP/s of fp32 FMA, or the
// operands' bytes (x and y or g once) against 3.35 TB/s where Ci or Co is
// 64 or less. A tile re-reads the weight from L2; blocks sharing an A tile
// run next to each other (the column tile is the fastest grid index), so A
// is read from device memory about once.
//
// bf16 mode (pvcnn_dense_rows_fwd_bf16 and pvcnn_dense_rows_wgrad_bf16,
// counted as dense_rows_fwd_bf16, dense_rows_dgrad_bf16 and
// dense_rows_wgrad_bf16): the same three calls on bf16 x, g and weight, as
// the TPU kernels run them on bf16 rows (jax.lax.dot with an f32
// accumulator), on dense_gemm.cuh's bf16 core (mma.sync m16n8k16, bf16
// operands, f32 accumulators; the same grid, ring and fixed orders).
// Rounding points, as in the JAX package (pvcnn_tpu/ops/pallas/
// dense_rows.py): the prologue a(x) in f32 from the bf16 x, rounded to
// bf16 before the product (_fwd_kernel's .astype(x.dtype)), applied to the
// staged slice in shared memory; the forward adds the f32 bias to the f32
// accumulator, takes the statistics from it (before any rounding) and
// rounds y to bf16 once; the dgrad (W^T, no bias, no statistics) rounds its
// output to bf16; K10 keeps dW and d(bias) in f32 (d(bias) the f32 sum of
// the bf16 cotangent) and folds its chunks in order. The wrapper casts the
// weight to a bf16 [Co, Ci] copy (the JAX op's w.astype(x.dtype)), which
// the forward reads K-major and the dgrad MN-major, in place. Bound:
// 2 * rows * Ci * Co FLOPs against 989 TFLOP/s of bf16 tensor cores, or
// the operands' bytes (2 an element) against 3.35 TB/s: at Ci or Co of
// 128 or less, bytes.
#include "dense_gemm.cuh"

namespace {

using pvcnn::gemm::kBK;
using pvcnn::gemm::kBM;
using pvcnn::gemm::kSA;
using pvcnn::gemm::kStages;
using pvcnn::gemm::kKMajor;
using pvcnn::gemm::kRows16;
using pvcnn::gemm::kRows4;
using pvcnn::gemm::Tile;

// t > 0 ? t : slope * t with t = x * s + h, as two roundings
__device__ __forceinline__ float activate(float x, float s, float h,
                                          float slope) {
  const float t = __fadd_rn(__fmul_rn(x, s), h);
  return t > 0.f ? t : __fmul_rn(slope, t);
}

// The prologue's channel: none, the reduction index k (K9: A = x is
// [rows, Ci]) or the row index m (K10: A = x^T is [Ci, rows]).
enum Prologue { kNone = 0, kByK = 1, kByM = 2 };

struct Args {
  const float* a;        // A(m, k): a[m * lda + k] (kKMajor) or a[k * lda + m]
  const float* b;        // B(k, n): b[n * ldb + k] (kKMajor) or b[k * ldb + n]
  int lda, ldb;
  const float* bias;     // [N] or null
  const float* pscale;   // [Ci] (with the prologue)
  const float* pshift;
  float slope;
  float* out;            // [splits][M][N]
  float* stats;          // [row tiles][2][N] or null
  float* dbias;          // [splits][N] or null (K10)
  int M, N, K, chunk;
};

// C = A B (+ bias) over k in one chunk; grid (row tiles x column tiles,
// chunks), the column tile fastest. kA and kB: each operand's Copy mode.
// K10 (kWgrad) also sums d(bias) and takes no statistics.
template <int BN, int kPro, int kA, int kB, bool kWgrad>
__device__ __forceinline__ void gemm(const Args& p, float* smem) {
  using T = Tile<BN>;
  constexpr int kThreads = T::kThreads;
  constexpr int kSB = T::kSB;

  const int tid = threadIdx.x;
  const int col_tiles = (p.N + BN - 1) / BN;
  const int tile_m = blockIdx.x / col_tiles;
  const int m0 = tile_m * kBM;
  const int n0 = (blockIdx.x % col_tiles) * BN;
  const int kbeg = blockIdx.y * p.chunk;
  const int kend = min(p.K, kbeg + p.chunk);
  const int slices = (kend - kbeg + kBK - 1) / kBK;
  const bool with_db = kWgrad && tile_m == 0;

  auto load = [&](int slice) {
    float* As = smem + (slice % kStages) * T::kStageFloats;
    const int k0 = kbeg + slice * kBK;
    pvcnn::gemm::stage<kA, kBM, kThreads>(As, p.a, p.lda, m0, p.M, k0, kend,
                                          tid);
    pvcnn::gemm::stage<kB, BN, kThreads>(As + kBK * kSA, p.b, p.ldb, n0, p.N,
                                         k0, kend, tid);
  };

  const int tm = tid / T::kTN;
  const int tn = tid % T::kTN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  // K10's d(bias): column tid % BN over half of each slice's rows
  const int db_col = tid % BN, db_half = tid / BN;
  float db = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slices) load(s);
    pvcnn::gemm::copy_commit();
  }
  for (int sl = 0; sl < slices; ++sl) {
    // every group but the newest kStages - 2 has landed: slice sl's
    pvcnn::gemm::copy_wait<kStages - 2>();
    __syncthreads();
    float* As = smem + (sl % kStages) * T::kStageFloats;
    const float* Bs = As + kBK * kSA;
    if (kPro != kNone) {
      const int k0 = kbeg + sl * kBK;
      for (int e = tid; e < kBK * kBM; e += kThreads) {
        const int k = e / kBM, m = e % kBM;
        if (m0 + m < p.M && k0 + k < kend) {
          const int ch = kPro == kByK ? k0 + k : m0 + m;
          float* v = As + k * kSA + m;
          *v = activate(*v, __ldg(p.pscale + ch), __ldg(p.pshift + ch),
                        p.slope);
        }
      }
      __syncthreads();
    }
    if (with_db) {
#pragma unroll
      for (int k = 0; k < kBK / 2; ++k) {
        db += Bs[(db_half * (kBK / 2) + k) * kSB + db_col];
      }
    }
    // the ring slot of slice sl - 1: every thread finished it before the
    // barrier above
    if (sl + kStages - 1 < slices) load(sl + kStages - 1);
    pvcnn::gemm::copy_commit();
    pvcnn::gemm::multiply<BN>(As, Bs, tm, tn, acc);
  }

  // the tile plus bias, stored from registers: a quarter warp writes 128
  // contiguous bytes of a row (float4 where N % 4 == 0)
  float bj[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + pvcnn::gemm::col<BN>(tn, j);
    bj[j] = (!kWgrad && p.bias != nullptr && n < p.N) ? __ldg(p.bias + n)
                                                      : 0.f;
  }
  float* out = p.out + static_cast<int64_t>(blockIdx.y) * p.M * p.N;
  const bool vec = p.N % 4 == 0 && pvcnn::gemm::aligned16(out);
  float s1[8], s2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s1[j] = s2[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + tm * 8 + i;
    if (m >= p.M) break;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = acc[i][j] + bj[j];
      s1[j] += v[j];
      s2[j] = fmaf(v[j], v[j], s2[j]);
    }
    float* row = out + static_cast<int64_t>(m) * p.N + n0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = pvcnn::gemm::col<BN>(tn, 4 * h);
      if (vec) {
        if (n0 + c < p.N) {
          *reinterpret_cast<float4*>(row + c) =
              make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (n0 + c + q < p.N) row[c + q] = v[4 * h + q];
        }
      }
    }
  }
  if (kWgrad ? !with_db : p.stats == nullptr) return;

  // the statistics (K9) or d(bias) (K10) of the tile's columns, in a fixed
  // order: a thread's rows, the warp's row groups (lanes tn + k * kTN), the
  // warps in order
  constexpr int kWarps = kThreads / 32;
  float* red = smem;                      // [kWarps][2][BN] or [2][BN]
  pvcnn::gemm::copy_wait<0>();
  __syncthreads();
  if (kWgrad) {
    red[db_half * BN + db_col] = db;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int off = T::kTN; off < 32; off <<= 1) {
        s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], off);
        s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], off);
      }
    }
    const int lane = tid & 31, warp = tid >> 5;
    if (lane < T::kTN) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = pvcnn::gemm::col<BN>(tn, j);
        red[(warp * 2) * BN + c] = s1[j];
        red[(warp * 2 + 1) * BN + c] = s2[j];
      }
    }
  }
  __syncthreads();
  if (tid < BN && n0 + tid < p.N) {
    if (kWgrad) {
      p.dbias[static_cast<int64_t>(blockIdx.y) * p.N + n0 + tid] =
          red[tid] + red[BN + tid];
    } else {
      float* o = p.stats + static_cast<int64_t>(tile_m) * 2 * p.N + n0 + tid;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float sum = red[q * BN + tid];
        for (int w = 1; w < kWarps; ++w) sum += red[(w * 2 + q) * BN + tid];
        o[q * p.N] = sum;
      }
    }
  }
}

template <int BN, int kPro, int kA, int kB>
__global__ void __launch_bounds__(Tile<BN>::kThreads, BN == 128 ? 2 : 3)
dense_rows_fwd_kernel(const Args p) {
  extern __shared__ __align__(16) float smem[];
  gemm<BN, kPro, kA, kB, false>(p, smem);
}

template <int BN, int kPro, int kA, int kB>
__global__ void __launch_bounds__(Tile<BN>::kThreads, BN == 128 ? 2 : 3)
dense_rows_wgrad_kernel(const Args p) {
  extern __shared__ __align__(16) float smem[];
  gemm<BN, kPro, kA, kB, true>(p, smem);
}

// dw = sum over the chunks of partial [splits][total] in order, and
// db = the same of dbp [splits][N]
__global__ void __launch_bounds__(pvcnn::kThreads)
dense_rows_fold_kernel(const float* __restrict__ partial,
                       const float* __restrict__ dbp,
                       float* __restrict__ dw, float* __restrict__ db,
                       int64_t total, int N, int splits) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i < total) {
    float s = __ldg(partial + i);
    for (int z = 1; z < splits; ++z) s += __ldg(partial + z * total + i);
    dw[i] = s;
  } else if (i < total + N) {
    const int n = static_cast<int>(i - total);
    float s = __ldg(dbp + n);
    for (int z = 1; z < splits; ++z) s += __ldg(dbp + z * N + n);
    db[n] = s;
  }
}

template <int BN, int kPro, int kA, int kB, bool kWgrad>
int launch_tile(const Args& a, int splits, cudaStream_t st) {
  void (*kernel)(const Args);
  if constexpr (kWgrad) {
    kernel = dense_rows_wgrad_kernel<BN, kPro, kA, kB>;
  } else {
    kernel = dense_rows_fwd_kernel<BN, kPro, kA, kB>;
  }
  constexpr int smem = Tile<BN>::kSmemBytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t tiles = static_cast<int64_t>((a.M + kBM - 1) / kBM) *
                        ((a.N + BN - 1) / BN);
  if (tiles > 0x7fffffff || splits > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  kernel<<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(splits)),
           Tile<BN>::kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int kPro, int kA, int kB, bool kWgrad>
int launch(const Args& a, int bn, int splits, cudaStream_t st) {
  switch (bn) {
    case 64: return launch_tile<64, kPro, kA, kB, kWgrad>(a, splits, st);
    case 128: return launch_tile<128, kPro, kA, kB, kWgrad>(a, splits, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The copy of an operand of `ld` floats per row or column, contiguous along
// k or along the tile's rows: 16 bytes at a time where that is aligned.
int copy_mode(const void* p, int ld, int kmajor) {
  return kmajor ? kKMajor
                : ld % 4 == 0 && pvcnn::gemm::aligned16(p) ? kRows16 : kRows4;
}

// K9: A = x (k-contiguous), B = the weight in its copy mode
template <int kPro>
int launch_fwd(const Args& a, int b_mode, int bn, cudaStream_t st) {
  switch (b_mode) {
    case kKMajor: return launch<kPro, kKMajor, kKMajor, false>(a, bn, 1, st);
    case kRows16: return launch<kPro, kKMajor, kRows16, false>(a, bn, 1, st);
    default: return launch<kPro, kKMajor, kRows4, false>(a, bn, 1, st);
  }
}

// K10: A = x^T and B = g, each by rows, 16 or 4 bytes at a time
template <int kPro>
int launch_wgrad(const Args& a, int a_mode, int b_mode, int bn, int splits,
                 cudaStream_t st) {
  if (a_mode == kRows16) {
    return b_mode == kRows16
               ? launch<kPro, kRows16, kRows16, true>(a, bn, splits, st)
               : launch<kPro, kRows16, kRows4, true>(a, bn, splits, st);
  }
  return b_mode == kRows16
             ? launch<kPro, kRows4, kRows16, true>(a, bn, splits, st)
             : launch<kPro, kRows4, kRows4, true>(a, bn, splits, st);
}


// ---- the bf16 mode ----------------------------------------------------------

namespace g16 = pvcnn::gemm16;

struct Args16 {
  const g16::u16* a;     // A(m, k): a[m * lda + k] (kAK) or a[k * lda + m]
  const g16::u16* b;     // B(k, n): b[n * ldb + k] (kBKM) or b[k * ldb + n]
  int lda, ldb;
  const float* bias;     // [N] or null
  const float* pscale;   // [Ci] (with the prologue)
  const float* pshift;
  float slope;
  void* out;             // bf16 [M][ldo] (K9), f32 [splits][M][N] (K10)
  int ldo;
  float* stats;          // [row tiles][2][N] or null
  float* dbias;          // [splits][N] or null (K10)
  int M, N, K, chunk;
};

// C = A B (+ bias) over k in one chunk, on the bf16 core; grid (row tiles
// x column tiles, chunks), the column tile fastest. kAK / kBKM: A / B
// K-major. K9 (!kWgrad) stores bf16 and its statistics; K10 stores f32 and
// sums d(bias) from the staged B (= g, MN-major).
template <int BN, int kPro, bool kAK, bool kBKM, bool kWgrad>
__device__ __forceinline__ void gemm16(const Args16& p, g16::u16* smem) {
  using T = g16::Tile<BN>;
  constexpr int kNT = T::kNT;
  constexpr int kThreads = g16::kThreads;
  constexpr int kBK = g16::kBK;
  constexpr int kStages = g16::kStages;
  constexpr int kSlotA = g16::Slot<g16::kBM>::kElems;
  constexpr int kBM = g16::kBM;
  constexpr int kPad = g16::kPad;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int col_tiles = (p.N + BN - 1) / BN;
  const int tile_m = blockIdx.x / col_tiles;
  const int m0 = tile_m * kBM;
  const int n0 = (blockIdx.x % col_tiles) * BN;
  const int kbeg = blockIdx.y * p.chunk;
  const int kend = min(p.K, kbeg + p.chunk);
  const int slices = (kend - kbeg + kBK - 1) / kBK;
  const bool with_db = kWgrad && tile_m == 0;

  auto load = [&](int slice) {
    g16::u16* As = smem + (slice % kStages) * T::kStageElems;
    const int k0 = kbeg + slice * kBK;
    g16::stage<kAK, kBM>(As, p.a, p.lda, m0, p.M, k0, kend, tid);
    g16::stage<kBKM, BN>(As + kSlotA, p.b, p.ldb, n0, p.N, k0, kend, tid);
  };

  float acc[4][kNT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    }
  }
  // K10's d(bias): column tid % BN over its part of each slice's rows
  constexpr int kParts = kThreads / BN;
  const int db_col = tid % BN, db_part = tid / BN;
  float db = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slices) load(s);
    pvcnn::gemm::copy_commit();
  }
  for (int sl = 0; sl < slices; ++sl) {
    pvcnn::gemm::copy_wait<kStages - 2>();
    __syncthreads();
    g16::u16* As = smem + (sl % kStages) * T::kStageElems;
    const g16::u16* Bs = As + kSlotA;
    if (kPro != kNone) {
      // a(x) of the in-range entries, rounded to bf16 (past the rows or
      // the channels the slot keeps its zeros: a(0) may not be 0)
      const int k0 = kbeg + sl * kBK;
      for (int e = tid; e < kBK * kBM; e += kThreads) {
        const int k = kAK ? e % kBK : e / kBM;
        const int m = kAK ? e / kBK : e % kBM;
        if (m0 + m < p.M && k0 + k < kend) {
          const int ch = kPro == kByK ? k0 + k : m0 + m;
          g16::u16* v = As + (kAK ? m * (kBK + kPad) + k
                                  : k * (kBM + kPad) + m);
          *v = g16::to_bf16(activate(g16::to_float(*v), __ldg(p.pscale + ch),
                                     __ldg(p.pshift + ch), p.slope));
        }
      }
      __syncthreads();
    }
    if (with_db) {
#pragma unroll
      for (int k = 0; k < kBK / kParts; ++k) {
        db += g16::to_float(Bs[(db_part * (kBK / kParts) + k) * (BN + kPad) +
                               db_col]);
      }
    }
    if (sl + kStages - 1 < slices) load(sl + kStages - 1);
    pvcnn::gemm::copy_commit();
    g16::multiply<BN, kAK, kBKM>(As, Bs, wm, wn, lane, acc);
  }

  // the tile (+ bias) from registers: lane (g, t) holds rows g and g + 8
  // of each m16 tile, columns 2t, 2t + 1 of each n8 tile
  const int g = lane >> 2, t = lane & 3;
  float bj[kNT][2];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n = n0 + wn * T::kWN + 8 * j + 2 * t + q;
      bj[j][q] = (!kWgrad && p.bias != nullptr && n < p.N)
                     ? __ldg(p.bias + n) : 0.f;
    }
  }
  float s1[kNT][2], s2[kNT][2];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    s1[j][0] = s1[j][1] = s2[j][0] = s2[j][1] = 0.f;
  }
  const bool pairs = p.ldo % 2 == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + 16 * i + g + 8 * h;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = n0 + wn * T::kWN + 8 * j + 2 * t;
        const float v0 = acc[i][j][2 * h] + bj[j][0];
        const float v1 = acc[i][j][2 * h + 1] + bj[j][1];
        if constexpr (kWgrad) {
          float* row = static_cast<float*>(p.out) +
                       (static_cast<int64_t>(blockIdx.y) * p.M + m) * p.N;
          if (n < p.N) row[n] = v0;
          if (n + 1 < p.N) row[n + 1] = v1;
        } else {
          s1[j][0] += v0;
          s2[j][0] = fmaf(v0, v0, s2[j][0]);
          s1[j][1] += v1;
          s2[j][1] = fmaf(v1, v1, s2[j][1]);
          g16::u16* row = static_cast<g16::u16*>(p.out) +
                          static_cast<int64_t>(m) * p.ldo;
          if (pairs && n + 1 < p.N) {
            const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
            *reinterpret_cast<__nv_bfloat162*>(row + n) = v;
          } else {
            if (n < p.N) row[n] = g16::to_bf16(v0);
            if (n + 1 < p.N) row[n + 1] = g16::to_bf16(v1);
          }
        }
      }
    }
  }
  if (kWgrad ? !with_db : p.stats == nullptr) return;

  // the statistics (K9) or d(bias) (K10) of the tile's columns, in a fixed
  // order: a thread's rows, the lanes of a column (g = 0..7), the two warps
  // of a column, or the parts of K10's rows
  auto* red = reinterpret_cast<float*>(smem);   // [2][2][BN] or [kParts][BN]
  pvcnn::gemm::copy_wait<0>();
  __syncthreads();
  if (kWgrad) {
    red[db_part * BN + db_col] = db;
  } else {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s1[j][q] += __shfl_xor_sync(0xffffffffu, s1[j][q], off);
          s2[j][q] += __shfl_xor_sync(0xffffffffu, s2[j][q], off);
        }
      }
    }
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int c = wn * T::kWN + 8 * j + 2 * t + q;
          red[(wm * 2) * BN + c] = s1[j][q];
          red[(wm * 2 + 1) * BN + c] = s2[j][q];
        }
      }
    }
  }
  __syncthreads();
  if (tid < BN && n0 + tid < p.N) {
    if (kWgrad) {
      float sum = red[tid];
      for (int q = 1; q < kParts; ++q) sum += red[q * BN + tid];
      p.dbias[static_cast<int64_t>(blockIdx.y) * p.N + n0 + tid] = sum;
    } else {
      float* o = p.stats + static_cast<int64_t>(tile_m) * 2 * p.N + n0 + tid;
#pragma unroll
      for (int q = 0; q < 2; ++q) o[q * p.N] = red[q * BN + tid] +
                                               red[(2 + q) * BN + tid];
    }
  }
}

template <int BN, int kPro, bool kAK, bool kBKM, bool kWgrad>
__global__ void __launch_bounds__(g16::kThreads, BN == 128 ? 2 : 3)
dense_rows_bf16_kernel(const Args16 p) {
  extern __shared__ __align__(16) g16::u16 smem16[];
  gemm16<BN, kPro, kAK, kBKM, kWgrad>(p, smem16);
}

template <int BN, int kPro, bool kAK, bool kBKM, bool kWgrad>
int launch_tile16(const Args16& a, int splits, cudaStream_t st) {
  auto kernel = dense_rows_bf16_kernel<BN, kPro, kAK, kBKM, kWgrad>;
  constexpr int smem = g16::Tile<BN>::kSmemBytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t tiles = static_cast<int64_t>((a.M + g16::kBM - 1) /
                                             g16::kBM) *
                        ((a.N + BN - 1) / BN);
  if (tiles > 0x7fffffff || splits > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  kernel<<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(splits)),
           g16::kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int kPro, bool kAK, bool kBKM, bool kWgrad>
int launch16(const Args16& a, int bn, int splits, cudaStream_t st) {
  switch (bn) {
    case 64: return launch_tile16<64, kPro, kAK, kBKM, kWgrad>(a, splits, st);
    case 128:
      return launch_tile16<128, kPro, kAK, kBKM, kWgrad>(a, splits, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// a bf16 operand the core reads: ld a multiple of 8 elements, 16-byte
// aligned
bool staged16(const void* p, int ld) {
  return ld > 0 && ld % 8 == 0 && pvcnn::gemm::aligned16(p);
}

}  // namespace

// K9: y [rows, N] = a(x) w (+ bias), x [rows, K] contiguous, w read as
// w[k, n] = w[n * ldw + k] (w_kmajor) or w[k * ldw + n]; bias may be null
// (the dgrad). partial [ceil(rows / 128)][2][N] or null. bn (64 or 128) is
// ops/dense_rows.py:_plan's column tile.
PVCNN_EXPORT int pvcnn_dense_rows_fwd(const void* x, const void* w, int ldw,
                                      int w_kmajor, const void* bias,
                                      const void* pscale,
                                      const void* pshift, float slope,
                                      void* y, void* partial, int rows,
                                      int K, int N, int has_prologue, int bn,
                                      void* stream) {
  if (rows == 0 || N == 0) return 0;
  const Args a{static_cast<const float*>(x),
               static_cast<const float*>(w),
               K, ldw,
               static_cast<const float*>(bias),
               static_cast<const float*>(pscale),
               static_cast<const float*>(pshift),
               slope,
               static_cast<float*>(y),
               static_cast<float*>(partial),
               nullptr,
               rows, N, K, K > 0 ? K : 1};
  const auto st = static_cast<cudaStream_t>(stream);
  const int b_mode = copy_mode(w, ldw, w_kmajor);
  return has_prologue ? launch_fwd<kByK>(a, b_mode, bn, st)
                      : launch_fwd<kNone>(a, b_mode, bn, st);
}

// K10: dw [Ci, Co] = a(x)^T g and db [Co] = sum_r g, x [rows, Ci] and
// g [rows, Co] contiguous, the rows in chunks of `chunk` (a multiple of the
// slice): with more than one chunk, partial holds [chunks][Ci][Co] and then
// [chunks][Co], which the fold adds in order.
PVCNN_EXPORT int pvcnn_dense_rows_wgrad(const void* x, const void* g,
                                        const void* pscale,
                                        const void* pshift, float slope,
                                        void* partial, void* dw, void* db,
                                        int rows, int Ci, int Co, int bn,
                                        int chunk, int has_prologue,
                                        void* stream) {
  if (Ci == 0 || Co == 0) return 0;
  if (rows < 1 || chunk < 1 || chunk % kBK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int splits = (rows + chunk - 1) / chunk;
  if (splits > 1 && partial == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = static_cast<int64_t>(Ci) * Co;
  auto* pf = static_cast<float*>(partial);
  float* out = splits > 1 ? pf : static_cast<float*>(dw);
  float* dbp = splits > 1 ? pf + splits * total : static_cast<float*>(db);
  const Args a{static_cast<const float*>(x),
               static_cast<const float*>(g),
               Ci, Co,
               nullptr,
               static_cast<const float*>(pscale),
               static_cast<const float*>(pshift),
               slope,
               out,
               nullptr,
               dbp,
               Ci, Co, rows, chunk};
  const auto st = static_cast<cudaStream_t>(stream);
  const int a_mode = copy_mode(x, Ci, 0), b_mode = copy_mode(g, Co, 0);
  const int err =
      has_prologue ? launch_wgrad<kByM>(a, a_mode, b_mode, bn, splits, st)
                   : launch_wgrad<kNone>(a, a_mode, b_mode, bn, splits, st);
  if (err != 0 || splits == 1) return err;
  dense_rows_fold_kernel<<<pvcnn::blocks_for(total + Co), pvcnn::kThreads, 0,
                           st>>>(pf, dbp, static_cast<float*>(dw),
                                 static_cast<float*>(db), total, Co, splits);
  return static_cast<int>(cudaGetLastError());
}

// K9 in bf16: y [rows, N] bf16 (row stride ldy) = a(x) w (+ bias), x bf16
// [rows, K] (row stride ldx >= K, zeros past K), w bf16 read as w[k, n] =
// w[n * ldw + k] (w_kmajor: the forward, w the [Co, Ci] weight) or w[k *
// ldw + n] (the dgrad: the same weight as W^T, no bias); bias f32 [N] or
// null; pscale / pshift f32 [K]; partial f32 [ceil(rows / 128)][2][N] or
// null, the statistics of the f32 y + bias. ldx and ldw multiples of 8,
// x and w 16-byte aligned; bn (64 or 128) is ops/dense_rows.py:_plan's
// column tile.
PVCNN_EXPORT int pvcnn_dense_rows_fwd_bf16(
    const void* x, int ldx, const void* w, int ldw, int w_kmajor,
    const void* bias, const void* pscale, const void* pshift, float slope,
    void* y, int ldy, void* partial, int rows, int K, int N,
    int has_prologue, int bn, void* stream) {
  if (rows == 0 || N == 0) return 0;
  if (!staged16(x, ldx) || !staged16(w, ldw) || ldx < K || ldy < N ||
      (w_kmajor && ldw < K) || (!w_kmajor && ldw < N)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args16 a{static_cast<const g16::u16*>(x),
                 static_cast<const g16::u16*>(w),
                 ldx, ldw,
                 static_cast<const float*>(bias),
                 static_cast<const float*>(pscale),
                 static_cast<const float*>(pshift),
                 slope, y, ldy,
                 static_cast<float*>(partial), nullptr,
                 rows, N, K, K > 0 ? K : 1};
  const auto st = static_cast<cudaStream_t>(stream);
  if (!w_kmajor) {
    if (has_prologue) return static_cast<int>(cudaErrorInvalidValue);
    return launch16<kNone, true, false, false>(a, bn, 1, st);
  }
  return has_prologue ? launch16<kByK, true, true, false>(a, bn, 1, st)
                      : launch16<kNone, true, true, false>(a, bn, 1, st);
}

// K10 in bf16: dw f32 [Ci, Co] = a(x)^T g and db f32 [Co] = sum_r g, x
// bf16 [rows, Ci] (row stride ldx) and g bf16 [rows, Co] (row stride ldg),
// both multiples of 8 and 16-byte aligned; the rows in chunks of `chunk`
// (a multiple of 32): with more than one chunk, partial holds
// [chunks][Ci][Co] and then [chunks][Co], which the fold adds in order.
PVCNN_EXPORT int pvcnn_dense_rows_wgrad_bf16(
    const void* x, int ldx, const void* g, int ldg, const void* pscale,
    const void* pshift, float slope, void* partial, void* dw, void* db,
    int rows, int Ci, int Co, int bn, int chunk, int has_prologue,
    void* stream) {
  if (Ci == 0 || Co == 0) return 0;
  if (rows < 1 || chunk < 1 || chunk % g16::kBK != 0 ||
      !staged16(x, ldx) || !staged16(g, ldg) || ldx < Ci || ldg < Co) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int splits = (rows + chunk - 1) / chunk;
  if (splits > 1 && partial == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = static_cast<int64_t>(Ci) * Co;
  auto* pf = static_cast<float*>(partial);
  float* out = splits > 1 ? pf : static_cast<float*>(dw);
  float* dbp = splits > 1 ? pf + splits * total : static_cast<float*>(db);
  const Args16 a{static_cast<const g16::u16*>(x),
                 static_cast<const g16::u16*>(g),
                 ldx, ldg,
                 nullptr,
                 static_cast<const float*>(pscale),
                 static_cast<const float*>(pshift),
                 slope, out, Co,
                 nullptr, dbp,
                 Ci, Co, rows, chunk};
  const auto st = static_cast<cudaStream_t>(stream);
  const int err =
      has_prologue ? launch16<kByM, false, false, true>(a, bn, splits, st)
                   : launch16<kNone, false, false, true>(a, bn, splits, st);
  if (err != 0 || splits == 1) return err;
  dense_rows_fold_kernel<<<pvcnn::blocks_for(total + Co), pvcnn::kThreads, 0,
                           st>>>(pf, dbp, static_cast<float*>(dw),
                                 static_cast<float*>(db), total, Co, splits);
  return static_cast<int>(cudaGetLastError());
}
