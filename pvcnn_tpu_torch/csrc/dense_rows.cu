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
// bf16 mode (counted as dense_rows_fwd_bf16, dense_rows_dgrad_bf16 and
// dense_rows_wgrad_bf16): the same three calls on bf16 x and g, as the TPU
// kernels run them on bf16 rows (jax.lax.dot with an f32 accumulator).
// Rounding points, as in the JAX package (pvcnn_tpu/ops/pallas/
// dense_rows.py): the weight rounded to bf16 (w.astype(x.dtype)); the
// prologue a(x) in f32 from the bf16 x, rounded to bf16 before the product
// (_fwd_kernel's .astype(x.dtype)), only on in-range entries (a(0) may not
// be 0); f32 products and sums; the forward adds the f32 bias to the f32
// accumulator, takes the statistics from it (before any rounding) and
// rounds y to bf16 once; the dgrad (W^T, no bias, no statistics) rounds its
// output to bf16; K10 keeps dW and d(bias) in f32 (d(bias) the f32 sum of
// the bf16 cotangent) and adds its partial sums in a fixed order.
//
// K9 in bf16 (pvcnn_dense_rows_fwd_wgmma, pvcnn_dense_rows_dgrad_wgmma;
// namespace w9): wgmma fed by TMA. The forward first rounds the f32 weight
// into a bf16 copy [ceil(Ci / 8)][Co][8] (dense_rows_bf16_weights_kernel):
// 16-byte rows of 8 input channels of one output channel, so that 8 of
// them are one core matrix of wgmma's unswizzled layout, K-major for the
// forward's B and MN-major for the dgrad's (W^T); the wrapper keeps the
// copy for the dgrad (JAX casts the same weight both times). A persistent
// block (dense_rows_wgmma_kernel<BN, kA, TB>: 2 consumer warpgroups of 64
// rows and a producer warp) walks its column tile's row tiles of 128 rows
// in a fixed order (blockIdx.x, + gridDim.x, ...), reducing over k in
// slices of 64 (4 k16 steps, wgmma m64nNk16, N = BN = 64 or 128) through
// a ring of slots on mbarriers. The
// producer's TMA loads fill each slot with A's slice (8 boxes of 8
// channels x 128 rows: core matrices stacked along the rows; rows and
// channels past the end zero-filled) and, unless the block's whole column
// slice of the weight fits shared memory and was loaded once at its start
// (`resident`), the weight's slice; the ring runs on across tiles, so a
// tile's epilogue overlaps the next tile's loads. Without the prologue
// wgmma reads A from shared memory; with it each warp takes its 16 rows of
// a k16 step by ldmatrix, activates the in-range entries in f32, rounds
// them and multiplies from registers. Rows whose stride is not a multiple
// of 16 bytes or that start off a 16-byte boundary (x at Ci = 9, g at Co =
// 196), which TMA cannot describe, are read by the consumers themselves
// into the fragment, zeros past the rows and channels: no padded copy.
// Epilogue: y + bias in f32 into a per-warp shared tile; the statistics of
// the in-range rows from those f32 values (a lane two columns over the
// warp's 16 rows: rows r and r + 8, then a pairwise tree over r, the
// order shuffles over a column's 8 lanes would give, which cost a forward
// 17-42% over none; then the warp's tiles and the 8 warps in order); y
// rounded once and stored as whole 16-byte pieces, a row's 128 bytes by 8
// lanes. Each block writes one statistics slot; the last block
// of a column tile (an integer ticket) adds the slots in block order: no
// float atomics, bitwise reproducible, no second launch. Bound: the bytes
// of x, y (or g, dx) and the copy at Ci or Co of 128 or less (2 an element
// against 3.35 TB/s), else 2 * rows * Ci * Co FLOPs against 989 TFLOP/s.
//
// K10 in bf16 (pvcnn_dense_rows_wgrad_bf16; namespace w10): wgmma with the
// reduction over the rows, dW [Ci, Co] as M = Ci (A = a(x)^T) by N = Co (B
// = g). Bound by bytes (x and g once against 3.35 TB/s; the products take
// a third of that at (128, 1024)), so the design reads each operand once
// and keeps bytes in flight. A block holds 128 x BN f32 of dW (two consumer
// warpgroups of 64 x BN, BN = 64, 128 or 256 columns; where Ci <= 64 one
// 64-channel tile whose rows the warpgroups split), so at (128, 1024) g,
// 2,048 bytes a row, is read once and x, 256 bytes, once per column tile
// (the column tiles of a row range run side by side and share it in L2).
// A producer warpgroup keeps a ring of slices in flight: 64-channel x
// sr-row boxes of x and g in the 128-byte swizzle (rows and channels past
// the end zero-filled) by TMA. g is wgmma's B, MN-major from shared
// memory; without the prologue x is its A from shared memory too,
// transposed, and with it x is loaded by ldmatrix.trans into registers,
// activated in f32 and rounded to bf16 there (the gradient-in-registers
// form of K4 in bf16, csrc/conv3d_bf16.cu). Rows TMA cannot describe (a
// stride or base off 16 bytes: x at Ci = 9, MSG's Ci of 6, 150, 196, 323
// and 515, g at Co = 196, views) take another route: x's slice, where its
// rows are contiguous and fit, as one bulk copy of their bytes, from which
// the consumers gather A's fragments; else the producer's threads copy by
// cp.async of 8 or 4 bytes straight into the swizzled slice where the
// rows allow, the slice's barrier completing when the copies land; else
// (odd channel counts) as raw 16-byte pieces that the consumers gather
// (x) or that the producer lays out a few slices behind (g). No padded
// copy. d(bias) is the f32 sum of the staged g
// columns, taken by the consumers while the products run. The producer
// hands registers to the consumers (setmaxnreg). Blocks are persistent,
// one wave: each walks a fixed run of slices of its tile and each
// warpgroup writes one f32 partial slot (no atomics); then every block
// takes a ticket and waits for all (launched cooperatively, so all are
// resident) and adds its share of the slots, each entry's in slot order:
// bitwise reproducible, no fold launch. (The last block of a tile alone
// would read up to 17 MB of slots at (128, 1024).)
#include "dense_gemm.cuh"
#include "wgmma.cuh"

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


// ---- K9 in bf16: wgmma fed by TMA --------------------------------------------

namespace w9 {

using namespace pvcnn::wg;
using u16 = unsigned short;

constexpr int kBM = 128;                 // rows a tile: 2 warpgroups x 64
constexpr int kBK = 64;                  // k a slice: 4 k16 steps
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 32;   // + a producer warp
constexpr int kEpiCols = 64;             // columns a warp stages at a time
constexpr int kEpiStride = kEpiCols + 8;    // its rows, floats
constexpr int kABytes = kBM * kBK * 2;   // an A slice: 128 rows of 128 bytes
// the 16-byte pieces that hold a row's 64 k of a slice, wherever it starts
constexpr int kDirectPieces = kBK * 2 / 16 + 1;

// How a slice of A (x, or the dgrad's cotangent) reaches the products:
// kSS by TMA into the ring (128-byte rows in the 128-byte swizzle) and
// read by wgmma from shared memory; kPro by TMA, then ldmatrix, the
// prologue in f32 and wgmma from registers; kDirect (rows whose stride TMA
// cannot describe) copied slice by slice by the consumers' cp.async, as
// the 9 16-byte pieces that hold each row's 64 k, into one of two
// shared-memory buffers (the next slice's in flight while this one is
// multiplied), from which each warp gathers its fragments (the prologue
// applied where pscale is given).
enum AMode { kSS = 0, kPro = 1, kDirect = 2 };

struct Params {
  const u16* x;            // A [M][ldx] (kDirect)
  int ldx;
  const u16* w16;          // the weight's copy [Kp / 8][Cop][8]
  int cop;
  const float* bias;       // [N] or null
  const float* pscale;     // [K] or null
  const float* pshift;
  float slope;
  u16* y;                  // [M][N]
  float* stats;            // [2][N] or null
  float* slots;            // [col tiles][gridDim.x][2][BN]
  unsigned* ticket;        // [col tiles], zeroed by the weights kernel
  int M, N, K, ksteps, slices, stages, resident, direct_bytes;
};

// the byte offsets of a block's shared memory (after 1024-byte alignment:
// the swizzled A slices), shared by the kernel and its launcher
struct Layout {
  int stage, res, direct, epi, red, bars, total;   // the ring starts at 0
  __host__ __device__ Layout(int bn, bool a_tma, int stages, int slices,
                             bool resident, int direct_bytes) {
    const int b = kBK * bn * 2;
    stage = (a_tma ? kABytes : 0) + (resident ? 0 : b);
    res = stages * stage;
    direct = res + (resident ? slices * b : 0);
    epi = direct + direct_bytes;
    red = epi + 8 * 16 * kEpiStride * 4;
    bars = red + 8 * 2 * bn * 4;
    total = bars + 8 * (2 * stages + 1) + 16 + 1024;   // + a flag, alignment
  }
};

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return static_cast<uint32_t>(to_bf16(lo)) |
         static_cast<uint32_t>(to_bf16(hi)) << 16;
}

// a(v) of the pair of bf16 values in r at channels k, k + 1 (rounded to
// bf16 once), zero where the row or a channel is out of range
__device__ __forceinline__ uint32_t act_pair(uint32_t r, bool row_ok, int k,
                                             const Params& p) {
  float v[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float f = to_float(static_cast<u16>(r >> (16 * e)));
    v[e] = row_ok && k + e < p.K
               ? activate(f, __ldg(p.pscale + k + e), __ldg(p.pshift + k + e),
                          p.slope)
               : 0.f;
  }
  return pack(v[0], v[1]);
}

// K9 in bf16: a persistent block of 2 consumer warpgroups (64 rows each)
// and a producer warp walks the row tiles blockIdx.x, + gridDim.x, ... of
// column tile blockIdx.y (BN = 64 or 128 columns, one wgmma m64nBNk16 a k16
// step), k in slices of 64 (4 k16 steps) through a ring of p.stages slots
// on mbarriers; the weight's slices come once a block (p.resident) or with
// A's in each slot. TB: B K-major (0, the forward) or MN-major (1, the
// dgrad). ptxas counts the producer warp as a third warpgroup: 2 blocks an
// SM leave a thread 80-96 registers. With A in registers (16 more a
// thread) BN = 128 takes the SM alone (at 2 blocks it spilled 130-160
// bytes). Tiles of 256 columns (two products of 128, 1 block an SM) ran
// 1.3-1.4x slower than 128 at 2 blocks: the epilogue does not hide its
// latency in one block's 8 warps.
template <int BN, int kA, int TB>
__global__ void __launch_bounds__(kThreads, BN == 128 && kA != kSS ? 1 : 2)
dense_rows_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                        const Params p) {
  constexpr int kB = kBK * BN * 2;       // a B slice's bytes
  constexpr bool kTma = kA != kDirect;
  const Layout L(BN, kTma, p.stages, p.slices, p.resident, p.direct_bytes);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + p.stages;
  uint64_t* wbar = empty + p.stages;
  int* flag = reinterpret_cast<int*>(wbar + 1);
  const bool ring = kTma || !p.resident;
  const int tid = threadIdx.x;
  const int ct = blockIdx.y, n0 = ct * BN;
  const int row_tiles = (p.M + kBM - 1) / kBM;
  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], 2);
    }
    bar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {               // the producer warp: one thread
    if (tid == kConsumers) {
      // B's slice s into dst by bulk copies of the (padded) copy: [8 k
      // groups][BN][8] (forward) or [BN / 8 n groups][64 k][8] (dgrad)
      auto load_b = [&](unsigned char* dst, int s, uint64_t* bar) {
        if (TB == 0) {
          for (int j = 0; j < kBK / 8; ++j) {
            bulk_load(dst + j * BN * 16,
                      p.w16 + (static_cast<int64_t>(kBK / 8 * s + j) * p.cop +
                               n0) * 8,
                      BN * 16, bar);
          }
        } else {
          for (int i = 0; i < BN / 8; ++i) {
            bulk_load(dst + i * kBK * 16,
                      p.w16 + (static_cast<int64_t>(n0 / 8 + i) * p.cop +
                               kBK * s) * 8,
                      kBK * 16, bar);
          }
        }
      };
      if (p.resident) {
        bar_expect(wbar, p.slices * kB);
        for (int s = 0; s < p.slices; ++s) {
          load_b(smem + L.res + s * kB, s, wbar);
        }
      }
      if (ring) {
        int it = 0;
        for (int t = blockIdx.x; t < row_tiles; t += gridDim.x) {
          for (int s = 0; s < p.slices; ++s, ++it) {
            const int st = it % p.stages;
            if (it >= p.stages) {
              bar_wait(&empty[st], (it / p.stages - 1) & 1);
            }
            unsigned char* slot = smem + st * L.stage;
            bar_expect(&full[st],
                       (kTma ? kABytes : 0) + (p.resident ? 0 : kB));
            if (kTma) {
              tma_load_2d(slot, &amap, &full[st], s * kBK, t * kBM);
            }
            if (!p.resident) load_b(slot + (kTma ? kABytes : 0), s, &full[st]);
          }
        }
      }
    }
    return;
  }

  const int wg = tid >> 7, lt = tid & 127;
  const int w4 = lt >> 5, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const bool with_stats = p.stats != nullptr;
  // the warp's column sums over its tiles, [2][BN]
  float* red = reinterpret_cast<float*>(smem + L.red) + warp * 2 * BN;
  float* epi =
      reinterpret_cast<float*>(smem + L.epi) + warp * 16 * kEpiStride;
  // kDirect: the 16-byte pieces that hold a slice's 128 rows x 64 k (9 a
  // row: [128][9][16] bytes; only pieces with elements in range), copied
  // by cp.async into buffer it % 2 of two
  auto stage_direct = [&](int at_it, int t, int s) {
    u16* buf = reinterpret_cast<u16*>(smem + L.direct) +
               (at_it & 1) * kBM * kDirectPieces * 8;
    const int kend = min(p.K, kBK * (s + 1));
#pragma unroll 4
    for (int i = tid; i < kBM * kDirectPieces; i += kConsumers) {
      const int r = i / kDirectPieces, j = i % kDirectPieces;
      if (t * kBM + r >= p.M) continue;
      const u16* row = p.x + static_cast<int64_t>(t * kBM + r) * p.ldx;
      const uintptr_t at =
          (reinterpret_cast<uintptr_t>(row + kBK * s) & ~uintptr_t{15}) +
          16 * j;
      if (at < reinterpret_cast<uintptr_t>(row + kend)) {
        copy16(buf + 8 * i, reinterpret_cast<const u16*>(at), 16);
      }
    }
  };
  if (kA == kDirect && static_cast<int>(blockIdx.x) < row_tiles) {
    stage_direct(0, blockIdx.x, 0);
    pvcnn::gemm::copy_commit();
  }
  for (int i = lane; i < 2 * BN; i += 32) red[i] = 0.f;
  __syncwarp();
  if (p.resident) bar_wait(wbar, 0);
  float acc[BN / 2];
  int it = 0;
  for (int t = blockIdx.x; t < row_tiles; t += gridDim.x) {
    const int m0 = t * kBM;
    const int mw = m0 + wg * 64 + w4 * 16;    // the warp's first row
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int s = 0; s < p.slices; ++s, ++it) {
      const int nst = min(4, p.ksteps - 4 * s);
      if constexpr (kA == kDirect) {
        // the next slice's pieces in flight while this one is multiplied
        named_sync(2, kConsumers);     // the buffer they go to is read
        if (s + 1 < p.slices) {
          stage_direct(it + 1, t, s + 1);
        } else if (t + static_cast<int>(gridDim.x) < row_tiles) {
          stage_direct(it + 1, t + gridDim.x, 0);
        }
        pvcnn::gemm::copy_commit();
        pvcnn::gemm::copy_wait<1>();   // this thread's pieces of slice s
        named_sync(2, kConsumers);     // everyone's
      }
      const int st = ring ? it % p.stages : 0;
      if (ring) bar_wait(&full[st], (it / p.stages) & 1);
      unsigned char* slot = smem + st * L.stage;
      const uint32_t b_at =
          smem_addr(p.resident ? smem + L.res + s * kB
                               : slot + (kTma ? kABytes : 0));
      // B of k16 step kk
      auto b_desc = [&](int kk) {
        return TB == 0 ? mat_desc(b_at + 2 * kk * BN * 16, BN * 16, 128)
                       : mat_desc(b_at + 16 * kk * 16, 128, kBK * 16);
      };
      if constexpr (kA == kSS) {
        const uint32_t a_at = smem_addr(slot) + wg * 64 * 128;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk < nst) {
            const uint64_t a = mat_desc_sw128(a_at + 32 * kk);
            wgmma_ss<BN, TB>(acc, a, b_desc(kk));
          }
        }
        wgmma_commit();
      } else {
        // the warp's 16 rows x 16 k of each step in mma.sync's A fragment:
        // lane (g, t4) holds rows g, g + 8 and k 2 t4 (+1), + 8 (+1)
        uint32_t afr[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk < nst) {
            const int k0 = 16 * (4 * s + kk) + 2 * t4;
            if constexpr (kA == kPro) {
              // matrix j = lane / 8: rows + 8 (j & 1), k + 8 (j >> 1); the
              // 16-byte piece c of row r sits at piece c ^ (r % 8)
              const int j = lane >> 3;
              const int r = wg * 64 + w4 * 16 + (j & 1) * 8 + (lane & 7);
              const int c = 2 * kk + (j >> 1);
              ldmatrix_x4(afr[kk], smem_addr(slot) + r * 128 +
                                       ((c ^ (r & 7)) << 4));
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                afr[kk][e] = act_pair(afr[kk][e], mw + g + 8 * (e & 1) < p.M,
                                      k0 + 8 * (e >> 1), p);
              }
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int row = mw + g + 8 * (e & 1), k = k0 + 8 * (e >> 1);
                const u16* at = reinterpret_cast<const u16*>(
                    smem + L.direct +
                    ((it & 1) * kBM + row - m0) * kDirectPieces * 16 +
                    (reinterpret_cast<uintptr_t>(
                         p.x + static_cast<int64_t>(row) * p.ldx + kBK * s) &
                     15) +
                    2 * (k - kBK * s));
                float v[2];
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const bool in = row < p.M && k + h < p.K;
                  v[h] = in ? to_float(at[h]) : 0.f;
                  if (in && p.pscale != nullptr) {   // rounded by pack
                    v[h] = activate(v[h], __ldg(p.pscale + k + h),
                                    __ldg(p.pshift + k + h), p.slope);
                  }
                }
                afr[kk][e] = pack(v[0], v[1]);
              }
            }
          }
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk < nst) {
            wgmma_rs<BN, TB>(acc, afr[kk], b_desc(kk));
          }
        }
        wgmma_commit();
      }
      wgmma_wait<0>();
      if (ring && lt == 0) bar_arrive(&empty[st]);
    }

    // epilogue, 64 columns at a time. Fragment: rows mw + g + 8 i, columns
    // n0 + 8 j + 2 t4 + e in acc[4 j + 2 i + e]. y + bias in f32 into the
    // warp's [16][72] tile; then lane l sums columns 2 l and 2 l + 1 over
    // the in-range rows (the statistics, from the f32 values), and the
    // lanes round and store the rows as 16-byte pieces, a row's 128 bytes
    // by 8 lanes (whole sectors)
    fence_acc(acc);
    const int rows_in = min(16, p.M - mw);
#pragma unroll
    for (int c = 0; c < BN / kEpiCols; ++c) {
#pragma unroll
      for (int jj = 0; jj < kEpiCols / 8; ++jj) {
        const int j = c * (kEpiCols / 8) + jj;
        const int col = n0 + 8 * j + 2 * t4;
        float bc[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          bc[e] = p.bias != nullptr && col + e < p.N ? __ldg(p.bias + col + e)
                                                     : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          *reinterpret_cast<float2*>(epi + (g + 8 * i) * kEpiStride + 8 * jj +
                                     2 * t4) =
              make_float2(acc[4 * j + 2 * i] + bc[0],
                          acc[4 * j + 2 * i + 1] + bc[1]);
        }
      }
      __syncwarp();
      if (with_stats) {
        // column 2 lane + e: rows r and r + 8 summed from 0, then a
        // pairwise tree over r = 0..7 (the order of a shuffle tree over a
        // column's 8 lanes), then the warp's tiles in order
        float s1[4][2], s2[4][2];   // the pairs' partial trees
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          float a[2] = {0.f, 0.f}, q[2] = {0.f, 0.f};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (r + 8 * i < rows_in) {
              const float2 v = *reinterpret_cast<const float2*>(
                  epi + (r + 8 * i) * kEpiStride + 2 * lane);
              a[0] += v.x;
              q[0] = fmaf(v.x, v.x, q[0]);
              a[1] += v.y;
              q[1] = fmaf(v.y, v.y, q[1]);
            }
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (r % 2 == 0) {
              s1[r / 2][e] = a[e];
              s2[r / 2][e] = q[e];
            } else {
              s1[r / 2][e] += a[e];
              s2[r / 2][e] += q[e];
            }
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float t1 = (s1[0][e] + s1[1][e]) + (s1[2][e] + s1[3][e]);
          const float t2 = (s2[0][e] + s2[1][e]) + (s2[2][e] + s2[3][e]);
          red[c * kEpiCols + 2 * lane + e] += t1;
          red[BN + c * kEpiCols + 2 * lane + e] += t2;
        }
      }
      const int cbase = n0 + c * kEpiCols;
      if (p.N % 8 == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int piece = lane + 32 * i;
          const int row = piece >> 3, c8 = (piece & 7) * 8;
          const int m = mw + row, n = cbase + c8;
          if (m < p.M && n < p.N) {
            const float4* src =
                reinterpret_cast<const float4*>(epi + row * kEpiStride + c8);
            const float4 lo = src[0], hi = src[1];
            *reinterpret_cast<uint4*>(p.y + static_cast<int64_t>(m) * p.N +
                                      n) =
                make_uint4(pack(lo.x, lo.y), pack(lo.z, lo.w),
                           pack(hi.x, hi.y), pack(hi.z, hi.w));
          }
        }
      } else {   // rows not in whole 16-byte pieces: a lane an element
#pragma unroll 4
        for (int i = lane; i < 16 * kEpiCols; i += 32) {
          const int row = i / kEpiCols, cc = i % kEpiCols;
          const int m = mw + row, n = cbase + cc;
          if (m < p.M && n < p.N) {
            p.y[static_cast<int64_t>(m) * p.N + n] =
                to_bf16(epi[row * kEpiStride + cc]);
          }
        }
      }
      __syncwarp();
    }
  }
  if (!with_stats) return;

  // the block's sums (its 8 warps in order) into its slot; the last block
  // of the column tile (an integer ticket) adds the slots in block order,
  // in kConsumers / BN runs of blocks whose sums it adds in run order (no
  // float atomics)
  named_sync(1, kConsumers);
  const float* sums = reinterpret_cast<const float*>(smem + L.red);
  float* first = p.slots + static_cast<int64_t>(ct) * gridDim.x * 2 * BN;
  if (tid < BN) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      a += sums[w * 2 * BN + tid];
      b += sums[w * 2 * BN + BN + tid];
    }
    first[blockIdx.x * 2 * BN + tid] = a;
    first[blockIdx.x * 2 * BN + BN + tid] = b;
  }
  __threadfence();
  named_sync(1, kConsumers);
  if (tid == 0) {
    *flag = atomicAdd(p.ticket + ct, 1u) == gridDim.x - 1;
  }
  named_sync(1, kConsumers);
  if (!*flag) return;
  __threadfence();
  constexpr int kRuns = kConsumers / BN;
  const int col = tid % BN, run = tid / BN;
  const int per = (static_cast<int>(gridDim.x) + kRuns - 1) / kRuns;
  const int b0 = run * per, b1 = min(static_cast<int>(gridDim.x), b0 + per);
  float a = 0.f, b = 0.f;
#pragma unroll 16
  for (int k = b0; k < b1; ++k) {
    a += __ldcg(first + k * 2 * BN + col);
    b += __ldcg(first + k * 2 * BN + BN + col);
  }
  float* part = reinterpret_cast<float*>(smem + L.red);
  part[run * 2 * BN + col] = a;
  part[run * 2 * BN + BN + col] = b;
  named_sync(1, kConsumers);
  if (tid < BN && n0 + tid < p.N) {
    a = part[tid];
    b = part[BN + tid];
#pragma unroll
    for (int r = 1; r < kRuns; ++r) {
      a += part[r * 2 * BN + tid];
      b += part[r * 2 * BN + BN + tid];
    }
    p.stats[n0 + tid] = a;
    p.stats[p.N + n0 + tid] = b;
  }
}

// the forward's weight w [Ci, Co] f32 (element (ci, co) at ci * sk + co *
// sn) -> its bf16 copy w16 [Kp / 8][Cop][8] (8 input channels of one
// output channel in 16 bytes, zeros past Ci and Co; Kp and Cop padded to
// whole column tiles and slices): the forward's B K-major and the dgrad's
// (W^T) MN-major, both in wgmma's core matrices; and the forward's
// statistics tickets zeroed
__global__ void __launch_bounds__(pvcnn::kThreads)
dense_rows_bf16_weights_kernel(const float* __restrict__ w, int64_t sk,
                               int64_t sn, u16* __restrict__ w16, int Ci,
                               int Co, int cop, int64_t total,
                               unsigned* __restrict__ ticket, int tickets) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i < tickets) ticket[i] = 0u;     // the forward's, before it runs
  if (i >= total) return;              // total = Kp / 8 * Cop
  const int n = static_cast<int>(i % cop);
  const int k0 = static_cast<int>(i / cop) * 8;
  union {
    uint4 v;
    u16 e[8];
  } out;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    out.e[j] = k0 + j < Ci && n < Co
                   ? to_bf16(__ldg(w + (k0 + j) * sk + n * sn))
                   : u16{0};
  }
  reinterpret_cast<uint4*>(w16)[i] = out.v;
}

template <int BN, int kA, int TB>
int launch_bn(const CUtensorMap& amap, const Params& p, int smem, int grid,
              cudaStream_t st) {
  auto kernel = dense_rows_wgmma_kernel<BN, kA, TB>;
  static int allowed = 0;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  const dim3 blocks(static_cast<unsigned>(grid),
                    static_cast<unsigned>((p.N + BN - 1) / BN));
  kernel<<<blocks, kThreads, smem, st>>>(amap, p);
  return static_cast<int>(cudaGetLastError());
}

template <int kA, int TB>
int launch_mode(const CUtensorMap& amap, const Params& p, int bn, int smem,
                int grid, cudaStream_t st) {
  switch (bn) {
    case 64: return launch_bn<64, kA, TB>(amap, p, smem, grid, st);
    case 128: return launch_bn<128, kA, TB>(amap, p, smem, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the padding of the weight copy's axes: whole column tiles (64, or a
// multiple of 128) and whole slices of 64
inline int padded(int c) { return c <= 64 ? 64 : (c + 127) / 128 * 128; }

// one K9 bf16 launch: y [M, N] bf16 = a(A) B (+ bias), A [M, K] bf16 (row
// stride lda, by TMA where a_tma), B the weight's bf16 copy [padded(Ci) /
// 8][padded(Co)][8] (dgrad: K = Co, N = Ci, read MN-major); with stats
// (f32 [2][N]) and work (f32 [N tiles][grid][2][bn], then N tiles
// tickets) the statistics of the f32 y + bias, summed in a fixed order
int run(const void* a, int lda, int a_tma, const void* w16, int Ci, int Co,
        int dgrad, const float* bias, const float* pscale,
        const float* pshift, float slope, void* y, float* stats,
        float* work, int M, int N, int K, int bn, int grid, int stages,
        int resident, int direct_bytes, int smem, cudaStream_t st) {
  if (M == 0 || N == 0) return 0;
  const int col_tiles = (N + bn - 1) / bn;
  const int slices = (K + kBK - 1) / kBK;
  const Layout L(bn, a_tma != 0, stages, slices, resident != 0,
                 a_tma ? 0 : direct_bytes);
  if (K < 1 || grid < 1 || stages < 1 || L.total > smem ||
      (dgrad && pscale != nullptr) || (stats != nullptr && work == nullptr) ||
      (a_tma && (lda % 8 != 0 || !pvcnn::gemm::aligned16(a))) ||
      (!a_tma && direct_bytes < 2 * kBM * kDirectPieces * 16) ||
      !pvcnn::gemm::aligned16(w16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap amap = {};
  if (a_tma) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                                static_cast<cuuint64_t>(M)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(lda) * 2};
    const cuuint32_t box[2] = {kBK, kBM};
    const int err = bf16_map(&amap, a, 2, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != 0) return err;
  }
  const Params p{static_cast<const u16*>(a), lda,
                 static_cast<const u16*>(w16), padded(Co), bias, pscale,
                 pshift, slope, static_cast<u16*>(y), stats, work,
                 work == nullptr
                     ? nullptr
                     : reinterpret_cast<unsigned*>(
                           work + static_cast<int64_t>(col_tiles) * grid *
                                      2 * bn),
                 M, N, K, (K + 15) / 16, slices, stages, resident,
                 a_tma ? 0 : direct_bytes};
  const int mode = !a_tma ? kDirect : pscale != nullptr ? kPro : kSS;
  if (dgrad) {
    return mode == kSS ? launch_mode<kSS, 1>(amap, p, bn, smem, grid, st)
                       : launch_mode<kDirect, 1>(amap, p, bn, smem, grid, st);
  }
  switch (mode) {
    case kSS: return launch_mode<kSS, 0>(amap, p, bn, smem, grid, st);
    case kPro: return launch_mode<kPro, 0>(amap, p, bn, smem, grid, st);
    default: return launch_mode<kDirect, 0>(amap, p, bn, smem, grid, st);
  }
}

}  // namespace w9

// ---- K10 in bf16: wgmma, x and g read once --------------------------------

namespace w10 {

using namespace pvcnn::wg;
using u16 = unsigned short;

constexpr int kConsumers = 256;             // 2 warpgroups
constexpr int kProducers = 128;             // a warpgroup
constexpr int kThreads = kConsumers + kProducers;
// registers a thread (setmaxnreg): 128 x 56 + 256 x 224 <= 65,536
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
constexpr int kChunk = 64;                  // channels in a 128-byte row

struct Params {
  const u16* x;            // [rows][ldx]
  const u16* g;            // [rows][ldg]
  int ldx, ldg;
  const float* pscale;     // [Ci] or null
  const float* pshift;
  float slope;
  float* dw;               // [Ci][Co]
  float* db;               // [Co]
  float* slots;            // [m64 tiles][ntiles][kps][64][BN], then
  float* db_slots;         //   [ntiles][parts][BN]
  unsigned* counter;       // zeroed before the launch
  int rows, ci, co;
  // each operand's copy route: 16 by TMA; 8 or 4 by cp.async of that
  // many bytes into its tile; 2 raw (x: rows gathered by the consumers;
  // g: laid out by the producer); 1 (x alone, its rows contiguous: ldx ==
  // Ci) a slice's rows as one bulk copy, gathered by the consumers
  int pair, sr, stages, a_mode, b_mode, dslots;
  int mtiles, ntiles, parts, slices;
};

// the 16-byte pieces a raw row of w channels takes, wherever it starts
__host__ __device__ inline int raw_pieces(int w) { return w / 8 + 1; }

// the byte offsets of a block's shared memory (after 1024-byte alignment),
// shared by the kernel and its launcher: the ring of slices (A's part:
// its 64-channel chunks, each sr rows of 128 bytes in the 128-byte
// swizzle, or its raw rows; then B's chunks), for g read raw a ring of
// `dslots` raw buffers, the d(bias) partials ([groups][BN] f32), the
// mbarriers
struct Layout {
  int na, nb, a_part, b_tile, stage, b_raw, db, bars, total;
  __host__ __device__ Layout(int bn, int pair, int sr, int stages,
                             int dslots, int a_mode, int b_mode, int ci) {
    na = pair ? 2 : 1;
    nb = bn / kChunk;
    a_part = a_mode == 2   ? (sr * raw_pieces(na * kChunk) * 16 + 1023) /
                                 1024 * 1024
             : a_mode == 1 ? (sr * ci * 2 + 1023) / 1024 * 1024
                           : na * sr * 128;
    b_tile = nb * sr * 128;
    stage = a_part + b_tile;
    b_raw = stages * stage;
    db = b_raw + (b_mode == 2 ? dslots * sr * raw_pieces(bn) * 16 : 0);
    bars = db + 8 * kConsumers * 4;
    total = bars + 8 * 2 * stages + 16 + 1024;   // + alignment
  }
};

// a(v) of the bf16 pair in r, rows row and row + 1 of channel c (rounded
// to bf16 once), zero where a row or the channel is out of range
__device__ __forceinline__ uint32_t act_rows(uint32_t r, int row, int rows,
                                             bool c_ok, float s, float h,
                                             float slope) {
  float v[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    v[e] = c_ok && row + e < rows
               ? activate(to_float(static_cast<u16>(r >> (16 * e))), s, h,
                          slope)
               : 0.f;
  }
  return w9::pack(v[0], v[1]);
}

// K10 in bf16: dW = a(x)^T g over the rows, a product of M = Ci (A =
// a(x)^T, in registers) by N = Co (B = g, MN-major in shared memory) with
// the rows as its reduction. A block of 2 consumer warpgroups and a
// producer warpgroup walks its units (blockIdx.x, + gridDim.x, ...); unit
// u is tile u % tiles (column tile fastest, then the Ci tile) over the
// slices of its part u / tiles, each slice sr rows. With `pair` (Ci > 64)
// the two consumer warpgroups own two 64-channel tiles of Ci over all of a
// slice's rows, else one tile over half a slice's rows each. The producer
// fills a ring of slices: its first thread by TMA, and all of it, for rows
// TMA cannot read, by cp.async into a ring of raw buffers dslots - 1
// slices ahead, then laid out as TMA would (its registers handed to the
// consumers by setmaxnreg). Each consumer warpgroup writes its f32 partial
// of a unit into its own slot, and the blocks of a Ci tile's first row sum
// d(bias) from the staged g; then every block waits for the others (one
// wave, launched cooperatively) and adds a share of the slots in slot
// order. kRegsA: A through registers (the prologue, or x's raw rows);
// else wgmma reads A from shared memory too, transposed (MN-major).
template <int BN, bool kRegsA>
__global__ void __launch_bounds__(kThreads, 1)
dense_rows_wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                              const __grid_constant__ CUtensorMap gmap,
                              const Params p) {
  // k16 steps a warpgroup takes of a slice at most (8: 128 rows; BN =
  // 256 runs slices of 64 rows)
  constexpr int kSteps = BN == 256 ? 4 : 8;
  const Layout L(BN, p.pair, p.sr, p.stages, p.dslots, p.a_mode, p.b_mode,
                 p.ci);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + p.stages;
  // the producer's threads copy rows (TMA cannot read) and arrive
  const bool copies = (p.a_mode != 16 && p.a_mode != 1) || p.b_mode != 16;
  const int tid = threadIdx.x;
  const int tiles = p.mtiles * p.ntiles;
  const int units = tiles * p.parts;
  const int tile_rows = p.sr * 128;         // bytes of a 64-channel chunk
  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      // the first producer thread's arrival (with the TMA bytes), and,
      // where they copy rows, every producer thread's once its copies of
      // the slice landed (or g's raw rows are laid out)
      bar_init(&full[i], 1 + (copies ? kProducers : 0));
      bar_init(&empty[i], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // unit u's slices [first(part), first(part + 1))
  auto first = [&](int part) {
    return static_cast<int>(static_cast<int64_t>(part) * p.slices / p.parts);
  };

  if (tid >= kConsumers) {                  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pt = tid - kConsumers;
    // the 64-channel chunks of x and g in range at a unit's tile
    auto chunks = [&](int c0, int c, int most) {
      return max(0, min(most, (c - c0 + kChunk - 1) / kChunk));
    };
    // slice s's rows [s * sr, + sr) of channels [c0, c0 + w) as the 16-byte
    // pieces that hold them, by cp.async into `raw` (a row's rp pieces)
    auto raw_fill = [&](unsigned char* raw, const u16* ptr, int ld, int c,
                        int c0, int w, int s) {
      const int rp = raw_pieces(w), cend = min(c, c0 + w);
      if (cend <= c0) return;
      const int dr = kProducers / rp, dj = kProducers % rp;
      for (int r = pt / rp, j = pt % rp; r < p.sr;) {
        const int row_at = s * p.sr + r;
        if (row_at < p.rows) {
          const u16* row = ptr + static_cast<int64_t>(row_at) * ld;
          const uintptr_t at =
              (reinterpret_cast<uintptr_t>(row + c0) & ~uintptr_t{15}) +
              16 * j;
          if (at < reinterpret_cast<uintptr_t>(row + cend)) {
            copy16(raw + 16 * (r * rp + j), reinterpret_cast<const void*>(at),
                   16);
          }
        }
        r += dr;                            // the next piece of this thread
        j += dj;
        if (j >= rp) {
          j -= rp;
          ++r;
        }
      }
    };
    // the same rows laid out as a TMA box would at `tile` (zeros past the
    // rows and channels), by cp.async of `bytes` (8 or 4) a copy: rows of
    // whole 8- or 4-byte pieces, channel groups that never straddle c
    auto pieces = [&](unsigned char* tile, const u16* ptr, int ld, int c,
                      int c0, int w, int s, int bytes) {
      const int per = w / 8, n = 16 / bytes, e = bytes / 2;
      for (int i = pt; i < p.sr * per; i += kProducers) {
        const int r = i / per, pc = i % per;
        const int row_at = s * p.sr + r, ch = c0 + 8 * pc;
        unsigned char* dst = tile + (pc >> 3) * tile_rows + r * 128 +
                             (((pc & 7) ^ (r & 7)) << 4);
        if (row_at >= p.rows || ch >= c) {
          copy16(dst, ptr, 0);              // zeros
          continue;
        }
        const u16* src = ptr + static_cast<int64_t>(row_at) * ld + ch;
        for (int q = 0; q < n; ++q) {
          const bool in = ch + q * e < c;
          copy_small(dst + q * bytes, in ? src + q * e : ptr, bytes,
                     in ? bytes : 0);
        }
      }
    };
    // raw buffer `raw` of slice s laid out at `tile` (zeros past the rows
    // and channels)
    auto repack = [&](const unsigned char* raw, const u16* ptr, int ld,
                      int c, int c0, int w, int s, unsigned char* tile) {
      const int rp = raw_pieces(w), per = w / 8;
      for (int i = pt; i < p.sr * per; i += kProducers) {
        const int r = i / per, pc = i % per;
        const int row_at = s * p.sr + r, ch = c0 + 8 * pc;
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (row_at < p.rows && ch < c) {
          const u16* row = ptr + static_cast<int64_t>(row_at) * ld;
          const uintptr_t lo =
              reinterpret_cast<uintptr_t>(row + c0) & ~uintptr_t{15};
          const u16* src = reinterpret_cast<const u16*>(
              raw + r * rp * 16 + (reinterpret_cast<uintptr_t>(row + ch) - lo));
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            if (ch + q < c) v[q >> 1] |= static_cast<uint32_t>(src[q])
                                         << (16 * (q & 1));
          }
        }
        *reinterpret_cast<uint4*>(tile + (pc >> 3) * tile_rows + r * 128 +
                                  (((pc & 7) ^ (r & 7)) << 4)) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    };
    // g's raw rows are laid out dslots - 1 slices behind their copies:
    // (unit, slice) of the walk's slice k, its raw buffer k % dslots
    int ru = blockIdx.x, rs = ru < units ? first(ru / tiles) : 0;
    auto finish = [&](int k) {              // lay out slice k, then arrive
      const int st = k % p.stages;
      named_sync(3, kProducers);            // every thread's pieces landed
      repack(smem + L.b_raw + (k % p.dslots) * p.sr * raw_pieces(BN) * 16,
             p.g, p.ldg, p.co, ru % tiles % p.ntiles * BN, BN, rs,
             smem + st * L.stage + L.a_part);
      // the products read the tile through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(3, kProducers);            // the raw buffer is free again
      bar_arrive(&full[st]);
      if (++rs == first(ru / tiles + 1)) {
        ru += gridDim.x;
        rs = ru < units ? first(ru / tiles) : 0;
      }
    };
    int it = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int tile = u % tiles, part = u / tiles;
      const int a_c0 = tile / p.ntiles * L.na * kChunk;
      const int b_c0 = tile % p.ntiles * BN;
      const int na = p.a_mode == 16 ? chunks(a_c0, p.ci, L.na) : 0;
      const int nb = p.b_mode == 16 ? chunks(b_c0, p.co, L.nb) : 0;
      for (int s = first(part); s < first(part + 1); ++s, ++it) {
        const int st = it % p.stages;
        if (it >= p.stages) bar_wait(&empty[st], (it / p.stages - 1) & 1);
        unsigned char* slot = smem + st * L.stage;
        if (pt == 0) {
          // x's slice as one bulk copy: its rows' bytes, in whole 16-byte
          // pieces (past the last row: rows no product reads)
          const int bulk =
              p.a_mode == 1
                  ? (min(p.sr, p.rows - s * p.sr) * p.ci * 2 + 15) / 16 * 16
                  : 0;
          bar_expect(&full[st], (na + nb) * tile_rows + bulk);
          if (bulk > 0) {
            bulk_load(slot, p.x + static_cast<int64_t>(s) * p.sr * p.ci,
                      bulk, &full[st]);
          }
          for (int q = 0; q < na; ++q) {
            tma_load_2d(slot + q * tile_rows, &xmap, &full[st],
                        a_c0 + q * kChunk, s * p.sr);
          }
          for (int q = 0; q < nb; ++q) {
            tma_load_2d(slot + L.a_part + q * tile_rows, &gmap, &full[st],
                        b_c0 + q * kChunk, s * p.sr);
          }
        }
        if (!copies) continue;
        if (p.a_mode == 2) {
          raw_fill(slot, p.x, p.ldx, p.ci, a_c0, L.na * kChunk, s);
        } else if (p.a_mode != 16 && p.a_mode != 1) {
          pieces(slot, p.x, p.ldx, p.ci, a_c0, L.na * kChunk, s, p.a_mode);
        }
        if (p.b_mode == 2) {
          raw_fill(smem + L.b_raw +
                       (it % p.dslots) * p.sr * raw_pieces(BN) * 16,
                   p.g, p.ldg, p.co, b_c0, BN, s);
        } else if (p.b_mode != 16) {
          pieces(slot + L.a_part, p.g, p.ldg, p.co, b_c0, BN, s, p.b_mode);
        }
        if (p.b_mode == 2) {
          pvcnn::gemm::copy_commit();
          if (it >= p.dslots - 1) {         // slice it - dslots + 1's landed
            if (p.dslots == 4) {
              pvcnn::gemm::copy_wait<3>();
            } else if (p.dslots == 3) {
              pvcnn::gemm::copy_wait<2>();
            } else {
              pvcnn::gemm::copy_wait<1>();
            }
            finish(it - p.dslots + 1);
          }
        } else {
          // this thread's arrival, once its copies of the slice landed
          copies_arrive(&full[st]);
        }
      }
    }
    if (p.b_mode == 2) {                    // the last slices' layouts
      pvcnn::gemm::copy_wait<0>();
      for (int k = max(0, it - p.dslots + 1); k < it; ++k) finish(k);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  const int wg = tid >> 7, lt = tid & 127;
  const int w4 = lt >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  // the warpgroup's rows of a slice and its k16 steps
  const int wrow = p.pair ? 0 : wg * (p.sr / 2);
  const int nst = (p.pair ? p.sr : p.sr / 2) / 16;
  // d(bias): a thread sums the 8 columns of one 16-byte piece of a g row
  // (piece tid % (BN / 8)) over its group's rows of each slice (group
  // tid / (BN / 8) of kDbGroups, sr / kDbGroups rows each)
  constexpr int kPieces = BN / 8, kDbGroups = kConsumers / kPieces;
  const int db_piece = tid % kPieces, db_group = tid / kPieces;
  const int db_rows = p.sr / kDbGroups;
  float* db_red = reinterpret_cast<float*>(smem + L.db);
  const int kps = p.pair ? p.parts : 2 * p.parts;
  float acc[BN / 2];
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int tile = u % tiles, part = u / tiles;
    const int mt = tile / p.ntiles, nt = tile % p.ntiles;
    const int wc0 = mt * L.na * kChunk + (p.pair ? wg * kChunk : 0);
    const bool active = wc0 < p.ci;
    const bool with_db = mt == 0;
    // the prologue's scale and shift of the lane's channels g8, g8 + 8
    bool c_ok[2];
    float sc[2], sh[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = wc0 + 16 * w4 + g8 + 8 * e;
      c_ok[e] = c < p.ci;
      sc[e] = c_ok[e] && p.pscale != nullptr ? __ldg(p.pscale + c) : 0.f;
      sh[e] = c_ok[e] && p.pscale != nullptr ? __ldg(p.pshift + c) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    float db[8] = {};
    const int s1 = first(part + 1);
    for (int s = first(part); s < s1; ++s, ++it) {
      const int st = it % p.stages;
      bar_wait(&full[st], (it / p.stages) & 1);
      if (p.b_mode != 16) {
        // g's tile, written by the producer's copies, read by wgmma
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
      unsigned char* slot = smem + st * L.stage;
      const unsigned char* bt = slot + L.a_part;
      // both warpgroups multiply whether or not their channels are in range
      // (a warpgroup past Ci stores nothing): wgmma on a divergent path is
      // serialized
      if constexpr (!kRegsA) {
        wgmma_fence();
        const uint32_t a_at = smem_addr(slot) +
                              (p.pair ? wg : 0) * tile_rows + wrow * 128;
        const uint32_t b_at = smem_addr(bt) + wrow * 128;
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          if (kk < nst) {
            wgmma_ss_tt<BN>(acc, mat_desc_sw128_mn(a_at + kk * 2048, tile_rows),
                            mat_desc_sw128_mn(b_at + kk * 2048, tile_rows));
          }
        }
        wgmma_commit();
      } else {
        // the warp's 16 channels x 16 rows of each k16 step by
        // ldmatrix.trans: matrix j = lane / 8 holds channels + 8 (j & 1),
        // rows + 8 (j >> 1); the 16-byte piece c of row r sits at piece
        // c ^ (r % 8). Lane (g8, t4) gets channels g8 (+ 8), rows 2 t4
        // (+ 1), + 8: mma.sync's A fragment, as wgmma takes A from
        // registers
        uint32_t afr[kSteps][4];
        const uint32_t a_at = smem_addr(slot) + (p.pair ? wg : 0) * tile_rows;
        const int j = lane >> 3;
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          if (kk < nst) {
            const int r = wrow + 16 * kk + (j >> 1) * 8 + (lane & 7);
            const int pc = 2 * w4 + (j & 1);
            if (p.a_mode == 1) {
              // x's rows as they lie (ldx == Ci): element (row, channel)
              // at 2 (row Ci + channel) bytes of the slice
              const int row = wrow + 16 * kk + 2 * t4;
              const int ch = mt * L.na * kChunk +
                             (p.pair ? wg * kChunk : 0) + 16 * w4 + g8;
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                uint32_t v = 0;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int rl = row + 8 * (e >> 1) + h;
                  if (s * p.sr + rl < p.rows && c_ok[e & 1]) {
                    v |= static_cast<uint32_t>(*reinterpret_cast<const u16*>(
                             slot + 2 * (rl * p.ci + ch + 8 * (e & 1))))
                         << (16 * h);
                  }
                }
                afr[kk][e] = v;
              }
            } else if (p.a_mode != 2) {
              ldmatrix_x4_trans(afr[kk],
                                a_at + r * 128 + ((pc ^ (r & 7)) << 4));
            } else {
              // x's raw rows (a stride TMA and 4-byte copies cannot take):
              // row r's pieces from the 16-byte boundary at or before its
              // first channel, each element where its row's offset puts it
              const int rp = raw_pieces(L.na * kChunk);
              const int row = wrow + 16 * kk + 2 * t4;
              const int ch = (p.pair ? wg * kChunk : 0) + 16 * w4 + g8;
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                uint32_t v = 0;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const int rl = row + 8 * (e >> 1) + h;
                  const int at = s * p.sr + rl;
                  if (at < p.rows && c_ok[e & 1]) {
                    const uint32_t off =
                        (static_cast<uint32_t>(reinterpret_cast<uintptr_t>(
                             p.x)) +
                         2u * (static_cast<uint32_t>(at) *
                                   static_cast<uint32_t>(p.ldx) +
                               static_cast<uint32_t>(mt * L.na * kChunk))) &
                        15u;
                    v |= static_cast<uint32_t>(*reinterpret_cast<const u16*>(
                             slot + rl * rp * 16 + off +
                             2 * (ch + 8 * (e & 1))))
                         << (16 * h);
                  }
                }
                afr[kk][e] = v;
              }
            }
            if (p.pscale != nullptr) {
              const int row = s * p.sr + wrow + 16 * kk + 2 * t4;
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                afr[kk][e] = act_rows(afr[kk][e], row + 8 * (e >> 1), p.rows,
                                      c_ok[e & 1], sc[e & 1], sh[e & 1],
                                      p.slope);
              }
            }
          }
        }
        wgmma_fence();
        const uint32_t b_at = smem_addr(bt) + wrow * 128;
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          if (kk < nst) {
            wgmma_rs<BN, 1>(acc, afr[kk],
                            mat_desc_sw128_mn(b_at + kk * 2048, tile_rows));
          }
        }
        wgmma_commit();
      }
      if (with_db) {
        // the f32 sum of the bf16 g in a fixed order (a group's rows in
        // order, the slices, then the groups and the parts), while the
        // products run
        const int pc = db_piece & 7;
        const unsigned char* chunk = bt + (db_piece >> 3) * tile_rows;
#pragma unroll 4
        for (int r = db_group * db_rows; r < (db_group + 1) * db_rows; ++r) {
          const uint4 v = *reinterpret_cast<const uint4*>(
              chunk + r * 128 + ((pc ^ (r & 7)) << 4));
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            db[e] += to_float(static_cast<u16>(w[e >> 1] >> (16 * (e & 1))));
          }
        }
      }
      wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[st]);
    }

    // the warpgroup's partial into its slot. Fragment: rows (channels)
    // 16 w4 + g8 + 8 i, columns 8 j + 2 t4 + e in acc[4 j + 2 i + e]
    if (active) {
      fence_acc(acc);
      const int m64 = p.pair ? 2 * mt + wg : 0;
      const int kp = p.pair ? part : 2 * part + wg;
      float* out = p.slots + (static_cast<int64_t>(m64 * p.ntiles + nt) *
                                  kps + kp) * 64 * BN;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float* row = out + (16 * w4 + g8 + 8 * i) * BN + 2 * t4;
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj) {
          *reinterpret_cast<float2*>(row + 8 * jj) =
              make_float2(acc[4 * jj + 2 * i], acc[4 * jj + 2 * i + 1]);
        }
      }
    }
    if (with_db) {
      // [group][BN]: the groups added in order
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        db_red[db_group * BN + 8 * db_piece + e] = db[e];
      }
      named_sync(1, kConsumers);
      if (tid < BN) {
        float sum = db_red[tid];
        for (int q = 1; q < kDbGroups; ++q) sum += db_red[q * BN + tid];
        p.db_slots[(static_cast<int64_t>(nt) * p.parts + part) * BN + tid] =
            sum;
      }
      named_sync(1, kConsumers);
    }
  }

  // every block's slots written: wait for all (a ticket each), then add
  // this block's share of dW and d(bias), each entry's slots in order
  __threadfence();
  named_sync(1, kConsumers);
  if (tid == 0) {
    atomicAdd(p.counter, 1u);
    const long long start = clock64();
    while (*reinterpret_cast<volatile unsigned*>(p.counter) < gridDim.x) {
      __nanosleep(256);
      if (clock64() - start > (1ll << 34)) __trap();
    }
    __threadfence();
  }
  named_sync(1, kConsumers);
  // items: 4 columns of a row of dW (row Ci: of d(bias)), each the sum of
  // its kps slots (parts for d(bias)) in slot order; kg threads take an
  // item, each a fixed run of its slots in order, and the runs are added
  // in order (kg a power of two, runs of at least 8 slots where there are
  // enough), ep items at a time
  const int nq = (p.co + 3) / 4;
  const int64_t items = static_cast<int64_t>(p.ci + 1) * nq;
  int kg = 1;
  while (kg < 32 && kg * 16 <= kps) kg *= 2;
  const int ep = kConsumers / kg, at = tid % ep, grp = tid / ep;
  float4* red = reinterpret_cast<float4*>(smem);   // the ring, done with
  const int64_t i1 = (blockIdx.x + 1) * items / gridDim.x;
  for (int64_t i0 = blockIdx.x * items / gridDim.x; i0 < i1; i0 += ep) {
    const int64_t item = i0 + at;
    const int row = static_cast<int>(item / nq), o = 4 * (item % nq);
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    if (item < i1) {
      const bool bias = row == p.ci;
      const int n = bias ? p.parts : kps;
      const int64_t stride = bias ? BN : 64 * BN;
      const float* src =
          bias ? p.db_slots + static_cast<int64_t>(o / BN) * p.parts * BN +
                     o % BN
               : p.slots + (static_cast<int64_t>((row >> 6) * p.ntiles +
                                                 o / BN) * kps * 64 +
                            (row & 63)) * BN + o % BN;
#pragma unroll 8
      for (int k = grp * n / kg; k < (grp + 1) * n / kg; ++k) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(
            src + k * stride));
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
    }
    red[grp * ep + at] = sum;
    named_sync(1, kConsumers);
    if (grp == 0 && item < i1) {
      for (int q = 1; q < kg; ++q) {
        const float4 v = red[q * ep + at];
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      float* out = row == p.ci ? p.db : p.dw + static_cast<int64_t>(row) *
                                                   p.co;
      const float v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (o + j < p.co) out[o + j] = v[j];
      }
    }
    named_sync(1, kConsumers);
  }
}

template <int BN, bool kRegsA>
int launch(const CUtensorMap& xmap, const CUtensorMap& gmap, const Params& p,
           int smem, int grid, cudaStream_t st) {
  auto kernel = dense_rows_wgrad_wgmma_kernel<BN, kRegsA>;
  static int allowed = 0;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = smem;
  }
  void* args[] = {const_cast<CUtensorMap*>(&xmap),
                  const_cast<CUtensorMap*>(&gmap),
                  const_cast<Params*>(&p)};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kThreads), args,
      static_cast<size_t>(smem), st));
}

// a bf16 operand [rows][ld] as a 2-d tensor map with 64-channel x sr-row
// boxes in the 128-byte swizzle
int rows_map(CUtensorMap* map, const void* base, int ld, int c, int rows,
             int sr) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(c),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kChunk),
                             static_cast<cuuint32_t>(sr)};
  return bf16_map(map, base, 2, dims, strides, box,
                  CU_TENSOR_MAP_SWIZZLE_128B);
}

// whether rows of stride ld (elements) from base take copy route mode
bool route_ok(const void* base, int ld, int mode) {
  if (mode == 1) return pvcnn::gemm::aligned16(base);   // and ld == Ci
  return (mode == 16 || mode == 8 || mode == 4 || mode == 2) &&
         (2 * ld) % mode == 0 && reinterpret_cast<uintptr_t>(base) % mode == 0;
}

int run(const void* x, int ldx, int x_mode, const void* g, int ldg,
        int g_mode, const float* pscale, const float* pshift, float slope,
        float* dw, float* db, float* work, int rows, int Ci, int Co, int bn,
        int pair, int sr, int stages, int dslots, int parts, int grid,
        int smem, cudaStream_t st) {
  if (Ci == 0 || Co == 0) return 0;
  const Layout L(bn, pair, sr, stages, dslots, x_mode, g_mode, Ci);
  if (rows < 1 || parts < 1 || grid < 1 ||
      (sr != 32 && sr != 64 && sr != 128) || g_mode == 1 ||
      (x_mode == 1 && ldx != Ci) ||
      (bn == 256 && sr > 64) ||
      (bn != 64 && bn != 128 && bn != 256) || (pair != 0) != (Ci > kChunk) ||
      stages < 2 || L.total > smem ||
      (g_mode == 2 ? dslots < 2 || dslots > 4 : dslots != 0) ||
      dslots > stages || ldx < Ci || ldg < Co || !route_ok(x, ldx, x_mode) ||
      !route_ok(g, ldg, g_mode)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap xmap = {}, gmap = {};
  int err = x_mode == 16 ? rows_map(&xmap, x, ldx, Ci, rows, sr) : 0;
  if (err != 0) return err;
  err = g_mode == 16 ? rows_map(&gmap, g, ldg, Co, rows, sr) : 0;
  if (err != 0) return err;
  const int mtiles = (Ci + L.na * kChunk - 1) / (L.na * kChunk);
  const int ntiles = (Co + bn - 1) / bn;
  const int kps = pair ? parts : 2 * parts;
  const int64_t slot_floats =
      static_cast<int64_t>(pair ? 2 * mtiles : 1) * ntiles * kps * 64 * bn;
  const int64_t db_floats = static_cast<int64_t>(ntiles) * parts * bn;
  auto* counter = reinterpret_cast<unsigned*>(work + slot_floats + db_floats);
  const Params p{static_cast<const u16*>(x), static_cast<const u16*>(g),
                 ldx, ldg, pscale, pshift, slope, dw, db, work,
                 work + slot_floats, counter, rows, Ci, Co, pair, sr, stages,
                 x_mode, g_mode, dslots, mtiles, ntiles, parts,
                 (rows + sr - 1) / sr};
  err = static_cast<int>(cudaMemsetAsync(counter, 0, sizeof(unsigned), st));
  if (err != 0) return err;
  if (pscale != nullptr || x_mode == 2 || x_mode == 1) {
    switch (bn) {
      case 64: return launch<64, true>(xmap, gmap, p, smem, grid, st);
      case 128: return launch<128, true>(xmap, gmap, p, smem, grid, st);
      default: return launch<256, true>(xmap, gmap, p, smem, grid, st);
    }
  }
  switch (bn) {
    case 64: return launch<64, false>(xmap, gmap, p, smem, grid, st);
    case 128: return launch<128, false>(xmap, gmap, p, smem, grid, st);
    default: return launch<256, false>(xmap, gmap, p, smem, grid, st);
  }
}

}  // namespace w10

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

// K10 in bf16: dw f32 [Ci, Co] = a(x)^T g and db f32 [Co] = sum_r g, x
// bf16 [rows, Ci] (row stride ldx) and g bf16 [rows, Co] (ldg), each by
// the copy route x_mode / g_mode (16: TMA, rows and base on 16 bytes; 8
// or 4: cp.async of that many bytes, rows and base on them; 2: raw rows;
// 1, x alone: contiguous rows, a slice as one bulk copy);
// pscale / pshift f32 [Ci] or null; work f32:
// the warpgroups' slots, the d(bias) slots and a counter. bn, pair, sr,
// stages, dslots, parts, grid and smem are ops/dense_rows.py:_wgrad_plan's.
PVCNN_EXPORT int pvcnn_dense_rows_wgrad_bf16(
    const void* x, int ldx, int x_mode, const void* g, int ldg, int g_mode,
    const void* pscale, const void* pshift, float slope, void* dw, void* db,
    void* work, int rows, int Ci, int Co, int bn, int pair, int sr,
    int stages, int dslots, int parts, int grid, int smem, void* stream) {
  return w10::run(x, ldx, x_mode, g, ldg, g_mode,
                  static_cast<const float*>(pscale),
                  static_cast<const float*>(pshift), slope,
                  static_cast<float*>(dw), static_cast<float*>(db),
                  static_cast<float*>(work), rows, Ci, Co, bn, pair, sr,
                  stages, dslots, parts, grid, smem,
                  static_cast<cudaStream_t>(stream));
}
// K9 in bf16, the forward: w16 [padded(Ci) / 8][padded(Co)][8] bf16 (w9::
// padded; zeros in the padding) = the f32 weight w [Ci, Co] (element (ci,
// co) at ci * sk + co * sn) rounded to bf16 (the dgrad reads the same
// copy); then y [rows, Co] bf16 = a(x) w16 + bias, x bf16 [rows, Ci] with
// row stride ldx (by TMA where x_tma: ldx % 8 == 0, 16-byte aligned; else
// staged slice by slice in direct_bytes of shared memory), bias f32 [Co],
// pscale / pshift f32 [Ci] or null; with stats (f32 [2][Co], followed by
// the blocks' slots [ceil(Co / bn)][grid][2][bn] and a ticket a column
// tile) the BatchNorm sums of the f32 y. bn, grid, stages, resident,
// direct_bytes and smem are ops/dense_rows.py:_wgmma_plan's.
PVCNN_EXPORT int pvcnn_dense_rows_fwd_wgmma(
    const void* x, int ldx, int x_tma, const void* w, int64_t sk, int64_t sn,
    void* w16, const void* bias, const void* pscale, const void* pshift,
    float slope, void* y, void* stats, int rows, int Ci, int Co, int bn,
    int grid, int stages, int resident, int direct_bytes, int smem,
    void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int cop = w9::padded(Co);
  const int64_t total = static_cast<int64_t>(w9::padded(Ci) / 8) * cop;
  float* work = stats == nullptr ? nullptr : static_cast<float*>(stats) +
                                                 2 * Co;
  // the tickets follow the slots
  const int col_tiles = (Co + bn - 1) / bn;
  unsigned* ticket =
      work == nullptr || rows == 0
          ? nullptr
          : reinterpret_cast<unsigned*>(work + static_cast<int64_t>(
                                                   col_tiles) * grid * 2 * bn);
  w9::dense_rows_bf16_weights_kernel<<<pvcnn::blocks_for(total),
                                       pvcnn::kThreads, 0, st>>>(
      static_cast<const float*>(w), sk, sn, static_cast<w9::u16*>(w16), Ci,
      Co, cop, total, ticket, ticket == nullptr ? 0 : col_tiles);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return w9::run(x, ldx, x_tma, w16, Ci, Co, 0,
                 static_cast<const float*>(bias),
                 static_cast<const float*>(pscale),
                 static_cast<const float*>(pshift), slope, y,
                 static_cast<float*>(stats), work, rows, Co, Ci, bn, grid,
                 stages, resident, direct_bytes, smem, st);
}

// K9 in bf16, the dgrad: dx [rows, Ci] bf16 = g w16^T, g bf16 [rows, Co]
// with row stride ldg (by TMA where g_tma), w16 the forward's copy of the
// weight (pvcnn_dense_rows_fwd_wgmma); no bias, prologue or statistics
PVCNN_EXPORT int pvcnn_dense_rows_dgrad_wgmma(
    const void* g, int ldg, int g_tma, const void* w16, void* dx, int rows,
    int Ci, int Co, int bn, int grid, int stages, int resident,
    int direct_bytes, int smem, void* stream) {
  return w9::run(g, ldg, g_tma, w16, Ci, Co, 1, nullptr, nullptr, nullptr,
                 0.f, dx, nullptr, nullptr, rows, Ci, Co, bn, grid, stages,
                 resident, direct_bytes, smem,
                 static_cast<cudaStream_t>(stream));
}
