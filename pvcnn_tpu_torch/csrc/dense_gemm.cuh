// The fp32 GEMM core of K9 and K10 (csrc/dense_rows.cu): C = A B + bias on
// the CUDA cores (FFMA, no TF32), C [M, N], the reduction over k in
// [kbeg, kend).
//
// Operands are read in place in either layout:
//   A(m, k) = p[m * ld + k] (k-contiguous) or p[k * ld + m]
//   B(k, n) = p[n * ld + k] (k-contiguous) or p[k * ld + n]
// and staged by cp.async through a ring of kStages slices of kBK in dynamic
// shared memory as As[k][m] and Bs[k][n] (rows padded by 4 floats), so that
// one multiply serves every layout. A row along m or n is copied 16 bytes
// at a time where its operand is contiguous along it, ld % 4 == 0 and the
// base is 16-byte aligned (a ragged end copies fewer bytes and zero-fills
// the rest), else 4 bytes at a time. A k-contiguous operand is transposed by
// its 4-byte copies: a warp takes 8 k of 4 rows (32-byte sectors read
// whole) and writes 32 distinct banks (row stride 4 mod 32 banks). Keeping
// both tiles k-major holds the multiply at 2 + 2 float4 reads and 64 FFMA
// per k with 16 fragment registers: with a k-contiguous A read as float4
// along k, 32 more registers of fragments would not fit the 128 that two
// blocks of 256 threads leave.
//
// Tile: kBM = 128 rows by BN = 128 columns (64 where N <= 64), 2 * BN
// threads, each an 8 x 8 accumulator at rows tm * 8 .. +7 and columns
// tn * 4 .. +3 and BN / 2 + tn * 4 .. +3 (two float4 reads a lane, 8 lanes
// a quarter warp on 128 contiguous bytes of Bs; their A reads broadcast).
// The epilogue stores each thread's rows from registers (a quarter warp
// writes 128 contiguous bytes of a row, float4 where N % 4 == 0) and sums
// the columns' statistics by warp shuffles and then across warps in shared
// memory, in a fixed order.
//
// The bf16 core (namespace gemm16, below) is the same GEMM on bf16
// operands on the tensor cores: mma.sync m16n8k16 with f32 accumulators.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

#ifndef PVCNN_DENSE_BK
#define PVCNN_DENSE_BK 16
#endif
#ifndef PVCNN_DENSE_STAGES
#define PVCNN_DENSE_STAGES 4
#endif

namespace pvcnn {
namespace gemm {

constexpr int kBM = 128;                   // output rows per block
constexpr int kBK = PVCNN_DENSE_BK;        // reduction slice
constexpr int kStages = PVCNN_DENSE_STAGES;
constexpr int kPad = 4;                    // row padding (keeps float4 rows)
constexpr int kSA = kBM + kPad;            // As row stride, floats
static_assert(kBK % 8 == 0 && kStages >= 2, "kBK: a multiple of 8");

template <int BN>
struct Tile {
  static constexpr int kThreads = 2 * BN;  // (kBM / 8) x (BN / 8)
  static constexpr int kTN = BN / 8;       // threads along n
  static constexpr int kSB = BN + kPad;    // Bs and Cs row stride, floats
  static constexpr int kStageFloats = kBK * (kSA + kSB);
  // the ring; the epilogue's partial sums [warps][2][BN] reuse it
  static constexpr int kSmemBytes = 4 * kStages * kStageFloats;
  static_assert(kStageFloats >= kThreads / 16 * BN, "the epilogue's sums");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// `bytes` (0 or 4) from src to shared dst, zeros for the rest; src is a
// valid address even where nothing is read
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// `bytes` (0 to 16) from src to shared dst, zeros for the rest
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// How an operand's slice is copied (a template argument of the kernel, so
// that each instantiation holds the addresses of one copy pattern only):
// kKMajor transposes a k-contiguous operand by 4-byte copies; kRows16 and
// kRows4 copy an operand contiguous along the tile's rows 16 or 4 bytes at a
// time.
enum Copy { kKMajor = 0, kRows16 = 1, kRows4 = 2 };

// One operand's slice into dst [kBK][W + kPad]: dst[k][c] = op(c0 + c,
// k0 + k), zero where c0 + c >= C or k0 + k >= kend (kMasked). Each
// thread's copies are a base pointer plus offsets.
template <int kMode, int W, int kThreads, bool kMasked>
__device__ __forceinline__ void copy_slice(float* dst, const float* p,
                                           int ld, int c0, int C, int k0,
                                           int kend, int tid) {
  constexpr int kS = W + kPad;
  if (kMode == kKMajor) {
    // a warp: 8 k (lane % 8) of 4 consecutive c: k = 8 r + tid % 8,
    // c = tid / 8 + j * kThreads / 8
    constexpr int kCStep = kThreads / 8;
    const int kk = tid & 7, cc = tid >> 3;
    const float* base = p + static_cast<int64_t>(c0 + cc) * ld + k0 + kk;
#pragma unroll
    for (int j = 0; j < W / kCStep; ++j) {
      const float* src = base + static_cast<int64_t>(j * kCStep) * ld;
#pragma unroll
      for (int r = 0; r < kBK / 8; ++r) {
        const bool ok = !kMasked || (c0 + cc + j * kCStep < C &&
                                     k0 + 8 * r + kk < kend);
        copy4(dst + (8 * r + kk) * kS + cc + j * kCStep,
              ok ? src + 8 * r : p, ok ? 4 : 0);
      }
    }
  } else if (kMode == kRows16) {
    // k = tid / G + i * kThreads / G, c = (tid % G) * 4
    constexpr int kG = W / 4;
    constexpr int kKStep = kThreads / kG;
    const int kk = tid / kG, cc = (tid % kG) * 4;
    const int left = C - (c0 + cc);
    const int bytes = !kMasked ? 16 : left > 0 ? 4 * min(left, 4) : 0;
    const float* base = p + static_cast<int64_t>(k0 + kk) * ld + c0 + cc;
    const int64_t step = static_cast<int64_t>(kKStep) * ld;
#pragma unroll
    for (int i = 0; i < kBK / kKStep; ++i) {
      const bool ok =
          !kMasked || (bytes > 0 && k0 + kk + i * kKStep < kend);
      copy16(dst + (kk + i * kKStep) * kS + cc, ok ? base + i * step : p,
             ok ? bytes : 0);
    }
  } else {
    // k = tid / W + i * kThreads / W, c = tid % W
    constexpr int kKStep = kThreads / W;
    const int kk = tid / W, cc = tid % W;
    const float* base = p + static_cast<int64_t>(k0 + kk) * ld + c0 + cc;
    const int64_t step = static_cast<int64_t>(kKStep) * ld;
#pragma unroll
    for (int i = 0; i < kBK / kKStep; ++i) {
      const bool ok = !kMasked || (c0 + cc < C && k0 + kk + i * kKStep < kend);
      copy4(dst + (kk + i * kKStep) * kS + cc, ok ? base + i * step : p,
            ok ? 4 : 0);
    }
  }
}

// The slice as copy_slice, without bounds tests where it lies inside the
// operand on both axes (most slices do)
template <int kMode, int W, int kThreads>
__device__ __forceinline__ void stage(float* dst, const float* p, int ld,
                                      int c0, int C, int k0, int kend,
                                      int tid) {
  if (c0 + W <= C && k0 + kBK <= kend) {
    copy_slice<kMode, W, kThreads, false>(dst, p, ld, c0, C, k0, kend, tid);
  } else {
    copy_slice<kMode, W, kThreads, true>(dst, p, ld, c0, C, k0, kend, tid);
  }
}

// acc[i][j] += sum_k As[k][tm * 8 + i] * Bs[k][col(j)]
template <int BN>
__device__ __forceinline__ void multiply(const float* As, const float* Bs,
                                         int tm, int tn,
                                         float (&acc)[8][8]) {
  constexpr int kSB = Tile<BN>::kSB;
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + k * kSA + tm * 8);
    const float4 a1 =
        *reinterpret_cast<const float4*>(As + k * kSA + tm * 8 + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * kSB + tn * 4);
    const float4 b1 =
        *reinterpret_cast<const float4*>(Bs + k * kSB + BN / 2 + tn * 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

template <int BN>
__device__ __forceinline__ int col(int tn, int j) {
  return j < 4 ? tn * 4 + j : BN / 2 + tn * 4 + j - 4;
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace gemm
}  // namespace pvcnn

namespace pvcnn {
namespace gemm16 {

// The bf16 GEMM core of K9 and K10 (csrc/dense_rows.cu): C = A B on bf16
// operands, products on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulators), the reduction over k in [kbeg, kend).
//
// Operands are read in place in either layout, each with its contiguous
// axis padded to a multiple of 8 elements (ld % 8 == 0, a 16-byte aligned
// base; the wrapper pads a copy where it is not, zeros past the data):
//   A(m, k) = p[m * ld + k] (K-major) or p[k * ld + m] (MN-major)
//   B(k, n) = p[n * ld + k] (K-major) or p[k * ld + n] (MN-major)
// Each slice of kBK = 32 k is staged by 16-byte cp.async copies through a
// ring of kStages slots as it lies in memory: a K-major tile as [rows][kBK
// + 8], an MN-major one as [kBK][cols + 8] (the 8 elements of padding put
// the 8 rows of an ldmatrix on 8 distinct 16-byte bank groups). Copies past
// an operand's rows, or past the slice's k, zero-fill. Fragments come from
// shared memory by ldmatrix.x4, with .trans for an MN-major tile, so one
// multiply serves every layout.
//
// Tile: kBM = 128 rows by BN = 128 columns (64 where N <= 64), 8 warps of
// 2 (m) x 4 (n), a warp 64 rows x BN / 4 columns: 4 m16 tiles by BN / 32
// n8 tiles, BN / 2 f32 accumulators a thread. mma.sync's accumulator
// layout: lane (g = lane / 4, t = lane % 4) of a 16 x 8 tile holds rows g
// and g + 8, columns 2t and 2t + 1.

constexpr int kBM = 128;                   // output rows per block
constexpr int kBK = 32;                    // reduction slice
constexpr int kStages = 4;
constexpr int kPad = 8;                    // elements of row padding
constexpr int kThreads = 256;

using u16 = unsigned short;

// the slot elements of a tile W wide (rows of a K-major tile, columns of
// an MN-major one), room for either layout
template <int W>
struct Slot {
  static constexpr int kK = W * (kBK + kPad);      // K-major [W][kBK + 8]
  static constexpr int kMN = kBK * (W + kPad);     // MN-major [kBK][W + 8]
  static constexpr int kElems = kK > kMN ? kK : kMN;
};

template <int BN>
struct Tile {
  static constexpr int kWN = BN / 4;               // columns a warp
  static constexpr int kNT = kWN / 8;              // n8 tiles a warp
  static constexpr int kStageElems = Slot<kBM>::kElems + Slot<BN>::kElems;
  static constexpr int kSmemBytes = 2 * kStages * kStageElems;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// `bytes` (0 or 16) from src to shared dst, zeros for the rest
__device__ __forceinline__ void copy16(u16* dst, const u16* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// One operand's slice into its slot: element (c, k) of the operand, c in
// [c0, c0 + W) along the tile's rows or columns, k in [k0, k0 + kBK).
// kKMajor: p[c * ld + k] -> dst[c][k], copied where c < C and k < kend
// (ld, a multiple of 8, holds kend: the elements past it are zeros).
// MN-major: p[k * ld + c] -> dst[k][c], copied where k < kend and c < ld
// (past C: the padding's zeros or columns no store reads).
template <bool kKMajor, int W>
__device__ __forceinline__ void stage(u16* dst, const u16* p, int ld, int c0,
                                      int C, int k0, int kend, int tid) {
  if constexpr (kKMajor) {
    constexpr int kChunks = W * kBK / 8;
#pragma unroll
    for (int i = tid; i < kChunks; i += kThreads) {
      const int c = i / (kBK / 8), kc = (i % (kBK / 8)) * 8;
      const bool ok = c0 + c < C && k0 + kc < kend;
      copy16(dst + c * (kBK + kPad) + kc,
             ok ? p + static_cast<int64_t>(c0 + c) * ld + k0 + kc : p,
             ok ? 16 : 0);
    }
  } else {
    constexpr int kChunks = kBK * W / 8;
#pragma unroll
    for (int i = tid; i < kChunks; i += kThreads) {
      const int k = i / (W / 8), cc = (i % (W / 8)) * 8;
      const bool ok = k0 + k < kend && c0 + cc < ld;
      copy16(dst + k * (W + kPad) + cc,
             ok ? p + static_cast<int64_t>(k0 + k) * ld + c0 + cc : p,
             ok ? 16 : 0);
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const u16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const u16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b on one 16 x 8 x 16 tile
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[i][j] += the warp's 64 x kWN block of the slice: As (kAK: K-major
// [kBM][kBK + 8], else MN-major [kBK][kBM + 8]), Bs likewise ([BN][kBK +
// 8] or [kBK][BN + 8]); the warp's rows wm * 64 + 16 i, its columns wn *
// kWN + 8 j.
template <int BN, bool kAK, bool kBKM>
__device__ __forceinline__ void multiply(const u16* As, const u16* Bs, int wm,
                                         int wn, int lane,
                                         float (&acc)[4][Tile<BN>::kNT][4]) {
  constexpr int kNT = Tile<BN>::kNT;
  const int lr = lane & 7, lj = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = wm * 64 + 16 * i;
      if constexpr (kAK) {
        // matrices (rows 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
        ldmatrix_x4(a[i], As + (m + lr + (lj & 1) * 8) * (kBK + kPad) + kk +
                              (lj >> 1) * 8);
      } else {
        ldmatrix_x4_trans(a[i], As + (kk + (lj >> 1) * 8 + lr) *
                                         (kBM + kPad) + m + (lj & 1) * 8);
      }
    }
#pragma unroll
    for (int p = 0; p < kNT / 2; ++p) {
      const int n = wn * Tile<BN>::kWN + 16 * p;
      // matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7),
      // (n 8-15, k 8-15): b0, b1 of n8 tile 2p, then of 2p + 1
      uint32_t b[4];
      if constexpr (kBKM) {
        ldmatrix_x4(b, Bs + (n + (lj >> 1) * 8 + lr) * (kBK + kPad) + kk +
                           (lj & 1) * 8);
      } else {
        ldmatrix_x4_trans(b, Bs + (kk + (lj & 1) * 8 + lr) * (BN + kPad) +
                                 n + (lj >> 1) * 8);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        mma(acc[i][2 * p], a[i], b[0], b[1]);
        mma(acc[i][2 * p + 1], a[i], b[2], b[3]);
      }
    }
  }
}

__device__ __forceinline__ float to_float(u16 v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

__device__ __forceinline__ u16 to_bf16(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

}  // namespace gemm16
}  // namespace pvcnn
