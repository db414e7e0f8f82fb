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
#pragma once

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
