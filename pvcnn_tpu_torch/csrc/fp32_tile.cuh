// The 128 x 64 fp32 output tile that K4 and K9-K11 multiply on the CUDA
// cores (no TF32): 128 threads, an 8 x 8 accumulator each, the reduction in
// slices of 16 staged in shared memory as A[k][m] and B[k][n]. Thread
// (tm, tn) = (tid / 8, tid % 8) owns rows tm*8 .. +7 and columns
// tile_col(tn, 0..7) = tn*4 .. +3 and 32 + tn*4 .. +3 (two float4 reads at
// different banks per lane). K4 (csrc/conv3d_wgrad.cu), K9/K10
// (csrc/dense_rows.cu) and K11 (csrc/conv3d_ndhwc_wgrad.cu) use it.
#pragma once

#include "common.cuh"

namespace pvcnn {

constexpr int kTileThreads = 128;
constexpr int kTileM = 128;   // output rows per block
constexpr int kTileN = 64;    // output columns per block
constexpr int kTileK = 16;    // reduction slice
constexpr int kTilePad = 4;   // shared-memory row padding (keeps float4 rows)

using TileA = float[kTileK][kTileM + kTilePad];
using TileB = float[kTileK][kTileN + kTilePad];

__device__ __forceinline__ int tile_col(int tn, int j) {
  return j < 4 ? tn * 4 + j : 32 + tn * 4 + j - 4;
}

// acc[i][j] += sum_k A[k][tm*8 + i] * B[k][tile_col(tn, j)]
__device__ __forceinline__ void multiply_slice(const TileA& A, const TileB& B,
                                               int tm, int tn,
                                               float (&acc)[8][8]) {
#pragma unroll
  for (int k = 0; k < kTileK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(&A[k][tm * 8]);
    const float4 a1 = *reinterpret_cast<const float4*>(&A[k][tm * 8 + 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&B[k][tn * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&B[k][32 + tn * 4]);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void zero_tile(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
}

inline dim3 tile_grid(int m, int n, int z) {
  return dim3(static_cast<unsigned>((m + kTileM - 1) / kTileM),
              static_cast<unsigned>((n + kTileN - 1) / kTileN),
              static_cast<unsigned>(z));
}

}  // namespace pvcnn
