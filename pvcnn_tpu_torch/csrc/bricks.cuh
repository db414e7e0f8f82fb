// The brick geometry and bf16 helpers that the bf16 modes of K2
// (devoxelize.cu) and K5 (devoxelize_bwd.cu) share.
//
// A cloud's R^3 grid is cut into bricks of 512 bins, numbered x-major as
// the bins are: 16 z x 8 y x 4 x where R % 16 == 0 (a brick's z-run of a
// channel is one 32-byte sector of a channel-major bf16 grid), else 8 x 8
// x 8 (the last brick of an axis is short where R is not a multiple of
// its extent). A block takes one (cloud, brick, chunk of channels) and
// stages the brick and one plane of halo a side into shared memory: K2
// the +1 halo (the hi corners of the points whose base bin lies in the
// brick), K5 the -1 halo (the base bins whose corners reach the brick).
// Halo bins are indexed (hx * kHY + hy) * kHZ + hz, its (x, y) rows
// hx * kHY + hy.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"

namespace bricks {

struct Origin {
  int x, y, z;
};

template <int BZ>
struct Brick {
  static constexpr int kZ = BZ, kY = 8, kX = 512 / (8 * BZ);
  static constexpr int kBins = kX * kY * kZ;               // 512
  static constexpr int kHX = kX + 1, kHY = kY + 1, kHZ = kZ + 1;
  static constexpr int kRows = kHX * kHY;                  // 45 or 81
  static constexpr int kHaloBins = kRows * kHZ;            // 765 or 729

  static __host__ __device__ int count(int R) {
    return ((R + kX - 1) / kX) * ((R + kY - 1) / kY) * ((R + kZ - 1) / kZ);
  }
  // brick `brick` of a grid of R^3 bins: its first bin on each axis
  static __device__ Origin origin(int brick, int R) {
    const int nz = (R + kZ - 1) / kZ, ny = (R + kY - 1) / kY;
    return {brick / (ny * nz) * kX, brick / nz % ny * kY, brick % nz * kZ};
  }
};

// the f32 values of the two bf16 in u (low half first: channel c, c + 1)
__device__ __forceinline__ float lo_bf16(unsigned u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float hi_bf16(unsigned u) {
  return __uint_as_float(u & 0xffff0000u);
}

// v rounded to bf16 (round to nearest even), as its 16 bits
__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// two values rounded to bf16, packed low first
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

// channels c .. c + 7 of a bf16 row of C, zeros past C: one 16-byte load
// where vec (C % 8 == 0 and the row 16-byte aligned), else 2-byte loads
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* row, int c, int C,
                                       bool vec) {
  if (vec) {
    return c < C ? __ldg(reinterpret_cast<const uint4*>(row + c))
                 : make_uint4(0, 0, 0, 0);
  }
  const unsigned short* r16 = reinterpret_cast<const unsigned short*>(row);
  unsigned v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = c + i < C ? __ldg(r16 + c + i) : 0u;
  return make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16, v[4] | v[5] << 16,
                    v[6] | v[7] << 16);
}

// the 8 bf16 of v (low half first) as channels c .. c + 7 of a row of C,
// none past C: one 16-byte store where vec (as load8), else 2-byte stores
__device__ __forceinline__ void store8(__nv_bfloat16* row, int c, int C,
                                       uint4 v, bool vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(row + c) = v;
    return;
  }
  unsigned short* r16 = reinterpret_cast<unsigned short*>(row);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (c + i < C) r16[c + i] = i % 2 ? w[i / 2] >> 16 : w[i / 2] & 0xffffu;
  }
}

constexpr int kDevices = 64;                    // devices the caches keep

// Lets Kernel take `bytes` of dynamic shared memory on the current device:
// cudaFuncSetAttribute once per device and size, since a call of it costs
// the launch tens of microseconds of host time
template <auto Kernel>
cudaError_t allow_shared(int bytes) {
  static int allowed[kDevices] = {};            // bytes allowed, per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kDevices && allowed[device] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && device < kDevices) allowed[device] = bytes;
  return err;
}

// the current device's SM count, queried once per device
inline int sm_count() {
  static int sms[kDevices] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 132;
  if (device < kDevices && sms[device] > 0) return sms[device];
  int n = 132;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
  if (device < kDevices) sms[device] = n;
  return n;
}

// How many blocks share a (cloud, brick)'s chunks of channels (each block
// takes every split-th chunk): one, unless the (cloud, brick) blocks fill
// fewer than two waves of `per_sm` resident blocks an SM
inline int chunk_split(int64_t blocks, int chunks, int per_sm) {
  const int64_t target = 2LL * per_sm * sm_count();
  const int64_t split = (target + blocks - 1) / blocks;
  return static_cast<int>(split < 1 ? 1 : split < chunks ? split : chunks);
}

}  // namespace bricks
