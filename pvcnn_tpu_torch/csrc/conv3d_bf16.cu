// K3 and K4 in bf16 on Hopper: the 3x3x3 conv3d on flat voxel rows with
// bf16 activations and weights, on wgmma (warpgroup tensor-core products)
// fed by TMA into rings of shared-memory stages.
//
// Replaces the bf16 mode of the TPU kernels pvcnn_tpu/ops/pallas/conv_rows.py:
// _run_fwd_act (:636, body _fwd_act_kernel) and _run_fwd (:477), the
// forward and data gradient, and _run_wgrad (:527) / _run_wgrad_act (:690),
// the weight gradient. They stage a bf16 x in VMEM, multiply on the MXU with
// f32 accumulation and store the output in x's dtype. The fp32 kernels
// (csrc/conv3d.cu, csrc/conv3d_wgrad.cu) stay as they are.
//
// Rounding points, as in the JAX package:
//   * the prologue a(x) = leaky(x * scale + shift, 0.1) runs in f32 on the
//     bf16 x and is rounded to bf16 once (conv_rows.py: _stage_act), in the
//     staging pass (conv3d_bf16_stage_kernel, csrc/prologue.cuh's roundings);
//   * products of bf16 operands accumulate in f32 (wgmma, f32 accumulators);
//   * forward: the f32 bias joins the f32 accumulator, the BatchNorm sums
//     (of y and of y^2) are taken from it, y is rounded to bf16 once
//     (conv_rows.py: _fwd_act_kernel); the data gradient is the same kernel
//     with no bias and no statistics;
//   * weight gradient: dW sums in f32 over every cloud and voxel in a fixed
//     order (the splits' partials added in split order) and is rounded to
//     bf16 once, as JAX's dw.astype(kernel.dtype) (conv_rows.py: _act_bwd).
//
// The staged layout. The staging pass (a shared-memory transpose of 8
// channels x 256 voxels a block) writes each operand as [B, Cp / 8, R^3,
// 8]: 8-channel groups, each group's voxels contiguous, a voxel's 8
// channels in 16 bytes (Cp = C rounded up to 16, zeros past C). Eight
// voxels of a z-run are then one 128-byte core matrix of wgmma's
// unswizzled layout (K-major for K3's A, MN-major for K4's B), so a tap's
// shift is a 16-byte offset of a matrix descriptor's start address. A
// block loads the halo'd slab of its voxels once (a 4-d TMA box of 10 z x
// 10 y x (2 + halo) x per 8-channel group, zero-filled outside the grid:
// no tap needs a mask, the staged copy needs no halo, and any R works)
// and runs all its taps as shifted views of it. That lifts the 27-fold
// re-gather of an im2col off L2: each input byte enters a block's shared
// memory once, plus its halo (400 voxels for 128). The forward's staged
// a(x) is kept for K4, and the backward stages the cotangent once for the
// dgrad and K4 (pvcnn_tpu_torch/ops/conv3d.py).
//
// K3 (conv3d_bf16_fwd_kernel<N>): a block computes a tile of 8 z x 8 y x 2
// x voxels (M: 64 rows a consumer warpgroup, 8 z-runs of 8 at one x) x N
// output channels (16, 32, 64 or 128; more channels take more blocks),
// reducing over 27 taps x Cp channels. A producer warp keeps a ring of 3
// slab stages (16 channels each, one TMA load) and a ring of 4 weight
// stages (3 taps x 16 x N, one cp.async.bulk of the weight that
// conv3d_bf16_weights_kernel lays out as [N tiles][Cp / 16][27][2][N][8])
// in flight, each completing on its mbarrier by transaction bytes; the
// two consumer warpgroups issue 3 wgmma m64nNk16 a weight stage (A: the
// slab at the tap's offset; B: the weights; both K-major from shared
// memory), commit, and release the stage the group before read once
// wgmma.wait_group(1) says it is done. Epilogue: bias, the statistics from
// the f32 sums (per column: 2 rows a thread, shuffles over the column's 8
// lanes, then the 8 warps in order: one slot per (cloud, tile), which
// conv3d_bf16_stats_kernel adds in a fixed order), y rounded once and
// stored channel-major through a shared-memory transpose as 16-byte
// z-runs (2-byte stores only where R % 8 != 0). One launcher call stages
// x, lays out the weight, multiplies and sums the statistics: at 0.25x
// the calls are bound by the host's work per call.
//
// K4 (conv3d_bf16_wgrad_kernel<NW>): dW[co, ci, tap] = sum over clouds and
// voxels of g[co, v] * a(x)[ci, v + tap], a product of M = 64 output
// channels (A: the staged gradient) by N = NW input channels of one tap
// (B: the slab at the tap's offset, MN-major from shared memory) over K =
// voxels, in chunks of the same 2 x 8 x 8 voxels (8 k16 steps of two
// z-runs). A block owns a 64-channel tile of Co and a set of columns: with
// NW = 16 (Cp an odd multiple of 16) all 27 taps of 16 channels,
// warpgroup w the taps at dx = w (9 accumulator tiles); with NW = 32 or
// 64 one dx plane of NW channels, warpgroup w the taps at dy = w (3
// tiles). Its three consumer warpgroups share one ring of 4 stages (the
// slab and the gradient tile of a chunk, two TMA loads on one mbarrier)
// over a run of chunks (its split). A is the same for all of a
// warpgroup's taps, so each warp loads its 16 rows into registers once a
// k16 step (ldmatrix.trans) and the products read only B from shared
// memory: small-N products are bound by shared-memory reads, not by the
// tensor cores. The 0.25x shapes (Cp = 16, Co = 16 or 32) fill the 64-row
// tile with rows past Co that are never stored: they are bound by bytes,
// and a block reads each chunk's slab once for all 27 taps. Each split
// writes its f32 partial [Co][Cp][27]; conv3d_bf16_wgrad_sum_kernel adds
// the splits in order and rounds (ops/conv3d.py: _wgrad_bf16_plan: one
// wave of one block an SM).
//
// K11 in bf16 (pvcnn_conv3d_bf16_wgrad_last, counted as
// conv3d_ndhwc_wgrad_bf16) replaces the bf16 mode of the TPU kernel
// pvcnn_tpu/ops/pallas/conv_wgrad.py:_conv3d_wgrad_impl (:166): the NDHWC
// branch's weight gradient from bf16 x and dY [B, R, R, R, C], f32 inside,
// returned as dw.astype(kernel.dtype), the bf16 weight's type
// (pvcnn_tpu/nn/conv3d.py:65-75). It is K4's function on another layout,
// and runs K4's core, plan and split order on it
// (conv3d_bf16_wgrad_last_kernel): a channel-last grid's flat voxel index
// is K4's (x * R^2 + y * R + z), and each 8-channel group of a voxel is 16
// contiguous bytes of it, so a 5-d tensor map (channels, z, y, x, cloud)
// with a box of 8 channels lands one group of K4's staged box, byte for
// byte, where the staged map puts it (one load per group; zeros outside
// the grid, in no other cloud, and past C), and the grids are read in
// place. An operand whose rows of C channels are not whole 16-byte pieces
// or that starts off a 16-byte boundary (x at Ci = 9) is first copied into
// K4's staged layout by conv3d_bf16_stage_last_kernel (16 bytes a thread,
// zeros past C; no transpose), which the wrapper runs for it alone.
//
// Bound: operations, 2 * Co * 27 * Ci a voxel against 989 TFLOP/s of bf16
// tensor cores at 1x; at 0.25x mostly bytes (x, y or g, and W once, 2 bytes
// an element, against 3.35 TB/s). Weights stream from L2 per block (K3:
// 32 N bytes a k16 step for 2 x 64 rows).
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using namespace pvcnn::wg;
using u16 = unsigned short;

constexpr int kTaps = 27;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kVox = 16;     // bytes of a voxel's 8-channel group
// K3's output tile and K4's reduction chunk: 8 z x 8 y x 2 x voxels
constexpr int kTileZ = 8, kTileY = 8, kTileX = 2;
// the halo'd slab's z and y extents
constexpr int kSlabZ = kTileZ + 2, kSlabY = kTileY + 2;
constexpr int kConsumer = 128;   // threads of a warpgroup

// leaky(x * s + t, 0.1) with csrc/prologue.cuh's roundings (no fused
// multiply-add: those of the plain version's x * s + t)
__device__ __forceinline__ float activate(float x, float s, float t) {
  const float y = __fadd_rn(__fmul_rn(x, s), t);
  return y > 0.f ? y : __fmul_rn(0.1f, y);
}

__device__ __forceinline__ float bf16_to_float(u16 u) {
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

__device__ __forceinline__ u16 float_to_bf16(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// ---- the staging pass -----------------------------------------------------

// x [B, C, R^3] channel-major -> xt [B, G, R^3, 8] (G = Cp / 8 groups, a
// voxel's 8 channels fastest, channels C .. Cp - 1 zero); with the
// prologue each value is activated in f32 and rounded to bf16 (the JAX
// kernel stage's rounding). A block transposes 8 channels x 256 voxels
// through shared memory: warp w loads channel w's row as 16-byte pieces
// (element by element where R^3 % 8 != 0 or x is not 16-byte aligned),
// then thread t stores voxel t's 16 bytes, both coalesced.
constexpr int kStageVox = 256;

__global__ void __launch_bounds__(kStageVox)
conv3d_bf16_stage_kernel(const u16* __restrict__ x,          // [B, C, R^3]
                         const float* __restrict__ pscale,   // [C] / null
                         const float* __restrict__ pshift,   // [C] / null
                         u16* __restrict__ xt,               // [B, G, R^3, 8]
                         int C, int G, int R3) {
  __shared__ __align__(16) u16 tile[8][kStageVox + 8];
  const int runs = (R3 + kStageVox - 1) / kStageVox;
  const int v0 = static_cast<int>(blockIdx.x % runs) * kStageVox;
  const int64_t bg = blockIdx.x / runs;    // cloud * G + group
  const int64_t b = bg / G;
  const int ci = threadIdx.x >> 5, vl = (threadIdx.x & 31) * 8;
  const int c = static_cast<int>(bg % G) * 8 + ci;
  union Row {
    uint4 v;
    u16 e[8];
  } in;
  in.v = make_uint4(0u, 0u, 0u, 0u);
  if (c < C) {
    const u16* row = x + (b * C + c) * R3 + v0 + vl;
    if (R3 % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
        v0 + vl < R3) {
      in.v = __ldg(reinterpret_cast<const uint4*>(row));
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (v0 + vl + j < R3) in.e[j] = __ldg(row + j);
      }
    }
    if (pscale != nullptr) {
      const float sc = __ldg(pscale + c), sh = __ldg(pshift + c);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        in.e[j] = float_to_bf16(activate(bf16_to_float(in.e[j]), sc, sh));
      }
    }
  }
  *reinterpret_cast<uint4*>(&tile[ci][vl]) = in.v;
  __syncthreads();
  const int v = v0 + static_cast<int>(threadIdx.x);
  if (v >= R3) return;
  Row out;
#pragma unroll
  for (int i = 0; i < 8; ++i) out.e[i] = tile[i][threadIdx.x];
  *reinterpret_cast<uint4*>(xt + (bg * R3 + v) * 8) = out.v;
}

// x [B, R^3, C] channel-last -> xt [B, G, R^3, 8] (G = Cp / 8), the staged
// layout of conv3d_bf16_stage_kernel: a thread copies one voxel's 8
// channels of one group, 16 bytes where C % 8 == 0 and x is 16-byte
// aligned, else element by element, zeros past C; the voxels of a group
// fastest, so a warp's stores are 512 contiguous bytes.
__global__ void __launch_bounds__(pvcnn::kThreads)
conv3d_bf16_stage_last_kernel(const u16* __restrict__ x,   // [B, R^3, C]
                              u16* __restrict__ xt,        // [B, G, R^3, 8]
                              int C, int G, int R3, int64_t total) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (t >= total) return;              // total = B * G * R^3
  const int v = static_cast<int>(t % R3);
  const int64_t bg = t / R3;           // cloud * G + group
  const int64_t b = bg / G;
  const int c0 = static_cast<int>(bg % G) * 8;
  union Row {
    uint4 v;
    u16 e[8];
  } in;
  in.v = make_uint4(0u, 0u, 0u, 0u);
  const u16* row = x + (b * R3 + v) * C + c0;
  if (C % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    if (c0 < C) in.v = __ldg(reinterpret_cast<const uint4*>(row));
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (c0 + j < C) in.e[j] = __ldg(row + j);
    }
  }
  *reinterpret_cast<uint4*>(xt + t * 8) = in.v;
}

// K3's weight: w [Co, Ci, 27] (flip: the forward's [Ci, Co, 27] with the
// taps reversed, the data gradient's) -> ws [NT][Cp / 16][27][2][N][8]:
// per block of N output channels, 16-channel chunk and tap, the two
// 8-channel halves as N rows of 8 (wgmma's K-major B), zeros past Ci, Co
__global__ void __launch_bounds__(pvcnn::kThreads)
conv3d_bf16_weights_kernel(const u16* __restrict__ w, u16* __restrict__ ws,
                           int Ci, int Co, int N, int flip, int64_t total) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (t >= total) return;             // total = NT * Cp * 27 * N
  const int k = static_cast<int>(t % 8);
  int64_t rest = t / 8;
  const int n = static_cast<int>(rest % N);
  rest /= N;
  const int h = static_cast<int>(rest % 2);
  rest /= 2;
  const int tap = static_cast<int>(rest % kTaps);
  rest /= kTaps;                      // nt * chunks + chunk
  const int chunks = (Ci + 15) / 16;
  const int co = static_cast<int>(rest / chunks) * N + n;
  const int ci = static_cast<int>(rest % chunks) * 16 + 8 * h + k;
  u16 v = 0;
  if (co < Co && ci < Ci) {
    v = flip ? __ldg(w + (static_cast<int64_t>(ci) * Co + co) * kTaps +
                     kTaps - 1 - tap)
             : __ldg(w + (static_cast<int64_t>(co) * Ci + ci) * kTaps + tap);
  }
  ws[t] = v;
}

// stats[i] = the sum of partial[i][0 .. slots) in a fixed order (a block
// a row: strided partial sums, then a tree), the BatchNorm sums of K3
__global__ void __launch_bounds__(pvcnn::kThreads)
conv3d_bf16_stats_kernel(const float* __restrict__ partial,
                         float* __restrict__ stats, int slots) {
  __shared__ float part[pvcnn::kThreads];
  const float* row = partial + static_cast<int64_t>(blockIdx.x) * slots;
  float s = 0.f;
  for (int j = threadIdx.x; j < slots; j += pvcnn::kThreads) s += row[j];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int w = pvcnn::kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) stats[blockIdx.x] = part[0];
}

// ---- K3: forward and data gradient ----------------------------------------

template <int N>
struct Fwd {
  static constexpr int kThreads = 2 * kConsumer + 32;   // + a producer warp
  static constexpr int kSlabStages = 3, kWStages = 4;
  static constexpr int kSlabVox = kSlabZ * kSlabY * (kTileX + 2);   // 400
  static constexpr int kSlabBytes = 2 * kSlabVox * kVox;   // 16 channels
  static constexpr int kWBytes = 3 * 16 * N * 2;           // 3 taps x 16 x N
  static constexpr int kRing = kSlabStages * kSlabBytes + kWStages * kWBytes;
  // the epilogue's transpose (over the ring): [2][N][64 + 8] bf16
  static constexpr int kEpiStride = 64 + 8;
  static constexpr int kEpiBytes = 2 * N * kEpiStride * 2;
  static constexpr int kBarOff = kRing > kEpiBytes ? kRing : kEpiBytes;
  static constexpr int kStatOff = kBarOff + 128;   // 14 barriers
  static constexpr int kStatBytes = 2 * 4 * 2 * N * 4;   // [2][4][2][N]
  static constexpr int kSmem = kStatOff + kStatBytes + 128;   // + alignment
};

template <int N>
__global__ void __launch_bounds__(Fwd<N>::kThreads, 2)
conv3d_bf16_fwd_kernel(const __grid_constant__ CUtensorMap xmap,
                       const u16* __restrict__ w,   // [NT][Cp/16][27][2][N][8]
                       const float* __restrict__ bias,   // [Co] / null
                       u16* __restrict__ y,              // [B, Co, R^3]
                       float* __restrict__ partial,      // [2, Co, slots]
                       int groups, int Co, int R, int tz, int ty, int tiles,
                       int slots) {
  using C = Fwd<N>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align128(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* full_a = bars;           // slab stages
  uint64_t* empty_a = bars + 3;
  uint64_t* full_w = bars + 6;       // weight stages
  uint64_t* empty_w = bars + 10;
  const int tid = threadIdx.x;
  const int chunks = groups / 2;     // 16-channel chunks of Cp
  const int slot = blockIdx.x;       // cloud * tiles + tile
  const int b = slot / tiles, tile = slot % tiles;
  const int z0 = tile % tz * kTileZ, y0 = tile / tz % ty * kTileY;
  const int x0 = tile / (tz * ty) * kTileX;
  if (tid == 0) {
    for (int i = 0; i < C::kSlabStages; ++i) {
      bar_init(&full_a[i], 1);
      bar_init(&empty_a[i], 2);
    }
    for (int i = 0; i < C::kWStages; ++i) {
      bar_init(&full_w[i], 1);
      bar_init(&empty_w[i], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  unsigned char* wring = smem + C::kSlabStages * C::kSlabBytes;
  if (tid >= 2 * kConsumer) {        // the producer warp: one thread loads
    if (tid == 2 * kConsumer) {
      const u16* wt = w + static_cast<int64_t>(blockIdx.y) * chunks * kTaps *
                              16 * N;
      int k = 0;                     // weight stages issued
      for (int c = 0; c < chunks; ++c) {
        const int s = c % C::kSlabStages;
        if (c >= C::kSlabStages) {
          bar_wait(&empty_a[s], (c / C::kSlabStages - 1) & 1);
        }
        bar_expect(&full_a[s], C::kSlabBytes);
        tma_load(smem + s * C::kSlabBytes, &xmap, &full_a[s],
                 (z0 - 1) * 8, y0 - 1, x0 - 1, b * groups + 2 * c);
        for (int t = 0; t < 9; ++t, ++k) {
          const int ws = k % C::kWStages;
          if (k >= C::kWStages) {
            bar_wait(&empty_w[ws], (k / C::kWStages - 1) & 1);
          }
          bar_expect(&full_w[ws], C::kWBytes);
          bulk_load(wring + ws * C::kWBytes,
                    wt + (static_cast<int64_t>(c) * kTaps + 3 * t) * 16 * N,
                    C::kWBytes, &full_w[ws]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg computes output x = x0 + wg, 64 rows (8 y-rows
  // of one z-run each) x N channels
  const int wg = tid / kConsumer, lt = tid % kConsumer;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const uint32_t slab0 = smem_addr(smem) + wg * kSlabZ * kSlabY * kVox;
  const uint32_t wbase = smem_addr(wring);
  int k = 0;
  for (int c = 0; c < chunks; ++c) {
    const int s = c % C::kSlabStages;
    bar_wait(&full_a[s], (c / C::kSlabStages) & 1);
    const uint32_t slab = slab0 + s * C::kSlabBytes;
    for (int t = 0; t < 9; ++t, ++k) {   // taps 3 t .. 3 t + 2: (dx, dy)
      const int ws = k % C::kWStages;
      bar_wait(&full_w[ws], (k / C::kWStages) & 1);
      const uint32_t at =
          slab + ((t / 3) * kSlabY + t % 3) * kSlabZ * kVox;
      const uint32_t bt = wbase + ws * C::kWBytes;
      wgmma_fence();
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        // A: 8 y-rows (SBO) of 8 z-voxels, channels 0-7 | 8-15 (LBO);
        // B: N rows of 8 k, k-halves N * 16 bytes apart
        wgmma_ss<N>(acc,
                       mat_desc(at + dz * kVox, C::kSlabVox * kVox,
                                kSlabZ * kVox),
                       mat_desc(bt + dz * 32 * N, N * kVox, 8 * kVox));
      }
      wgmma_commit();
      wgmma_wait<1>();     // the group before this one has read its stage
      if (lt == 0 && k > 0) {
        bar_arrive(&empty_w[(k - 1) % C::kWStages]);
        if ((k - 1) % 9 == 8) {
          bar_arrive(&empty_a[((k - 1) / 9) % C::kSlabStages]);
        }
      }
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // epilogue. Fragment: warp q, lane l holds rows m = 16 q + l / 4 + 8 i
  // (y-row m / 8 = 2 q + i, z = l / 4) and columns 8 j + 2 (l % 4) + e in
  // acc[4 j + 2 i + e].
  named_sync(1, 2 * kConsumer);   // both warpgroups are done with the ring
  const int warp = lt >> 5, lane = tid & 31;
  const int x = x0 + wg;
  const int zz = lane >> 2;
  u16* ebuf = reinterpret_cast<u16*>(smem) + wg * N * C::kEpiStride;
  float* stat = reinterpret_cast<float*>(smem + C::kStatOff);
  const int n0 = blockIdx.y * N;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * j + 2 * (lane & 3) + e;
      const float bc =
          bias != nullptr && n0 + n < Co ? __ldg(bias + n0 + n) : 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = warp * 16 + zz + 8 * i;
        const float v = acc[4 * j + 2 * i + e] + bc;
        ebuf[n * C::kEpiStride + m] = float_to_bf16(v);
        if (z0 + zz < R && y0 + (m >> 3) < R && x < R) {
          s1[e] += v;
          s2[e] = fmaf(v, v, s2[e]);
        }
      }
    }
    if (partial != nullptr) {   // the column's 8 lanes, in a fixed order
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s1[e] += __shfl_xor_sync(kFull, s1[e], o);
          s2[e] += __shfl_xor_sync(kFull, s2[e], o);
        }
        if (lane < 4) {
          float* row = stat + (wg * 4 + warp) * 2 * N + 8 * j + 2 * lane + e;
          row[0] = s1[e];
          row[N] = s2[e];
        }
      }
    }
  }
  named_sync(1, 2 * kConsumer);
  if (partial != nullptr && tid < N && n0 + tid < Co) {
    float a = 0.f, q = 0.f;   // the 8 warps in order
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      a += stat[p * 2 * N + tid];
      q += stat[p * 2 * N + N + tid];
    }
    partial[static_cast<int64_t>(n0 + tid) * slots + slot] = a;
    partial[(static_cast<int64_t>(Co) + n0 + tid) * slots + slot] = q;
  }
  // y: a z-run of 8 voxels of one channel a step, 16 bytes where R % 8 == 0
  const int64_t r3 = static_cast<int64_t>(R) * R * R;
  for (int p = lt; p < N * kTileY; p += kConsumer) {
    const int n = p / kTileY, yy = p % kTileY;
    if (n0 + n >= Co || y0 + yy >= R || x >= R) continue;
    const u16* src = ebuf + n * C::kEpiStride + yy * kTileZ;
    u16* dst = y + (static_cast<int64_t>(b) * Co + n0 + n) * r3 +
               (static_cast<int64_t>(x) * R + y0 + yy) * R + z0;
    if (R % kTileZ == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int q = 0; q < kTileZ && z0 + q < R; ++q) dst[q] = src[q];
    }
  }
}

// ---- K4: weight gradient --------------------------------------------------

template <int NW>
struct Wgrad {
  static constexpr int kThreads = 3 * kConsumer + 32;   // + a producer warp
  // NW == 16: all 27 taps a block (warpgroup w: dx = w, 9 tiles); else
  // one dx plane (warpgroup w: dy = w, 3 tiles)
  static constexpr bool kAllTaps = NW == 16;
  static constexpr int kTW = kAllTaps ? 9 : 3;
  // k16 steps whose A fragments are held at once: the producer warp takes
  // a fourth warpgroup's registers, so a thread has 128; 9 tiles of
  // accumulators leave room for 4 steps, 3 tiles for all 8 (no spills)
  static constexpr int kGroup = kAllTaps ? 4 : 8;
  static constexpr int kSlabX = kTileX + (kAllTaps ? 2 : 0);
  static constexpr int kSlabVox = kSlabZ * kSlabY * kSlabX;
  static constexpr int kSlabBytes = NW / 8 * kSlabVox * kVox;
  static constexpr int kGVox = kTileZ * kTileY * kTileX;      // 128
  static constexpr int kGBytes = 8 * kGVox * kVox;            // 64 channels
  static constexpr int kStage = kSlabBytes + kGBytes;
  static constexpr int kStages = 4;
  static constexpr int kBarOff = kStages * kStage;
  static constexpr int kSmem = kBarOff + 64 + 128;   // + alignment
};

// The block's work, as conv3d_bf16_wgrad_kernel (K4) and
// conv3d_bf16_wgrad_last_kernel (K11) run it. With kLast, the operands
// named in `last` (bit 0: x, bit 1: the gradient) are channel-last grids
// read in place by 5-d tensor maps (dims C, z, y, x, cloud; box 8 x bz x
// by x bx x 1, one load per 8-channel group, each landing where the staged
// map's box puts that group), the others staged as K4's.
template <int NW, bool kLast>
__device__ __forceinline__ void wgrad_block(
    const CUtensorMap& xmap, const CUtensorMap& gmap,
    float* __restrict__ partial, int groups, int ggroups, int gbox, int Co,
    int R, int tz, int ty, int tiles, int chunks, int per_split, int last) {
  using C = Wgrad<NW>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align128(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* empty = full + C::kStages;
  const int tid = threadIdx.x;
  const int split = blockIdx.x, col = blockIdx.y, ct = blockIdx.z;
  // the block's input channels (group g0 ..) and, for one plane, its dx
  const int g0 = C::kAllTaps ? 2 * col : col / 3 * (NW / 8);
  const int dxb = C::kAllTaps ? 0 : col % 3;
  const int k0 = split * per_split;
  const int k1 = min(chunks, k0 + per_split);
  if (tid == 0) {
    for (int i = 0; i < C::kStages; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], 3);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 3 * kConsumer) {        // the producer warp: one thread loads
    if (tid == 3 * kConsumer) {
      const unsigned bytes = C::kSlabBytes + gbox * C::kGVox * kVox;
      for (int k = k0, i = 0; k < k1; ++k, ++i) {
        const int s = i % C::kStages;
        if (i >= C::kStages) bar_wait(&empty[s], (i / C::kStages - 1) & 1);
        const int b = k / tiles, tile = k % tiles;
        const int z0 = tile % tz * kTileZ, y0 = tile / tz % ty * kTileY;
        const int x0 = tile / (tz * ty) * kTileX;
        unsigned char* stage = smem + s * C::kStage;
        bar_expect(&full[s], bytes);
        if (kLast && (last & 1)) {
          for (int j = 0; j < NW / 8; ++j) {
            tma_load_5d(stage + j * C::kSlabVox * kVox, &xmap, &full[s],
                        8 * (g0 + j), z0 - 1, y0 - 1, x0 - 1 + dxb, b);
          }
        } else {
          tma_load(stage, &xmap, &full[s], (z0 - 1) * 8, y0 - 1,
                   x0 - 1 + dxb, b * groups + g0);
        }
        if (kLast && (last & 2)) {
          for (int j = 0; j < gbox; ++j) {
            tma_load_5d(stage + C::kSlabBytes + j * C::kGVox * kVox, &gmap,
                        &full[s], 8 * (ct * 8 + j), z0, y0, x0, b);
          }
        } else {
          tma_load(stage + C::kSlabBytes, &gmap, &full[s], z0 * 8, y0, x0,
                   b * ggroups + ct * 8);
        }
      }
    }
    return;
  }

  const int wg = tid / kConsumer, lt = tid % kConsumer;
  const int warp = lt >> 5, lane = tid & 31;
  float acc[C::kTW][NW / 2];
#pragma unroll
  for (int t = 0; t < C::kTW; ++t) {
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[t][i] = 0.f;
  }
  // A, the gradient, is the same for all the warpgroup's taps: each warp
  // loads its 16 rows (output channels) of a k16 step once, by
  // ldmatrix.trans from the voxel-major tile: matrix lane / 8 = (channel
  // half, y-row of the step), row lane % 8 = z
  const uint32_t arow = ((warp * 2 + ((lane >> 3) & 1)) * C::kGVox +
                         (lane >> 4) * kTileZ + (lane & 7)) * kVox;
  const uint32_t base = smem_addr(smem);
  for (int k = k0, i = 0; k < k1; ++k, ++i) {
    const int s = i % C::kStages;
    bar_wait(&full[s], (i / C::kStages) & 1);
    const uint32_t slab = base + s * C::kStage;
    // the 8 k16 steps (step st: x st / 4, y-rows 2 (st % 4) and + 1) in
    // groups of kGroup: a group's A fragments are loaded, its products
    // issued and finished before the next group rewrites the fragments'
    // registers (the other warpgroups keep the tensor cores busy)
#pragma unroll 1
    for (int g0 = 0; g0 < 8; g0 += C::kGroup) {
      uint32_t afr[C::kGroup][4];
#pragma unroll
      for (int q = 0; q < C::kGroup; ++q) {
        const int st = g0 + q;
        ldmatrix_x4_trans(afr[q], slab + C::kSlabBytes + arow +
                                      ((st >> 2) * kTileY + 2 * (st & 3)) *
                                          kTileZ * kVox);
      }
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < C::kGroup; ++q) {
        const int st = g0 + q, xl = st >> 2, yl = 2 * (st & 3);
#pragma unroll
        for (int t = 0; t < C::kTW; ++t) {
          const int dxl = C::kAllTaps ? wg : 0;
          const int dy = C::kAllTaps ? t / 3 : wg;
          const int dz = C::kAllTaps ? t % 3 : t;
          // B: the slab at the tap, channel groups (SBO), two y-rows (LBO)
          const uint32_t bs =
              slab + (((xl + dxl) * kSlabY + yl + dy) * kSlabZ + dz) * kVox;
          wgmma_rs<NW>(acc[t], afr[q],
                       mat_desc(bs, kSlabZ * kVox, C::kSlabVox * kVox));
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
    }
    if (lt == 0) bar_arrive(&empty[s]);
  }

  // this split's partial dW (every entry of the block's columns; zeros for
  // a split without chunks). Fragment: rows (output channels) 16 q + l / 4
  // + 8 i, columns (input channels) 8 j + 2 (l % 4) + e.
  const int cp = groups * 8;
  float* out = partial + static_cast<int64_t>(split) * Co * cp * kTaps;
#pragma unroll
  for (int t = 0; t < C::kTW; ++t) {
    fence_acc(acc[t]);
    const int tap = C::kAllTaps ? 9 * wg + t : 9 * dxb + 3 * wg + t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int co = ct * 64 + warp * 16 + (lane >> 2) + 8 * i;
      if (co >= Co) continue;
      float* row = out + static_cast<int64_t>(co) * cp * kTaps;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ci = g0 * 8 + 8 * j + 2 * (lane & 3) + e;
          row[ci * kTaps + tap] = acc[t][4 * j + 2 * i + e];
        }
      }
    }
  }
}

template <int NW>
__global__ void __launch_bounds__(Wgrad<NW>::kThreads, 1)
conv3d_bf16_wgrad_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap gmap,
                         float* __restrict__ partial,   // [S, Co, Cp, 27]
                         int groups, int ggroups, int gbox, int Co, int R,
                         int tz, int ty, int tiles, int chunks,
                         int per_split) {
  wgrad_block<NW, false>(xmap, gmap, partial, groups, ggroups, gbox, Co, R,
                         tz, ty, tiles, chunks, per_split, 0);
}

template <int NW>
__global__ void __launch_bounds__(Wgrad<NW>::kThreads, 1)
conv3d_bf16_wgrad_last_kernel(const __grid_constant__ CUtensorMap xmap,
                              const __grid_constant__ CUtensorMap gmap,
                              float* __restrict__ partial,
                              int groups, int ggroups, int gbox, int Co,
                              int R, int tz, int ty, int tiles, int chunks,
                              int per_split, int last) {
  wgrad_block<NW, true>(xmap, gmap, partial, groups, ggroups, gbox, Co, R,
                        tz, ty, tiles, chunks, per_split, last);
}

// dW[co, ci, tap] = bf16(the sum of the splits' partials at (co, ci, tap),
// in split order), in torch's [Co, Ci, 3, 3, 3] order
__global__ void __launch_bounds__(pvcnn::kThreads)
conv3d_bf16_wgrad_sum_kernel(const float* __restrict__ partial,
                             u16* __restrict__ dw,  // [Co, Ci * 27]
                             int Co, int Ci, int Cp, int splits) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  const int64_t row = static_cast<int64_t>(Ci) * kTaps;
  if (i >= Co * row) return;
  const int64_t co = i / row;
  const int64_t at = co * Cp * kTaps + (i - co * row);
  const int64_t stride = static_cast<int64_t>(Co) * Cp * kTaps;
  float sum = __ldg(partial + at);
  for (int s = 1; s < splits; ++s) sum += __ldg(partial + s * stride + at);
  dw[i] = float_to_bf16(sum);
}

// ---- host side ------------------------------------------------------------

// a staged operand [B * G][R][R][R * 8] as a 4-d tensor map (z and the
// group's 8 channels merged innermost, y, x, cloud * G + group) with box
// (bz * 8, by, bx, bg); outside the grid TMA fills zeros
int staged_map(CUtensorMap* map, const void* base, int64_t groups, int R,
               int bz, int by, int bx, int bg) {
  const int64_t r = R;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(r * 8),
                              static_cast<cuuint64_t>(r),
                              static_cast<cuuint64_t>(r),
                              static_cast<cuuint64_t>(groups)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(r * kVox),
                                 static_cast<cuuint64_t>(r * r * kVox),
                                 static_cast<cuuint64_t>(r * r * r * kVox)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(bz * 8),
                             static_cast<cuuint32_t>(by),
                             static_cast<cuuint32_t>(bx),
                             static_cast<cuuint32_t>(bg)};
  return bf16_map(map, base, 4, dims, strides, box);
}

template <int N>
int launch_fwd(const CUtensorMap& map, const u16* w, const float* bias,
               u16* y, float* partial, int B, int Cp, int Co, int R,
               cudaStream_t stream) {
  using C = Fwd<N>;
  static bool ready = false;
  const int err = allow_smem(conv3d_bf16_fwd_kernel<N>, C::kSmem, &ready);
  if (err != 0) return err;
  const int tz = (R + kTileZ - 1) / kTileZ, ty = (R + kTileY - 1) / kTileY;
  const int tiles = tz * ty * ((R + kTileX - 1) / kTileX);
  const dim3 grid(static_cast<unsigned>(B) * tiles,
                  static_cast<unsigned>((Co + N - 1) / N));
  conv3d_bf16_fwd_kernel<N><<<grid, C::kThreads, C::kSmem, stream>>>(
      map, w, bias, y, partial, Cp / 8, Co, R, tz, ty, tiles, B * tiles);
  return static_cast<int>(cudaGetLastError());
}

// a channel-last grid [B, R, R, R, C] read in place as a 5-d tensor map
// (channels, z, y, x, cloud) with box (8, bz, by, bx, 1): each box is one
// 8-channel group of a staged_map box, its bytes where that box puts them
// (C % 8 == 0 and a 16-byte aligned base; zeros outside the grid and past
// C)
int last_map(CUtensorMap* map, const void* base, int B, int C, int R,
             int bz, int by, int bx) {
  const int64_t r = R, c = C;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(c),
                              static_cast<cuuint64_t>(r),
                              static_cast<cuuint64_t>(r),
                              static_cast<cuuint64_t>(r),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[4] = {static_cast<cuuint64_t>(c * 2),
                                 static_cast<cuuint64_t>(r * c * 2),
                                 static_cast<cuuint64_t>(r * r * c * 2),
                                 static_cast<cuuint64_t>(r * r * r * c * 2)};
  const cuuint32_t box[5] = {8, static_cast<cuuint32_t>(bz),
                             static_cast<cuuint32_t>(by),
                             static_cast<cuuint32_t>(bx), 1};
  return bf16_map(map, base, 5, dims, strides, box);
}

// K4's core on x and the gradient g: each staged ([B, Cp / 8, R^3, 8]), or
// with kLast a channel-last grid where `last` says so (bit 0: x, bit 1: g)
template <int NW, bool kLast>
int launch_wgrad(const void* x, const void* g, int last, float* partial,
                 int B, int Ci, int Co, int R, int splits, int per_split,
                 cudaStream_t stream) {
  using C = Wgrad<NW>;
  static bool ready = false;
  int err;
  if constexpr (kLast) {
    err = allow_smem(conv3d_bf16_wgrad_last_kernel<NW>, C::kSmem, &ready);
  } else {
    err = allow_smem(conv3d_bf16_wgrad_kernel<NW>, C::kSmem, &ready);
  }
  if (err != 0) return err;
  const int cp = (Ci + 15) / 16 * 16, cop = (Co + 15) / 16 * 16;
  const int gbox = cop / 8 < 8 ? cop / 8 : 8;
  CUtensorMap xmap, gmap;
  err = kLast && (last & 1)
            ? last_map(&xmap, x, B, Ci, R, kSlabZ, kSlabY, C::kSlabX)
            : staged_map(&xmap, x, static_cast<int64_t>(B) * cp / 8, R,
                         kSlabZ, kSlabY, C::kSlabX, NW / 8);
  if (err != 0) return err;
  err = kLast && (last & 2)
            ? last_map(&gmap, g, B, Co, R, kTileZ, kTileY, kTileX)
            : staged_map(&gmap, g, static_cast<int64_t>(B) * cop / 8, R,
                         kTileZ, kTileY, kTileX, gbox);
  if (err != 0) return err;
  const int tz = (R + kTileZ - 1) / kTileZ, ty = (R + kTileY - 1) / kTileY;
  const int tiles = tz * ty * ((R + kTileX - 1) / kTileX);
  const int cols = C::kAllTaps ? cp / 16 : 3 * cp / NW;
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>(cols),
                  static_cast<unsigned>((Co + 63) / 64));
  if constexpr (kLast) {
    conv3d_bf16_wgrad_last_kernel<NW><<<grid, C::kThreads, C::kSmem,
                                        stream>>>(
        xmap, gmap, partial, cp / 8, cop / 8, gbox, Co, R, tz, ty, tiles,
        B * tiles, per_split, last);
  } else {
    conv3d_bf16_wgrad_kernel<NW><<<grid, C::kThreads, C::kSmem, stream>>>(
        xmap, gmap, partial, cp / 8, cop / 8, gbox, Co, R, tz, ty, tiles,
        B * tiles, per_split);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4's core (kLast: K11's route), then the splits' sum: dw [Co, Ci * 27]
template <bool kLast>
int wgrad(const void* x, const void* g, int last, void* partial, void* dw,
          int B, int Ci, int Co, int R, int cols, int splits, int per_split,
          void* stream) {
  if (Co == 0 || Ci == 0) return 0;
  const int cp = (Ci + 15) / 16 * 16;
  if (B < 1 || R < 1 || splits < 1 || per_split < 1 || cols <= 0 ||
      cp % cols != 0 || (kLast && (last & 1) && Ci % 8 != 0) ||
      (kLast && (last & 2) && Co % 8 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  auto* pf = static_cast<float*>(partial);
  int err;
  switch (cols) {
    case 16:
      err = launch_wgrad<16, kLast>(x, g, last, pf, B, Ci, Co, R, splits,
                                    per_split, st);
      break;
    case 32:
      err = launch_wgrad<32, kLast>(x, g, last, pf, B, Ci, Co, R, splits,
                                    per_split, st);
      break;
    case 64:
      err = launch_wgrad<64, kLast>(x, g, last, pf, B, Ci, Co, R, splits,
                                    per_split, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  const int64_t n = static_cast<int64_t>(Co) * Ci * kTaps;
  conv3d_bf16_wgrad_sum_kernel<<<pvcnn::blocks_for(n), pvcnn::kThreads, 0,
                                 st>>>(pf, static_cast<u16*>(dw), Co, Ci, cp,
                                       splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the staging pass: x [B, C, R3] bf16 -> xt [B, Cp / 8, R3, 8] bf16 (Cp =
// C rounded up to 16); with pscale/pshift (f32 [C]) a(x), rounded
PVCNN_EXPORT int pvcnn_conv3d_bf16_stage(const void* x, const void* pscale,
                                         const void* pshift, void* xt, int B,
                                         int C, int R3, void* stream) {
  const int groups = (C + 15) / 16 * 2;
  const int64_t blocks = static_cast<int64_t>(B) * groups *
                         ((R3 + kStageVox - 1) / kStageVox);
  if (blocks == 0) return 0;
  conv3d_bf16_stage_kernel<<<static_cast<unsigned>(blocks), kStageVox, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u16*>(x), static_cast<const float*>(pscale),
      static_cast<const float*>(pshift), static_cast<u16*>(xt), C, groups,
      R3);
  return static_cast<int>(cudaGetLastError());
}

// the channel-last staging pass (K11 in bf16): x [B, R^3, C] bf16 -> xt
// [B, Cp / 8, R^3, 8] (Cp = C rounded up to 16, zeros past C)
PVCNN_EXPORT int pvcnn_conv3d_bf16_stage_last(const void* x, void* xt, int B,
                                              int C, int R3, void* stream) {
  const int groups = (C + 15) / 16 * 2;
  const int64_t total = static_cast<int64_t>(B) * groups * R3;
  if (total == 0) return 0;
  conv3d_bf16_stage_last_kernel<<<pvcnn::blocks_for(total), pvcnn::kThreads,
                                  0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const u16*>(x), static_cast<u16*>(xt), C, groups, R3,
      total);
  return static_cast<int>(cudaGetLastError());
}

// K3 in bf16, one call: the staging pass of x [B, Ci, R^3] bf16 into xt
// [B, Cp / 8, R^3, 8] (with pscale/pshift, f32 [Ci], a(x)), or xt given
// staged (x null); w [Co, Ci, 27] bf16 (flip: the forward's [Ci, Co, 27],
// taps reversed: the data gradient) into ws (bf16, ceil(Co / N) * N * Cp *
// 27) in K3's layout; then the product with N output channels a block
// (16, 32, 64 or 128): bias f32 [Co] or null; y [B, Co, R^3] bf16; with
// partial (f32 [2, Co, B * tiles], tiles = ceil(R / 2) * ceil(R / 8)^2)
// and stats (f32 [2, Co]) the BatchNorm sums, slots added in order
PVCNN_EXPORT int pvcnn_conv3d_bf16_fwd(
    const void* x, const void* pscale, const void* pshift, void* xt,
    const void* w, void* ws, const void* bias, void* y, void* partial,
    void* stats, int B, int Ci, int Co, int R, int N, int flip,
    void* stream) {
  if (B == 0 || R == 0 || Co == 0) return 0;
  if (Ci <= 0 || (N != 16 && N != 32 && N != 64 && N != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const int cp = (Ci + 15) / 16 * 16;
  const int r3 = R * R * R;
  if (x != nullptr) {
    const int64_t blocks = static_cast<int64_t>(B) * (cp / 8) *
                           ((r3 + kStageVox - 1) / kStageVox);
    conv3d_bf16_stage_kernel<<<static_cast<unsigned>(blocks), kStageVox, 0,
                               st>>>(
        static_cast<const u16*>(x), static_cast<const float*>(pscale),
        static_cast<const float*>(pshift), static_cast<u16*>(xt), Ci,
        cp / 8, r3);
  }
  const int64_t wtotal =
      static_cast<int64_t>((Co + N - 1) / N) * N * cp * kTaps;
  conv3d_bf16_weights_kernel<<<pvcnn::blocks_for(wtotal), pvcnn::kThreads,
                               0, st>>>(static_cast<const u16*>(w),
                                        static_cast<u16*>(ws), Ci, Co, N,
                                        flip, wtotal);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  CUtensorMap map;
  err = staged_map(&map, xt, static_cast<int64_t>(B) * cp / 8, R, kSlabZ,
                   kSlabY, kTileX + 2, 2);
  if (err != 0) return err;
  const auto* wb = static_cast<const u16*>(ws);
  const auto* bf = static_cast<const float*>(bias);
  auto* yb = static_cast<u16*>(y);
  auto* pf = static_cast<float*>(partial);
  switch (N) {
    case 16: err = launch_fwd<16>(map, wb, bf, yb, pf, B, cp, Co, R, st);
      break;
    case 32: err = launch_fwd<32>(map, wb, bf, yb, pf, B, cp, Co, R, st);
      break;
    case 64: err = launch_fwd<64>(map, wb, bf, yb, pf, B, cp, Co, R, st);
      break;
    default: err = launch_fwd<128>(map, wb, bf, yb, pf, B, cp, Co, R, st);
  }
  if (err != 0 || stats == nullptr) return err;
  const int slots = B * ((R + 1) / 2) * ((R + 7) / 8) * ((R + 7) / 8);
  conv3d_bf16_stats_kernel<<<2 * Co, pvcnn::kThreads, 0, st>>>(
      pf, static_cast<float*>(stats), slots);
  return static_cast<int>(cudaGetLastError());
}

// K4 in bf16 on the staged a(x) xt [B, Cp / 8, R^3, 8] and gradient gt [B,
// Cop / 8, R^3, 8] (Cp, Cop: Ci, Co rounded up to 16): dw [Co, Ci * 27]
// bf16; partial f32 [splits, Co, Cp, 27]; cols the input channels of a
// warpgroup's product (16: all taps a block, 32 or 64: a dx plane); the
// reduction's B * tiles chunks go to splits runs of per_split
PVCNN_EXPORT int pvcnn_conv3d_bf16_wgrad(const void* xt, const void* gt,
                                         void* partial, void* dw, int B,
                                         int Ci, int Co, int R, int cols,
                                         int splits, int per_split,
                                         void* stream) {
  return wgrad<false>(xt, gt, 0, partial, dw, B, Ci, Co, R, cols, splits,
                      per_split, stream);
}

// K11 in bf16: K4's core and plan on x [B, R, R, R, Ci] and its gradient
// g [B, R, R, R, Co], each read in place where `last` says so (bit 0: x,
// bit 1: g; C % 8 == 0 and 16-byte aligned), else given staged by
// pvcnn_conv3d_bf16_stage_last; dw, partial and the plan as
// pvcnn_conv3d_bf16_wgrad's
PVCNN_EXPORT int pvcnn_conv3d_bf16_wgrad_last(const void* x, const void* g,
                                              int last, void* partial,
                                              void* dw, int B, int Ci,
                                              int Co, int R, int cols,
                                              int splits, int per_split,
                                              void* stream) {
  return wgrad<true>(x, g, last, partial, dw, B, Ci, Co, R, cols, splits,
                     per_split, stream);
}
