// K3 and K4 in bf16: the 3x3x3 conv3d on flat voxel rows with bf16
// activations and weights, on the tensor cores.
//
// Replaces the bf16 mode of the TPU kernels pvcnn_tpu/ops/pallas/conv_rows.py:
// _run_fwd_act (body _fwd_act_kernel) and _run_fwd, its forward and data
// gradient, and _run_wgrad_act / _run_wgrad, its weight gradient, which stage
// a bf16 x in VMEM (conv_rows.py:496-519, 651-682), multiply on the MXU with
// f32 accumulation and store the output in x's dtype. The fp32 kernels
// (csrc/conv3d.cu, csrc/conv3d_wgrad.cu) stay as they are; this file holds
// the bf16 mode beside them.
//
// Rounding points, as in the JAX package:
//   * the prologue a(x) = leaky(x * scale + shift, 0.1) runs in f32 on the
//     bf16 x and is rounded to bf16 before the product (conv_rows.py:
//     _stage_act), once per element, in the staging pass K3 and K4 share
//     (conv3d_bf16_stage_kernel, with csrc/prologue.cuh's roundings);
//   * products of bf16 operands accumulate in f32 (mma.sync m16n8k16, f32
//     accumulators);
//   * forward: the f32 bias joins the f32 accumulator, the BatchNorm sums
//     (sum of y and of y^2) are taken from it, and y is rounded to bf16 once
//     (conv_rows.py:_fwd_act_kernel); the data gradient is the same kernel
//     with a zero bias and no statistics;
//   * weight gradient: dW sums in f32 over every cloud and voxel, in a fixed
//     order (split partials added in split order), and is rounded to bf16
//     once at the end, as JAX's dw.astype(kernel.dtype) of the bf16 kernel
//     (conv_rows.py:_act_bwd).
//
// K3 (conv3d_bf16_fwd_kernel<BM>): an implicit GEMM, output channels x
// voxels of one cloud, reduction K = 27 * Cp tap-major in slices of 16 (one
// mma k-step, 16 channels of one tap), Cp = Ci rounded up to 16. A staging
// pass (conv3d_bf16_stage_kernel) first writes the input voxel-major, [B,
// R^3, Cp] with zero channels past Ci (the prologue applied and rounded on
// the way), so a voxel's 16 channels of a slice are one 32-byte read: the
// im2col slice is gathered by two 16-byte loads a voxel and tap, where
// channel-major rows would take 16 scalar loads. A block of 4 warps
// computes BM output channels x 256 / (BM / 32) voxels (64 x 128, or 32 x
// 256 where Co <= 32); each warp a 32 x 64 tile as 2 x 8 mma tiles of 16 x
// 8. The weight slice [16][BM] (channels fastest, read by ldmatrix.trans)
// and the im2col slice [BN][16] (a voxel's channels fastest, read by
// ldmatrix) are staged in shared memory with rows padded by 16 bytes, so
// the 8 rows of an ldmatrix hit 8 different bank groups. The next slice is
// loaded into registers while the current one multiplies, two buffers, one
// barrier a slice, as csrc/conv3d.cu. Each warp also reduces its 64-voxel
// span of the biased y to per-channel sum and sum of squares and writes
// them to partial[2][Co][B * ceil(R^3 / 64)] at the slot of (cloud, span):
// the caller adds the slots in a fixed order, so the statistics are
// reproducible bit for bit.
//
// K4 (conv3d_bf16_wgrad_kernel<BM>): dW[co, ci, tap] = sum over clouds and
// voxels of g[co, v] * a(x)[ci, v + tap], a GEMM of output channels x (27 *
// Cp) columns, tap-major, over a reduction of B * R^3 voxels in slices of
// 32 (two mma k-steps) that never straddle clouds. Both operands are
// staged voxel-major first (the staging pass: x with the prologue, and g),
// so a slice is gathered in 8-channel chunks of 16 bytes: a gradient chunk
// at the voxel, an input chunk at the voxel shifted by its column's tap
// (or zero outside the grid; a chunk lies in one tap). A block of 4 warps
// computes BM (64, or 32 where Co <= 32) output channels x 64 columns over
// a run of slices (its split); both slices sit in shared memory voxel
// rows by channel columns, padded by 16 bytes, and are read by
// ldmatrix.trans. Each split writes its f32 partial;
// conv3d_bf16_wgrad_sum_kernel adds the splits in order, rounds, and
// writes torch's [Co, Ci, 3, 3, 3] order. The wrapper picks the splits
// (pvcnn_tpu_torch/ops/conv3d.py: _wgrad_bf16_plan).
//
// Bound. Operations: 2 * Co * 27 * Ci per voxel (0.23 TFLOP for the 64 ->
// 64 layer at B = 32, R = 32) against 989 TFLOP/s of bf16 tensor cores;
// bytes: x, y (or g, dW) once, 2 bytes an element. Both kernels stage
// their operands through registers, one slice ahead, and run far from the
// tensor cores' rate (PERF.md). A later change can move the staging to
// TMA and the product to wgmma.
#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"

namespace {

using u16 = unsigned short;

constexpr int kThreads = 128;
constexpr int kTaps = 27;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPad = 8;     // shared-memory row padding, in bf16 (16 bytes)
constexpr int kBK = 16;     // K3: reduction slice
constexpr int kSpan = 64;   // K3: voxels of one warp (statistics slot)
constexpr int kWK = 32;     // K4: voxels per reduction slice

// flat offset of tap t (dx, dy, dz in -1..1) on an R^3 grid
__device__ __forceinline__ int tap_offset(int t, int R) {
  return ((t / 9 - 1) * R + (t / 3) % 3 - 1) * R + t % 3 - 1;
}

// bit t set where tap t of voxel v lies in the grid (0 for v >= R^3)
__device__ __forceinline__ unsigned tap_mask(int v, int R) {
  if (v >= R * R * R) return 0u;
  const int c[3] = {v / (R * R), (v / R) % R, v % R};
  unsigned ok[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {   // bit d: offset d - 1 stays in the grid
    ok[a] = (c[a] > 0 ? 1u : 0u) | 2u | (c[a] < R - 1 ? 4u : 0u);
  }
  unsigned m = 0u;
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    if ((ok[0] >> (t / 9)) & (ok[1] >> ((t / 3) % 3)) & (ok[2] >> (t % 3)) &
        1u) {
      m |= 1u << t;
    }
  }
  return m;
}

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8 x 8 b16 matrices; lanes 8j .. 8j + 7 address matrix j's rows
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the staging pass of K3 and K4's bf16 modes: x [B, C, R^3] channel-major
// -> xt [B, R^3, Cp] voxel-major, Cp = C rounded up to 16, channels C ..
// Cp - 1 zero; with the prologue each value is activated in f32 and
// rounded to bf16 (the JAX kernel stage's rounding). A thread writes 8
// channels of one voxel (16 bytes); neighbouring threads take neighbouring
// voxels, so each channel's reads are coalesced.
__global__ void __launch_bounds__(pvcnn::kThreads)
conv3d_bf16_stage_kernel(const u16* __restrict__ x,          // [B, C, R^3]
                         const float* __restrict__ pscale,   // [C] / null
                         const float* __restrict__ pshift,   // [C] / null
                         u16* __restrict__ xt,               // [B, R^3, Cp]
                         int C, int Cp, int R3, int64_t total) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (t >= total) return;                 // total = B * R^3 * Cp / 8
  const int groups = Cp / 8;
  const int v = static_cast<int>(t % R3);
  const int64_t rest = t / R3;
  const int c0 = static_cast<int>(rest % groups) * 8;
  const int64_t b = rest / groups;
  auto value = [&](int c) -> unsigned {
    if (c >= C) return 0u;
    const u16 raw = __ldg(x + (b * C + c) * R3 + v);
    if (pscale == nullptr) return raw;
    return float_to_bf16(activate(bf16_to_float(raw), __ldg(pscale + c),
                                  __ldg(pshift + c)));
  };
  uint4 out;
  out.x = value(c0) | (value(c0 + 1) << 16);
  out.y = value(c0 + 2) | (value(c0 + 3) << 16);
  out.z = value(c0 + 4) | (value(c0 + 5) << 16);
  out.w = value(c0 + 6) | (value(c0 + 7) << 16);
  *reinterpret_cast<uint4*>(xt + (b * R3 + v) * Cp + c0) = out;
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
conv3d_bf16_fwd_kernel(const u16* __restrict__ xt,       // [B, R^3, Cp]
                       const u16* __restrict__ w,        // [27 * Cp, Co]
                       const float* __restrict__ bias,   // [Co] / null
                       u16* __restrict__ y,              // [B, Co, R^3]
                       float* __restrict__ partial,  // [2, Co, B*spans]/null
                       int B, int Cp, int Co, int R) {
  constexpr int WM = BM / 32;                    // warps over channels
  constexpr int WN = 4 / WM;                     // warps over voxels
  constexpr int BN = kSpan * WN;                 // voxels per block
  constexpr int kCols = BN / kThreads;           // voxels per thread
  constexpr int kAVec = kBK * BM / kThreads;     // weights per thread
  using AVec = typename std::conditional<kAVec == 8, uint4, uint2>::type;
  __shared__ __align__(16) u16 As[2][kBK][BM + kPad];
  // a voxel's 16 channels of the slice, padded to 48 bytes a row
  __shared__ __align__(16) u16 Bs[2][BN][kBK + kPad];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wm = (tid >> 5) / WN;   // channels co0 + wm * 32 + {0..31}
  const int wn = (tid >> 5) % WN;   // voxels v0 + wn * 64 + {0..63}
  const int b = blockIdx.z;
  const int co0 = blockIdx.y * BM;
  const int v0 = blockIdx.x * BN;
  const int R3 = R * R * R;
  const int slices = Cp * kTaps / kBK;          // one tap each
  const u16* xb = xt + static_cast<int64_t>(b) * R3 * Cp;

  // this thread stages voxels v0 + tid + 128 q (their 16 channels of a
  // slice, two 16-byte loads), with their in-grid taps
  int col[kCols];
  unsigned mask[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    col[q] = v0 + tid + kThreads * q;
    mask[q] = tap_mask(col[q], R);
  }
  // and kAVec neighbouring weights of row ak of a slice
  const int ak = tid >> 3, am = (tid & 7) * kAVec;
  const bool a_vec = Co % kAVec == 0 && co0 + am + kAVec <= Co;

  AVec a_next;
  uint4 b_next[kCols][2];
  auto load_slice = [&](int k0) {
    const u16* wr = w + static_cast<int64_t>(k0 + ak) * Co + co0 + am;
    if (a_vec) {
      a_next = __ldg(reinterpret_cast<const AVec*>(wr));
    } else {                   // the ragged channel tile
      union {
        AVec v;
        u16 e[kAVec];
      } u;
#pragma unroll
      for (int i = 0; i < kAVec; ++i) {
        u.e[i] = co0 + am + i < Co ? __ldg(wr + i) : u16(0);
      }
      a_next = u.v;
    }
    const int tap = k0 / Cp;
    const int off = tap_offset(tap, R);
    const u16* src = xb + (k0 - tap * Cp);
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      if ((mask[q] >> tap) & 1u) {
        const uint4* p = reinterpret_cast<const uint4*>(
            src + static_cast<int64_t>(col[q] + off) * Cp);
        b_next[q][0] = __ldg(p);
        b_next[q][1] = __ldg(p + 1);
      } else {
        b_next[q][0] = b_next[q][1] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  auto store_slice = [&](int buf) {
    *reinterpret_cast<AVec*>(&As[buf][ak][am]) = a_next;
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      uint4* d = reinterpret_cast<uint4*>(&Bs[buf][tid + kThreads * q][0]);
      d[0] = b_next[q][0];
      d[1] = b_next[q][1];
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }

  // ldmatrix: lane 8j + r addresses row r of matrix j
  const int mat = lane >> 3, r8 = lane & 7;
  load_slice(0);
  store_slice(0);
  __syncthreads();
  for (int s = 0; s < slices; ++s) {
    const int cur = s & 1;
    if (s + 1 < slices) load_slice((s + 1) * kBK);
    unsigned a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // a0a1 a2a3 a4a5 a6a7: (m, k) 00 10 01 11
      ldmatrix_x4_trans(
          a[i], &As[cur][r8 + (mat >> 1) * 8][wm * 32 + i * 16 + (mat & 1) * 8]);
    }
#pragma unroll
    for (int j2 = 0; j2 < 4; ++j2) {   // n8 tiles 2 j2 and 2 j2 + 1
      unsigned bf[4];                  // (n, k) 00 01 10 11
      ldmatrix_x4(bf, &Bs[cur][wn * kSpan + j2 * 16 + (mat >> 1) * 8 + r8]
                         [(mat & 1) * 8]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_bf16(acc[i][2 * j2], a[i], bf[0], bf[1]);
        mma_bf16(acc[i][2 * j2 + 1], a[i], bf[2], bf[3]);
      }
    }
    // the other buffer was last read in slice s - 1, before the barrier
    // that ended it
    if (s + 1 < slices) store_slice(cur ^ 1);
    __syncthreads();
  }

  // epilogue: lane (g, t4) holds rows g, g + 8 of each 16-row tile and
  // columns 2 t4, 2 t4 + 1 of each 8-column tile
  const int g = lane >> 2, t4 = lane & 3;
  const int vw = v0 + wn * kSpan;              // this warp's 64-voxel span
  const int spans = (R3 + kSpan - 1) / kSpan;
  const int64_t slots = static_cast<int64_t>(B) * spans;
  const int slot = b * spans + vw / kSpan;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + wm * 32 + i * 16 + h * 8 + g;
      float s1 = 0.f, s2 = 0.f;
      if (co < Co) {
        const float bc = bias != nullptr ? __ldg(bias + co) : 0.f;
        u16* yrow = y + (static_cast<int64_t>(b) * Co + co) * R3;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int v = vw + j * 8 + t4 * 2;
          const float y0 = acc[i][j][2 * h] + bc;
          const float y1 = acc[i][j][2 * h + 1] + bc;
          if (v + 1 < R3 && (R3 & 1) == 0) {
            *reinterpret_cast<unsigned*>(yrow + v) =
                static_cast<unsigned>(float_to_bf16(y0)) |
                (static_cast<unsigned>(float_to_bf16(y1)) << 16);
          } else {
            if (v < R3) yrow[v] = float_to_bf16(y0);
            if (v + 1 < R3) yrow[v + 1] = float_to_bf16(y1);
          }
          if (v < R3) {
            s1 += y0;
            s2 = fmaf(y0, y0, s2);
          }
          if (v + 1 < R3) {
            s1 += y1;
            s2 = fmaf(y1, y1, s2);
          }
        }
      }
      if (partial != nullptr) {   // the 4 lanes of row g, in a fixed order
        s1 += __shfl_xor_sync(kFull, s1, 1);
        s2 += __shfl_xor_sync(kFull, s2, 1);
        s1 += __shfl_xor_sync(kFull, s1, 2);
        s2 += __shfl_xor_sync(kFull, s2, 2);
        if (t4 == 0 && co < Co && vw < R3) {
          partial[static_cast<int64_t>(co) * slots + slot] = s1;
          partial[(static_cast<int64_t>(Co) + co) * slots + slot] = s2;
        }
      }
    }
  }
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
conv3d_bf16_wgrad_kernel(const u16* __restrict__ xt,  // [B, R^3, Cp] a(x)
                         const u16* __restrict__ gt,  // [B, R^3, Cop]
                         float* __restrict__ partial,  // [S, Co, 27 * Cp]
                         int B, int Cp, int Cop, int Co, int R,
                         int per_split) {
  constexpr int BN = 64;                          // (tap, channel) columns
  constexpr int WTM = BM / 2;                     // warp tile WTM x 32
  constexpr int MT = WTM / 16;                    // 16-row tiles per warp
  constexpr int kAChunks = BM * kWK / 8 / kThreads;  // 8-channel loads
  constexpr int kBChunks = BN * kWK / 8 / kThreads;
  // voxel-major slices: a voxel's channels (columns) fastest, rows padded
  // by 16 bytes
  __shared__ __align__(16) u16 As[2][kWK][BM + kPad];
  __shared__ __align__(16) u16 Bs[2][kWK][BN + kPad];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * BN;
  const int co0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int R3 = R * R * R;
  const int N = Cp * kTaps;
  const int spc = (R3 + kWK - 1) / kWK;         // slices per cloud
  const int s_begin = split * per_split;
  const int s_end = min(B * spc, s_begin + per_split);

  // this thread's 8-channel chunks of a slice: gradient chunk (voxel
  // ak, channels co0 + am ..) and input chunk (voxel bk, columns bn ..);
  // an input chunk lies in one tap (Cp % 16 == 0), fixed for the block
  int ak[kAChunks], am[kAChunks], bk[kBChunks], boff[kBChunks];
  int bd[kBChunks][3];   // the chunk's tap as offsets -1..1 on x, y, z
  bool bvalid[kBChunks];
#pragma unroll
  for (int i = 0; i < kAChunks; ++i) {
    const int e = tid + kThreads * i;
    ak[i] = e / (BM / 8);
    am[i] = e % (BM / 8) * 8;
  }
#pragma unroll
  for (int i = 0; i < kBChunks; ++i) {
    const int e = tid + kThreads * i;
    bk[i] = e / (BN / 8);
    const int n = n0 + e % (BN / 8) * 8;
    const int tap = n / Cp;
    bvalid[i] = n < N;
    bd[i][0] = tap / 9 - 1;
    bd[i][1] = tap / 3 % 3 - 1;
    bd[i][2] = tap % 3 - 1;
    boff[i] = bvalid[i] ? tap_offset(tap, R) * Cp + (n - tap * Cp) : 0;
  }

  uint4 a_next[kAChunks], b_next[kBChunks];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  auto load_slice = [&](int s) {
    const int cb = s / spc;
    const int v0 = (s - cb * spc) * kWK;
    const u16* gb = gt + static_cast<int64_t>(cb) * R3 * Cop;
    const u16* xb = xt + static_cast<int64_t>(cb) * R3 * Cp;
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      const int v = v0 + ak[i];
      a_next[i] = (v < R3 && co0 + am[i] < Cop)
                      ? __ldg(reinterpret_cast<const uint4*>(
                            gb + static_cast<int64_t>(v) * Cop + co0 + am[i]))
                      : zero;
    }
#pragma unroll
    for (int i = 0; i < kBChunks; ++i) {
      const int v = v0 + bk[i];
      const int px = v / (R * R) + bd[i][0];
      const int py = v / R % R + bd[i][1];
      const int pz = v % R + bd[i][2];
      const bool in = bvalid[i] && v < R3 && px >= 0 && px < R && py >= 0 &&
                      py < R && pz >= 0 && pz < R;
      b_next[i] = in ? __ldg(reinterpret_cast<const uint4*>(
                           xb + static_cast<int64_t>(v) * Cp + boff[i]))
                     : zero;
    }
  };

  auto store_slice = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kAChunks; ++i) {
      *reinterpret_cast<uint4*>(&As[buf][ak[i]][am[i]]) = a_next[i];
    }
#pragma unroll
    for (int i = 0; i < kBChunks; ++i) {
      *reinterpret_cast<uint4*>(
          &Bs[buf][bk[i]][(tid + kThreads * i) % (BN / 8) * 8]) = b_next[i];
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }

  const int mat = lane >> 3, r8 = lane & 7;
  if (s_begin < s_end) {
    load_slice(s_begin);
    store_slice(0);
  }
  __syncthreads();
  for (int s = s_begin; s < s_end; ++s) {
    const int cur = (s - s_begin) & 1;
    if (s + 1 < s_end) load_slice(s + 1);
#pragma unroll
    for (int kk = 0; kk < kWK; kk += 16) {
      unsigned a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {   // (m, k) 00 10 01 11
        ldmatrix_x4_trans(a[i], &As[cur][kk + (mat >> 1) * 8 + r8]
                                   [wm * WTM + i * 16 + (mat & 1) * 8]);
      }
#pragma unroll
      for (int j2 = 0; j2 < 2; ++j2) {   // n8 tiles 2 j2 and 2 j2 + 1
        unsigned bf[4];                  // (k, n) 00 10 01 11
        ldmatrix_x4_trans(bf, &Bs[cur][kk + (mat & 1) * 8 + r8]
                                 [wn * 32 + j2 * 16 + (mat >> 1) * 8]);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][2 * j2], a[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * j2 + 1], a[i], bf[2], bf[3]);
        }
      }
    }
    if (s + 1 < s_end) store_slice(cur ^ 1);
    __syncthreads();
  }

  // this split's partial dW, columns (tap, channel) tap-major, every entry
  // of the block's tile (zeros for a split without slices)
  const int gq = lane >> 2, t4 = lane & 3;
  float* out = partial + static_cast<int64_t>(split) * Co * N;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + wm * WTM + i * 16 + h * 8 + gq;
      if (co >= Co) continue;
      float* row = out + static_cast<int64_t>(co) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + t4 * 2;
        if (n < N) row[n] = acc[i][j][2 * h];
        if (n + 1 < N) row[n + 1] = acc[i][j][2 * h + 1];
      }
    }
  }
}

// dW[co, ci, tap] = bf16(the sum of the splits' partials at column
// tap * Cp + ci, in split order), in torch's [Co, Ci, 3, 3, 3] order
__global__ void __launch_bounds__(pvcnn::kThreads)
conv3d_bf16_wgrad_sum_kernel(const float* __restrict__ partial,
                             u16* __restrict__ dw,  // [Co, Ci * 27]
                             int Co, int Ci, int Cp, int splits) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  const int64_t n = static_cast<int64_t>(Co) * Ci * kTaps;
  if (i >= n) return;
  const int tap = static_cast<int>(i % kTaps);
  const int64_t rest = i / kTaps;
  const int ci = static_cast<int>(rest % Ci);
  const int64_t co = rest / Ci;
  const int64_t stride = static_cast<int64_t>(Co) * Cp * kTaps;
  const int64_t at = co * Cp * kTaps + tap * Cp + ci;
  float sum = __ldg(partial + at);
  for (int s = 1; s < splits; ++s) sum += __ldg(partial + s * stride + at);
  dw[i] = float_to_bf16(sum);
}

template <int BM>
int launch_fwd(const u16* xt, const u16* w, const float* bias, u16* y,
               float* partial, int B, int Cp, int Co, int R,
               cudaStream_t stream) {
  constexpr int BN = kSpan * 4 / (BM / 32);
  const int64_t r3 = static_cast<int64_t>(R) * R * R;
  const dim3 grid(static_cast<unsigned>((r3 + BN - 1) / BN),
                  static_cast<unsigned>((Co + BM - 1) / BM),
                  static_cast<unsigned>(B));
  conv3d_bf16_fwd_kernel<BM><<<grid, kThreads, 0, stream>>>(
      xt, w, bias, y, partial, B, Cp, Co, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3 in bf16: x [B, Ci, R^3] and y bf16; w [27 * Cp, Co] bf16, tap-major,
// Cp = Ci rounded up to 16 (the rows of channels Ci .. Cp - 1 zero); xt a
// bf16 buffer [B, R^3, Cp] for the staged input; bias f32 or null (the
// data gradient); with pscale/pshift (f32) the stage applies the
// prologue; partial (f32 [2, Co, B * ceil(R^3 / 64)]) or null: the
// statistics slots
PVCNN_EXPORT int pvcnn_conv3d_bf16_fwd(const void* x, const void* w,
                                       const void* bias, const void* pscale,
                                       const void* pshift, void* xt,
                                       void* y, void* partial, int B, int Ci,
                                       int Co, int R, void* stream) {
  if (B == 0 || R == 0 || Co == 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const int r3 = R * R * R;
  const int cp = (Ci + kBK - 1) / kBK * kBK;
  auto* xs = static_cast<u16*>(xt);
  const int64_t total = static_cast<int64_t>(B) * r3 * (cp / 8);
  conv3d_bf16_stage_kernel<<<pvcnn::blocks_for(total), pvcnn::kThreads, 0,
                             st>>>(
      static_cast<const u16*>(x), static_cast<const float*>(pscale),
      static_cast<const float*>(pshift), xs, Ci, cp, r3, total);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const auto* wb = static_cast<const u16*>(w);
  const auto* bf = static_cast<const float*>(bias);
  auto* yb = static_cast<u16*>(y);
  auto* pf = static_cast<float*>(partial);
  return Co <= 32 ? launch_fwd<32>(xs, wb, bf, yb, pf, B, cp, Co, R, st)
                  : launch_fwd<64>(xs, wb, bf, yb, pf, B, cp, Co, R, st);
}

// K4 in bf16: x [B, Ci, R^3] and g [B, Co, R^3] bf16, dw [Co, Ci * 27]
// bf16; xt [B, R^3, Cp] and gt [B, R^3, Cop] bf16 buffers for the staged
// operands (Cp, Cop: Ci, Co rounded up to 16); partial f32 [splits, Co,
// 27 * Cp]; the reduction's B * ceil(R^3 / 32) slices go to splits runs of
// per_split; with pscale/pshift the stage applies the prologue to x
PVCNN_EXPORT int pvcnn_conv3d_bf16_wgrad(const void* x, const void* g,
                                         const void* pscale,
                                         const void* pshift, void* xt,
                                         void* gt, void* partial, void* dw,
                                         int B, int Ci, int Co, int R,
                                         int splits, int per_split,
                                         void* stream) {
  if (Co == 0 || Ci == 0) return 0;
  if (splits < 1 || per_split < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const int r3 = R * R * R;
  const int cp = (Ci + kBK - 1) / kBK * kBK;
  const int cop = (Co + kBK - 1) / kBK * kBK;
  auto* xs = static_cast<u16*>(xt);
  auto* gs = static_cast<u16*>(gt);
  int64_t total = static_cast<int64_t>(B) * r3 * (cp / 8);
  if (total > 0) {
    conv3d_bf16_stage_kernel<<<pvcnn::blocks_for(total), pvcnn::kThreads,
                               0, st>>>(
        static_cast<const u16*>(x), static_cast<const float*>(pscale),
        static_cast<const float*>(pshift), xs, Ci, cp, r3, total);
  }
  total = static_cast<int64_t>(B) * r3 * (cop / 8);
  if (total > 0) {
    conv3d_bf16_stage_kernel<<<pvcnn::blocks_for(total), pvcnn::kThreads,
                               0, st>>>(static_cast<const u16*>(g), nullptr,
                                        nullptr, gs, Co, cop, r3, total);
  }
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  auto* pf = static_cast<float*>(partial);
  const unsigned nt = static_cast<unsigned>((cp * kTaps + 63) / 64);
  if (Co <= 32) {
    const dim3 grid(nt, static_cast<unsigned>((Co + 31) / 32),
                    static_cast<unsigned>(splits));
    conv3d_bf16_wgrad_kernel<32><<<grid, kThreads, 0, st>>>(
        xs, gs, pf, B, cp, cop, Co, R, per_split);
  } else {
    const dim3 grid(nt, static_cast<unsigned>((Co + 63) / 64),
                    static_cast<unsigned>(splits));
    conv3d_bf16_wgrad_kernel<64><<<grid, kThreads, 0, st>>>(
        xs, gs, pf, B, cp, cop, Co, R, per_split);
  }
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const int64_t n = static_cast<int64_t>(Co) * Ci * kTaps;
  conv3d_bf16_wgrad_sum_kernel<<<pvcnn::blocks_for(n), pvcnn::kThreads, 0,
                                 st>>>(pf, static_cast<u16*>(dw), Co, Ci, cp,
                                       splits);
  return static_cast<int>(cudaGetLastError());
}
