// K3: fused 3x3x3 conv3d forward on flat voxel rows.
//
// Replaces the TPU kernel pvcnn_tpu/ops/pallas/conv_rows.py:_run_fwd_act
// (kernel body _fwd_act_kernel), the PVConv voxel branch's
// prologue -> conv -> +bias, and serves _run_fwd's forward (no prologue).
//
//   y[b, co, v] = bias[co] + sum_{tap, ci} w[tap, ci, co] * a(x[b, ci, v + tap])
//   a(x) = leaky(x * scale[ci] + shift[ci], 0.1)   with the prologue, else x
//
// Out-of-grid taps read 0 AFTER the activation (zero padding of the
// activated tensor, as torch Conv3d(padding=1) on it): leaky(0*s + t) != 0,
// so the prologue is applied to in-grid values only (the TPU kernel
// re-zeroes its pad columns for the same reason, conv_rows.py:_stage_act).
// The prologue runs once per input element, in a pass that writes the
// activated input to a buffer like x (csrc/prologue.cuh), which the
// conv then reads: applied while staging, it would run once per element,
// tap and output-channel tile (27 times or more), which cost the prologue
// cases 12-21% of their time on the H100, more than the pass's 2|x| bytes.
//
// BN-statistics epilogue (training): with a `partial` buffer, each warp
// also reduces its 128-voxel span of the BIASED y to per-channel sum and
// sum of squares over its in-range voxels (out-of-range columns, vo >= R^3,
// stay out) and writes them to partial[2][Co][B * ceil(R^3 / 128)] at the
// slot of (cloud, 128-voxel tile). The caller sums the slots in a fixed
// order, so the statistics are reproducible bit for bit (no atomics). The
// reduction is a lane-local sum of the 4 voxels, then a butterfly over the
// warp's 32 lanes.
//
// The same kernel, without prologue and with a zero bias, is the conv's
// data gradient (pvcnn_tpu/ops/pallas/conv_rows.py:_run_fwd as _act_bwd runs
// it): dx = conv(dy, W flipped over the three spatial axes, Ci <-> Co).
//
// Design. An implicit GEMM in fp32 on the CUDA cores. A block of 4 warps
// computes 16 * WM output channels x 128 * WN voxels of one cloud (WM * WN =
// 4): each warp owns 16 output channels and a 128-voxel span, each lane 4
// neighbouring voxels (a 16 x 4 accumulator tile), so per reduction step
// the weights are four float4 shared-memory reads that all lanes of a warp
// share (broadcast) and the inputs one float4 per lane: 64 FMAs against
// about 8 shared-memory wavefronts. (4 x 8 and 8 x 8 thread tiles spread
// over both axes of the warp were tried first and measured slower.) The
// tile follows Co: 64 x 128 (WM = 4), and 32 x 256 (WM = 2) where Co <= 32,
// so that no half of the block multiplies zero weights. The reduction runs
// over K = 27 * Ci in slices of 16, tap-major: the weight arrives as
// [27 * Ci, Co], the JAX kernel layout [k, k, k, Ci, Co] flattened. Each
// thread stages WN im2col columns, with a 27-bit mask of the taps that lie
// in the grid for each, computed once. When Ci % 16 == 0 a slice is 16
// channels of ONE tap (the kAligned instantiation): one mask test and one
// address per column and slice. Else a table in shared memory holds each
// reduction index's (channel, tap) and offset for up to kTabSlices slices,
// so a slice's 16 entries cost a broadcast read and a mask test each (the
// first layers, Ci = 6 or 9, fit one table of 2 KB; a Ci above 37 rebuilds
// it every kTabSlices slices, behind one more barrier). Each slice's weight
// block and im2col block go through two shared-memory buffers: the next
// slice is loaded into registers while the current one is multiplied, one
// barrier per slice. fp32 accumulation, no TF32: the kernel is held to
// torch's F.conv3d in fp32.
//
// Split reduction. Where a grid of blocks fills less than 2 waves of the
// card (R = 8: 4 voxel tiles per cloud), the wrapper splits the slices over
// `splits` blocks per tile (pvcnn_tpu_torch/ops/conv3d.py:_fwd_plan). Each
// writes its partial sums, without bias, to ypart[split][b][co][v]; a
// second kernel sums the splits in order, adds the bias and writes y and
// the statistics slots as above. Reproducible bit for bit.
//
// Bound. Compute: 2 * Co * 27 * Ci FLOPs per voxel (0.23 TFLOP for the
// 64->64 layer at B=32, R=32) against 67 TFLOP/s of fp32 FMA; the input
// block is re-read from L2 for each of its 27 taps. A later PR can move the
// product to the tensor cores and the staging to cp.async/TMA.
#include "prologue.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSpan = 128;  // voxels of one warp (32 lanes x 4)
constexpr int kBK = 16;     // reduction slice
constexpr int kTaps = 27;   // 3x3x3
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoTap = 31;  // a table entry past K: no mask has bit 31
constexpr int kTabSlices = 64;   // reduction slices of one table, at most

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

template <int WM, bool kAligned>
__global__ void __launch_bounds__(kThreads, 3)
conv3d_fwd_kernel(const float* __restrict__ x,       // [B, Ci, R^3]
                  const float* __restrict__ w,       // [27 * Ci, Co]
                  const float* __restrict__ bias,    // [Co]
                  float* __restrict__ y,             // [B, Co, R^3]
                  float* __restrict__ partial,  // [2, Co, B*tiles] / null
                  float* __restrict__ ypart,    // [S, B, Co, R^3] / null
                  int B, int Ci, int Co, int R, int splits) {
  constexpr int WN = 4 / WM;
  constexpr int kBM = 16 * WM;      // output channels per block
  constexpr int kBN = kSpan * WN;   // voxels per block
  constexpr int kAPer = kBK * kBM / kThreads;   // weights staged per thread
  __shared__ __align__(16) float As[2][kBK][kBM];
  __shared__ __align__(16) float Bs[2][kBK][kBN];
  // dynamic, where !kAligned: the reduction table of min(slices,
  // kTabSlices) slices, (channel * R^3 + tap offset, tap) of each reduction
  // index
  extern __shared__ int2 s_tab[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wm = (tid >> 5) / WN;   // output channels wm*16 + {0..15}
  const int wn = (tid >> 5) % WN;   // voxels wn*128 + lane*4 + {0..3}
  const int b = blockIdx.z / splits;
  const int split = blockIdx.z % splits;
  const int co0 = blockIdx.y * kBM;
  const int v0 = blockIdx.x * kBN;
  const int R3 = R * R * R;
  const int K = Ci * kTaps;
  const int slices = (K + kBK - 1) / kBK;
  const float* xb = x + static_cast<int64_t>(b) * Ci * R3;

  // this thread stages im2col columns v0 + tid + 128 q (all 16 rows of a
  // slice), with their in-grid taps
  int col[WN];
  unsigned mask[WN];
#pragma unroll
  for (int q = 0; q < WN; ++q) {
    col[q] = v0 + tid + kThreads * q;
    mask[q] = tap_mask(col[q], R);
  }

  // the table of slices s0 .. s0 + kTabSlices - 1 (s0 a multiple of
  // kTabSlices), or of all slices
  auto build_table = [&](int s0) {
    for (int e = tid; e < min(slices, kTabSlices) * kBK; e += kThreads) {
      const int k = s0 * kBK + e;
      const int tap = k / Ci, ci = k - tap * Ci;
      s_tab[e] = k < K ? make_int2(ci * R3 + tap_offset(tap, R), tap)
                       : make_int2(0, kNoTap);
    }
  };

  // the next slice in registers: weights and input values (0 outside the
  // grid: zero padding of the activated input)
  float a_next[kAPer], b_next[WN][16];

  auto load_slice = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int e = tid + i * kThreads;
      const int k = k0 + e / kBM;
      const int co = co0 + e % kBM;
      a_next[i] = (k < K && co < Co)
                      ? __ldg(w + static_cast<int64_t>(k) * Co + co) : 0.f;
    }
    if (kAligned) {            // one tap, channels ci0 .. ci0 + 15
      const int tap = k0 / Ci;
      const int off = tap_offset(tap, R);
#pragma unroll
      for (int q = 0; q < WN; ++q) {
        const bool in = (mask[q] >> tap) & 1u;
        const float* src =
            xb + static_cast<int64_t>(k0 - tap * Ci) * R3 + col[q] + off;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          b_next[q][i] = in ? __ldg(src + static_cast<int64_t>(i) * R3) : 0.f;
        }
      }
    } else {                   // a slice may span taps: the table
      const int t0 = k0 % (kTabSlices * kBK);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int2 e = s_tab[t0 + i];
#pragma unroll
        for (int q = 0; q < WN; ++q) {
          b_next[q][i] =
              (mask[q] >> e.y) & 1u ? __ldg(xb + col[q] + e.x) : 0.f;
        }
      }
    }
  };

  auto store_slice = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int e = tid + i * kThreads;
      As[buf][e / kBM][e % kBM] = a_next[i];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int q = 0; q < WN; ++q) {
        Bs[buf][i][tid + kThreads * q] = b_next[q][i];
      }
    }
  };

  float acc[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  // this block's slices of the reduction
  const int per_split = (slices + splits - 1) / splits;
  const int s_begin = split * per_split;
  const int s_end = min(slices, s_begin + per_split);
  if (!kAligned) {
    build_table(s_begin / kTabSlices * kTabSlices);
    __syncthreads();
  }
  if (s_begin < s_end) {
    load_slice(s_begin * kBK);
    store_slice(0);
    __syncthreads();
  }
  for (int s = s_begin; s < s_end; ++s) {
    const int cur = (s - s_begin) & 1;
    if (!kAligned && s + 1 < s_end && (s + 1) % kTabSlices == 0) {
      // every read of the old table (load_slice(s)) ended before the
      // barrier that ended slice s - 1
      build_table(s + 1);
      __syncthreads();
    }
    if (s + 1 < s_end) load_slice((s + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(
          &Bs[cur][kk][wn * kSpan + lane * 4]);
      const float bv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 a = *reinterpret_cast<const float4*>(
            &As[cur][kk][wm * 16 + g * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[g * 4 + i][j] = fmaf(av[i], bv[j], acc[g * 4 + i][j]);
          }
        }
      }
    }
    // the other buffer was last read in slice s - 1, before the barrier
    // that ended it
    if (s + 1 < s_end) store_slice(cur ^ 1);
    __syncthreads();
  }

  const int vw = v0 + wn * kSpan;        // this warp's 128-voxel span
  if (splits > 1) {                      // partial sums, no bias
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int co = co0 + wm * 16 + i;
      if (co >= Co) continue;
      float* row =
          ypart + ((static_cast<int64_t>(split) * B + b) * Co + co) * R3;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int vo = vw + lane * 4 + j;
        if (vo < R3) row[vo] = acc[i][j];
      }
    }
    return;
  }

  // the statistics slot of this warp: (cloud, 128-voxel tile)
  const int tiles = (R3 + kSpan - 1) / kSpan;
  const int slot = b * tiles + vw / kSpan;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int co = co0 + wm * 16 + i;   // uniform over the warp
    if (co >= Co) continue;
    const float bc = __ldg(bias + co);
    float* yrow = y + (static_cast<int64_t>(b) * Co + co) * R3;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int vo = vw + lane * 4 + j;
      if (vo < R3) {
        const float val = acc[i][j] + bc;
        yrow[vo] = val;
        s1 += val;
        s2 = fmaf(val, val, s2);
      }
    }
    if (partial != nullptr && vw < R3) {
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
        s1 += __shfl_xor_sync(kFull, s1, m);
        s2 += __shfl_xor_sync(kFull, s2, m);
      }
      if (lane == 0) {
        partial[static_cast<int64_t>(co) * B * tiles + slot] = s1;
        partial[(static_cast<int64_t>(Co) + co) * B * tiles + slot] = s2;
      }
    }
  }
}

// the split reduction's second pass: a warp per (cloud, channel, 128-voxel
// tile) sums the splits in order, adds the bias, writes y and the
// statistics slot as conv3d_fwd_kernel's epilogue does
__global__ void __launch_bounds__(kThreads)
conv3d_split_sum_kernel(const float* __restrict__ ypart,  // [S, B, Co, R^3]
                        const float* __restrict__ bias,   // [Co]
                        float* __restrict__ y,            // [B, Co, R^3]
                        float* __restrict__ partial,  // [2, Co, B*tiles]/null
                        int B, int Co, int R3, int splits) {
  const int tiles = (R3 + kSpan - 1) / kSpan;
  const int64_t warp =
      (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  if (warp >= static_cast<int64_t>(B) * Co * tiles) return;
  const int lane = threadIdx.x & 31;
  const int tile = static_cast<int>(warp % tiles);
  const int64_t bco = warp / tiles;               // b * Co + co
  const int co = static_cast<int>(bco % Co);
  const int b = static_cast<int>(bco / Co);
  const int64_t plane = static_cast<int64_t>(B) * Co * R3;
  const float bc = __ldg(bias + co);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int vo = tile * kSpan + lane * 4 + j;
    if (vo < R3) {
      const int64_t at = bco * R3 + vo;
      float sum = __ldg(ypart + at);
      for (int s = 1; s < splits; ++s) sum += __ldg(ypart + s * plane + at);
      const float val = sum + bc;
      y[at] = val;
      s1 += val;
      s2 = fmaf(val, val, s2);
    }
  }
  if (partial != nullptr) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      s1 += __shfl_xor_sync(kFull, s1, m);
      s2 += __shfl_xor_sync(kFull, s2, m);
    }
    if (lane == 0) {
      const int slot = b * tiles + tile;
      partial[static_cast<int64_t>(co) * B * tiles + slot] = s1;
      partial[(static_cast<int64_t>(Co) + co) * B * tiles + slot] = s2;
    }
  }
}

struct Args {
  const float *x, *w, *bias;
  float *y, *partial, *ypart;
  int B, Ci, Co, R, splits;
  cudaStream_t stream;
};

template <int WM, bool kAligned>
int launch(const Args& a) {
  constexpr int kBM = 16 * WM, kBN = kSpan * (4 / WM);
  const int64_t r3 = static_cast<int64_t>(a.R) * a.R * a.R;
  const int slices = (kTaps * a.Ci + kBK - 1) / kBK;
  const size_t dyn = kAligned ? 0 : sizeof(int2) * kBK *
                                        (slices < kTabSlices ? slices
                                                             : kTabSlices);
  auto* kernel = conv3d_fwd_kernel<WM, kAligned>;
  const dim3 grid(static_cast<unsigned>((r3 + kBN - 1) / kBN),
                  static_cast<unsigned>((a.Co + kBM - 1) / kBM),
                  static_cast<unsigned>(a.B * a.splits));
  kernel<<<grid, kThreads, dyn, a.stream>>>(a.x, a.w, a.bias, a.y,
                                            a.partial, a.ypart, a.B, a.Ci,
                                            a.Co, a.R, a.splits);
  return static_cast<int>(cudaGetLastError());
}

template <int WM>
int launch_for(const Args& a) {
  return a.Ci % kBK == 0 ? launch<WM, true>(a) : launch<WM, false>(a);
}

}  // namespace

// xact (with pscale/pshift): a buffer like x for the activated input, which
// the prologue writes first; wm: 2 (a 32 x 256 tile, Co <= 32) or 4 (64 x
// 128); splits > 1 with a ypart buffer [splits, B, Co, R^3]: the split
// reduction
PVCNN_EXPORT int pvcnn_conv3d_fwd(const void* x, const void* w,
                                  const void* bias, const void* pscale,
                                  const void* pshift, void* xact, void* y,
                                  void* partial, void* ypart, int B, int Ci,
                                  int Co, int R, int wm, int splits,
                                  void* stream) {
  if (B == 0 || R == 0 || Co == 0) return 0;
  if ((wm != 2 && wm != 4) || splits < 1 || (splits > 1 && !ypart)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const int r3 = R * R * R;
  const auto* xf = static_cast<const float*>(x);
  if (xact != nullptr) {
    auto* xa = static_cast<float*>(xact);
    const int err = pvcnn::launch_conv3d_prologue(
        xf, static_cast<const float*>(pscale),
        static_cast<const float*>(pshift), xa, B, Ci, r3, st);
    if (err != 0) return err;
    xf = xa;
  }
  const Args a{xf, static_cast<const float*>(w),
               static_cast<const float*>(bias), static_cast<float*>(y),
               static_cast<float*>(partial), static_cast<float*>(ypart),
               B, Ci, Co, R, splits, st};
  const int err = wm == 2 ? launch_for<2>(a) : launch_for<4>(a);
  if (err != 0 || splits == 1) return err;
  const int64_t warps =
      static_cast<int64_t>(B) * Co * ((r3 + kSpan - 1) / kSpan);
  conv3d_split_sum_kernel<<<pvcnn::blocks_for(warps * 32, kThreads), kThreads,
                            0, a.stream>>>(a.ypart, a.bias, a.y, a.partial, B,
                                           Co, r3, splits);
  return static_cast<int>(cudaGetLastError());
}
