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
// so the prologue is applied to in-grid taps only (the TPU kernel re-zeroes
// its pad columns for the same reason, conv_rows.py:_stage_act).
//
// BN-statistics epilogue (training): with a `partial` buffer, each block
// also reduces its tile of the BIASED y to per-channel sum and sum of
// squares over its in-range voxels (out-of-range columns, vo >= R^3, stay
// out) and writes them to partial[2][Co][B * voxel_tiles] at its own slot.
// The caller sums the slots in a fixed order, so the statistics are
// reproducible bit for bit (no atomics). The reduction is a lane-local sum
// of the 4 voxels, then a butterfly over the warp's 32 lanes.
//
// The same kernel, without prologue and with a zero bias, is the conv's
// data gradient (pvcnn_tpu/ops/pallas/conv_rows.py:_run_fwd as _act_bwd runs
// it): dx = conv(dy, W flipped over the three spatial axes, Ci <-> Co).
//
// Design. An implicit GEMM in fp32 on the CUDA cores. The output tile of a
// block is 64 output channels x 128 voxels of one cloud; each of its 4
// warps owns 16 output channels and each lane 4 neighbouring voxels (a
// 16 x 4 accumulator tile), so per reduction step the weights are four
// float4 shared-memory reads that all lanes of a warp share (broadcast) and
// the inputs one float4 per lane: 64 FMAs against about 8 shared-memory
// wavefronts. (4 x 8 and 8 x 8 tiles spread over both axes of the warp were
// tried first and measured slower.) The reduction runs over K = 27 * Ci in
// slices of 16, tap-major: the weight arrives as [27 * Ci, Co], the JAX
// kernel layout [k, k, k, Ci, Co] flattened. When Ci % 16 == 0 a slice is 16
// channels of ONE tap, so a thread tests its voxel's tap bounds and forms
// its address once per slice (the kAligned instantiation). Each slice's
// weight block and im2col block go through two shared-memory buffers: the
// next slice is loaded into registers while the current one is multiplied,
// one barrier per slice. The prologue is applied when those registers are
// stored to shared memory, after the multiply, with scale/shift in shared
// memory (float4 reads in the kAligned path: 32 scalar reads per slice cost
// the prologue cases about 15% of their time); activated values are never
// written back to device memory. fp32 accumulation, no TF32: the kernel is
// held to torch's F.conv3d in fp32.
//
// Bound. Compute: 2 * Co * 27 * Ci FLOPs per voxel (0.23 TFLOP for the
// 64->64 layer at B=32, R=32) against 67 TFLOP/s of fp32 FMA; the input
// block is re-read from L2 for each of its 27 taps. A later PR can move the
// product to the tensor cores and the staging to cp.async/TMA.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBM = 64;    // output channels per block
constexpr int kBN = 128;   // voxels per block (one per staging thread)
constexpr int kBK = 16;    // reduction slice
constexpr int kTaps = 27;  // 3x3x3

__device__ __forceinline__ bool tap_in_grid(int vx, int vy, int vz, int tap,
                                            int R, int* offset) {
  const int nx = vx + tap / 9 - 1;
  const int ny = vy + (tap / 3) % 3 - 1;
  const int nz = vz + tap % 3 - 1;
  *offset = (nx * R + ny) * R + nz;
  return static_cast<unsigned>(nx) < static_cast<unsigned>(R) &&
         static_cast<unsigned>(ny) < static_cast<unsigned>(R) &&
         static_cast<unsigned>(nz) < static_cast<unsigned>(R);
}

// leaky(x * s + t, 0.1) with the prologue, else x. No fused multiply-add:
// the same two roundings as the plain version's x * s + t.
template <bool kPrologue>
__device__ __forceinline__ float activate(float x, float s, float t) {
  if (!kPrologue) return x;
  const float y = __fadd_rn(__fmul_rn(x, s), t);
  return y > 0.f ? y : __fmul_rn(0.1f, y);
}

template <bool kAligned, bool kPrologue>
__global__ void __launch_bounds__(kThreads, 3)
conv3d_fwd_kernel(const float* __restrict__ x,       // [B, Ci, R^3]
                  const float* __restrict__ w,       // [27 * Ci, Co]
                  const float* __restrict__ bias,    // [Co]
                  const float* __restrict__ pscale,  // [Ci] (kPrologue)
                  const float* __restrict__ pshift,  // [Ci] (kPrologue)
                  float* __restrict__ y,             // [B, Co, R^3]
                  float* __restrict__ partial,       // [2, Co, B*tiles] or null
                  int Ci, int Co, int R) {
  __shared__ __align__(16) float As[2][kBK][kBM];
  __shared__ __align__(16) float Bs[2][kBK][kBN];
  extern __shared__ __align__(16) float s_pro[];  // [2 * Ci]: scale, shift

  const int tid = threadIdx.x;
  const int lane = tid & 31;  // voxels lane*4 + {0..3}
  const int warp = tid >> 5;  // output channels warp*16 + {0..15}
  const int b = blockIdx.z;
  const int co0 = blockIdx.y * kBM;
  const int v0 = blockIdx.x * kBN;
  const int R3 = R * R * R;
  const int K = Ci * kTaps;
  const float* xb = x + static_cast<int64_t>(b) * Ci * R3;

  // this thread stages im2col column v (all 16 rows of a slice)
  const int v = v0 + tid;
  const bool v_ok = v < R3;
  int vx = 0, vy = 0, vz = 0;
  if (v_ok) {
    vx = v / (R * R);
    vy = (v / R) % R;
    vz = v % R;
  }

  if (kPrologue) {
    for (int i = tid; i < Ci; i += kThreads) {
      s_pro[i] = __ldg(pscale + i);
      s_pro[Ci + i] = __ldg(pshift + i);
    }
    __syncthreads();
  }

  // the next slice in registers: weights, raw input values, and where each
  // input value came from (its channel, or -1 outside the grid / past K)
  float a_next[8], b_next[16];
  int b_ci[kAligned ? 1 : 16];    // kAligned: the slice's first channel
  bool next_in = false;           // kAligned: the slice's tap is in the grid

  auto load_slice = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = tid + i * kThreads;
      const int k = k0 + e / kBM;
      const int co = co0 + (e & (kBM - 1));
      a_next[i] = (k < K && co < Co) ? __ldg(w + static_cast<int64_t>(k) * Co + co)
                                     : 0.f;
    }
    if (kAligned) {            // one tap, channels ci0 .. ci0 + 15
      const int tap = k0 / Ci;
      const int ci0 = k0 - tap * Ci;
      int off;
      next_in = v_ok && tap_in_grid(vx, vy, vz, tap, R, &off);
      b_ci[0] = ci0;
      const float* src = xb + static_cast<int64_t>(ci0) * R3 + off;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        b_next[i] = next_in ? __ldg(src + static_cast<int64_t>(i) * R3) : 0.f;
      }
    } else {                   // a slice may span two taps
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int k = k0 + i;
        const int tap = k / Ci;
        const int ci = k - tap * Ci;
        int off;
        const bool ok = v_ok && k < K && tap_in_grid(vx, vy, vz, tap, R, &off);
        b_next[i] = ok ? __ldg(xb + static_cast<int64_t>(ci) * R3 + off) : 0.f;
        b_ci[kAligned ? 0 : i] = ok ? ci : -1;
      }
    }
  };

  auto store_slice = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = tid + i * kThreads;
      As[buf][e / kBM][e & (kBM - 1)] = a_next[i];
    }
    // out of the grid (next_in false, ci < 0): zero padding of the
    // ACTIVATED input
    if (kAligned) {            // channels b_ci[0] .. + 15: float4 scale/shift
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float4 sc = make_float4(1.f, 1.f, 1.f, 1.f);
        float4 sh = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kPrologue) {
          sc = *reinterpret_cast<const float4*>(&s_pro[b_ci[0] + 4 * q]);
          sh = *reinterpret_cast<const float4*>(&s_pro[Ci + b_ci[0] + 4 * q]);
        }
        const float s4[4] = {sc.x, sc.y, sc.z, sc.w};
        const float t4[4] = {sh.x, sh.y, sh.z, sh.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Bs[buf][4 * q + j][tid] =
              next_in ? activate<kPrologue>(b_next[4 * q + j], s4[j], t4[j]) : 0.f;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int ci = b_ci[kAligned ? 0 : i];
        Bs[buf][i][tid] = ci < 0 ? 0.f
            : (kPrologue ? activate<true>(b_next[i], s_pro[ci], s_pro[Ci + ci])
                         : b_next[i]);
      }
    }
  };

  float acc[16][4];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  const int slices = (K + kBK - 1) / kBK;
  load_slice(0);
  store_slice(0);
  __syncthreads();
  for (int s = 0; s < slices; ++s) {
    const int cur = s & 1;
    if (s + 1 < slices) load_slice((s + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(&Bs[cur][kk][lane * 4]);
      const float bv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 a = *reinterpret_cast<const float4*>(
            &As[cur][kk][warp * 16 + g * 4]);
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
    if (s + 1 < slices) store_slice(cur ^ 1);
    __syncthreads();
  }

  // the statistics slot of this block: (cloud, voxel tile)
  const int slots = gridDim.x * gridDim.z;
  const int slot = b * gridDim.x + blockIdx.x;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int co = co0 + warp * 16 + i;   // uniform over the warp
    if (co >= Co) continue;
    const float bc = __ldg(bias + co);
    float* yrow = y + (static_cast<int64_t>(b) * Co + co) * R3;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int vo = v0 + lane * 4 + j;
      if (vo < R3) {
        const float val = acc[i][j] + bc;
        yrow[vo] = val;
        s1 += val;
        s2 = fmaf(val, val, s2);
      }
    }
    if (partial != nullptr) {
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, m);
        s2 += __shfl_xor_sync(0xffffffffu, s2, m);
      }
      if (lane == 0) {
        partial[static_cast<int64_t>(co) * slots + slot] = s1;
        partial[(static_cast<int64_t>(Co) + co) * slots + slot] = s2;
      }
    }
  }
}

template <bool kAligned, bool kPrologue>
void launch(const float* x, const float* w, const float* bias,
            const float* pscale, const float* pshift, float* y, float* partial,
            int B, int Ci, int Co, int R, cudaStream_t stream) {
  const int64_t r3 = static_cast<int64_t>(R) * R * R;
  const dim3 grid(static_cast<unsigned>((r3 + kBN - 1) / kBN),
                  static_cast<unsigned>((Co + kBM - 1) / kBM),
                  static_cast<unsigned>(B));
  const size_t pro_bytes = kPrologue ? 2 * sizeof(float) * Ci : 0;
  conv3d_fwd_kernel<kAligned, kPrologue><<<grid, kThreads, pro_bytes, stream>>>(
      x, w, bias, pscale, pshift, y, partial, Ci, Co, R);
}

}  // namespace

PVCNN_EXPORT int pvcnn_conv3d_fwd(const void* x, const void* w,
                                  const void* bias, const void* pscale,
                                  const void* pshift, void* y, void* partial,
                                  int B, int Ci, int Co, int R,
                                  int has_prologue, void* stream) {
  if (B == 0 || R == 0 || Co == 0) return 0;
  const auto xf = static_cast<const float*>(x);
  const auto wf = static_cast<const float*>(w);
  const auto bf = static_cast<const float*>(bias);
  const auto sf = static_cast<const float*>(pscale);
  const auto tf = static_cast<const float*>(pshift);
  const auto yf = static_cast<float*>(y);
  const auto pf = static_cast<float*>(partial);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool aligned = Ci % kBK == 0;
  if (aligned && has_prologue) {
    launch<true, true>(xf, wf, bf, sf, tf, yf, pf, B, Ci, Co, R, st);
  } else if (aligned) {
    launch<true, false>(xf, wf, bf, sf, tf, yf, pf, B, Ci, Co, R, st);
  } else if (has_prologue) {
    launch<false, true>(xf, wf, bf, sf, tf, yf, pf, B, Ci, Co, R, st);
  } else {
    launch<false, false>(xf, wf, bf, sf, tf, yf, pf, B, Ci, Co, R, st);
  }
  return static_cast<int>(cudaGetLastError());
}
