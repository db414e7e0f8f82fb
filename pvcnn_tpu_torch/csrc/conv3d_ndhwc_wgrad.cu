// K11: 3x3x3 conv3d weight gradient on channel-last (NDHWC) voxel grids.
//
// Replaces the TPU kernel pvcnn_tpu/ops/pallas/conv_wgrad.py:
// _conv3d_wgrad_impl, the custom weight gradient of the NDHWC voxel
// branch's stride-1 SAME conv (pvcnn_tpu/nn/conv3d.py:conv3d_same):
//
//   dW[tap, ci, co] = sum_b sum_v Xpad[b, v + tap, ci] * g[b, v, co]
//
// with tap = (kx, ky, kz), kx walking D (the first spatial axis), Xpad the
// grid zero-padded by 1 on each side, x [B, R, R, R, Ci] and g
// [B, R, R, R, Co]. The output is torch's [Co, Ci, 3, 3, 3] (the JAX kernel
// layout [k, k, k, Ci, Co] transposed; tap = tx * 9 + ty * 3 + tz), written
// by the kernel itself.
//
// Design: K4's (csrc/conv3d_wgrad.cu) on channel-last operands. A GEMM
// with M = 27 * Ci rows (ci, tap), N = Co columns and a reduction over the
// K = B * R^3 voxels of all clouds, fp32 on the CUDA cores (no TF32). K11
// keeps a source of its own: built from one shared core, K4's registers
// moved and its steps ran 0.4-0.8% slower on an H100 80GB HBM3 at 700 W.
//
// * Rows by channel. A block computes all 27 taps of cb channels (27 * cb
//   rows) against 64 output channels, or 32 where Co <= 32. The reduction
//   runs over z-segments: L consecutive voxels of one z-row (L = 8, 16 or
//   32, the least that is at least R, 32 above), 32 / L segments per
//   32-voxel slice. For a segment the block stages, per channel and per
//   (tx, ty), the L + 2 input values z0 - 1 .. z0 + L of the neighbouring
//   z-row; the three tz taps read them at shifts 0, 1, 2, so no tap needs
//   a mask: out-of-grid values, and rows outside the grid, are staged as
//   zeros. A thread owns one (channel, tx) and 8 output channels: a 9 x 8
//   accumulator (ty, tz rows).
// * x's staging (Layout). Where Ci and cb are multiples of 4 and x is
//   aligned, x keeps its layout: a (tx, ty) row is L + 2 z-slots of the
//   block's channels, staged a channel quad (16 bytes) a copy, and the
//   multiply reads a row's z-slots as scalars at constant offsets. Else
//   (Ci = 9 on the S3DIS PVCNN opt-in path) the caller transposes x to
//   channel-major once and the block stages its z-rows as K4 does (16
//   bytes a copy where R % 4 == 0 and x is aligned, else 4). On an H100
//   80GB HBM3 at 700 W, transposing both operands into K4's rows by 4-byte
//   copies measured no faster than the earlier 128 x 64-tile kernel and up
//   to 18% slower; x alone so, 15% slower than z-slots at R = 32. The
//   gradient is staged voxel-major, a column quad a copy where Co % 4 ==
//   0, and read as 4 columns of one voxel.
// * Asynchronous staging by cp.async (out-of-grid parts zero-filled)
//   through a ring of 2 stages, one barrier per slice.
// * A split sized to the card: K4's plan
//   (pvcnn_tpu_torch/ops/conv3d.py:_wgrad_plan) splits the flattened
//   voxels of all clouds into `splits` equal runs of slices. Each block
//   writes its sum to its own slice of a partial buffer [splits, Co, Ci,
//   27], or straight to dW when there is one split;
//   conv3d_ndhwc_wgrad_sum_kernel adds the slices in order. Every kFlush =
//   16 slices a thread folds its accumulators into running sums in shared
//   memory, in order, so no fp32 chain of products runs longer than 512
//   voxels. No atomics: reproducible bit for bit.
// Zero padding is the copies' zero fill, never a padded copy of the grid
// (the pad + reshape prologue is what cost the TPU version its in-step
// A/B, pvcnn_tpu/nn/conv3d.py). Its kernels have names of their own, so a
// profile tells them from K4's.
//
// Bound. Compute: 2 * 27 * Ci * Co * B * R^3 FLOPs against 67 TFLOP/s of
// fp32 FMA; the bytes (x and g read once) take less time at 3.35 TB/s at
// the training shapes.
#include "common.cuh"

namespace {

namespace wg {

constexpr int kSlice = 32;       // voxels per slice of the reduction
constexpr int kStages = 2;       // shared-memory ring
constexpr int kMaxThreads = 192; // 3 * cb * (columns / 8)
constexpr int kFlush = 16;       // slices per chunk of the running sum

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 (16) bytes from src to shared dst, or zeros where !ok (src is then not
// read; it is still a valid address)
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// How a block stages x: channel-major in K4's rows (kLastRows: x
// transposed by the caller) or channel-last in z-slots (kLastSlots). The
// values are the launcher's `layout` argument.
enum Layout { kLastRows = 1, kLastSlots = 2 };

// kLastRows: per channel, 9 * (32 / L) input rows of stride L + 4 (3 free
// slots, z0 - 1, then z0 .. z0 + L - 1 16-byte aligned; z0 + L lands in the
// next row's first slot), 4 more floats that close the last row.
// kLastSlots: per (tx, ty, segment) a block of L + 2 z-slots (z0 - 1 ..
// z0 + L) of 64 / TN floats, room for the most channels a block takes (3 *
// cb * TN <= 192 threads), so that every offset of the multiply is a
// constant; the block stride is rounded to 4 mod 8 floats, so that the 4
// (channel, tx) rows a warp reads fall on distinct banks; 3 more slots
// take the reads past the last slot of the last block.
template <int TN>
__host__ __device__ constexpr int slot_floats() {
  return kMaxThreads / (3 * TN);
}

template <int L, int TN>
__host__ __device__ constexpr int slot_block_floats() {
  return (L + 2) * slot_floats<TN>() % 8 == 0
             ? (L + 2) * slot_floats<TN>() + 4
             : (L + 2) * slot_floats<TN>();
}

template <int L, int TN, int M>
__host__ __device__ __forceinline__ int a_floats(int cb) {
  if (M == kLastSlots) {
    return 9 * (kSlice / L) * slot_block_floats<L, TN>() +
           3 * slot_floats<TN>();
  }
  return 9 * cb * (kSlice / L) * (L + 4) + 4;
}

// then the gradient [kSlice][columns + 4]
template <int L, int TN, int M>
__host__ __device__ __forceinline__ int stage_floats(int cb) {
  return a_floats<L, TN, M>(cb) + kSlice * (8 * TN + 4);
}

// the ring, then the running sums (72 per thread)
template <int L, int TN, int M>
inline size_t smem_bytes(int cb) {
  return sizeof(float) * (kStages * stage_floats<L, TN, M>(cb) +
                          72 * 3 * cb * TN);
}

// One block of the GEMM: input channels blockIdx.x * cb .., output channels
// blockIdx.y * 8 * TN .., the run of slices blockIdx.z. g [B, R^3, Co];
// kLastRows: x [B, Ci, R^3], kLastSlots: x [B, R^3, Ci] (Ci and cb
// multiples of 4, x aligned). vec bit 0: x's rows by 16-byte copies
// (kLastRows: R a multiple of 4, x aligned), bit 1: g by 16-byte copies (Co
// a multiple of 4, g aligned).
template <int L, int TN, int M>
__device__ __forceinline__ void wgrad_block(const float* __restrict__ x,
                                            const float* __restrict__ g,
                                            float* __restrict__ out,
                                            int B, int Ci, int Co, int R,
                                            int cb, int slices, int per_split,
                                            int vec) {
  constexpr int kSegs = kSlice / L;   // z-segments per slice
  constexpr int kAS = L + 4;          // input row stride
  constexpr int kChan = 9 * kSegs * kAS;  // a channel's input rows
  constexpr int kCols = 8 * TN;       // output channels per block
  constexpr int kBV = kCols + 4;      // gradient voxel stride
  // kLastSlots: a z-slot's stride and a (tx, ty, segment) block's
  constexpr int cs = slot_floats<TN>();
  constexpr int rb = slot_block_floats<L, TN>();
  extern __shared__ __align__(16) float smem[];

  const int nthreads = blockDim.x;    // 3 * cb * TN, a multiple of kSegs
  const int tid = threadIdx.x;
  const int a_rows = 9 * cb * kSegs;
  const int a_size = a_floats<L, TN, M>(cb);
  const int stage = stage_floats<L, TN, M>(cb);
  const int c0 = blockIdx.x * cb;
  const int n0 = blockIdx.y * kCols;
  const int64_t R3 = static_cast<int64_t>(R) * R * R;
  const int zsegs = (R + L - 1) / L;
  const int s_begin = blockIdx.z * per_split;
  const int n_slices = max(0, min(slices, s_begin + per_split) - s_begin);

  // The copies. Each thread follows one segment of each slice: its cursor
  // (cloud, x, y, z-segment) steps by kSegs segments per slice.
  // kLastRows: thread tid stages x's rows tid, tid + nthreads, ... (channel,
  // tx, ty, segment) of each slice; row r belongs to segment r % kSegs =
  // tid % kSegs. g: the W = nthreads / kSegs threads w of a segment (w =
  // tid / kSegs; kLastSlots: the W threads tid / W = segment, w = tid % W)
  // copy its values w, w + W, ... of L voxels x kCols columns (a quad or a
  // value each). kLastSlots: thread w takes, of the 9 (tx, ty) x (L + 2)
  // z-slots, slots w / q, w / q + W / q, ... at channel quad w % q of the
  // q = cb / 4 (16 bytes a copy).
  const int seg_threads = nthreads / kSegs;
  const int my_seg = M == kLastSlots ? tid / seg_threads : tid % kSegs;
  const int w_seg =
      M == kLastSlots ? tid - my_seg * seg_threads : tid / kSegs;
  const int a_lanes = max(cb / 4, 1);
  const int a_lane = w_seg % a_lanes, a_slot = w_seg / a_lanes;
  constexpr int a_step = 12 * TN / kSegs;
  int cur_b, cur_x, cur_y, cur_zs;
  {
    int64_t s = static_cast<int64_t>(s_begin) * kSegs + my_seg;
    cur_zs = static_cast<int>(s % zsegs);
    s /= zsegs;
    cur_y = static_cast<int>(s % R);
    s /= R;
    cur_x = static_cast<int>(s % R);
    s /= R;
    cur_b = s < B ? static_cast<int>(s) : B;   // past the end: no segment
  }

  auto load_slice = [&](float* st) {
    const bool seg_ok = cur_b < B;
    const int z0 = cur_zs * L;
    float* As = st;
    float* Bs = st + a_size;
    if constexpr (M == kLastSlots) {
      const int64_t vox0 = static_cast<int64_t>(seg_ok ? cur_b : 0) * R3;
      for (int pos = a_slot; pos < 9 * (L + 2); pos += a_step) {
        const int txy = pos / (L + 2), e = pos - txy * (L + 2);
        const int xx = cur_x + txy / 3 - 1, yy = cur_y + txy % 3 - 1;
        const int zz = z0 - 1 + e;
        const int c = 4 * a_lane;
        const bool ok =
            seg_ok && c0 + c < Ci &&
            static_cast<unsigned>(xx) < static_cast<unsigned>(R) &&
            static_cast<unsigned>(yy) < static_cast<unsigned>(R) &&
            static_cast<unsigned>(zz) < static_cast<unsigned>(R);
        const int64_t v =
            vox0 + (static_cast<int64_t>(xx) * R + yy) * R + zz;
        copy16(As + (txy * kSegs + my_seg) * rb + e * cs + c,
               ok ? x + v * Ci + c0 + c : x, ok);
      }
    } else {
      // x's row (channel, tx, ty, segment) `row` of this slice, from x [B,
      // Ci, R^3], z0 - 1 .. z0 + L to slots 3 .. L + 4 of the row
      for (int row = tid; row < a_rows; row += nthreads) {
        const int q = row / kSegs;          // channel * 9 + tx * 3 + ty
        const int ca = q / 9, txy = q - 9 * ca;
        const int ci = c0 + ca;
        const int xx = cur_x + txy / 3 - 1, yy = cur_y + txy % 3 - 1;
        const bool ok =
            seg_ok && ci < Ci &&
            static_cast<unsigned>(xx) < static_cast<unsigned>(R) &&
            static_cast<unsigned>(yy) < static_cast<unsigned>(R);
        const float* src =
            ok ? x + (static_cast<int64_t>(cur_b) * Ci + ci) * R3 +
                     (static_cast<int64_t>(xx) * R + yy) * R + z0
               : x;
        float* dst = As + row * kAS + 4;
        if (vec & 1) {
          const bool okl = ok && z0 > 0;
          copy4(dst - 1, okl ? src - 1 : x, okl);
#pragma unroll
          for (int q4 = 0; q4 < L / 4; ++q4) {
            const bool okq = ok && z0 + 4 * q4 < R;
            copy16(dst + 4 * q4, okq ? src + 4 * q4 : x, okq);
          }
          const bool okr = ok && z0 + L < R;
          copy4(dst + L, okr ? src + L : x, okr);
        } else {
#pragma unroll
          for (int e = -1; e <= L; ++e) {
            const bool oke = ok && z0 + e >= 0 && z0 + e < R;
            copy4(dst + e, oke ? src + e : x, oke);
          }
        }
      }
    }
    const float* gb =
        g + (static_cast<int64_t>(seg_ok ? cur_b : 0) * R3 +
             (static_cast<int64_t>(cur_x) * R + cur_y) * R + z0) * Co + n0;
    if (vec & 2) {
      for (int k = w_seg; k < kCols / 4 * L; k += seg_threads) {
        const int c4 = k % (kCols / 4), e = k / (kCols / 4);
        const bool ok = seg_ok && n0 + 4 * c4 < Co && z0 + e < R;
        copy16(Bs + (my_seg * L + e) * kBV + 4 * c4,
               ok ? gb + static_cast<int64_t>(e) * Co + 4 * c4 : g, ok);
      }
    } else {
      for (int k = w_seg; k < kCols * L; k += seg_threads) {
        const int n = k % kCols, e = k / kCols;
        const bool ok = seg_ok && n0 + n < Co && z0 + e < R;
        copy4(Bs + (my_seg * L + e) * kBV + n,
              ok ? gb + static_cast<int64_t>(e) * Co + n : g, ok);
      }
    }
    // the next slice's segment of this thread
    cur_zs += kSegs;
    while (cur_zs >= zsegs) {
      cur_zs -= zsegs;
      if (++cur_y == R) {
        cur_y = 0;
        if (++cur_x == R) {
          cur_x = 0;
          ++cur_b;
        }
      }
    }
  };

  // the multiply: this thread's channel and tx, ty rows x 8 columns
  const int tn = tid % TN;
  const int r = tid / TN;              // channel * 3 + tx
  const int c = r / 3, tx = r % 3;
  float acc[9][8];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[t][j] = 0.f;
  }

  auto multiply = [&](const float* st) {
    const float* As = st;
    const float* Bs = st + a_size;
    // z-slots s .. s + 3 of a row (slot 0: z0 - 1): a float4 of a row,
    // four values cs apart in z-slots
    auto slots4 = [&](const float* a, int s) {
      if constexpr (M == kLastSlots) {
        return make_float4(a[s * cs], a[(s + 1) * cs], a[(s + 2) * cs],
                           a[(s + 3) * cs]);
      } else {
        return *reinterpret_cast<const float4*>(a + 3 + s);
      }
    };
    // In rows the segment loop stays rolled and the j loop is unrolled by
    // 2, so the loop body fits the instruction cache (K4's finding: fully
    // unrolled it ran 7-16% slower). In z-slots the segment loop is
    // unrolled: rolled, L = 16 spilled 112 bytes and its cases ran 13-20%
    // slower on an H100 80GB HBM3 at 700 W.
#pragma unroll (M == kLastSlots ? kSegs : 1)
    for (int sg = 0; sg < kSegs; ++sg) {
      const float* ap[3];
      float pw[3];
      float4 cur[3];
#pragma unroll
      for (int ty = 0; ty < 3; ++ty) {
        const int row = (tx * 3 + ty) * kSegs + sg;
        ap[ty] = M == kLastSlots ? As + row * rb + c
                                 : As + c * kChan + row * kAS;
        pw[ty] = M == kLastSlots ? ap[ty][0] : ap[ty][3];
        cur[ty] = slots4(ap[ty], 1);
      }
#pragma unroll 2
      for (int j = 0; j < L / 4; ++j) {
        float4 nx[3];
#pragma unroll
        for (int ty = 0; ty < 3; ++ty) nx[ty] = slots4(ap[ty], 5 + 4 * j);
        // the 8 columns in two halves of 4: 16 registers of gradient
        // values live at a time
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // bv[q][i]: column 4 * (TN * h + tn) + q at voxel 4j + i
          float bv[4][4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 b = *reinterpret_cast<const float4*>(
                Bs + (sg * L + 4 * j + q) * kBV + 4 * (TN * h + tn));
            bv[0][q] = b.x;
            bv[1][q] = b.y;
            bv[2][q] = b.z;
            bv[3][q] = b.w;
          }
#pragma unroll
          for (int ty = 0; ty < 3; ++ty) {
            // z0 + 4j - 1 .. z0 + 4j + 4: voxel 4j + i at tap tz reads
            // w[i + tz]
            const float w[6] = {pw[ty],    cur[ty].x, cur[ty].y,
                                cur[ty].z, cur[ty].w, nx[ty].x};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
              for (int tz = 0; tz < 3; ++tz) {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  acc[ty * 3 + tz][4 * h + q] = fmaf(
                      w[i + tz], bv[q][i], acc[ty * 3 + tz][4 * h + q]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int ty = 0; ty < 3; ++ty) {
          pw[ty] = cur[ty].w;
          cur[ty] = nx[ty];
        }
      }
    }
  };

  // The running sum of this thread's finished chunks of kFlush slices,
  // [72][nthreads] in shared memory after the ring: the accumulators are
  // folded into it in order (run = chunk 1, run += chunk 2, ...).
  float* run = smem + kStages * stage;
  bool first = true;
  auto fold = [&]() {
#pragma unroll
    for (int t = 0; t < 9; ++t) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float* sum = run + (t * 8 + jj) * nthreads + tid;
        *sum = first ? acc[t][jj] : *sum + acc[t][jj];
        acc[t][jj] = 0.f;
      }
    }
    first = false;
  };

  // the ring: slice s waits in stage s % kStages; every iteration commits
  // one group (empty past the end), so wait_group<kStages - 2> means slice
  // s has landed
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < n_slices) load_slice(smem + p * stage);
    copy_commit();
  }
  for (int s = 0; s < n_slices; ++s) {
    copy_wait<kStages - 2>();
    __syncthreads();
    // the stage of slice s + kStages - 1 was last read by slice s - 1's
    // multiply, which every thread finished before the barrier
    if (s + kStages - 1 < n_slices) {
      load_slice(smem + ((s + kStages - 1) % kStages) * stage);
    }
    copy_commit();
    multiply(smem + (s % kStages) * stage);
    if ((s + 1) % kFlush == 0 && s + 1 < n_slices) fold();
  }

  // the block's sum, (co, ci, tx * 9 + 0 .. 8) for this thread's 8 columns:
  // the running sum plus the last chunk
  const int ci = c0 + c;
  if (ci >= Ci) return;
  float* o = out + static_cast<int64_t>(blockIdx.z) * Co * Ci * 27;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int co = n0 + 4 * (TN * (jj / 4) + tn) + jj % 4;
    if (co >= Co) continue;
    float* p = o + (static_cast<int64_t>(co) * Ci + ci) * 27 + tx * 9;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      p[t] = first ? acc[t][jj]
                   : run[(t * 8 + jj) * nthreads + tid] + acc[t][jj];
    }
  }
}

}  // namespace wg

template <int L, int TN, int M>
__global__ void __launch_bounds__(wg::kMaxThreads, 2)
conv3d_ndhwc_wgrad_kernel(const float* __restrict__ x,
                          const float* __restrict__ g,  // [B, R^3, Co]
                          float* __restrict__ out,      // [splits, Co, Ci, 27]
                          int B, int Ci, int Co, int R, int cb, int slices,
                          int per_split, int vec) {
  wg::wgrad_block<L, TN, M>(x, g, out, B, Ci, Co, R, cb, slices, per_split,
                            vec);
}

// the splits' fixed-order sum: dw[i] = partial[0][i] + partial[1][i] + ...
__global__ void __launch_bounds__(pvcnn::kThreads)
conv3d_ndhwc_wgrad_sum_kernel(const float* __restrict__ partial,
                              float* __restrict__ dw, int64_t total,
                              int splits) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= total) return;
  float s = __ldg(partial + i);
  for (int k = 1; k < splits; ++k) s += __ldg(partial + k * total + i);
  dw[i] = s;
}

struct Args {
  const float *x, *g;
  float* out;
  int B, Ci, Co, R, cb, slices, per_split, splits, vec;
  cudaStream_t stream;
};

template <int L, int TN, int M>
int launch(const Args& a) {
  auto* kernel = conv3d_ndhwc_wgrad_kernel<L, TN, M>;
  const size_t smem = wg::smem_bytes<L, TN, M>(a.cb);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((a.Ci + a.cb - 1) / a.cb),
                  static_cast<unsigned>((a.Co + 8 * TN - 1) / (8 * TN)),
                  static_cast<unsigned>(a.splits));
  kernel<<<grid, 3 * a.cb * TN, smem, a.stream>>>(
      a.x, a.g, a.out, a.B, a.Ci, a.Co, a.R, a.cb, a.slices, a.per_split,
      a.vec);
  return static_cast<int>(cudaGetLastError());
}

template <int TN, int M>
int launch_seg(const Args& a, int seg) {
  switch (seg) {
    case 8: return launch<8, TN, M>(a);
    case 16: return launch<16, TN, M>(a);
    case 32: return launch<32, TN, M>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int M>
int launch_cols(const Args& a, int seg, int cols) {
  return cols == 64 ? launch_seg<8, M>(a, seg) : launch_seg<4, M>(a, seg);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dw [Co, Ci, 27] from g [B, R^3, Co] and x: layout 2 (kLastSlots), x [B,
// R^3, Ci] with Ci and cb multiples of 4 and x 16-byte aligned; layout 1
// (kLastRows), x [B, Ci, R^3]. The plan is K4's
// (pvcnn_tpu_torch/ops/conv3d.py:_wgrad_plan): seg (L: 8, 16 or 32), cols
// (32 or 64 output channels per block), cb (input channels per block, 3 *
// cb * cols / 8 <= 192 threads) and splits, with partial [splits, Co, Ci,
// 27] where splits > 1.
PVCNN_EXPORT int pvcnn_conv3d_ndhwc_wgrad(const void* x, const void* g,
                                          void* partial, void* dw, int B,
                                          int Ci, int Co, int R, int seg,
                                          int cols, int cb, int splits,
                                          int layout, void* stream) {
  if (Co == 0 || Ci == 0) return 0;
  const int tn = cols / 8;
  const bool slots = layout == wg::kLastSlots;
  if (B < 1 || R < 1 || (cols != 32 && cols != 64) || cb < 1 ||
      3 * cb * tn > wg::kMaxThreads || splits < 1 ||
      (splits > 1 && partial == nullptr) ||
      (seg != 8 && seg != 16 && seg != 32) ||
      (!slots && layout != wg::kLastRows) ||
      (slots && (Ci % 4 != 0 || cb % 4 != 0 || !aligned16(x)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const int64_t segs = static_cast<int64_t>(B) * R * R * ((R + seg - 1) / seg);
  const int slices =
      static_cast<int>((segs * seg + wg::kSlice - 1) / wg::kSlice);
  // 16-byte copies of x's rows (kLastRows) and of g's column quads
  const int vec = (!slots && R % 4 == 0 && aligned16(x) ? 1 : 0) |
                  (Co % 4 == 0 && aligned16(g) ? 2 : 0);
  const Args a{static_cast<const float*>(x),
               static_cast<const float*>(g),
               static_cast<float*>(splits > 1 ? partial : dw),
               B, Ci, Co, R, cb, slices, (slices + splits - 1) / splits,
               splits, vec, st};
  int err = slots ? launch_cols<wg::kLastSlots>(a, seg, cols)
                  : launch_cols<wg::kLastRows>(a, seg, cols);
  if (err != 0 || splits == 1) return err;
  const int64_t total = static_cast<int64_t>(Co) * Ci * 27;
  conv3d_ndhwc_wgrad_sum_kernel<<<pvcnn::blocks_for(total), pvcnn::kThreads,
                                  0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), total,
      splits);
  return static_cast<int>(cudaGetLastError());
}
