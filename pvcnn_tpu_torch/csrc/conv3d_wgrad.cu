// K4: 3x3x3 conv3d weight gradient on flat voxel rows, with and without the
// input prologue.
//
// Replaces the TPU kernels pvcnn_tpu/ops/pallas/conv_rows.py:_run_wgrad (the
// raw-input conv's dW) and :_run_wgrad_act (dW against the prologue-activated
// input), which _act_bwd runs for every conv of the PVConv voxel branch:
//
//   dW[co, ci, tap] = sum_b sum_v a(x)[b, ci, v + tap] * g[b, co, v]
//   a(x) = leaky(x * scale[ci] + shift[ci], 0.1)   with the prologue, else x
//
// Out-of-grid taps contribute 0 (zero padding of the ACTIVATED input, as in
// the forward, csrc/conv3d.cu). The output is torch's [Co, Ci, 3, 3, 3]
// (tap = tx * 9 + ty * 3 + tz, tx along the x axis: flat offset +-R^2).
//
// Design. A GEMM with M = 27 * Ci rows (ci, tap), N = Co columns and a
// reduction over the K = B * R^3 voxels of all clouds, fp32 on the CUDA
// cores (no TF32).
//
// * Rows by channel. A block computes all 27 taps of cb channels (27 * cb
//   rows) against 64 output channels, or 32 where Co <= 32 (no half of a
//   tile multiplies zero columns). The reduction runs over z-segments: L
//   consecutive voxels of one z-row (L = 8, 16 or 32, the least that is at
//   least R, 32 above), 32 / L segments per 32-voxel slice. For a segment
//   the block stages, per channel and per (tx, ty), the L + 2 input values
//   of the neighbouring z-row, z0 - 1 .. z0 + L, in one shared-memory row;
//   the three tz taps are the same row read at shifts 0, 1, 2. So each
//   staged input value serves three taps, each value of a row is fetched
//   once per slice (9 rows per channel where the im2col tile has 27), and
//   no tap needs a mask: out-of-grid values, and rows outside the grid,
//   are staged as zeros. A thread owns one (channel, tx) and 8 output
//   channels: a 9 x 8 accumulator (ty, tz rows), its three input rows read
//   as float4s that slide along z (one float4 per row for 4 voxels), the
//   gradient as Bs[co][voxel] float4s: 11 shared-memory reads per 288
//   FMAs.
// * Asynchronous staging. Input rows and gradient rows go to shared memory
//   by cp.async (16 bytes where R % 4 == 0 and the rows are aligned, else 4;
//   out-of-grid parts zero-filled) through a ring of 2 stages, one barrier
//   per slice: the copies of slice s + 1 are in flight while slice s is
//   multiplied. (3 stages measured no faster, and their shared memory is
//   the running sums' below.)
// * The prologue runs once per input element, in K3's pass
//   (csrc/prologue.cuh) into a buffer like x, which the copies then read:
//   zero-filled padding stays the zero of the activated tensor.
// * A split sized to the card. The reduction runs over the flattened
//   voxels of ALL clouds (a segment's cloud comes from its index), and the
//   wrapper splits it into `splits` equal runs of slices so that the grid
//   fills about one to two waves of the card
//   (pvcnn_tpu_torch/ops/conv3d.py:_wgrad_plan). Each block writes its sum
//   to its own slice of a partial buffer [splits, Co, Ci, 27], or straight
//   to dW when there is one split; conv3d_wgrad_sum_kernel adds the slices
//   in order. Every kFlush = 16 slices a thread folds its accumulators
//   into running sums in shared memory, in order, so no fp32 chain of
//   products runs longer than 512 voxels (2048-voxel chains doubled the
//   error against fp64 at R = 8). Folding into the
//   output in global memory instead (with 3 stages) made K4 23% slower on
//   an H100 80GB HBM3 at 700 W. No atomics: reproducible bit for bit.
//
// Bound. Compute: 2 * 27 * Ci * Co * B * R^3 FLOPs (0.23 TFLOP at 64 -> 64,
// B = 32, R = 32) against 67 TFLOP/s of fp32 FMA; the bytes (x and g read
// once) take 4-90x less time at 3.35 TB/s at the training shapes.
#include "prologue.cuh"

namespace {

constexpr int kSlice = 32;       // voxels per slice of the reduction
constexpr int kStages = 2;       // shared-memory ring
constexpr int kMaxThreads = 192; // 3 * cb * (columns / 8)
constexpr int kBS = kSlice + 4;  // gradient row stride (conflict-free float4s)
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

// The shared-memory floats of one stage: 9 * cb * (32 / L) input rows of
// stride L + 4 (3 free slots, z0 - 1, then z0 .. z0 + L - 1 16-byte aligned;
// z0 + L lands in the next row's first slot, and 4 more floats close the
// last row), then the gradient [columns][kBS].
template <int L>
__host__ __device__ __forceinline__ int a_floats(int cb) {
  return 9 * cb * (kSlice / L) * (L + 4) + 4;
}

template <int L, int TN>
__host__ __device__ __forceinline__ int stage_floats(int cb) {
  return a_floats<L>(cb) + 8 * TN * kBS;
}

template <int L, int TN>
__global__ void __launch_bounds__(kMaxThreads, 2)
conv3d_wgrad_kernel(const float* __restrict__ x,  // [B, Ci, R^3] (activated)
                    const float* __restrict__ g,  // [B, Co, R^3]
                    float* __restrict__ out,      // [splits, Co, Ci, 27]
                    int B, int Ci, int Co, int R, int cb, int slices,
                    int per_split, int vec) {
  constexpr int kSegs = kSlice / L;   // z-segments per slice
  constexpr int kAS = L + 4;          // input row stride
  constexpr int kCols = 8 * TN;       // output channels per block
  extern __shared__ __align__(16) float smem[];

  const int nthreads = blockDim.x;    // 3 * cb * TN, a multiple of kSegs
  const int tid = threadIdx.x;
  const int a_rows = 9 * cb * kSegs;
  const int a_size = a_floats<L>(cb);
  const int stage = stage_floats<L, TN>(cb);
  const int c0 = blockIdx.x * cb;
  const int n0 = blockIdx.y * kCols;
  const int64_t R3 = static_cast<int64_t>(R) * R * R;
  const int zsegs = (R + L - 1) / L;
  const int s_begin = blockIdx.z * per_split;
  const int n_slices = max(0, min(slices, s_begin + per_split) - s_begin);

  // The copies. Thread tid stages rows tid, tid + nthreads, ... of each
  // slice: input rows (channel, tx, ty, segment) first, then gradient rows
  // (column, segment). Row r belongs to segment r % kSegs = tid % kSegs, so
  // a thread follows one segment of each slice: its cursor (cloud, x, y,
  // z-segment) steps by kSegs segments per slice.
  const int my_seg = tid % kSegs;
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
    for (int row = tid; row < a_rows + kCols * kSegs; row += nthreads) {
      if (row < a_rows) {
        const int q = row / kSegs;          // channel * 9 + tx * 3 + ty
        const int ca = q / 9, txy = q - 9 * ca;
        const int ci = c0 + ca;
        const int xx = cur_x + txy / 3 - 1, yy = cur_y + txy % 3 - 1;
        const bool ok = seg_ok && ci < Ci &&
                        static_cast<unsigned>(xx) < static_cast<unsigned>(R) &&
                        static_cast<unsigned>(yy) < static_cast<unsigned>(R);
        const float* src =
            ok ? x + (static_cast<int64_t>(cur_b) * Ci + ci) * R3 +
                     (static_cast<int64_t>(xx) * R + yy) * R + z0
               : x;
        float* dst = As + row * kAS + 4;
        if (vec) {
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
      } else {
        const int n = (row - a_rows) / kSegs;
        const int co = n0 + n;
        const bool ok = seg_ok && co < Co;
        const float* src =
            ok ? g + (static_cast<int64_t>(cur_b) * Co + co) * R3 +
                     (static_cast<int64_t>(cur_x) * R + cur_y) * R + z0
               : g;
        float* dst = Bs + n * kBS + my_seg * L;
        if (vec) {
#pragma unroll
          for (int q4 = 0; q4 < L / 4; ++q4) {
            const bool okq = ok && z0 + 4 * q4 < R;
            copy16(dst + 4 * q4, okq ? src + 4 * q4 : g, okq);
          }
        } else {
#pragma unroll
          for (int e = 0; e < L; ++e) {
            const bool oke = ok && z0 + e < R;
            copy4(dst + e, oke ? src + e : g, oke);
          }
        }
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
    // The segment loop stays rolled and the j loop is unrolled by 2, so the
    // loop body fits the instruction cache: fully unrolled, a slice is 2304
    // FMAs of code, and it ran 7% slower at L = 32 and 13-16% slower at
    // L = 8 (four segments) on an H100 80GB HBM3 at 700 W.
#pragma unroll 1
    for (int sg = 0; sg < kSegs; ++sg) {
      const float* ap[3];
      float pw[3];
      float4 cur[3];
#pragma unroll
      for (int ty = 0; ty < 3; ++ty) {
        ap[ty] = As + ((c * 9 + tx * 3 + ty) * kSegs + sg) * kAS;
        pw[ty] = ap[ty][3];
        cur[ty] = *reinterpret_cast<const float4*>(ap[ty] + 4);
      }
#pragma unroll 2
      for (int j = 0; j < L / 4; ++j) {
        float4 nx[3];
#pragma unroll
        for (int ty = 0; ty < 3; ++ty) {
          nx[ty] = *reinterpret_cast<const float4*>(ap[ty] + 8 + 4 * j);
        }
        // the 8 columns in two halves of 4: 16 registers of gradient
        // values live at a time
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float bv[4][4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 b = *reinterpret_cast<const float4*>(
                Bs + (tn + TN * (4 * h + q)) * kBS + sg * L + 4 * j);
            bv[q][0] = b.x;
            bv[q][1] = b.y;
            bv[q][2] = b.z;
            bv[q][3] = b.w;
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
    const int co = n0 + tn + TN * jj;
    if (co >= Co) continue;
    float* p = o + (static_cast<int64_t>(co) * Ci + ci) * 27 + tx * 9;
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      p[t] = first ? acc[t][jj]
                   : run[(t * 8 + jj) * nthreads + tid] + acc[t][jj];
    }
  }
}

// the splits' fixed-order sum: dw[i] = partial[0][i] + partial[1][i] + ...
__global__ void __launch_bounds__(pvcnn::kThreads)
conv3d_wgrad_sum_kernel(const float* __restrict__ partial,
                        float* __restrict__ dw, int64_t total, int splits) {
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

template <int L, int TN>
int launch(const Args& a) {
  auto* kernel = conv3d_wgrad_kernel<L, TN>;
  // the ring, then the running sums (72 per thread)
  const size_t smem = sizeof(float) * (kStages * stage_floats<L, TN>(a.cb) +
                                       72 * 3 * a.cb * TN);
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

template <int TN>
int launch_cols(const Args& a, int seg) {
  switch (seg) {
    case 8: return launch<8, TN>(a);
    case 16: return launch<16, TN>(a);
    case 32: return launch<32, TN>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dw [Co, Ci, 27]. The plan (pvcnn_tpu_torch/ops/conv3d.py:_wgrad_plan):
// seg (L: 8, 16 or 32), cols (32 or 64 output channels per block), cb
// (input channels per block, 3 * cb * cols / 8 <= 192 threads) and splits
// (with partial [splits, Co, Ci, 27] where splits > 1). With pscale/pshift,
// xact is a buffer like x for the activated input, which the prologue
// writes first.
PVCNN_EXPORT int pvcnn_conv3d_wgrad(const void* x, const void* g,
                                    const void* pscale, const void* pshift,
                                    void* xact, void* partial, void* dw,
                                    int B, int Ci, int Co, int R, int seg,
                                    int cols, int cb, int splits,
                                    void* stream) {
  if (Co == 0 || Ci == 0) return 0;
  const int tn = cols / 8;
  if (B < 1 || R < 1 || (cols != 32 && cols != 64) || cb < 1 ||
      3 * cb * tn > kMaxThreads ||
      splits < 1 || (splits > 1 && partial == nullptr) ||
      (seg != 8 && seg != 16 && seg != 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const int64_t r3 = static_cast<int64_t>(R) * R * R;
  const auto* xf = static_cast<const float*>(x);
  if (xact != nullptr) {
    auto* xa = static_cast<float*>(xact);
    const int err = pvcnn::launch_conv3d_prologue(
        xf, static_cast<const float*>(pscale),
        static_cast<const float*>(pshift), xa, B, Ci, static_cast<int>(r3),
        st);
    if (err != 0) return err;
    xf = xa;
  }
  const int64_t segs =
      static_cast<int64_t>(B) * R * R * ((R + seg - 1) / seg);
  const int slices = static_cast<int>((segs * seg + kSlice - 1) / kSlice);
  const int per_split = (slices + splits - 1) / splits;
  const auto* gf = static_cast<const float*>(g);
  const int vec = R % 4 == 0 && aligned16(xf) && aligned16(gf);
  float* out = static_cast<float*>(splits > 1 ? partial : dw);
  const Args a{xf, gf, out, B, Ci, Co, R, cb, slices, per_split, splits,
               vec, st};
  const int err = tn == 8 ? launch_cols<8>(a, seg) : launch_cols<4>(a, seg);
  if (err != 0 || splits == 1) return err;
  const int64_t total = static_cast<int64_t>(Co) * Ci * 27;
  conv3d_wgrad_sum_kernel<<<pvcnn::blocks_for(total), pvcnn::kThreads, 0,
                            st>>>(static_cast<const float*>(partial),
                                  static_cast<float*>(dw), total, splits);
  return static_cast<int>(cudaGetLastError());
}
