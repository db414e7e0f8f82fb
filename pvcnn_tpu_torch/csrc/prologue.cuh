// The conv prologue pass of K3 (csrc/conv3d.cu) and K4 (csrc/conv3d_wgrad.cu):
// xact = leaky(x * scale[ci] + shift[ci], 0.1), once per element of a
// channel-major [B, Ci, R^3] input, into a buffer like x that the conv then
// reads. A conv's out-of-grid taps read zeros: the zero padding of the
// activated tensor. Applied while staging, the prologue would run once per
// element and tap: on an H100 80GB HBM3 at 700 W that cost K3 12-21% and
// K4 17-23% of their time, more than the pass's 2|x| bytes.
#pragma once

#include "common.cuh"

namespace pvcnn {
namespace {

// leaky(x * s + t, 0.1). No fused multiply-add: the same two roundings as
// the plain version's x * s + t.
__device__ __forceinline__ float activate(float x, float s, float t) {
  const float y = __fadd_rn(__fmul_rn(x, s), t);
  return y > 0.f ? y : __fmul_rn(0.1f, y);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
conv3d_prologue_kernel(const float* __restrict__ x,       // [B, Ci, R^3]
                       const float* __restrict__ pscale,  // [Ci]
                       const float* __restrict__ pshift,  // [Ci]
                       float* __restrict__ xact,          // [B, Ci, R^3]
                       int Ci, int R3, int64_t total) {
  const int64_t i = (blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x) * V;
  if (i >= total) return;
  const int ci = static_cast<int>(i / R3 % Ci);   // V divides R^3
  const float s = __ldg(pscale + ci), t = __ldg(pshift + ci);
  if (V == 4) {
    float4 v = __ldg(reinterpret_cast<const float4*>(x + i));
    v = make_float4(activate(v.x, s, t), activate(v.y, s, t),
                    activate(v.z, s, t), activate(v.w, s, t));
    *reinterpret_cast<float4*>(xact + i) = v;
  } else {
    xact[i] = activate(__ldg(x + i), s, t);
  }
}

// the pass on float4s where R^3 % 4 == 0 and both buffers are 16-byte
// aligned, else on floats; returns cudaGetLastError()
inline int launch_conv3d_prologue(const float* x, const float* pscale,
                                  const float* pshift, float* xact, int B,
                                  int Ci, int R3, cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(B) * Ci * R3;
  if (R3 % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(xact) % 16 == 0) {
    conv3d_prologue_kernel<4><<<blocks_for(total / 4), kThreads, 0,
                                stream>>>(x, pscale, pshift, xact, Ci, R3,
                                          total);
  } else {
    conv3d_prologue_kernel<1><<<blocks_for(total), kThreads, 0, stream>>>(
        x, pscale, pshift, xact, Ci, R3, total);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace pvcnn
