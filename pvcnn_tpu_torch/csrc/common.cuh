// Shared helpers for the pvcnn_tpu_torch CUDA kernels.
//
// Every kernel is exported through a plain C function loaded with ctypes
// (pvcnn_tpu_torch/kernels/__init__.py): pointers and the CUDA stream arrive
// as void*, sizes as int. Each launcher returns cudaGetLastError() right
// after the launch, so a refused launch (too many threads, bad grid) is
// reported to the Python wrapper instead of silently never running.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#define PVCNN_EXPORT extern "C" __attribute__((visibility("default")))

namespace pvcnn {

constexpr int kThreads = 256;

inline unsigned int blocks_for(int64_t total, int threads = kThreads) {
  return static_cast<unsigned int>((total + threads - 1) / threads);
}

}  // namespace pvcnn
