// Shared by every kernel library in this directory.  Each .cu builds into
// its own shared library with a plain C interface (see kernels/_build.py),
// so each gets its own copy of what is defined here.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

// Shared memory one block may use on Hopper (227 KB of the SM's 256 KB).
constexpr size_t kMaxSharedBytes = 232448;
// Above this a kernel must opt in to more dynamic shared memory.
constexpr size_t kDefaultSharedBytes = 48 * 1024;

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Opt `kernel` in to `bytes` of dynamic shared memory where that exceeds the
// default; returns the CUDA error code (0 on success).
template <typename Kernel>
inline int allow_shared_bytes(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSharedBytes) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}
