// Shared by every kernel library in this directory.  Each .cu builds into
// its own shared library with a plain C interface (see kernels/_build.py),
// so each gets its own copy of what is defined here.
#pragma once

#include <cstdint>
#include <cstdio>

#include <cuda_runtime.h>

// Shared memory one block may use on Hopper (227 KB of the SM's 256 KB).
constexpr size_t kMaxSharedBytes = 232448;
// Above this a kernel must opt in to more dynamic shared memory.
constexpr size_t kDefaultSharedBytes = 48 * 1024;

// Codes an entry point returns beside cudaError_t values: libcuda has no
// cuTensorMapEncodeTiled, or it refused a tensor map (base + its CUresult).
constexpr int kNoTensorMapEncoder = 100000;
constexpr int kTensorMapErrorBase = 200000;

extern "C" const char* error_string(int code) {
  static thread_local char text[96];
  if (code == kNoTensorMapEncoder) return "cuTensorMapEncodeTiled not found in libcuda.so.1";
  if (code >= kTensorMapErrorBase) {
    snprintf(text, sizeof text, "cuTensorMapEncodeTiled failed with CUresult %d",
             code - kTensorMapErrorBase);
    return text;
  }
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
