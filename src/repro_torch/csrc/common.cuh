// Shared by every kernel library in this directory.  Each .cu builds into
// its own shared library with a plain C interface (see kernels/_build.py),
// so each gets its own copy of what is defined here.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cstdio>

#include <cuda_bf16.h>
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

// cp.async copies into shared memory (sm_80 and up), one commit group per
// call of cp_async_commit: `bytes` of the 16 (or 4) are read and the rest
// zero-filled, so 0 copies nothing and writes zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, uint32_t bytes = 16) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, uint32_t bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N of this thread's commit groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// The sign bit the reference gives a float: 1 where x >= 0.  The reference's
// signs are computed with subnormals flushed to zero (XLA's CPU backend and
// the TPU), so a negative subnormal counts as -0.0 and gets a 1.  The rule
// that matches is x > -FLT_MIN: -0.0 gives 1, NaN gives 0, and it reads the
// value, not the floating-point mode, so it holds whether or not a compare
// flushes subnormals (the port builds without -ftz).  repro_torch's
// core/bitops.py::sign_bit is the same rule in PyTorch.
__device__ __forceinline__ bool sign_bit(float x) { return x > -FLT_MIN; }

// The same rule on both halves of a bf16 pair: 1.0 where the half's sign bit
// is 1, else 0.0.  bf16 has float32's exponent range, so it holds
// subnormals too, and -FLT_MIN (-2^-126) is exact in bf16.
__device__ __forceinline__ __nv_bfloat162 sign_bits_bf16x2(__nv_bfloat162 x) {
  return __hgt2(x, __float2bfloat162_rn(-FLT_MIN));
}
