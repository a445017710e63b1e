// ±1 binary GEMM on the tensor cores, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bnn_matmul_mxu.py::
// bnn_matmul_mxu (the MXU variant of the binary GEMM).
//
// What it computes: out (M, N) float32 = binarize(x) @ w, with x (M, K)
// float32 or bf16 and w (K, N) bf16 (pre-binarized ±1 weights), accumulated
// in float32.  binarize(x) is +1 where x >= 0 (so -0.0 gives +1) and -1
// elsewhere (so NaN gives -1), as jnp.where(x >= 0, 1, -1); with
// binarize_x = 0, x is rounded to bf16 (round to nearest even) instead.
// With ±1 operands every partial sum is an integer below 2^24, so the result
// is exact whatever the order of the sums.
//
// What bounds it on this card: at the shapes of a prefill or a training
// step (M, N, K in the thousands) the tensor cores' operations, 989 TFLOP/s
// dense bf16; bytes only when M is small.
//
// Design: the TPU kernel carried an f32 accumulator across a sequential K
// grid axis.  Here a block owns an output tile and loops over K in slices of
// 32 itself, with WMMA (bf16 16x16x16, f32 accumulation).  Two kernels, the
// launch choosing by what it can see:
//
// * pipelined (bf16 x, K and N multiples of 8, 16-byte aligned operands: the
//   model's path): 128 x 128 tiles, eight warps of 64 x 32.  A three-stage
//   ring of slices in shared memory is filled with cp.async, 16 bytes a
//   copy, so the next slices load while the tensor cores work.  x is staged
//   as it is and its sign taken on the loaded fragment (an elementwise map,
//   so which element sits where does not matter).  A copy past an edge
//   fills zeros: a zero x past K is signed into +1, but the w rows past K
//   are zero too, so it adds 0.  Full 16 x 16 results are stored straight
//   to device memory, ragged ones through a per-warp scratch tile.
// * staged (any other shape or type): 64 x 64 tiles, four warps of 32 x 32;
//   x is signed (or rounded to bf16) while it is copied into shared memory,
//   anything past an edge is stored as 0 in both operands, and the tile is
//   written through shared memory to mask the ragged edges.
//
// wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;  // 4 warps, 2 x 2 over the tile
constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kLdA = kBK + 8;  // bf16 row strides: multiples of 8 elements,
constexpr int kLdB = kBN + 8;  // fragment rows 32-byte aligned
constexpr int kLdC = kBN + 4;  // float stride: a multiple of 4

__device__ __forceinline__ __nv_bfloat16 to_operand(float v, bool binarize) {
  if (binarize) return __float2bfloat16_rn(v >= 0.f ? 1.f : -1.f);
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ __nv_bfloat16 to_operand(__nv_bfloat16 v, bool binarize) {
  if (binarize) return __float2bfloat16_rn(__bfloat162float(v) >= 0.f ? 1.f : -1.f);
  return v;
}

template <typename TX>
__global__ void __launch_bounds__(kThreads)
bnn_matmul_mxu_kernel(const TX* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                      float* __restrict__ out, int m, int n, int k, bool binarize) {
  __shared__ __align__(128) __nv_bfloat16 as[kBM * kLdA];
  __shared__ __align__(128) __nv_bfloat16 bs[kBK * kLdB];
  __shared__ __align__(128) float cs[kBM * kLdC];
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < k; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int gm = m0 + r, gk = k0 + c;
      as[r * kLdA + c] = (gm < m && gk < k)
          ? to_operand(x[static_cast<long long>(gm) * k + gk], binarize) : zero;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      const int gk = k0 + r, gn = n0 + c;
      bs[r * kLdB + c] = (gk < k && gn < n) ? w[static_cast<long long>(gk) * n + gn] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], as + (wm + 16 * i) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], bs + kk * kLdB + wn + 16 * j, kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm + 16 * i) * kLdC + wn + 16 * j, acc[i][j], kLdC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < m && gn < n) out[static_cast<long long>(gm) * n + gn] = cs[r * kLdC + c];
  }
}

template <typename TX>
int launch(const void* x, const void* w, void* out, int m, int n, int k, int binarize,
           void* stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  bnn_matmul_mxu_kernel<TX><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TX*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<float*>(out), m, n, k, binarize != 0);
  return static_cast<int>(cudaGetLastError());
}


// ---- pipelined kernel: bf16 x, K % 8 == 0, N % 8 == 0 ----------------------

constexpr int kPThreads = 256;            // 8 warps, 2 x 4 over the tile
constexpr int kPBM = 128, kPBN = 128, kPBK = 32, kStages = 3;
constexpr int kPWM = 64, kPWN = 32;       // one warp's part of the tile
constexpr int kPLdA = kPBK + 8, kPLdB = kPBN + 8;
constexpr int kStageElems = kPBM * kPLdA + kPBK * kPLdB;
constexpr size_t kPSharedBytes =
    static_cast<size_t>(kStages) * kStageElems * sizeof(__nv_bfloat16) + 8 * 256 * sizeof(float);

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in_range) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = in_range ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__global__ void __launch_bounds__(kPThreads)
bnn_matmul_mxu_pipelined_kernel(const __nv_bfloat16* __restrict__ x,
                                const __nv_bfloat16* __restrict__ w, float* __restrict__ out,
                                int m, int n, int k, bool binarize) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* scratch = reinterpret_cast<float*>(ring + kStages * kStageElems) + (threadIdx.x >> 5) * 256;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 2) * kPWM, wn = (warp & 3) * kPWN;
  const int m0 = blockIdx.y * kPBM, n0 = blockIdx.x * kPBN;
  const int slices = (k + kPBK - 1) / kPBK;

  // Slice s into stage s % kStages: A is 128 rows x 4 chunks of 8, B is 32
  // rows x 16 chunks; two chunks of each per thread.
  auto load = [&](int s) {
    __nv_bfloat16* as = ring + (s % kStages) * kStageElems;
    __nv_bfloat16* bs = as + kPBM * kPLdA;
    const int k0 = s * kPBK;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tid + kPThreads * j;
      const int r = c >> 2, col = (c & 3) * 8;
      const bool in = m0 + r < m && k0 + col < k;
      cp_async16(as + r * kPLdA + col, in ? x + static_cast<long long>(m0 + r) * k + k0 + col : x, in);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = tid + kPThreads * j;
      const int r = c >> 4, col = (c & 15) * 8;
      const bool in = k0 + r < k && n0 + col < n;
      cp_async16(bs + r * kPLdB + col, in ? w + static_cast<long long>(k0 + r) * n + n0 + col : w, in);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kPWM / 16][kPWN / 16];
#pragma unroll
  for (int i = 0; i < kPWM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kPWN / 16; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slices) load(s);
    cp_async_commit();
  }
  const __nv_bfloat16 plus = __float2bfloat16_rn(1.f), minus = __float2bfloat16_rn(-1.f);
  for (int s = 0; s < slices; ++s) {
    cp_async_wait<kStages - 2>();  // slice s has landed
    __syncthreads();               // and every warp is done with slice s - 1
    if (s + kStages - 1 < slices) load(s + kStages - 1);
    cp_async_commit();
    const __nv_bfloat16* as = ring + (s % kStages) * kStageElems;
    const __nv_bfloat16* bs = as + kPBM * kPLdA;
#pragma unroll
    for (int kk = 0; kk < kPBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[kPWM / 16];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[kPWN / 16];
#pragma unroll
      for (int i = 0; i < kPWM / 16; ++i) {
        wmma::load_matrix_sync(a[i], as + (wm + 16 * i) * kPLdA + kk, kPLdA);
        if (binarize) {
#pragma unroll
          for (int e = 0; e < a[i].num_elements; ++e)
            a[i].x[e] = __bfloat162float(a[i].x[e]) >= 0.f ? plus : minus;
        }
      }
#pragma unroll
      for (int j = 0; j < kPWN / 16; ++j)
        wmma::load_matrix_sync(b[j], bs + kk * kPLdB + wn + 16 * j, kPLdB);
#pragma unroll
      for (int i = 0; i < kPWM / 16; ++i)
#pragma unroll
        for (int j = 0; j < kPWN / 16; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kPWM / 16; ++i)
#pragma unroll
    for (int j = 0; j < kPWN / 16; ++j) {
      const int gm = m0 + wm + 16 * i, gn = n0 + wn + 16 * j;
      if (gm + 16 <= m && gn + 16 <= n) {
        wmma::store_matrix_sync(out + static_cast<long long>(gm) * n + gn, acc[i][j], n,
                                wmma::mem_row_major);
        continue;
      }
      wmma::store_matrix_sync(scratch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32)
        if (gm + e / 16 < m && gn + e % 16 < n)
          out[static_cast<long long>(gm + e / 16) * n + gn + e % 16] = scratch[e];
      __syncwarp();
    }
}

int launch_pipelined(const void* x, const void* w, void* out, int m, int n, int k, int binarize,
                     void* stream) {
  const int err = allow_shared_bytes(bnn_matmul_mxu_pipelined_kernel, kPSharedBytes);
  if (err) return err;
  const dim3 grid((n + kPBN - 1) / kPBN, (m + kPBM - 1) / kPBM);
  bnn_matmul_mxu_pipelined_kernel<<<grid, kPThreads, kPSharedBytes,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<float*>(out), m, n, k, binarize != 0);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, unsigned bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

extern "C" int bnn_matmul_mxu_f32(const void* x, const void* w, void* out, int m, int n,
                                  int k, int binarize, void* stream) {
  return launch<float>(x, w, out, m, n, k, binarize, stream);
}

extern "C" int bnn_matmul_mxu_bf16(const void* x, const void* w, void* out, int m, int n,
                                   int k, int binarize, void* stream) {
  // cp.async copies 16 bytes; WMMA stores to device memory need 32-byte alignment
  if (k % 8 == 0 && n % 8 == 0 && aligned(x, 16) && aligned(w, 16) && aligned(out, 32))
    return launch_pipelined(x, w, out, m, n, k, binarize, stream);
  return launch<__nv_bfloat16>(x, w, out, m, n, k, binarize, stream);
}
