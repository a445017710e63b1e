// Bit-packed XNOR-popcount GEMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bnn_matmul.py::
// bnn_matmul_packed.
//
// What it computes: x (M, Kw) and w (N, Kw) hold sign bits packed 32 to a
// uint32 word (int32 bit views), zero-padded past k_bits in both operands.
//   out[m, n] = 2 * sum_w popc(~(x[m, w] ^ w[n, w])) - 2 * Kw * 32 + k_bits
// as int32, exact.  Each pad bit agrees (0 with 0) and the affine term
// removes it.
//
// What bounds it on this card: for decode (M of 1 to 4) the weight words,
// which are read once; in prefill (M of 100s) the integer operations: five
// per word pair (xor, not, popc, add, and the load), against 64 INT32 lanes
// per SM, with popc at a quarter of that rate (16 per SM per clock).
//
// Design: the TPU kernel carried the sum across a sequential Kw grid axis in
// its output block.  Here blocks run in no order, so each block owns a
// BM x 64 output tile and loops over Kw itself, staging 32-word slices of
// its x rows and w rows in shared memory (row stride 33 words, so the 16
// rows a half-warp reads sit in 16 banks).  Each of the 256 threads keeps
// TM x 4 int32 sums in registers.  Ragged M, N and Kw are masked here, not
// padded by the caller: rows past M or N load 0 and are never stored, and
// the word loop stops at Kw.  BM is 16 (TM = 1) for M <= 16, so a decode
// step does not spend 64-row tiles on 1 to 4 rows; else 64 (TM = 4).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kBN = 64;        // output columns per block
constexpr int kBKW = 32;       // words per shared-memory slice
constexpr int kLd = kBKW + 1;  // padded row stride in words

template <int TM>
__global__ void __launch_bounds__(kThreads)
bnn_matmul_packed_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ w,
                         int* __restrict__ out, int m, int n, int kw, int affine) {
  constexpr int BM = 16 * TM;
  __shared__ uint32_t xs[BM * kLd];
  __shared__ uint32_t ws[kBN * kLd];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  int acc[TM][4] = {};

  for (int k0 = 0; k0 < kw; k0 += kBKW) {
    const int words = min(kBKW, kw - k0);
    // Word c of row r at shared offset r * kLd + c; consecutive threads load
    // consecutive words of a row (coalesced).
    for (int i = threadIdx.x; i < BM * kBKW; i += kThreads) {
      const int r = i / kBKW, c = i % kBKW;
      const int gm = m0 + r;
      xs[r * kLd + c] = (gm < m && c < words) ? x[static_cast<long long>(gm) * kw + k0 + c] : 0u;
    }
    for (int i = threadIdx.x; i < kBN * kBKW; i += kThreads) {
      const int r = i / kBKW, c = i % kBKW;
      const int gn = n0 + r;
      ws[r * kLd + c] = (gn < n && c < words) ? w[static_cast<long long>(gn) * kw + k0 + c] : 0u;
    }
    __syncthreads();
    for (int c = 0; c < words; ++c) {
      uint32_t a[TM], b[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[(ty + 16 * i) * kLd + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[(tx + 16 * j) * kLd + c];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += __popc(~(a[i] ^ b[j]));
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < n) out[static_cast<long long>(gm) * n + gn] = 2 * acc[i][j] + affine;
    }
  }
}

template <int TM>
int launch(const void* x, const void* w, void* out, int m, int n, int kw, int k_bits,
           cudaStream_t stream) {
  constexpr int BM = 16 * TM;
  const dim3 grid((n + kBN - 1) / kBN, (m + BM - 1) / BM);
  // The affine term is computed in 64 bits and fits int32 for kw < 2^25.
  const int affine = static_cast<int>(-2LL * kw * 32 + k_bits);
  bnn_matmul_packed_kernel<TM><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(w),
      static_cast<int*>(out), m, n, kw, affine);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bnn_matmul_packed(const void* x, const void* w, void* out, int m, int n,
                                 int kw, int k_bits, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return m <= 16 ? launch<1>(x, w, out, m, n, kw, k_bits, s)
                 : launch<4>(x, w, out, m, n, kw, k_bits, s);
}
