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
// What bounds it on this card: for decode (M of 1 to 16) the weight words,
// which are read once; in prefill (M of 100s) the integer operations: five
// per word pair (xor, not, popc, add, and the load), against 64 INT32 lanes
// per SM, with popc at a quarter of that rate (16 per SM per clock).
//
// Two routes, one entry point each; kernels/bnn_matmul.py::route picks one.
//
// "stream" (M <= 16, Kw a multiple of 4, 16-byte aligned operands): the
// decode route, which has to stream the weights at the card's memory rate.
// A block stages x's M x Kw words once in shared memory.  Each row of w is
// read by a team of LPR lanes (8, 16 or 32: the fewest that cover the row
// in at most four 16-byte loads a lane), neighbouring lanes on neighbouring
// addresses, all of a lane's loads issued before any is used.  Each lane
// does popc(~(x ^ w)) against every row of x, the team reduces by
// __shfl_xor_sync, and the affine term is applied once.  The grid has one
// team per output column, so every SM holds many warps and tens of KB of
// loads in flight, and a launch is a round trip or two to memory beyond its
// launch latency.  Ragged N is masked (teams past N load nothing and store
// nothing).
//
// "tiled" (every other shape: prefill, scoring, ragged Kw, sliced views):
// blocks run in no order, so each block owns a BM x 64 output tile and loops
// over Kw itself, staging 32-word slices of its x rows and w rows in shared
// memory (row stride 33 words, so the 16 rows a half-warp reads sit in 16
// banks).  Each of the 256 threads keeps TM x 4 int32 sums in registers.
// Ragged M, N and Kw are masked here, not padded by the caller: rows past M
// or N load 0 and are never stored, and the word loop stops at Kw.  BM is 16
// (TM = 1) for M <= 16, else 64 (TM = 4).
//
// Experts: the same two kernels, with an expert grid axis, also serve
// layers/moe.py's batched packed expert GEMM (bnn_matmul_packed_experts).
// It replaces no Pallas kernel but the jnp contraction at
// src/repro/layers/moe.py:104-124, which XLA fuses on the TPU.  x (E, C, Kw)
// and w (E, O, Kw) give out (E, C, O), each expert's slice computed exactly
// as above: blockIdx.z is the expert, and each block moves its x, w and out
// pointers by the expert's stride (C * Kw, O * Kw and C * O words) before
// it starts.  It is bound by the expert weights, read once: E * O * Kw * 4
// bytes at 3.35 TB/s (25.2 MB, about 7.5 us, for each of qwen3-moe-30b-a3b's
// three launches a layer).  Like the reference it computes every capacity
// slot of every expert, empty ones included (an empty slot's row of x holds
// the packed signs of zeros); layers/moe.py gathers only the kept slots
// back.

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
  const long long e = blockIdx.z;  // the expert (0 for the plain GEMM)
  x += e * m * kw;
  w += e * n * kw;
  out += e * m * n;
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
int launch(const void* x, const void* w, void* out, int experts, int m, int n, int kw, int k_bits,
           cudaStream_t stream) {
  constexpr int BM = 16 * TM;
  const dim3 grid((n + kBN - 1) / kBN, (m + BM - 1) / BM, experts);
  // The affine term is computed in 64 bits and fits int32 for kw < 2^25.
  const int affine = static_cast<int>(-2LL * kw * 32 + k_bits);
  bnn_matmul_packed_kernel<TM><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(w),
      static_cast<int*>(out), m, n, kw, affine);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// "stream": the decode route
// ---------------------------------------------------------------------------

constexpr int kStreamThreads = 128;
constexpr int kStreamLoads = 4;    // 16-byte loads a lane issues before using any
constexpr int kStreamMaxRows = 16;  // kernels/bnn_matmul.py STREAM_MAX_M

template <int MT, int LPR>
__global__ void __launch_bounds__(kStreamThreads)
bnn_matmul_stream_kernel(const uint4* __restrict__ x, const uint4* __restrict__ w,
                         int* __restrict__ out, int m, int n, int chunks, int affine) {
  extern __shared__ uint4 xs[];  // [m][chunks]
  const long long e = blockIdx.z;  // the expert (0 for the plain GEMM)
  x += e * m * chunks;
  w += e * n * chunks;
  out += e * m * n;
  for (int i = threadIdx.x; i < m * chunks; i += kStreamThreads) xs[i] = x[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int lr = lane % LPR;  // this lane's place in its row's team
  const int col = (blockIdx.x * (kStreamThreads / 32) + (threadIdx.x >> 5)) * (32 / LPR) + lane / LPR;
  const bool live = col < n;
  const uint4* wr = w + static_cast<long long>(live ? col : 0) * chunks;
  int acc[MT] = {};
  for (int c0 = lr; c0 < chunks; c0 += LPR * kStreamLoads) {
    uint4 wv[kStreamLoads];
#pragma unroll
    for (int u = 0; u < kStreamLoads; ++u) {
      const int c = c0 + u * LPR;
      wv[u] = live && c < chunks ? __ldg(wr + c) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kStreamLoads; ++u) {
      const int c = c0 + u * LPR;
      if (c >= chunks) break;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i < m) {
          const uint4 a = xs[i * chunks + c];
          acc[i] += __popc(~(a.x ^ wv[u].x)) + __popc(~(a.y ^ wv[u].y)) +
                    __popc(~(a.z ^ wv[u].z)) + __popc(~(a.w ^ wv[u].w));
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < m && i % LPR == lr) out[static_cast<long long>(i) * n + col] = 2 * acc[i] + affine;
    }
  }
}

template <int MT, int LPR>
int launch_stream(const void* x, const void* w, void* out, int experts, int m, int n, int chunks,
                  int affine, cudaStream_t stream) {
  constexpr int kCols = kStreamThreads / 32 * (32 / LPR);  // output columns per block
  const size_t smem = static_cast<size_t>(m) * chunks * sizeof(uint4);
  const dim3 grid((n + kCols - 1) / kCols, 1, experts);
  bnn_matmul_stream_kernel<MT, LPR><<<grid, kStreamThreads, smem, stream>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(w), static_cast<int*>(out), m, n,
      chunks, affine);
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
int launch_stream_mt(const void* x, const void* w, void* out, int experts, int m, int n,
                     int chunks, int affine, cudaStream_t stream) {
  if (chunks <= 8 * kStreamLoads)
    return launch_stream<MT, 8>(x, w, out, experts, m, n, chunks, affine, stream);
  if (chunks <= 16 * kStreamLoads)
    return launch_stream<MT, 16>(x, w, out, experts, m, n, chunks, affine, stream);
  return launch_stream<MT, 32>(x, w, out, experts, m, n, chunks, affine, stream);
}

constexpr int kMaxExperts = 65535;  // grid.z

int tiled(const void* x, const void* w, void* out, int experts, int m, int n, int kw, int k_bits,
          void* stream) {
  if (experts < 1 || experts > kMaxExperts) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return m <= 16 ? launch<1>(x, w, out, experts, m, n, kw, k_bits, s)
                 : launch<4>(x, w, out, experts, m, n, kw, k_bits, s);
}

int stream_route(const void* x, const void* w, void* out, int experts, int m, int n, int kw,
                 int k_bits, void* stream) {
  const uintptr_t both = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w);
  if (experts < 1 || experts > kMaxExperts || m < 1 || m > kStreamMaxRows || kw % 4 || both % 16 ||
      static_cast<size_t>(m) * kw * 4 > kDefaultSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = kw / 4;
  const int affine = static_cast<int>(-2LL * kw * 32 + k_bits);
  if (m <= 4) return launch_stream_mt<4>(x, w, out, experts, m, n, chunks, affine, s);
  if (m <= 8) return launch_stream_mt<8>(x, w, out, experts, m, n, chunks, affine, s);
  return launch_stream_mt<16>(x, w, out, experts, m, n, chunks, affine, s);
}

}  // namespace

extern "C" int bnn_matmul_packed_tiled(const void* x, const void* w, void* out, int m, int n,
                                       int kw, int k_bits, void* stream) {
  return tiled(x, w, out, 1, m, n, kw, k_bits, stream);
}

extern "C" int bnn_matmul_packed_stream(const void* x, const void* w, void* out, int m, int n,
                                        int kw, int k_bits, void* stream) {
  return stream_route(x, w, out, 1, m, n, kw, k_bits, stream);
}

// Experts: x (E, C, Kw), w (E, O, Kw), out (E, C, O), all contiguous; the
// stream route's limits hold for one expert's (C, Kw) (each expert's slices
// stay 16-byte aligned because Kw is a multiple of 4).
extern "C" int bnn_matmul_packed_experts_tiled(const void* x, const void* w, void* out, int e,
                                               int c, int o, int kw, int k_bits, void* stream) {
  return tiled(x, w, out, e, c, o, kw, k_bits, stream);
}

extern "C" int bnn_matmul_packed_experts_stream(const void* x, const void* w, void* out, int e,
                                                int c, int o, int kw, int k_bits, void* stream) {
  return stream_route(x, w, out, e, c, o, kw, k_bits, stream);
}
