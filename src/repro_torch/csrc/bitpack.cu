// Bit packing for the packed dataplane backend, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitpack.py::bitpack and
// its any-width front end pack_bits_words.
//
// What it computes: out[m, w] packs x[m, 32*w + k] >= thr into bit k of a
// uint32 word (bit k of the row lands in word k // 32 at shift k % 32, the
// lowering.pack_bit_rows layout).  Columns past the true width n pack as 0.
// `bitpack` is thr = 0 on float32 or int32 input (the sign of x);
// `pack_bits_words` is thr = 1 on {0,1} int32 bits.
//
// What bounds it on this card: device-memory bytes.  It reads 4 bytes per
// bit and writes 4 bytes per 32 bits, with one compare per bit.
//
// Design: one warp per output word.  Lane k loads column 32*w + k (a warp
// reads 128 contiguous bytes) and __ballot_sync collects the 32 predicates
// into one word with lane k in bit k — exactly the packed layout, with no
// shifts or reductions.  Lane 0 stores the word.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void pack_ge_kernel(const T* __restrict__ x, uint32_t* __restrict__ out,
                               long long m, int n, int words, T thr) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= m * words) return;  // warp-uniform: every lane shares `warp`
  const long long row = warp / words;
  const int word = static_cast<int>(warp % words);
  const int col = word * 32 + lane;
  const bool bit = col < n && x[row * n + col] >= thr;
  const uint32_t packed = __ballot_sync(0xffffffffu, bit);
  if (lane == 0) out[row * words + word] = packed;
}

template <typename T>
int launch(const void* x, void* out, long long m, int n, T thr, void* stream) {
  const int words = n > 0 ? (n + 31) / 32 : 1;
  const long long warps = m * words;
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  pack_ge_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<uint32_t*>(out), m, n, words, thr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pack_ge_f32(const void* x, void* out, long long m, int n,
                           float thr, void* stream) {
  return launch<float>(x, out, m, n, thr, stream);
}

extern "C" int pack_ge_i32(const void* x, void* out, long long m, int n,
                           int thr, void* stream) {
  return launch<int>(x, out, m, n, thr, stream);
}
