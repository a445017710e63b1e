// Bit packing for the packed dataplane backend and the LM's packed
// projections, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bitpack.py::bitpack and
// its any-width front end pack_bits_words.
//
// What it computes: out[m, w] packs pred(x[m, 32*w + k]) into bit k of a
// uint32 word (bit k of the row lands in word k // 32 at shift k % 32, the
// lowering.pack_bit_rows layout).  Columns past the true width n pack as 0.
// On float32 and bf16 x (bitpack) pred is the sign bit as the reference
// computes it, with subnormals flushed to zero: sign_bit / sign_bits_bf16x2
// in common.cuh, x > -FLT_MIN.  On int32 x it is x >= thr (thr = 0 is
// bitpack's sign; thr = 1 is pack_bits_words on {0,1} bits).
//
// What bounds it on this card: device-memory bytes.  It reads 4 bytes (2 for
// bf16) per bit and writes 4 bytes per 32 bits, with one compare per bit.
//
// Design: two kernels, one entry point per (type, route); the wrapper
// (kernels/bitpack.py::route) picks the route by what it can see.
//
// * vec (n a multiple of V, the elements in 16 bytes: 4 for float32 and
//   int32, 8 for bf16; 16-byte aligned x).  A word's 32 inputs are G = 32/V
//   16-byte vectors, read by G neighbouring lanes.  Each lane turns its
//   vector into V bits (bf16 pairs through one bf16x2 compare each), shifts
//   them to their place in the word, and the G lanes OR their pieces
//   together with log2(G) shuffles.  So a warp step (32 lanes x 16 bytes)
//   makes V words, which V/4 lanes gather by shuffles and store as 16-byte
//   chunks.  One 16-byte load a lane: four in flight a lane measured within
//   4% of one, either way, at the packet-path and scoring shapes, and slower
//   at the LM's decode rows (fewer warps, longer chains).  Words are
//   numbered flat over (row, word), the output's own order: when n is a
//   multiple of 32 the inputs of word t start at element 32t, with no row
//   arithmetic, and narrow rows (the packet path's 32- and 64-bit rows) pack
//   several to a warp step; otherwise one 32-bit division gives (row, word)
//   and vectors past the row's end count as 0.  Warps stride over the steps
//   with 32-bit word indices (the wrapper keeps the word count below 2^31);
//   element offsets are 64-bit, so an input may pass 2^32 elements (a
//   prefill of 8 x 32,768 rows of 8,192).
// * scalar (ragged widths, misaligned views): one warp per word.  Lane k
//   loads column 32*w + k and __ballot_sync collects the 32 predicates into
//   one word with lane k in bit k; lane 0 stores it.  32-bit word indices,
//   64-bit element offsets.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kMaxBlocks = 132 * 8;  // 8 blocks of 256 fill an SM's 2048 threads

__device__ __forceinline__ bool predicate(float v, int) { return sign_bit(v); }
__device__ __forceinline__ bool predicate(__nv_bfloat16 v, int) {
  return sign_bit(__bfloat162float(v));  // exact: bf16 widens to float without rounding
}
__device__ __forceinline__ bool predicate(int v, int thr) { return v >= thr; }

// The V predicate bits of one 16-byte vector, element e in bit e.
__device__ __forceinline__ uint32_t vector_bits(const uint4& v, const float*, int) {
  return static_cast<uint32_t>(sign_bit(__uint_as_float(v.x))) |
         static_cast<uint32_t>(sign_bit(__uint_as_float(v.y))) << 1 |
         static_cast<uint32_t>(sign_bit(__uint_as_float(v.z))) << 2 |
         static_cast<uint32_t>(sign_bit(__uint_as_float(v.w))) << 3;
}
__device__ __forceinline__ uint32_t vector_bits(const uint4& v, const int*, int thr) {
  return static_cast<uint32_t>(static_cast<int>(v.x) >= thr) |
         static_cast<uint32_t>(static_cast<int>(v.y) >= thr) << 1 |
         static_cast<uint32_t>(static_cast<int>(v.z) >= thr) << 2 |
         static_cast<uint32_t>(static_cast<int>(v.w) >= thr) << 3;
}
// Two bf16 (the lower address in the low half) -> two bits.  The compare
// gives 1.0 (0x3F80, bit 7 of the half set) or 0.0 in each half.
__device__ __forceinline__ uint32_t pair_bits(uint32_t pair) {
  const __nv_bfloat162 r = sign_bits_bf16x2(*reinterpret_cast<const __nv_bfloat162*>(&pair));
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&r);
  return ((u >> 7) & 1u) | ((u >> 22) & 2u);
}
__device__ __forceinline__ uint32_t vector_bits(const uint4& v, const __nv_bfloat16*, int) {
  return pair_bits(v.x) | pair_bits(v.y) << 2 | pair_bits(v.z) << 4 | pair_bits(v.w) << 6;
}

template <typename T, bool kFlat>
__global__ void __launch_bounds__(kThreads)
pack_vec_kernel(const T* __restrict__ x, uint32_t* __restrict__ out, uint32_t n, uint32_t words,
                uint32_t total, int thr) {
  constexpr uint32_t V = 16 / sizeof(T);  // elements per vector, and words per warp step
  constexpr uint32_t G = 32 / V;          // lanes per word
  const uint32_t lane = threadIdx.x & 31;
  const uint32_t sub = lane % G, slot = lane / G;
  const uint32_t steps = (total + V - 1) / V;
  for (uint32_t step = (blockIdx.x * kThreads + threadIdx.x) >> 5; step < steps;
       step += (gridDim.x * kThreads) >> 5) {
    const uint32_t t0 = step * V, t = t0 + slot;  // the step's first word, this lane's word
    bool live;
    size_t start;  // element offset of this lane's vector
    if (kFlat) {
      live = t < total;
      start = static_cast<size_t>(t) * 32 + sub * V;
    } else {
      const uint32_t row = t / words;
      const uint32_t col = (t - row * words) * 32 + sub * V;
      live = t < total && col < n;
      start = static_cast<size_t>(row) * n + col;
    }
    uint32_t bits = 0;
    if (live) bits = vector_bits(__ldg(reinterpret_cast<const uint4*>(x + start)), x, thr) << (sub * V);
#pragma unroll
    for (uint32_t d = 1; d < G; d <<= 1) bits |= __shfl_xor_sync(0xffffffffu, bits, d);
    // Lane s < V/4 gathers words 4s .. 4s+3 (held by lanes (4s + j) * G) for
    // one 16-byte store.
    uint4 four;
    four.x = __shfl_sync(0xffffffffu, bits, (4 * lane + 0) * G % 32);
    four.y = __shfl_sync(0xffffffffu, bits, (4 * lane + 1) * G % 32);
    four.z = __shfl_sync(0xffffffffu, bits, (4 * lane + 2) * G % 32);
    four.w = __shfl_sync(0xffffffffu, bits, (4 * lane + 3) * G % 32);
    if (t0 + V <= total) {
      if (lane < V / 4) reinterpret_cast<uint4*>(out + t0)[lane] = four;
    } else if (sub == 0 && live) {
      out[t] = bits;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pack_scalar_kernel(const T* __restrict__ x, uint32_t* __restrict__ out, uint32_t n, uint32_t words,
                   uint32_t total, int thr) {
  const uint32_t task = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const uint32_t lane = threadIdx.x & 31;
  if (task >= total) return;  // warp-uniform: every lane shares `task`
  const uint32_t row = task / words;
  const uint32_t col = (task - row * words) * 32 + lane;
  const bool bit = col < n && predicate(x[static_cast<size_t>(row) * n + col], thr);
  const uint32_t packed = __ballot_sync(0xffffffffu, bit);
  if (lane == 0) out[task] = packed;
}

template <typename T>
int launch(const void* x, void* out, int m, int n, int thr, bool vec, void* stream) {
  const uint32_t words = n > 0 ? (static_cast<uint32_t>(n) + 31) / 32 : 1;
  const uint32_t total = static_cast<uint32_t>(m) * words;
  const auto* xt = static_cast<const T*>(x);
  auto* o = static_cast<uint32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec) {
    constexpr uint32_t per_step = 16 / sizeof(T);  // words a warp step makes
    const uint32_t steps = (total + per_step - 1) / per_step;
    const uint32_t wanted = (steps + kWarps - 1) / kWarps;
    const uint32_t blocks = wanted < kMaxBlocks ? wanted : kMaxBlocks;
    if (n % 32 == 0) {
      pack_vec_kernel<T, true><<<blocks, kThreads, 0, s>>>(xt, o, n, words, total, thr);
    } else {
      pack_vec_kernel<T, false><<<blocks, kThreads, 0, s>>>(xt, o, n, words, total, thr);
    }
  } else {
    const uint32_t blocks = (total + kWarps - 1) / kWarps;
    pack_scalar_kernel<T><<<blocks, kThreads, 0, s>>>(xt, o, n, words, total, thr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pack_ge_f32_vec(const void* x, void* out, int m, int n, void* stream) {
  return launch<float>(x, out, m, n, 0, true, stream);
}
extern "C" int pack_ge_f32_scalar(const void* x, void* out, int m, int n, void* stream) {
  return launch<float>(x, out, m, n, 0, false, stream);
}
extern "C" int pack_ge_bf16_vec(const void* x, void* out, int m, int n, void* stream) {
  return launch<__nv_bfloat16>(x, out, m, n, 0, true, stream);
}
extern "C" int pack_ge_bf16_scalar(const void* x, void* out, int m, int n, void* stream) {
  return launch<__nv_bfloat16>(x, out, m, n, 0, false, stream);
}
extern "C" int pack_ge_i32_vec(const void* x, void* out, int m, int n, int thr, void* stream) {
  return launch<int>(x, out, m, n, thr, true, stream);
}
extern "C" int pack_ge_i32_scalar(const void* x, void* out, int m, int n, int thr, void* stream) {
  return launch<int>(x, out, m, n, thr, false, stream);
}
