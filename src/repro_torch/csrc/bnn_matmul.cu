// Bit-packed XNOR-popcount GEMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bnn_matmul.py::
// bnn_matmul_packed.
//
// What it computes: x (M, Kw) and w (N, Kw) hold sign bits packed 32 to a
// uint32 word (int32 bit views), zero-padded past k_bits in both operands.
//   out[m, n] = 2 * sum_w popc(~(x[m, w] ^ w[n, w])) - 2 * Kw * 32 + k_bits
// as int32, exact.  Each pad bit agrees (0 with 0) and the affine term
// removes it.  The same sum is the dot product of the two rows read as +1
// (a 1 bit) and -1 (a 0 bit), which the int8 tensor cores compute exactly.
//
// What bounds it on this card: for decode (M of 1 to 16) the weight words,
// which are read once; past that the multiply-adds, 2 * M * N * Kw * 32
// int8 operations at the tensor cores' 1,979 T/s (a popcount path tops out
// at 16 popc per SM a clock, 32 multiply-adds each: about 268 T/s).
//
// Three routes, one entry point each; kernels/bnn_matmul.py::route picks
// "stream" or "mma", and "tiled" is only ever forced.
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
// "mma" (every other shape: prefill, scoring, ragged Kw, sliced views): the
// packed words stay packed in device memory (32 times fewer bytes than
// int8) and are unpacked to +1/-1 int8 in the block, for wgmma
// m64nBNk32.s32.s8.s8.  A block of two warpgroups owns a 128 x BN output
// tile (BN of 128, 64 or 32: the wrapper picks the one whose waves over the
// card's SMs cost least, so that a 128-token prefill still fills the card)
// and loops over K in stages of 8 words (256 bits: two 128-byte swizzle
// rows of int8, eight k32 steps; 32 bytes of each packed row, one memory
// sector).  Two blocks share an SM, so that one's barrier, unpacking and
// stores overlap the other's products.  The stage's packed words of the
// block's x and w rows come through a ring of 5 shared-memory slots by
// cp.async (16-byte copies where Kw is a multiple of 4 and both operands
// are 16-byte aligned, else 4-byte ones), issued 3 stages ahead.  Each
// stage: one barrier; every thread unpacks its own x rows of the stage
// straight into A registers (x never goes to shared memory unpacked) and
// issues the stage's wgmma, the second half's registers built while the
// first half's products run; then, while they run, all 256 threads unpack
// the next stage's w words into the other of two int8 B buffers, in
// wgmma's K-major 128B-swizzled layout.  A word unpacks by a shift, a mask
// and one multiply a register: bits j, 8 + j, 16 + j and 24 + j become the
// four bytes 0xFF - 0xFE * bit (+1 or -1), so register j of a word (j =
// 0..7) holds its k32 step's elements 4j .. 4j + 3.  That is a fixed
// permutation of the 32 bits of a word (element 4j + b is bit 8b + j);
// both operands take it, so the dot product is the same.  A B buffer is
// rewritten only after every warpgroup has waited for the products that
// read it, before the barrier.  Words past Kw (the last stage's tail), rows
// past M and rows past N are zero-filled in both operands, so each such
// word unpacks to 32 values of -1 on both sides and adds +32: with
// Kw_staged = 8 * stages, out = acc - 32 * Kw_staged + k_bits.  Stores go
// from the accumulators, masked at ragged M and N, as 16-byte vectors (two
// lanes swap halves by shuffle) where N is a multiple of 4, else one int
// at a time.  A warpgroup whose rows lie past M multiplies zeros: the wgmma
// sit under no branch (ptxas serializes wgmma under a branch it cannot
// prove uniform).
//
// "tiled" (the first design, forced only, kept for timing in turns): blocks
// own a BM x 64 output tile and loop over Kw, staging 32-word slices of
// their x rows and w rows in shared memory (row stride 33 words, so the 16
// rows a half-warp reads sit in 16 banks).  Each of the 256 threads keeps
// TM x 4 int32 popcount sums in registers.  Ragged M, N and Kw are masked:
// rows past M or N load 0 and are never stored, and the word loop stops at
// Kw.  BM is 16 (TM = 1) for M <= 16, else 64 (TM = 4).
//
// Experts: the same kernels, with an expert grid axis, also serve
// layers/moe.py's batched packed expert GEMM (bnn_matmul_packed_experts).
// It replaces no Pallas kernel but the jnp contraction at
// src/repro/layers/moe.py:104-124, which XLA fuses on the TPU.  x (E, C, Kw)
// and w (E, O, Kw) give out (E, C, O), each expert's slice computed exactly
// as above: blockIdx.z is the expert, and each block moves its x, w and out
// pointers by the expert's stride (C * Kw, O * Kw and C * O words) before
// it starts.  At a decode step it is bound by the expert weights, read
// once: E * O * Kw * 4 bytes at 3.35 TB/s (25.2 MB, about 7.5 us, for each
// of qwen3-moe-30b-a3b's three launches a layer).  Like the reference it
// computes every capacity slot of every expert, empty ones included (an
// empty slot's row of x holds the packed signs of zeros); layers/moe.py
// gathers only the kept slots back.

#include "common.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// "mma": the int8 tensor-core route
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 256;    // two warpgroups, 64 output rows each
constexpr int kMmaBM = 128;         // output rows a block (kernels/bnn_matmul.py MMA_BLOCK_M)
constexpr int kMmaStageWords = 8;   // words of K a stage (MMA_STAGE_WORDS): 32 bytes, a sector
constexpr int kMmaAtoms = kMmaStageWords / 4;  // 128-byte swizzle rows of int8 a stage
constexpr int kMmaRing = 5;         // ring slots of packed words, issued 3 stages ahead

template <int BN>
struct MmaShape {
  static constexpr int kRows = kMmaBM + BN;          // packed rows a stage: x's, then w's
  static constexpr int kSlotWords = kRows * kMmaStageWords;
  static constexpr int kAtomBytes = BN * 128;        // BN rows of one 128-byte swizzle row
  static constexpr int kBBytes = kMmaAtoms * kAtomBytes;  // one stage of unpacked w
  static constexpr size_t kShared =
      2 * kBBytes + static_cast<size_t>(kMmaRing) * kSlotWords * 4 + 1024;  // + alignment slack
};

// Bits j, 8 + j, 16 + j and 24 + j of a packed word as four int8 in bytes 0
// to 3: 0xFF - 0xFE * bit in each byte, +1 for a 1 bit and -1 (0xFF) for a
// 0 bit, with no borrow between bytes.
__device__ __forceinline__ uint32_t pm1(uint32_t word, int j) {
  return 0xFFFFFFFFu - ((word >> j) & 0x01010101u) * 0xFEu;
}

// Two blocks an SM (at most 128 registers a thread), so that one block's
// barrier, unpacking and stores overlap the other's products.
template <int BN, bool VEC>
__global__ void __launch_bounds__(kMmaThreads, 2)
bnn_matmul_mma_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ w,
                      int* __restrict__ out, int m, int n, int kw, int affine, bool vec_out) {
  using namespace hopper;
  using S = MmaShape<BN>;
  extern __shared__ unsigned char smem_raw[];
  // [2 stages][kMmaAtoms][BN rows][128 B], 128B-swizzled; then the ring,
  // [kMmaRing][kRows][kMmaStageWords] words.
  unsigned char* bbuf = align_shared(smem_raw, 1024);
  uint32_t* ring = reinterpret_cast<uint32_t*>(bbuf + 2 * S::kBBytes);

  const long long e = blockIdx.z;  // the expert (0 for the plain GEMM)
  x += e * m * kw;
  w += e * n * kw;
  out += e * m * n;
  const int m0 = blockIdx.x * kMmaBM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = tid / 32 % 4, lane = tid % 32, tig = lane % 4;
  const int stages = (kw + kMmaStageWords - 1) / kMmaStageWords;

  // Packed stage t (words 8t .. 8t + 7 of every row; zeros past Kw, M and N)
  // into ring slot t % kMmaRing, two 16-byte pieces a row (neighbouring
  // threads on neighbouring pieces): one commit group a call, empty past
  // the end.
  auto load_stage = [&](int t) {
    if (t < stages) {
      uint32_t* slot = ring + (t % kMmaRing) * S::kSlotWords;
      for (int i = tid; i < S::kRows * 2; i += kMmaThreads) {
        const int r = i >> 1, k0 = t * kMmaStageWords + 4 * (i & 1);
        const bool is_x = r < kMmaBM;
        const uint32_t* base = is_x ? x : w;
        const int g = is_x ? m0 + r : n0 + r - kMmaBM;
        const bool ok = g < (is_x ? m : n) && k0 < kw;
        const uint32_t* src = base + (ok ? static_cast<long long>(g) * kw + k0 : 0);
        uint32_t* dst = slot + r * kMmaStageWords + 4 * (i & 1);
        if (VEC) {
          cp_async16(dst, src, ok ? 16 : 0);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const bool in = ok && k0 + q < kw;
            cp_async4(dst + q, in ? src + q : base, in ? 4 : 0);
          }
        }
      }
    }
    cp_async_commit();
  };
  // Stage t's w words into B buffer `dst` as +1/-1 int8: word 4a + q of row
  // r fills chunks 2q and 2q + 1 (registers j = 0..3 and 4..7 of pm1) of
  // the row in swizzle atom a, chunk c stored at c ^ (r % 8) (the 128B
  // swizzle).  Eight neighbouring lanes write rows r and r + 1 (r even) of
  // one atom: eight bank groups.
  auto unpack_w = [&](int t, unsigned char* dst) {
    const uint32_t* slot = ring + (t % kMmaRing) * S::kSlotWords + kMmaBM * kMmaStageWords;
    for (int i = tid; i < BN * kMmaStageWords; i += kMmaThreads) {
      const int q = i & 3, a = (i >> 2) / BN, r = (i >> 2) % BN;
      const uint32_t word = slot[r * kMmaStageWords + 4 * a + q];
      unsigned char* row = dst + a * S::kAtomBytes + r * 128;
      *reinterpret_cast<uint4*>(row + (((2 * q) ^ (r & 7)) << 4)) =
          make_uint4(pm1(word, 0), pm1(word, 1), pm1(word, 2), pm1(word, 3));
      *reinterpret_cast<uint4*>(row + (((2 * q + 1) ^ (r & 7)) << 4)) =
          make_uint4(pm1(word, 4), pm1(word, 5), pm1(word, 6), pm1(word, 7));
    }
  };
  // Atom `half` of stage t's A registers for this thread: a[q] is k32 step
  // 4 * half + q (that word) of its rows r and r + 8 in the m16n8k32 A
  // layout (elements 4 * tig .. + 3 and 16 + 4 * tig .. + 3: pm1 registers
  // tig and tig + 4).
  auto build_a = [&](int t, int half, uint32_t (&a)[4][4]) {
    const uint32_t* slot = ring + (t % kMmaRing) * S::kSlotWords + 4 * half;
    const int r = 64 * wg + 16 * warp + lane / 4;
    const uint4 lo4 = *reinterpret_cast<const uint4*>(slot + r * kMmaStageWords);
    const uint4 hi4 = *reinterpret_cast<const uint4*>(slot + (r + 8) * kMmaStageWords);
    const uint32_t lo[4] = {lo4.x, lo4.y, lo4.z, lo4.w}, hi[4] = {hi4.x, hi4.y, hi4.z, hi4.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[q][0] = pm1(lo[q], tig);
      a[q][1] = pm1(hi[q], tig);
      a[q][2] = pm1(lo[q], tig + 4);
      a[q][3] = pm1(hi[q], tig + 4);
    }
  };

  int acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0;
  uint32_t a_lo[4][4], a_hi[4][4];

  // Stages 0 .. kMmaRing - 2 in flight; stages 0 and 1 landed and seen by
  // every thread before stage 0 is unpacked.  Invariant: at the barrier
  // that opens iteration t, stage t + 1 is visible to every thread and B
  // buffer t % 2 holds stage t.
  for (int t = 0; t < kMmaRing - 1; ++t) load_stage(t);
  cp_async_wait<kMmaRing - 3>();
  __syncthreads();
  unpack_w(0, bbuf);
  fence_proxy_async();

  for (int t = 0; t < stages; ++t) {
    __syncthreads();
    // Slot (t - 1) % kMmaRing was last read before this barrier.
    load_stage(t + kMmaRing - 1);
    // The first atom's A registers and its four products; the second
    // atom's registers are built while those run.  Every warpgroup runs
    // them, one whose rows lie past M on zeros: a wgmma under a branch
    // ptxas cannot prove uniform is serialized (C7518).
    const unsigned char* b = bbuf + (t & 1) * S::kBBytes;
    build_a(t, 0, a_lo);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < 4; ++q) WgmmaS8<BN>::rs(acc, a_lo[q], desc_k_major_128b(b + 32 * q), 1);
    build_a(t, 1, a_hi);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < 4; ++q)
      WgmmaS8<BN>::rs(acc, a_hi[q], desc_k_major_128b(b + S::kAtomBytes + 32 * q), 1);
    wgmma_commit();
    // B buffer (t + 1) % 2 was last read by stage t - 1's products, which
    // every warpgroup waited for before this iteration's barrier.
    if (t + 1 < stages) {
      unpack_w(t + 1, bbuf + ((t + 1) & 1) * S::kBBytes);
      fence_proxy_async();
    }
    cp_async_wait<kMmaRing - 3>();  // stage t + 2 landed
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(a_lo);  // the A registers stay live until their products are done
    reg_fence(a_hi);
  }

  const int row0 = m0 + 64 * wg + 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] += affine;
  if (vec_out) {
    // Columns 8g + 2 * tig, + 1 of rows row0 (acc[4g], acc[4g + 1]) and
    // row0 + 8 (acc[4g + 2], acc[4g + 3]): an even lane gathers four
    // columns of row0 from itself and its odd neighbour, which gathers the
    // same four of row0 + 8.
    const bool odd = tig & 1;
    const int row = row0 + (odd ? 8 : 0);
#pragma unroll
    for (int g = 0; g < BN / 8; ++g) {
      const int r0 = __shfl_xor_sync(0xffffffffu, odd ? acc[4 * g] : acc[4 * g + 2], 1);
      const int r1 = __shfl_xor_sync(0xffffffffu, odd ? acc[4 * g + 1] : acc[4 * g + 3], 1);
      const int col = n0 + 8 * g + 2 * (tig & ~1);
      const int4 v = odd ? make_int4(r0, r1, acc[4 * g + 2], acc[4 * g + 3])
                         : make_int4(acc[4 * g], acc[4 * g + 1], r0, r1);
      if (row < m && col < n)  // n is a multiple of 4, so col + 3 < n too
        *reinterpret_cast<int4*>(out + static_cast<long long>(row) * n + col) = v;
    }
  } else {
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) {
      const int row = row0 + 8 * ((j >> 1) & 1);
      const int col = n0 + 8 * (j >> 2) + 2 * tig + (j & 1);
      if (row < m && col < n) out[static_cast<long long>(row) * n + col] = acc[j];
    }
  }
}

bool aligned(const void* p, unsigned bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <int BN, bool VEC>
int launch_mma(const void* x, const void* w, void* out, int experts, int m, int n, int kw,
               int k_bits, cudaStream_t stream) {
  using S = MmaShape<BN>;
  static const int opt_in = allow_shared_bytes(bnn_matmul_mma_kernel<BN, VEC>, S::kShared);
  if (opt_in) return opt_in;
  const int stages = (kw + kMmaStageWords - 1) / kMmaStageWords;
  const int affine = static_cast<int>(k_bits - 32LL * kMmaStageWords * stages);
  const bool vec_out = n % 4 == 0 && aligned(out, 16);
  const dim3 grid((m + kMmaBM - 1) / kMmaBM, (n + BN - 1) / BN, experts);
  bnn_matmul_mma_kernel<BN, VEC><<<grid, kMmaThreads, S::kShared, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(w), static_cast<int*>(out), m,
      n, kw, affine, vec_out);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_mma_bn(const void* x, const void* w, void* out, int experts, int m, int n, int kw,
                  int k_bits, cudaStream_t stream) {
  if ((n + BN - 1) / BN > 65535) return static_cast<int>(cudaErrorInvalidValue);  // grid.y
  return kw % 4 == 0 && aligned(x, 16) && aligned(w, 16)
             ? launch_mma<BN, true>(x, w, out, experts, m, n, kw, k_bits, stream)
             : launch_mma<BN, false>(x, w, out, experts, m, n, kw, k_bits, stream);
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

int mma_route(const void* x, const void* w, void* out, int experts, int m, int n, int kw,
              int k_bits, int block_n, void* stream) {
  // m + kMmaBM - 1 must not overflow (kernels/bnn_matmul.py _MAX_ROWS).
  if (experts < 1 || experts > kMaxExperts || m < 1 || m > 0x7FFFFFFF - kMmaBM || n < 1 ||
      kw < 1 || kw >= (1 << 25)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block_n) {
    case 128: return launch_mma_bn<128>(x, w, out, experts, m, n, kw, k_bits, s);
    case 64: return launch_mma_bn<64>(x, w, out, experts, m, n, kw, k_bits, s);
    case 32: return launch_mma_bn<32>(x, w, out, experts, m, n, kw, k_bits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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

// The int8 tensor-core route; block_n (128, 64 or 32) is the output
// tile's width, kernels/bnn_matmul.py::mma_block_n's choice.
extern "C" int bnn_matmul_packed_mma(const void* x, const void* w, void* out, int m, int n, int kw,
                                     int k_bits, int block_n, void* stream) {
  return mma_route(x, w, out, 1, m, n, kw, k_bits, block_n, stream);
}

extern "C" int bnn_matmul_packed_experts_mma(const void* x, const void* w, void* out, int e, int c,
                                             int o, int kw, int k_bits, int block_n, void* stream) {
  return mma_route(x, w, out, e, c, o, kw, k_bits, block_n, stream);
}
