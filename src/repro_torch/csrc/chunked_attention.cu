// Softmax attention over a whole prompt with the reference's roundings, for
// Hopper (sm_90a).
//
// Replaces the jnp of src/repro/layers/attention.py:104-152
// (chunked_attention), which the reference leaves to XLA: no Pallas kernel.
//
// What it computes: q (B, S_q, H, Dqk), k (B, S_k, KVH, Dqk), v (B, S_k,
// KVH, Dv), all float32 or all bf16; query head h reads KV head h / G.
//   s = (q . k) as a float32 sum of the products, times `scale`; with
//   bf16 scores the sum is rounded to bf16, multiplied by bf16(scale) and
//   rounded again;  -inf past the query's position when causal (key j is
//   kept for query i when j <= i);
//   p = e^(s - max) / sum e^(s - max) over the row, in float32 with the
//   row's final max and sum, then rounded to q's type;
//   out = sum p v in float32, rounded to q's type.
// q_chunk does not change the function and is not an argument.
//
// What bounds it on this card: the operations, 2 (Dqk + Dv) a (query, key)
// pair of each head (the causal half when causal): phi3's prefill of 2 x
// 32,768 tokens is 1.3e13 of them a layer against 1.6 GB of q, k, v and out.
// Because p is rounded after it is normalised, the online softmax (flash's
// running rescale) would round it at other places; so a block walks the
// keys twice: the first pass takes each row's max and sum (rescaled online,
// exactly the row's final max), the second recomputes the scores bit for
// bit, normalises, rounds and accumulates P V.  That is 1.5 times the
// function's products on the tensor cores and two exponentials a pair on
// the exp2 unit (about 16 a clock an SM): at phi3's 32k prefill about 10
// ms of products and 9 ms of exponentials, a floor of about 10 ms where
// they overlap.
//
// Design: the jnp writes a float32 (Cq, S) score block a head per query
// chunk to device memory and reads it back for the scale, the mask, the
// softmax and the cast.  Here no score leaves the SM.  A block owns a tile
// of query rows of one (b, head) and reads K and V of head h / G directly
// (no repeated KV heads); key tiles past a causal tile's last row are
// skipped, and the longest causal tiles launch first, the q tiles of one
// head next to each other so the blocks in flight share its K and V in L2.
// e^x is taken as 2^(x log2(e)) (an FFMA and the exp2 unit) and p as
// e^(s - m) times 1 / l: a few float32 ulps from the reference's exp and
// division, far inside p's rounding to bf16.  The mask is tested only on
// tiles that cross S or the diagonal.  Three kernels, one entry point each
// (kernels/chunked_attention.py::route picks one by type, shape and
// alignment):
//
// * tma (bf16, Dqk and Dv multiples of 8, Dqk <= 192, Dv <= 128, 16-byte
//   aligned operands and strides: every served prefill).  384 threads: one
//   producer thread keeps TMA loads in flight (4-D tensor maps over the
//   (B, S, heads, D) views as they are, 64-column boxes under the 128B
//   swizzle, zeros past S and D) of 128-key K tiles, and in the second pass
//   V tiles, into rings of stages with full and empty mbarriers; two
//   consumer warpgroups own 64 query rows each.  QK^T is wgmma with K
//   K-major in shared memory and Q from registers (A fragments loaded once;
//   where Dqk + Dv > 224, Q from shared memory, for the registers); PV is
//   wgmma with P from registers (rounded to bf16 straight into the A
//   fragments) and V MN-major (the transpose bit).  Pass 1 takes 128 keys a
//   product (narrower products run below the tensor cores' rate) and keeps
//   the row max and sum; pass 2 takes a tile's keys in two halves of 64
//   (its scores, P and output accumulators fill the 168 registers a thread
//   of a 384-thread block has: ptxas allocates no more after setmaxnreg),
//   issuing S of one half with P V of the half before, so the exponentials
//   of one run while the other product is on the tensor cores.  Dqk is
//   padded to 64, 96, 128 or 192 and Dv to 64, 96 or 128 (template widths).
// * mma (bf16 that TMA cannot take: D % 8 != 0, Dqk > 192, Dv > 128 or a
//   misaligned operand; the first design): eight warps of 16 query rows (four
//   where Dv > 128); 64-key K and V tiles double-buffered in shared memory
//   by cp.async (16-byte copies; element copies for D % 8 != 0 or
//   misaligned operands), rows padded by 16 bytes so ldmatrix reads no bank
//   twice; QK^T and PV on mma.sync m16n8k16 bf16 with float32 accumulators,
//   scores and O in registers.  Dv padded to a template width (32 .. 256).
// * f32 (CUDA cores; a tensor-core float32 product would round to TF32):
//   256 threads, four to a query row, each scoring 16 of a tile's keys and
//   owning every fourth output column.
//
// Scores in both bf16 kernels are float32 sums of exact bf16 products (the
// reference's precision).

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;   // keys a tile
constexpr int kMaxDim = 256;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int s_q, s_k, heads, kv_heads, dqk, dv;
  float scale;  // float32; with bf16 scores the bf16 scale, exactly
  int scores_bf16, causal, vec;
};

__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// The score of one (query, key) pair from its float32 sum, as the reference
// rounds it; -inf where masked.
__device__ __forceinline__ float score(float sum, const Args& a, int row, int key) {
  if (key >= a.s_k || (a.causal && key > row)) return -INFINITY;
  return a.scores_bf16 ? bf16_round(bf16_round(sum) * a.scale) : sum * a.scale;
}

// Key tiles a block of `rows` query rows from q0 reads.
__device__ __forceinline__ int key_tiles(const Args& a, int q0, int rows) {
  const int all = (a.s_k + kBK - 1) / kBK;
  return a.causal ? min(all, (q0 + rows - 1) / kBK + 1) : all;
}

// ---- bf16: tensor cores ------------------------------------------------------

// Warps a block (16 query rows each): eight up to Dv = 128, two blocks an
// SM where Dv's accumulators leave room for them (at most 128 registers a
// thread); four past it.
template <int DVP>
struct Bf16Block {
  static constexpr int kWarps = DVP <= 128 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;
  static constexpr int kMinBlocks = DVP <= 96 ? 2 : 1;
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix of four 8x8 matrices, transposed: r[i] holds matrix i's
// elements (2 (lane % 4), lane / 4) and (2 (lane % 4) + 1, lane / 4).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_u32(row))
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Copy rows r0 .. r0 + count - 1 (those below `rows`) of `base` (row r at
// base + r * stride), columns [0, width) of which [0, dim) are data, into
// `dst` (row stride ld) with kNT threads; the rest are zeros.  One commit
// group.
template <int kNT>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* base, long long stride, int r0,
                                          int count, int rows, int dim, int width, bool vec) {
  const int chunks = width / 8;
  for (int i = threadIdx.x; i < count * chunks; i += kNT) {
    const int r = i / chunks, c = i % chunks;
    const int row = r0 + r;
    bf16* out = dst + r * ld + 8 * c;
    if (vec) {
      const bool live = row < rows && 8 * c < dim;
      cp_async16(out, live ? base + row * stride + 8 * c : base, live ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int col = 8 * c + e;
        out[e] = row < rows && col < dim ? base[row * stride + col] : __float2bfloat16_rn(0.f);
      }
    }
  }
  cp_async_commit();
}

// S = Q K^T of this warp's 16 rows and the tile's 64 keys: sc[j] is key
// n-tile j (keys 8j ..) in the mma accumulator layout (rows lane / 4 and
// + 8, keys 2 (lane % 4) and + 1).
__device__ __forceinline__ void qk(float (&sc)[kBK / 8][4], const bf16* qs, const bf16* kt, int ld, int width,
                                   int warp, int lane) {
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
  const bf16* qrow = qs + (16 * warp + lane % 8 + 8 * ((lane / 8) % 2)) * ld + 8 * (lane / 16);
  const bf16* krow = kt + (lane % 8 + 8 * (lane / 16)) * ld + 8 * ((lane / 8) % 2);
#pragma unroll 2
  for (int kk = 0; kk < width; kk += 16) {
    uint32_t a[4];
    hopper::ldmatrix_x4(a, qrow + kk);
#pragma unroll
    for (int np = 0; np < kBK / 16; ++np) {
      uint32_t b[4];
      hopper::ldmatrix_x4(b, krow + 16 * np * ld + kk);
      mma_bf16(sc[2 * np], a, b[0], b[1]);
      mma_bf16(sc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// The scores of the tile at k0 as the reference rounds and masks them; the
// mask is tested only on a tile that crosses S_k or the diagonal of the
// warp's rows (from row0).
__device__ __forceinline__ void finish_scores(float (&sc)[kBK / 8][4], const Args& a, int k0, int row0,
                                              int row_a, int t4) {
  if (k0 + kBK > a.s_k || (a.causal && k0 + kBK - 1 > row0)) {
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = score(sc[j][e], a, row_a + 8 * (e / 2), k0 + 8 * j + 2 * t4 + e % 2);
  } else if (a.scores_bf16) {
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = bf16_round(bf16_round(sc[j][e]) * a.scale);
  } else {
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] *= a.scale;
  }
}

// e^(s - m) as 2^(s log2(e) - m log2(e)): one FFMA and the exp2 unit; within
// a few float32 ulps of expf, far inside a bf16 rounding of p.
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float exp_shifted(float s, float m_log2) { return exp2f(fmaf(s, kLog2e, -m_log2)); }

template <int DVP>
struct Bf16Layout {
  int width, ldq;  // Dqk padded to 16; Q and K row stride (+16 bytes)
  static constexpr int kLdv = DVP + 8;
  size_t bytes;
  __host__ __device__ explicit Bf16Layout(int dqk)
      : width((dqk + 15) / 16 * 16), ldq(width + 8),
        bytes((static_cast<size_t>(Bf16Block<DVP>::kRows) * ldq + 2 * kBK * ldq + 2 * kBK * kLdv) *
              sizeof(bf16)) {}
};

template <int DVP>
__global__ void __launch_bounds__(Bf16Block<DVP>::kThreads, Bf16Block<DVP>::kMinBlocks)
chunked_attention_bf16_kernel(Args a) {
  constexpr int kBQ = Bf16Block<DVP>::kRows, kNT = Bf16Block<DVP>::kThreads;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Bf16Layout<DVP> lay(a.dqk);
  constexpr int ldv = Bf16Layout<DVP>::kLdv;
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // kBQ x ldq
  bf16* ks = qs + kBQ * lay.ldq;                  // 2 stages x kBK x ldq
  bf16* vs = ks + 2 * kBK * lay.ldq;              // 2 stages x kBK x ldv

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // the longest causal tiles first
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (a.heads / a.kv_heads);
  const bf16* qb = static_cast<const bf16*>(a.q) + (static_cast<long long>(b) * a.s_q * a.heads + head) * a.dqk;
  const bf16* kb = static_cast<const bf16*>(a.k) + (static_cast<long long>(b) * a.s_k * a.kv_heads + kvh) * a.dqk;
  const bf16* vb = static_cast<const bf16*>(a.v) + (static_cast<long long>(b) * a.s_k * a.kv_heads + kvh) * a.dv;
  const long long q_stride = static_cast<long long>(a.heads) * a.dqk;
  const long long k_stride = static_cast<long long>(a.kv_heads) * a.dqk;
  const long long v_stride = static_cast<long long>(a.kv_heads) * a.dv;
  const bool vec = a.vec != 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t4 = lane % 4;
  const int row0 = q0 + 16 * warp;               // the warp's first row
  const int row_a = row0 + lane / 4;             // this thread's rows: row_a and row_a + 8
  const int tiles = key_tiles(a, q0, kBQ);

  // Pass 1: each row's max and sum, K tiles only.
  load_rows<kNT>(qs, lay.ldq, qb, q_stride, q0, kBQ, a.s_q, a.dqk, lay.width, vec);
  load_rows<kNT>(ks, lay.ldq, kb, k_stride, 0, kBK, a.s_k, a.dqk, lay.width, vec);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      load_rows<kNT>(ks + ((t + 1) & 1) * kBK * lay.ldq, lay.ldq, kb, k_stride, (t + 1) * kBK, kBK, a.s_k,
                     a.dqk, lay.width, vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float sc[kBK / 8][4];
    qk(sc, qs, ks + (t & 1) * kBK * lay.ldq, lay.ldq, lay.width, warp, lane);
    finish_scores(sc, a, t * kBK, row0, row_a, t4);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      if (m_new > -INFINITY) {  // a row with no live key yet adds nothing
        const float m_log2 = m_new * kLog2e;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
          sum += exp_shifted(sc[j][2 * r], m_log2) + exp_shifted(sc[j][2 * r + 1], m_log2);
        l[r] = l[r] * exp_shifted(m[r], m_log2) + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();  // the stage is free for the load after next
  }
  float m_log2[2], inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    m_log2[r] = m[r] * kLog2e;
    inv_l[r] = 1.f / l[r];
  }

  // Pass 2: the same scores, p = e^(s - m) / l rounded to bf16, O += P V.
  float o[DVP / 8][4];
#pragma unroll
  for (int j = 0; j < DVP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  load_rows<kNT>(ks, lay.ldq, kb, k_stride, 0, kBK, a.s_k, a.dqk, lay.width, vec);
  load_rows<kNT>(vs, ldv, vb, v_stride, 0, kBK, a.s_k, a.dv, DVP, vec);
  const bf16* vrow = vs + (lane % 8 + 8 * ((lane / 8) % 2)) * ldv + 8 * (lane / 16);
  for (int t = 0; t < tiles; ++t) {
    const int next = (t + 1) & 1;
    if (t + 1 < tiles) {
      load_rows<kNT>(ks + next * kBK * lay.ldq, lay.ldq, kb, k_stride, (t + 1) * kBK, kBK, a.s_k, a.dqk,
                     lay.width, vec);
      load_rows<kNT>(vs + next * kBK * ldv, ldv, vb, v_stride, (t + 1) * kBK, kBK, a.s_k, a.dv, DVP, vec);
      cp_async_wait<2>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float sc[kBK / 8][4];
    qk(sc, qs, ks + (t & 1) * kBK * lay.ldq, lay.ldq, lay.width, warp, lane);
    finish_scores(sc, a, t * kBK, row0, row_a, t4);
    const bf16* vt = vrow + (t & 1) * kBK * ldv;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      float p[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[h][e] = exp_shifted(sc[2 * kk + h][e], m_log2[e / 2]) * inv_l[e / 2];
      const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
      for (int dn = 0; dn < DVP / 16; ++dn) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vt + 16 * kk * ldv + 16 * dn);
        mma_bf16(o[2 * dn], pa, bv[0], bv[1]);
        mma_bf16(o[2 * dn + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();
  }

  bf16* ob = static_cast<bf16*>(a.out) + (static_cast<long long>(b) * a.s_q * a.heads + head) * a.dv;
  const long long o_stride = static_cast<long long>(a.heads) * a.dv;
#pragma unroll
  for (int j = 0; j < DVP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row_a + 8 * (e / 2), col = 8 * j + 2 * t4 + e % 2;
      if (row < a.s_q && col < a.dv) ob[row * o_stride + col] = __float2bfloat16_rn(o[j][e]);
    }
}

// ---- bf16 on wgmma, fed by TMA ("tma") -------------------------------------------

constexpr int kTBQ = 128;        // query rows a block: two consumer warpgroups of 64
constexpr int kTBK = 128;        // keys a tile: pass 1's scores' N (a narrower product runs below rate)
constexpr int kHalf = kTBK / 2;  // keys pass 2 takes at a time: its registers hold no more
constexpr int kTThreads = 384;   // two consumer warpgroups and a producer
constexpr int kConsumerWarps = 8;
constexpr int kMaxTmaDqk = 192, kMaxTmaDv = 128;

// DQ: Dqk padded to 64, 96, 128 or 192 (the QK product's depth, DQ / 16
// k-steps); DN: Dv padded to 64, 96 or 128 (the PV product's N).  K and V
// tiles (128 keys) are held as 64-column TMA boxes (128-byte rows, 128B
// swizzle); a box's columns past D arrive as zeros and add nothing.  Where
// DQ + DN <= 224 each consumer holds its Q rows in registers, the A operand
// of QK^T, so the product reads only K from shared memory; past that the
// 168 registers a thread of a 384-thread block has go to the accumulators
// and Q sits in shared memory (128-row boxes, loaded once).
template <int DQ, int DN>
struct TmaChunked {
  static constexpr bool kQInRegisters = DQ + DN <= 224;
  static constexpr int kKBoxes = (DQ + 63) / 64, kVBoxes = (DN + 63) / 64;
  static constexpr int kBoxBytes = 128 * 128;  // 128 rows of 64 bf16
  static constexpr int kQBytes = kQInRegisters ? 0 : kKBoxes * kBoxBytes;
  static constexpr int kKBytes = kKBoxes * kBoxBytes, kVBytes = kVBoxes * kBoxBytes;
  static constexpr int kStages = kQBytes + 3 * (kKBytes + kVBytes) <= 200 * 1024 ? 3 : 2;
  static constexpr int kBarOffset = kQBytes + kStages * (kKBytes + kVBytes);
  static constexpr size_t kSharedBytes =
      kBarOffset + (1 + 4 * kStages) * sizeof(uint64_t) + 1024;  // + alignment slack
};

struct TmaArgs {
  const bf16* q;
  long long q_sb, q_ss, q_sh;  // q's batch, position and head strides, elements
  int s_q, s_k, heads, group, dqk, dv;
  float scale;  // float32; with bf16 scores the bf16 scale, exactly
  int mode;     // kRawScores, kScaledScores or kBf16Scores
  int causal;
};

// How a tile's float32 sums become softmax inputs x, and the c of
// p = 2^(x c - m c): the sum itself with the scale folded into c (float32
// scores, scale > 0: the max of the sums is the max of the scores); the
// sum times the scale; or the bf16 scores' two roundings.
constexpr int kRawScores = 0, kScaledScores = 1, kBf16Scores = 2;

template <int kMode>
__device__ __forceinline__ float softmax_input(float sum, float scale) {
  if (kMode == kRawScores) return sum;
  if (kMode == kScaledScores) return sum * scale;
  return bf16_round(bf16_round(sum) * scale);
}

__device__ __forceinline__ float fast_exp2(float x) {  // 2^x; 0 at -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The key tile at k0 as softmax inputs, in place, for this thread's rows
// row_a and row_a + 8 (the wgmma accumulator layout, hopper.cuh: sc[j] is
// row row_a + 8 ((j / 2) % 2), key k0 + 8 (j / 4) + col_t + j % 2); -inf
// where masked, tested only on a tile that crosses S_k or the diagonal of
// the warpgroup's rows from k_row0.
template <int kMode, int N>
__device__ __forceinline__ void tile_inputs(float (&sc)[N / 2], const TmaArgs& a, int k0, int k_row0, int row_a,
                                            int col_t) {
  const bool edge = k0 + N > a.s_k || (a.causal && k0 + N - 1 > k_row0);
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    float x = softmax_input<kMode>(sc[j], a.scale);
    if (edge) {
      const int key = k0 + 8 * (j >> 2) + col_t + (j & 1);
      if (key >= a.s_k || (a.causal && key > row_a + 8 * ((j >> 1) & 1))) x = -INFINITY;
    }
    sc[j] = x;
  }
}

// The max of each of this thread's two rows over a tile, as a tree (short
// dependency chains: two warps an SM partition hide little latency).
template <int N>
__device__ __forceinline__ void tile_max(const float (&sc)[N / 2], float (&mx)[2]) {
  float part[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) part[r][i] = -INFINITY;
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    float& p = part[(j >> 1) & 1][(j >> 2) & 3];
    p = fmaxf(p, sc[j]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) mx[r] = fmaxf(fmaxf(part[r][0], part[r][1]), fmaxf(part[r][2], part[r][3]));
}

// Pass 1's recurrence over one tile of inputs: the rows' running max m
// (quad-wide) and this thread's share of the running sum l, rescaled by
// 2^((m_old - m_new) c).  A row with no live key yet adds nothing.
template <int N>
__device__ __forceinline__ void row_stats(const float (&sc)[N / 2], float (&m)[2], float (&l)[2], float c) {
  float mx[2], m_sub[2], alpha[2];
  tile_max<N>(sc, mx);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    const bool live = m_new > -INFINITY;
    m_sub[r] = live ? m_new * c : 0.f;
    alpha[r] = live ? fast_exp2(fmaf(m[r], c, -m_sub[r])) : 0.f;
    m[r] = m_new;
  }
  float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const int r = (j >> 1) & 1;
    part[r][(j >> 2) & 3] += fast_exp2(fmaf(sc[j], c, -m_sub[r]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ((part[r][0] + part[r][1]) + (part[r][2] + part[r][3]));
}

// One consumer warp is done with a stage: its lane 0 arrives.
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(empty);
}

// This consumer's Q: in registers (qa[kk], k-step kk's A fragment in the
// mma.sync m16n8k16 layout: rows row_a and row_a + 8, columns 16 kk +
// col_t, + 1, + 8, + 9; zeros past S_q and Dqk), or this warpgroup's rows
// of the Q boxes in shared memory.
template <int DQ, int DN>
struct QOperand {
  uint32_t qa[TmaChunked<DQ, DN>::kQInRegisters ? DQ / 16 : 1][4];
  const unsigned char* q_wg;
};

// Issue S = Q K^T for N keys from `k_rows` (not waited for): float32 in
// registers, K K-major in shared memory (the rows of one 128-key tile, or
// of one half of it: 64 rows on is 8 KB on in every box).
template <int DQ, int DN, int N>
__device__ __forceinline__ void issue_scores(float (&sc)[N / 2], const QOperand<DQ, DN>& q,
                                             const unsigned char* k_rows) {
  using namespace hopper;
  using L = TmaChunked<DQ, DN>;
#pragma unroll
  for (int kk = 0; kk < DQ / 16; ++kk) {
    const uint64_t desc_k = desc_k_major_128b(k_rows + (kk / 4) * L::kBoxBytes + 32 * (kk % 4));
    if constexpr (L::kQInRegisters)
      Wgmma<N>::template rs<0>(sc, q.qa[kk], desc_k, kk > 0);
    else
      Wgmma<N>::template ss<0>(sc, desc_k_major_128b(q.q_wg + (kk / 4) * L::kBoxBytes + 32 * (kk % 4)), desc_k,
                               kk > 0);
  }
}

// Issue O += P V for 64 keys from `v_rows` (not waited for): P from
// registers (keys 16kk .. 16kk + 15 in p[4kk .. 4kk + 3]), V MN-major (Dv
// contiguous) through the transpose bit.
template <int DQ, int DN>
__device__ __forceinline__ void issue_pv(float (&o)[DN / 2], const uint32_t (&p)[kHalf / 4],
                                         const unsigned char* v_tile) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < kHalf / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    Wgmma<DN>::template rs<1>(o, a, desc_mn_major_128b(v_tile + 2048 * kk, TmaChunked<DQ, DN>::kBoxBytes), 1);
  }
}

template <int DQ, int DN>
__global__ void __launch_bounds__(kTThreads, 1)
chunked_attention_tma_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ out, TmaArgs a) {
  using namespace hopper;
  using L = TmaChunked<DQ, DN>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_shared(smem_raw, 1024);
  unsigned char* q_s = smem;                        // kQBytes (none with Q in registers)
  unsigned char* k_s = smem + L::kQBytes;           // stage s at + s * L::kKBytes
  unsigned char* v_s = k_s + kStages * L::kKBytes;  // stage s at + s * L::kVBytes
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + kStages;
  uint64_t* v_full = k_empty + kStages;
  uint64_t* v_empty = v_full + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTBQ;  // the longest causal tiles first
  const int head = blockIdx.y, b = blockIdx.z, kvh = head / a.group;
  int tiles = (a.s_k + kTBK - 1) / kTBK;
  if (a.causal) tiles = min(tiles, (q0 + kTBQ - 1) / kTBK + 1);  // skip tiles past the diagonal

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, kConsumerWarps);
      mbar_init(v_empty + s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The warpgroup index, broadcast from lane 0 so that the compiler sees it
  // is uniform across each warp and setmaxnreg applies to each branch.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {  // the producer warpgroup: one thread issues every load
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      tma_prefetch_map(&k_map);
      tma_prefetch_map(&v_map);
      if constexpr (!L::kQInRegisters) {
        tma_prefetch_map(&q_map);
        mbar_arrive_expect_tx(q_full, L::kQBytes);
#pragma unroll
        for (int box = 0; box < L::kKBoxes; ++box)
          tma_load_4d(q_s + box * L::kBoxBytes, &q_map, q_full, 64 * box, head, q0, b);
      }
      // Pass 1's K tiles, then pass 2's K and V tiles: K tile n of the
      // sequence goes to K stage n % kStages.
      for (int n = 0; n < 2 * tiles; ++n) {
        const int s = n % kStages, t = n < tiles ? n : n - tiles;
        mbar_wait(k_empty + s, ((n / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(k_full + s, L::kKBytes);
#pragma unroll
        for (int box = 0; box < L::kKBoxes; ++box)
          tma_load_4d(k_s + s * L::kKBytes + box * L::kBoxBytes, &k_map, k_full + s, 64 * box, kvh, t * kTBK, b);
        if (n >= tiles) {
          const int sv = t % kStages;
          mbar_wait(v_empty + sv, ((t / kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(v_full + sv, L::kVBytes);
#pragma unroll
          for (int box = 0; box < L::kVBoxes; ++box)
            tma_load_4d(v_s + sv * L::kVBytes + box * L::kBoxBytes, &v_map, v_full + sv, 64 * box, kvh,
                        t * kTBK, b);
        }
      }
    }
  } else {
    // Two consumer warpgroups, 64 query rows each: their score,
    // probability, output (and Q) registers need more than 168 a thread.
    // This thread's rows are row_a and row_a + 8; its columns in each
    // 8-column group col_t and col_t + 1 (the wgmma accumulator layout).
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int k_row0 = q0 + 64 * wg;  // this warpgroup's first row
    const int row_a = k_row0 + 16 * warp + lane / 4;
    const int col_t = 2 * (lane % 4);
    QOperand<DQ, DN> q;
    q.q_wg = q_s + wg * 64 * 128;
    if constexpr (L::kQInRegisters) {
      const bf16* qh = a.q + b * a.q_sb + head * a.q_sh;
      auto pair = [&](int row, int col) -> uint32_t {
        return row < a.s_q && col < a.dqk ? *reinterpret_cast<const uint32_t*>(qh + row * a.q_ss + col) : 0u;
      };
#pragma unroll
      for (int kk = 0; kk < DQ / 16; ++kk) {
        const int col = 16 * kk + col_t;
        q.qa[kk][0] = pair(row_a, col);
        q.qa[kk][1] = pair(row_a + 8, col);
        q.qa[kk][2] = pair(row_a, col + 8);
        q.qa[kk][3] = pair(row_a + 8, col + 8);
      }
    } else {
      mbar_wait(q_full, 0);
    }
    const float c = a.mode == kRawScores ? a.scale * kLog2e : kLog2e;

    // Pass 1: each row's max and sum, K tiles only, 128 keys a product.
    // The two consumer warpgroups overlap each other's products and
    // exponentials.
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    {
      float sc[kTBK / 2];
#pragma unroll
      for (int j = 0; j < kTBK / 2; ++j) sc[j] = 0.f;
      for (int t = 0; t < tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(k_full + s, (t / kStages) & 1);
        reg_fence(sc);
        wgmma_fence();
        issue_scores<DQ, DN, kTBK>(sc, q, k_s + s * L::kKBytes);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(sc);
        release(k_empty + s, lane);
        if (a.mode == kRawScores)
          tile_inputs<kRawScores, kTBK>(sc, a, t * kTBK, k_row0, row_a, col_t);
        else if (a.mode == kScaledScores)
          tile_inputs<kScaledScores, kTBK>(sc, a, t * kTBK, k_row0, row_a, col_t);
        else
          tile_inputs<kBf16Scores, kTBK>(sc, a, t * kTBK, k_row0, row_a, col_t);
        row_stats<kTBK>(sc, m, l, c);
      }
    }
    float m_sub[2], inv_l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      m_sub[r] = m[r] > -INFINITY ? m[r] * c : 0.f;
      inv_l[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    }

    // Pass 2: the same inputs, p = 2^(x c - m c) / l rounded to bf16 into
    // the A registers, O += P V, over 64-key halves u of the tiles (half u
    // % 2 of tile u / 2).  S of half u and P V of half u - 1 are issued
    // together; the exponentials of half u run while P V(u - 1) is on the
    // tensor cores.  A tile's K stage is released after both halves' S,
    // its V stage after both halves' P V.
    auto probs = [&](float (&sc)[kHalf / 2], int u) {
      const int k0 = u * kHalf;
      if (a.mode == kRawScores)
        tile_inputs<kRawScores, kHalf>(sc, a, k0, k_row0, row_a, col_t);
      else if (a.mode == kScaledScores)
        tile_inputs<kScaledScores, kHalf>(sc, a, k0, k_row0, row_a, col_t);
      else
        tile_inputs<kBf16Scores, kHalf>(sc, a, k0, k_row0, row_a, col_t);
#pragma unroll
      for (int j = 0; j < kHalf / 2; ++j) {
        const int r = (j >> 1) & 1;
        sc[j] = fast_exp2(fmaf(sc[j], c, -m_sub[r])) * inv_l[r];
      }
    };
    auto k_half = [&](int u) {  // half u's K rows: tile u / 2 of pass 2's K sequence
      return k_s + (tiles + u / 2) % kStages * L::kKBytes + (u % 2) * (kHalf * 128);
    };
    auto v_half = [&](int u) { return v_s + (u / 2) % kStages * L::kVBytes + (u % 2) * (kHalf * 128); };
    float o[DN / 2], sa[kHalf / 2];
#pragma unroll
    for (int j = 0; j < DN / 2; ++j) o[j] = 0.f;
#pragma unroll
    for (int j = 0; j < kHalf / 2; ++j) sa[j] = 0.f;
    uint32_t pa[kHalf / 4];
    mbar_wait(k_full + tiles % kStages, (tiles / kStages) & 1);
    reg_fence(sa);
    wgmma_fence();
    issue_scores<DQ, DN, kHalf>(sa, q, k_half(0));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sa);
    probs(sa, 0);
#pragma unroll
    for (int i = 0; i < kHalf / 4; ++i) pa[i] = pack_bf16(sa[2 * i], sa[2 * i + 1]);
    for (int u = 1; u < 2 * tiles; ++u) {
      const int n = tiles + u / 2;  // the K sequence's tile of half u
      if (u % 2 == 0) mbar_wait(k_full + n % kStages, (n / kStages) & 1);
      if (u % 2 == 1) mbar_wait(v_full + (u / 2) % kStages, ((u / 2) / kStages) & 1);  // V of half u - 1
      reg_fence(sa);
      reg_fence(o);
      wgmma_fence();
      issue_scores<DQ, DN, kHalf>(sa, q, k_half(u));
      wgmma_commit();
      issue_pv<DQ, DN>(o, pa, v_half(u - 1));
      wgmma_commit();
      wgmma_wait<1>();  // S of half u is ready
      reg_fence(sa);
      if (u % 2 == 1) release(k_empty + n % kStages, lane);
      probs(sa, u);
      wgmma_wait<0>();  // P V of half u - 1 is done
      reg_fence(o);
      if (u % 2 == 0) release(v_empty + (u / 2 - 1) % kStages, lane);
#pragma unroll
      for (int i = 0; i < kHalf / 4; ++i) pa[i] = pack_bf16(sa[2 * i], sa[2 * i + 1]);
    }
    reg_fence(o);
    wgmma_fence();
    issue_pv<DQ, DN>(o, pa, v_half(2 * tiles - 1));
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);

    // out = sum p v, rounded to bf16; Dv is a multiple of 8, so col + 1 < Dv.
    const long long o_row = static_cast<long long>(a.heads) * a.dv;
    bf16* ob = out + (static_cast<long long>(b) * a.s_q * a.heads + head) * a.dv;
#pragma unroll
    for (int j = 0; j < DN / 2; j += 2) {
      const int row = row_a + 8 * ((j >> 1) & 1), col = 8 * (j >> 2) + col_t;
      if (row < a.s_q && col < a.dv)
        *reinterpret_cast<__nv_bfloat162*>(ob + row * o_row + col) = __floats2bfloat162_rn(o[j], o[j + 1]);
    }
  }
}

// A (D, heads, S, B) tensor map of a (B, S, heads, D) bf16 operand with
// element strides sb, ss, sh (a position's head dim contiguous) and a box
// of 64 columns, one head, 128 positions and one batch: a box never crosses
// into another head or batch, and positions past S and columns past D
// arrive as zeros.
int operand_map(CUtensorMap* map, const void* base, int batch, int s, int heads, int d, long long sb,
                long long ss, long long sh) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, 128, 1};
  return hopper::bf16_tensor_map(map, base, 4, dims, strides, box);
}

struct TmaOperands {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  long long strides[9];  // q, k, v: batch, position and head strides in elements
};

template <int DQ, int DN>
int launch_tma(const TmaOperands& ops, const TmaArgs& a, int batch, int kv_heads, void* stream) {
  const long long* st = ops.strides;
  CUtensorMap maps[3];
  int err = operand_map(&maps[0], ops.q, batch, a.s_q, a.heads, a.dqk, st[0], st[1], st[2]);
  if (!err) err = operand_map(&maps[1], ops.k, batch, a.s_k, kv_heads, a.dqk, st[3], st[4], st[5]);
  if (!err) err = operand_map(&maps[2], ops.v, batch, a.s_k, kv_heads, a.dv, st[6], st[7], st[8]);
  if (err) return err;
  auto kernel = chunked_attention_tma_kernel<DQ, DN>;
  constexpr size_t smem = TmaChunked<DQ, DN>::kSharedBytes;
  err = allow_shared_bytes(kernel, smem);
  if (err) return err;
  const dim3 grid((a.s_q + kTBQ - 1) / kTBQ, a.heads, batch);
  kernel<<<grid, kTThreads, smem, static_cast<cudaStream_t>(stream)>>>(maps[0], maps[1], maps[2],
                                                                        static_cast<bf16*>(ops.out), a);
  return static_cast<int>(cudaGetLastError());
}

template <int DQ>
int launch_tma_dv(const TmaOperands& ops, const TmaArgs& a, int batch, int kv_heads, void* stream) {
  if (a.dv <= 64) return launch_tma<DQ, 64>(ops, a, batch, kv_heads, stream);
  if (a.dv <= 96) return launch_tma<DQ, 96>(ops, a, batch, kv_heads, stream);
  return launch_tma<DQ, 128>(ops, a, batch, kv_heads, stream);
}

// ---- float32: CUDA cores -------------------------------------------------------

constexpr int kFRows = 64;         // query rows a block
constexpr int kFThreads = 256;     // four to a query row
constexpr int kKeys = kBK / 4;     // keys a thread scores a tile
constexpr int kLdP = kBK + 1;

// Rows r0 .. r0 + 63 of `base` (columns [0, dim)) into dst (stride dim + 1),
// zeros past `rows`.
__device__ __forceinline__ void load_rows_f32(float* dst, const float* base, long long stride, int r0,
                                              int rows, int dim) {
  const int ld = dim + 1;
  for (int i = threadIdx.x; i < kBK * dim; i += kFThreads) {
    const int r = i / dim, c = i % dim;
    dst[r * ld + c] = r0 + r < rows ? base[(r0 + r) * stride + c] : 0.f;
  }
}

// This thread's keys quad, quad + 4, ... of the tile at k0 against its row.
__device__ __forceinline__ void scores_f32(float (&sc)[kKeys], const float* qs, const float* ks,
                                           const Args& a, int row, int quad, int k0, int q_pos) {
  const int ld = a.dqk + 1;
#pragma unroll
  for (int i = 0; i < kKeys; ++i) sc[i] = 0.f;
  for (int c = 0; c < a.dqk; ++c) {
    const float qc = qs[row * ld + c];
#pragma unroll
    for (int i = 0; i < kKeys; ++i) sc[i] = fmaf(qc, ks[(quad + 4 * i) * ld + c], sc[i]);
  }
#pragma unroll
  for (int i = 0; i < kKeys; ++i) sc[i] = score(sc[i], a, q_pos, k0 + quad + 4 * i);
}

template <int kCols>  // output columns a thread owns, at most
__global__ void __launch_bounds__(kFThreads)
chunked_attention_f32_kernel(Args a) {
  extern __shared__ float smem[];
  float* qs = smem;                       // kFRows x (dqk + 1)
  float* ks = qs + kFRows * (a.dqk + 1);  // kBK x (dqk + 1)
  float* vs = ks + kBK * (a.dqk + 1);     // kBK x (dv + 1)
  float* ps = vs + kBK * (a.dv + 1);      // kFRows x kLdP

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kFRows;
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (a.heads / a.kv_heads);
  const float* qb = static_cast<const float*>(a.q) + (static_cast<long long>(b) * a.s_q * a.heads + head) * a.dqk;
  const float* kb = static_cast<const float*>(a.k) + (static_cast<long long>(b) * a.s_k * a.kv_heads + kvh) * a.dqk;
  const float* vb = static_cast<const float*>(a.v) + (static_cast<long long>(b) * a.s_k * a.kv_heads + kvh) * a.dv;
  const long long k_stride = static_cast<long long>(a.kv_heads) * a.dqk;
  const long long v_stride = static_cast<long long>(a.kv_heads) * a.dv;
  const int row = threadIdx.x >> 2, quad = threadIdx.x & 3;
  const int q_pos = q0 + row;
  const int tiles = key_tiles(a, q0, kFRows);

  load_rows_f32(qs, qb, static_cast<long long>(a.heads) * a.dqk, q0, a.s_q, a.dqk);
  float m = -INFINITY, l = 0.f;
  for (int t = 0; t < tiles; ++t) {
    __syncthreads();  // the previous tile's readers are done
    load_rows_f32(ks, kb, k_stride, t * kBK, a.s_k, a.dqk);
    __syncthreads();
    float sc[kKeys];
    scores_f32(sc, qs, ks, a, row, quad, t * kBK, q_pos);
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) mx = fmaxf(mx, sc[i]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    if (m_new > -INFINITY) {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kKeys; ++i) sum += expf(sc[i] - m_new);
      l = l * expf(m - m_new) + sum;
      m = m_new;
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);

  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    __syncthreads();
    load_rows_f32(ks, kb, k_stride, t * kBK, a.s_k, a.dqk);
    load_rows_f32(vs, vb, v_stride, t * kBK, a.s_k, a.dv);
    __syncthreads();
    float sc[kKeys];
    scores_f32(sc, qs, ks, a, row, quad, t * kBK, q_pos);
#pragma unroll
    for (int i = 0; i < kKeys; ++i) ps[row * kLdP + quad + 4 * i] = expf(sc[i] - m) / l;
    __syncwarp();  // a row's p is written and read by the same four lanes
    for (int key = 0; key < kBK; ++key) {
      const float p = ps[row * kLdP + key];
      const float* vr = vs + key * (a.dv + 1) + quad;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (quad + 4 * j < a.dv) acc[j] = fmaf(p, vr[4 * j], acc[j]);
    }
  }

  if (q_pos < a.s_q) {
    float* orow = static_cast<float*>(a.out) + ((static_cast<long long>(b) * a.s_q + q_pos) * a.heads + head) * a.dv;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (quad + 4 * j < a.dv) orow[quad + 4 * j] = acc[j];
  }
}

template <typename Kernel>
int launch(Kernel kernel, int threads, int rows, size_t smem, const Args& a, int batch, void* stream) {
  int err = allow_shared_bytes(kernel, smem);
  if (err) return err;
  const dim3 grid((a.s_q + rows - 1) / rows, a.heads, batch);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool valid(const Args& a, int batch) {
  return a.dqk >= 1 && a.dqk <= kMaxDim && a.dv >= 1 && a.dv <= kMaxDim && a.s_q >= 1 && a.s_k >= 1 &&
         batch >= 1 && a.kv_heads >= 1 && a.heads % a.kv_heads == 0 && a.heads <= 65535 && batch <= 65535;
}

template <int DVP>
int launch_bf16(const Args& a, int batch, void* stream) {
  return launch(chunked_attention_bf16_kernel<DVP>, Bf16Block<DVP>::kThreads, Bf16Block<DVP>::kRows,
                Bf16Layout<DVP>(a.dqk).bytes, a, batch, stream);
}

template <int kCols>
int launch_f32(const Args& a, int batch, void* stream) {
  const size_t smem =
      (static_cast<size_t>(kFRows + kBK) * (a.dqk + 1) + kBK * (a.dv + 1) + kFRows * kLdP) * sizeof(float);
  return launch(chunked_attention_f32_kernel<kCols>, kFThreads, kFRows, smem, a, batch, stream);
}

}  // namespace

// q (B, S_q, H, Dqk), k (B, S_k, KVH, Dqk), v (B, S_k, KVH, Dv), out
// (B, S_q, H, Dv), contiguous.  scores_bf16: round the scores as bf16
// (then `scale` must be a bf16 value).  vec: Dqk and Dv multiples of 8 and
// 16-byte aligned q, k, v (bf16 only).
#define CHUNKED_ARGS                                                                                  \
  const void *q, const void *k, const void *v, void *out, int batch, int s_q, int s_k, int heads,    \
      int kv_heads, int dqk, int dv, float scale, int scores_bf16, int causal, int vec, void *stream
#define CHUNKED_FILL Args a{q, k, v, out, s_q, s_k, heads, kv_heads, dqk, dv, scale, scores_bf16, causal, vec}

extern "C" int chunked_attention_bf16(CHUNKED_ARGS) {
  CHUNKED_FILL;
  if (!valid(a, batch)) return static_cast<int>(cudaErrorInvalidValue);
  if (dv <= 32) return launch_bf16<32>(a, batch, stream);
  if (dv <= 64) return launch_bf16<64>(a, batch, stream);
  if (dv <= 80) return launch_bf16<80>(a, batch, stream);
  if (dv <= 96) return launch_bf16<96>(a, batch, stream);
  if (dv <= 128) return launch_bf16<128>(a, batch, stream);
  if (dv <= 192) return launch_bf16<192>(a, batch, stream);
  return launch_bf16<256>(a, batch, stream);
}

extern "C" int chunked_attention_f32(CHUNKED_ARGS) {
  CHUNKED_FILL;
  a.vec = 0;
  if (!valid(a, batch)) return static_cast<int>(cudaErrorInvalidValue);
  if (dv <= 32) return launch_f32<8>(a, batch, stream);
  if (dv <= 64) return launch_f32<16>(a, batch, stream);
  if (dv <= 128) return launch_f32<32>(a, batch, stream);
  return launch_f32<64>(a, batch, stream);
}

// The tma route: bf16 q (B, S_q, H, Dqk), k (B, S_k, KVH, Dqk), v (B, S_k,
// KVH, Dv) with element strides (batch, position, head) each, the head dim
// contiguous; out (B, S_q, H, Dv) contiguous.  Dqk and Dv multiples of 8
// (Dqk <= 192, Dv <= 128), every stride a multiple of 8 elements and every
// pointer 16-byte aligned (TMA's rules).
extern "C" int chunked_attention_bf16_tma(const void* q, const void* k, const void* v, void* out, int batch,
                                          int s_q, int s_k, int heads, int kv_heads, int dqk, int dv,
                                          long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                                          long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                                          long long v_sh, float scale, int scores_bf16, int causal,
                                          void* stream) {
  const TmaOperands ops{q, k, v, out, {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh}};
  bool ok = dqk >= 8 && dqk <= kMaxTmaDqk && dqk % 8 == 0 && dv >= 8 && dv <= kMaxTmaDv && dv % 8 == 0 &&
            s_q >= 1 && s_k >= 1 && batch >= 1 && batch <= 65535 && kv_heads >= 1 && heads % kv_heads == 0 &&
            heads <= 65535;
  for (const void* p : {q, k, v, static_cast<const void*>(out)}) ok = ok && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (long long s : ops.strides) ok = ok && s > 0 && s % 8 == 0;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int mode = scores_bf16 ? kBf16Scores : scale > 0.f ? kRawScores : kScaledScores;
  const TmaArgs a{static_cast<const bf16*>(q), q_sb, q_ss, q_sh, s_q, s_k, heads, heads / kv_heads, dqk, dv,
                  scale, mode, causal};
  if (dqk <= 64) return launch_tma_dv<64>(ops, a, batch, kv_heads, stream);
  if (dqk <= 96) return launch_tma_dv<96>(ops, a, batch, kv_heads, stream);
  if (dqk <= 128) return launch_tma_dv<128>(ops, a, batch, kv_heads, stream);
  return launch_tma_dv<192>(ops, a, batch, kv_heads, stream);
}
