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
//
// Design: the jnp writes a float32 (Cq, S) score block a head per query
// chunk to device memory and reads it back for the scale, the mask, the
// softmax and the cast.  Here no score leaves the SM.  Because p is
// rounded after it is normalised, the online softmax (flash's running
// rescale) would round it at other places; so a block walks the keys
// twice: the first pass takes each row's max and sum (rescaled online,
// exactly the row's final max), the second recomputes the scores
// bit for bit, normalises, rounds and accumulates P V.  A block owns a tile
// of query rows of one (b, head) and reads K and V of head h / G directly
// (no repeated KV heads); key tiles past a causal tile's last row are skipped,
// and the longest causal tiles launch first.  Two kernels, one entry point
// each:
//
// * bf16 (tensor cores): eight warps of 16 query rows (four where Dv > 128,
//   whose accumulators take more registers); 64-key K and V tiles
//   double-buffered in shared memory by cp.async (16-byte copies; element
//   copies for D % 8 != 0 or misaligned operands), rows padded by 16 bytes
//   so ldmatrix reads no bank twice.  QK^T and PV are mma.sync m16n8k16 bf16
//   with float32 accumulators (the reference's precision: bf16 products are
//   exact in float32); the scores stay in registers, P goes from the score
//   registers into the A fragments of the PV product, O stays in registers.
//   e^x is taken as 2^(x log2(e)) (an FFMA and the exp2 unit) and p as
//   e^(s - m) times 1 / l: a few float32 ulps from the reference's exp and
//   division, far inside p's rounding to bf16.  The mask is tested only on
//   tiles that cross S or the warp's diagonal.  Dqk any, Dv padded to a
//   template width (32 .. 256).
// * f32 (CUDA cores; a tensor-core float32 product would round to TF32):
//   256 threads, four to a query row, each scoring 16 of a tile's keys and
//   owning every fourth output column.

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
