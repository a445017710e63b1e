// Fused causal / full attention with the online softmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention.
//
// What it computes: q, k, v (BH, S, D) of one type (float32 or bf16),
// out (BH, S, D) of the same type:
//   s = (q . k) * scale in float32, -inf where masked (key past S, or past
//   the query's position when causal);  per key tile, the recurrence
//     m' = max(m, rowmax s);  alpha = e^(m - m'),  p = e^(s - m')
//     (both 0 while m' is -inf: a fully masked row)
//     l' = l * alpha + rowsum p;  acc' = acc * alpha + (p cast to v's type) @ v
//   out = acc / max(l, 1e-30), cast to q's type.
// These are the reference's roundings: scores in float32 from the input
// type, p rounded to v's type before the PV product, the division last.
//
// What bounds it on this card: the operations, 4 * S^2 * D per head (half of
// that when causal), against the tensor cores' 989 TFLOP/s in bf16.
//
// Design: the TPU kernel kept a whole K/V slab in VMEM and looped over it
// inside a (BH, query tile) grid step.  Here a block owns a query tile of
// one head and loops over key tiles in shared memory.  Key tiles wholly
// above the diagonal are skipped when causal (they change nothing).  Any S
// works: keys past S are masked and rows past S are not stored.  Three
// kernels; the wrapper (kernels/flash_attention.py::route) picks one by
// type, head dim and alignment, with one entry point each:
//
// * tma (bf16, D % 8 == 0, 16-byte aligned operands: the model's path).
//   A block owns 128 query rows of one head: one producer thread issues TMA
//   loads (128B swizzle, 64-column boxes, zeros past D and past S) of its Q
//   tile once and of 64-key K and V tiles into a three-stage ring, each tile
//   with a "full" and an "empty" mbarrier; two consumer warpgroups of 64
//   query rows run S = Q K^T on wgmma (both operands K-major in shared
//   memory, S float32 in registers), the scale, masks (only on a tile that
//   crosses the diagonal or S) and the recurrence in registers (row max and
//   sum over the four lanes that share a row, exp2 with the scale folded
//   into one FMA), round P to bf16 straight into the register A operand of
//   the next wgmma, and run O += P V with V read MN-major (the transpose
//   bit).  S of tile t and P V of tile t - 1 are issued together, so the
//   softmax of tile t runs while P V(t - 1) is on the tensor cores.  O stays
//   in registers, rescaled by alpha there; the epilogue divides by
//   max(l, 1e-30) and stores bf16.  The grid launches the longest causal
//   query tiles first.  D is padded to 64, 96 or 128 (the PV product's N; a
//   template parameter).  64-key tiles keep S, P, O and the in-flight
//   operands within the 168 registers a thread of a 384-thread block has.
// * wmma (bf16 that the tma kernel cannot take: D % 8 != 0, or a misaligned
//   operand): WMMA bf16 16x16x16 with float32 accumulation; a block owns 64
//   query rows, four warps 16 each.  S goes through shared memory for the
//   softmax (two threads a row), P is stored there already rounded to bf16,
//   and the output accumulator lives in shared memory as float32 so the
//   softmax threads can rescale its rows by alpha.  D is zero-padded to a
//   multiple of 16.
// * f32: computed on the CUDA cores (a tensor-core float32 product would
//   round to TF32).  256 threads, four to a query row: each scores 16 of the
//   tile's keys and owns every fourth output column; row maxima and sums go
//   through shuffles.

#include <math.h>

#include <cuda_bf16.h>
#include <mma.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kBQ = 64, kBK = 64;  // query rows and key rows per tile
constexpr int kDMax = 128;

// ---- float32: CUDA cores ---------------------------------------------------

constexpr int kThreads = 256;
constexpr int kCols = kDMax / 4;   // output columns per thread, at most
constexpr int kKeys = kBK / 4;     // keys per thread per tile
constexpr int kLdP = kBK + 1;

__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, int s_len,
                           int d, float scale, bool causal) {
  extern __shared__ float smem[];
  const int ld = d + 1;          // odd row stride: the 8 rows a warp reads sit in 8 banks
  float* qs = smem;              // kBQ x ld
  float* ks = qs + kBQ * ld;     // kBK x ld
  float* vs = ks + kBK * ld;     // kBK x ld
  float* ps = vs + kBK * ld;     // kBQ x kLdP

  const long long base = static_cast<long long>(blockIdx.y) * s_len * d;
  const int q0 = blockIdx.x * kBQ;
  const int row = threadIdx.x >> 2, quad = threadIdx.x & 3;
  const int q_pos = q0 + row;

  for (int i = threadIdx.x; i < kBQ * d; i += kThreads) {
    const int r = i / d, c = i % d;
    qs[r * ld + c] = q0 + r < s_len ? q[base + static_cast<long long>(q0 + r) * d + c] : 0.f;
  }

  float m = -INFINITY, l = 0.f;
  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;

  int tiles = (s_len + kBK - 1) / kBK;
  if (causal) tiles = min(tiles, (q0 + kBQ - 1) / kBK + 1);
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done (and qs is stored)
    for (int i = threadIdx.x; i < kBK * d; i += kThreads) {
      const int r = i / d, c = i % d;
      const bool in = k0 + r < s_len;
      const long long g = base + static_cast<long long>(k0 + r) * d + c;
      ks[r * ld + c] = in ? k[g] : 0.f;
      vs[r * ld + c] = in ? v[g] : 0.f;
    }
    __syncthreads();

    float sc[kKeys];
#pragma unroll
    for (int i = 0; i < kKeys; ++i) sc[i] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float qc = qs[row * ld + c];
#pragma unroll
      for (int i = 0; i < kKeys; ++i) sc[i] += qc * ks[(quad + 4 * i) * ld + c];
    }
    float tile_max = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      const int k_pos = k0 + quad + 4 * i;
      sc[i] = (k_pos >= s_len || (causal && k_pos > q_pos)) ? -INFINITY : sc[i] * scale;
      tile_max = fmaxf(tile_max, sc[i]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const bool live = m_new > -INFINITY;  // the guard for fully masked rows
    const float alpha = live ? expf(m - m_new) : 0.f;
    float p_sum = 0.f;
#pragma unroll
    for (int i = 0; i < kKeys; ++i) {
      const float p = live ? expf(sc[i] - m_new) : 0.f;
      p_sum += p;
      ps[row * kLdP + quad + 4 * i] = p;
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 2);
    l = l * alpha + p_sum;
    m = m_new;
    __syncwarp();  // a row's p is written and read by the same four lanes

#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] *= alpha;
    for (int key = 0; key < kBK; ++key) {
      const float p = ps[row * kLdP + key];
      const float* vrow = vs + key * ld + quad;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (quad + 4 * j < d) acc[j] += p * vrow[4 * j];
    }
  }

  if (q_pos < s_len) {
    const float denom = fmaxf(l, 1e-30f);
    float* orow = out + base + static_cast<long long>(q_pos) * d;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (quad + 4 * j < d) orow[quad + 4 * j] = acc[j] / denom;
  }
}

size_t f32_shared_bytes(int d) {
  return (static_cast<size_t>(kBQ + 2 * kBK) * (d + 1) + kBQ * kLdP) * sizeof(float);
}

// ---- bf16: tensor cores ------------------------------------------------------

constexpr int kWarps = 4;            // warp w owns query rows 16w .. 16w + 15
constexpr int kWThreads = 32 * kWarps;
constexpr int kLdS = kBK + 4;        // float32 score stride (a multiple of 4)
constexpr int kLdPh = kBK + 8;       // bf16 P stride (a multiple of 8)

struct Bf16Layout {
  int dp, ldh, ldo;  // padded D; bf16 stride of Q, K, V; float32 stride of O
  size_t bytes;
  __host__ __device__ explicit Bf16Layout(int d)
      : dp((d + 15) / 16 * 16), ldh(dp + 8), ldo(dp + 4),
        // every region's size is a multiple of 32 bytes, so each starts
        // 32-byte aligned as WMMA's loads and stores require
        bytes(static_cast<size_t>(kBQ) * ldo * 4 + kBQ * kLdS * 4 +
              static_cast<size_t>(kBQ + 2 * kBK) * ldh * 2 + kBQ * kLdPh * 2 + 3 * kBQ * 4) {}
};

__global__ void __launch_bounds__(kWThreads)
flash_attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ out, int s_len,
                            int d, float scale, bool causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Bf16Layout lay(d);
  const int dp = lay.dp, ldh = lay.ldh, ldo = lay.ldo;
  float* os = reinterpret_cast<float*>(smem_raw);  // kBQ x ldo, the output accumulator
  float* ss = os + kBQ * ldo;                       // kBQ x kLdS, scores
  bf16* qs = reinterpret_cast<bf16*>(ss + kBQ * kLdS);  // kBQ x ldh
  bf16* ks = qs + kBQ * ldh;                        // kBK x ldh
  bf16* vs = ks + kBK * ldh;                        // kBK x ldh
  bf16* ps = vs + kBK * ldh;                        // kBQ x kLdPh, probabilities
  float* row_m = reinterpret_cast<float*>(ps + kBQ * kLdPh);
  float* row_l = row_m + kBQ;
  float* row_alpha = row_l + kBQ;

  const int tid = threadIdx.x, warp = tid >> 5;
  const long long base = static_cast<long long>(blockIdx.y) * s_len * d;
  const int q0 = blockIdx.x * kBQ;
  const bf16 zero = __float2bfloat16_rn(0.f);

  for (int i = tid; i < kBQ * dp; i += kWThreads) {
    const int r = i / dp, c = i % dp;
    qs[r * ldh + c] = (q0 + r < s_len && c < d) ? q[base + static_cast<long long>(q0 + r) * d + c] : zero;
    os[r * ldo + c] = 0.f;
  }
  for (int i = tid; i < kBQ; i += kWThreads) {
    row_m[i] = -INFINITY;
    row_l[i] = 0.f;
  }

  int tiles = (s_len + kBK - 1) / kBK;
  if (causal) tiles = min(tiles, (q0 + kBQ - 1) / kBK + 1);
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * dp; i += kWThreads) {
      const int r = i / dp, c = i % dp;
      const bool in = k0 + r < s_len && c < d;
      const long long g = base + static_cast<long long>(k0 + r) * d + c;
      ks[r * ldh + c] = in ? k[g] : zero;
      vs[r * ldh + c] = in ? v[g] : zero;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows: K row-major is K^T column-major.
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[kBK / 16];
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) wmma::fill_fragment(sacc[j], 0.f);
      for (int kk = 0; kk < dp; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, qs + 16 * warp * ldh + kk, ldh);
#pragma unroll
        for (int j = 0; j < kBK / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(b, ks + 16 * j * ldh + kk, ldh);
          wmma::mma_sync(sacc[j], a, b, sacc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j)
        wmma::store_matrix_sync(ss + 16 * warp * kLdS + 16 * j, sacc[j], kLdS, wmma::mem_row_major);
    }
    __syncthreads();

    // The recurrence: two neighbouring lanes per row, 32 keys each.
    {
      const int row = tid >> 1, half = tid & 1;
      const int q_pos = q0 + row;
      const float* srow = ss + row * kLdS + 32 * half;
      float sc[32];
      float tile_max = -INFINITY;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int k_pos = k0 + 32 * half + c;
        sc[c] = (k_pos >= s_len || (causal && k_pos > q_pos)) ? -INFINITY : srow[c] * scale;
        tile_max = fmaxf(tile_max, sc[c]);
      }
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
      const float m_old = row_m[row];
      const float m_new = fmaxf(m_old, tile_max);
      const bool live = m_new > -INFINITY;  // the guard for fully masked rows
      const float alpha = live ? expf(m_old - m_new) : 0.f;
      float p_sum = 0.f;
      bf16* prow = ps + row * kLdPh + 32 * half;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const float p = live ? expf(sc[c] - m_new) : 0.f;
        p_sum += p;
        prow[c] = __float2bfloat16_rn(p);  // p rounded to v's type
      }
      p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
      __syncwarp();  // both lanes have read row_m[row]
      if (half == 0) {
        row_m[row] = m_new;
        row_l[row] = row_l[row] * alpha + p_sum;
        row_alpha[row] = alpha;
      }
    }
    __syncthreads();

    for (int i = tid; i < kBQ * dp; i += kWThreads) os[(i / dp) * ldo + i % dp] *= row_alpha[i / dp];
    __syncthreads();

    // O += P V for this warp's 16 rows.
    for (int j = 0; j < dp / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      float* optr = os + 16 * warp * ldo + 16 * j;
      wmma::load_matrix_sync(o, optr, ldo, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, ps + 16 * warp * kLdPh + kk, kLdPh);
        wmma::load_matrix_sync(b, vs + kk * ldh + 16 * j, ldh);
        wmma::mma_sync(o, a, b, o);
      }
      wmma::store_matrix_sync(optr, o, ldo, wmma::mem_row_major);
    }
  }
  __syncthreads();

  for (int i = tid; i < kBQ * d; i += kWThreads) {
    const int r = i / d, c = i % d;
    if (q0 + r < s_len)
      out[base + static_cast<long long>(q0 + r) * d + c] =
          __float2bfloat16_rn(os[r * ldo + c] / fmaxf(row_l[r], 1e-30f));
  }
}

// ---- bf16 on wgmma, fed by TMA (D % 8 == 0, 16-byte aligned operands) ---------

constexpr int kTBQ = 128, kTBK = 64;  // query rows per block, keys per tile
constexpr int kTStages = 3;           // K and V tiles in flight
constexpr int kTThreads = 384;         // two consumer warpgroups + a producer
constexpr int kConsumerWarps = 8;

// DN: the head dim padded to 64, 96 or 128 (the PV product's N).  Q tiles
// (128 rows) and K and V tiles (64 rows) of DN columns are held as
// 64-column TMA boxes (128-byte rows, 128B swizzle); a box's columns past D
// arrive as zeros.
template <int DN>
struct TmaFlash {
  static constexpr int kBoxes = (DN + 63) / 64;
  static constexpr int kQBoxBytes = kTBQ * 128;   // 128 rows x 64 bf16
  static constexpr int kKVBoxBytes = kTBK * 128;  // 64 rows x 64 bf16
  static constexpr int kQBytes = kBoxes * kQBoxBytes;
  static constexpr int kKVBytes = kBoxes * kKVBoxBytes;
  static constexpr int kBarOffset = kQBytes + 2 * kTStages * kKVBytes;  // Q, K ring, V ring
  static constexpr size_t kSharedBytes =
      kBarOffset + (1 + 4 * kTStages) * sizeof(uint64_t) + 1024;  // + alignment slack
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float fast_exp2(float x) {  // 2^x; 0 at -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One consumer warp is done with a stage: its lane 0 arrives.
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(empty);
}

// Issue S = Q K^T for one key tile (not waited for): float32 in registers,
// both operands K-major.  Head-dim columns past D are zeros and add nothing.
template <int DN>
__device__ __forceinline__ void issue_scores(float (&sc)[kTBK / 2], const unsigned char* q_wg,
                                             const unsigned char* k_tile) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < DN / 16; ++kk) {
    const int box = kk / 4, at = 32 * (kk % 4);
    Wgmma<kTBK>::ss<0>(sc, desc_k_major_128b(q_wg + box * TmaFlash<DN>::kQBoxBytes + at),
                       desc_k_major_128b(k_tile + box * TmaFlash<DN>::kKVBoxBytes + at), kk > 0);
  }
}

// Issue O += P V (not waited for): P from registers, V MN-major (D
// contiguous) from shared memory, read through the transpose bit.
template <int DN>
__device__ __forceinline__ void issue_pv(float (&o)[DN / 2], const uint32_t (&p)[kTBK / 4],
                                         const unsigned char* v_tile) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < kTBK / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    Wgmma<DN>::template rs<1>(o, a, desc_mn_major_128b(v_tile + 2048 * kk, TmaFlash<DN>::kKVBoxBytes), 1);
  }
}

// The online-softmax recurrence for the key tile at k0 and this thread's
// rows row_a and row_a + 8: mask the scores (only on a tile that crosses
// the diagonal of the warpgroup's rows from k_row0, or S), update the
// running max, return alpha, update the running sums, and leave P in place
// of the scores in float32.  Exponents are base 2: scale_log2 is the
// scale times log2(e).  With kRaw (scale_log2 > 0) the max is taken over
// the unscaled scores and the scale folds into one FMA per element,
// p = 2^(s * c - m * c); otherwise the scores are scaled first.  A row with
// no live key yet subtracts 0 instead of -inf, so its p are 0 (the
// reference's guard).
template <bool kRaw>
__device__ __forceinline__ void online_softmax(float (&sc)[kTBK / 2], float (&m_run)[2],
                                               float (&l_run)[2], float (&alpha)[2], int k0,
                                               int k_row0, int row_a, int col_t, int s_len,
                                               bool causal, float scale_log2) {
  const bool edge = k0 + kTBK > s_len || (causal && k0 + kTBK - 1 > k_row0);
  float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kTBK / 2; ++j) {
    const int r = (j >> 1) & 1;
    float x = kRaw ? sc[j] : sc[j] * scale_log2;
    if (edge) {
      const int key = k0 + 8 * (j >> 2) + col_t + (j & 1);
      if (key >= s_len || (causal && key > row_a + 8 * r)) x = -INFINITY;
    }
    sc[j] = x;
    tile_max[r] = fmaxf(tile_max[r], x);
  }
  const float c = kRaw ? scale_log2 : 1.f;
  float m_sub[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 1));
    tile_max[r] = fmaxf(tile_max[r], __shfl_xor_sync(0xffffffffu, tile_max[r], 2));
    const float m_new = fmaxf(m_run[r], tile_max[r]);
    const bool live = m_new > -INFINITY;
    alpha[r] = live ? fast_exp2((m_run[r] - m_new) * c) : 0.f;
    m_sub[r] = live ? m_new * c : 0.f;
    m_run[r] = m_new;
  }
  float p_sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kTBK / 2; ++j) {
    const int r = (j >> 1) & 1;
    sc[j] = fast_exp2(kRaw ? fmaf(sc[j], c, -m_sub[r]) : sc[j] - m_sub[r]);
    p_sum[r] += sc[j];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + p_sum[r];
}

// P rounded to bf16 (v's type) straight into wgmma's A-fragment layout:
// keys 16kk .. 16kk + 15 of the tile are p[4kk .. 4kk + 3].
__device__ __forceinline__ void round_p(const float (&sc)[kTBK / 2], uint32_t (&p)[kTBK / 4]) {
#pragma unroll
  for (int i = 0; i < kTBK / 4; ++i) p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
}

template <int DN>
__global__ void __launch_bounds__(kTThreads, 1)
flash_attention_tma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ out,
                           int s_len, int d, float scale_log2, bool causal) {
  using namespace hopper;
  using L = TmaFlash<DN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_shared(smem_raw, 1024);
  unsigned char* q_s = smem;
  unsigned char* k_s = smem + L::kQBytes;  // stage s at + s * L::kKVBytes
  unsigned char* v_s = k_s + kTStages * L::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + kTStages;
  uint64_t* v_full = k_empty + kTStages;
  uint64_t* v_empty = v_full + kTStages;

  const int head = blockIdx.x;
  // Causal rows past q0 see more keys: launch the longest query tiles first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTBQ;
  int tiles = (s_len + kTBK - 1) / kTBK;
  if (causal) tiles = min(tiles, (q0 + kTBQ - 1) / kTBK + 1);  // skip tiles above the diagonal

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kTStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, kConsumerWarps);
      mbar_init(v_empty + s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // the producer warpgroup: one thread issues every load
    if (threadIdx.x == 256) {
      tma_prefetch_map(&q_map);
      tma_prefetch_map(&k_map);
      tma_prefetch_map(&v_map);
      mbar_arrive_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int b = 0; b < L::kBoxes; ++b)
        tma_load_3d(q_s + b * L::kQBoxBytes, &q_map, q_full, 64 * b, q0, head);
      for (int t = 0; t < tiles; ++t) {
        const int s = t % kTStages;
        const uint32_t free_parity = ((t / kTStages) & 1) ^ 1;
        mbar_wait(k_empty + s, free_parity);
        mbar_arrive_expect_tx(k_full + s, L::kKVBytes);
#pragma unroll
        for (int b = 0; b < L::kBoxes; ++b)
          tma_load_3d(k_s + s * L::kKVBytes + b * L::kKVBoxBytes, &k_map, k_full + s, 64 * b,
                      t * kTBK, head);
        mbar_wait(v_empty + s, free_parity);
        mbar_arrive_expect_tx(v_full + s, L::kKVBytes);
#pragma unroll
        for (int b = 0; b < L::kBoxes; ++b)
          tma_load_3d(v_s + s * L::kKVBytes + b * L::kKVBoxBytes, &v_map, v_full + s, 64 * b,
                      t * kTBK, head);
      }
    }
  } else {  // two consumer warpgroups, 64 query rows each
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    // This thread's rows are row_a and row_a + 8 (r = 0, 1); its columns in
    // each 8-column group are col_t and col_t + 1 (the wgmma accumulator
    // layout, hopper.cuh).
    const int row_a = q0 + 64 * wg + 16 * warp + lane / 4;
    const int col_t = 2 * (lane % 4);
    const unsigned char* q_wg = q_s + wg * 64 * 128;

    float o[DN / 2], sc[kTBK / 2];
#pragma unroll
    for (int j = 0; j < DN / 2; ++j) o[j] = 0.f;
#pragma unroll
    for (int j = 0; j < kTBK / 2; ++j) sc[j] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

    // The loop keeps one product in flight behind the softmax: S of tile t
    // and O += P V of tile t - 1 are issued together, the softmax of S(t)
    // runs while P V(t - 1) is on the tensor cores, and once that product
    // is done O is rescaled by tile t's alpha and P(t) rounded into the A
    // fragment the next P V reads.
    const int k_row0 = q0 + 64 * wg;  // this warpgroup's first query row
    uint32_t pa[kTBK / 4];            // P of the tile whose P V product is next
    float alpha[2];
    mbar_wait(q_full, 0);
    mbar_wait(k_full, 0);
    reg_fence(sc);
    wgmma_fence();
    issue_scores<DN>(sc, q_wg, k_s);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);
    release(k_empty, lane);
    // The max is kept in the units softmax() takes its scores in.
    auto softmax = [&](int k0) {
      if (scale_log2 > 0.f)
        online_softmax<true>(sc, m_run, l_run, alpha, k0, k_row0, row_a, col_t, s_len, causal,
                             scale_log2);
      else
        online_softmax<false>(sc, m_run, l_run, alpha, k0, k_row0, row_a, col_t, s_len, causal,
                              scale_log2);
    };
    softmax(0);
    round_p(sc, pa);
    for (int t = 1; t < tiles; ++t) {
      const int s = t % kTStages, prev = (t - 1) % kTStages;
      mbar_wait(k_full + s, (t / kTStages) & 1);
      mbar_wait(v_full + prev, ((t - 1) / kTStages) & 1);
      reg_fence(sc);
      reg_fence(o);
      wgmma_fence();
      issue_scores<DN>(sc, q_wg, k_s + s * L::kKVBytes);
      wgmma_commit();
      issue_pv<DN>(o, pa, v_s + prev * L::kKVBytes);
      wgmma_commit();
      wgmma_wait<1>();  // S of tile t is ready
      reg_fence(sc);
      release(k_empty + s, lane);
      softmax(t * kTBK);
      wgmma_wait<0>();  // P V of tile t - 1 is done
      reg_fence(o);
      release(v_empty + prev, lane);
#pragma unroll
      for (int j = 0; j < DN / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
      round_p(sc, pa);
    }
    const int last = (tiles - 1) % kTStages;
    mbar_wait(v_full + last, ((tiles - 1) / kTStages) & 1);
    reg_fence(o);
    wgmma_fence();
    issue_pv<DN>(o, pa, v_s + last * L::kKVBytes);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);

    // out = O / max(l, 1e-30): the row sums so far are per thread.
    float denom[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      denom[r] = fmaxf(l, 1e-30f);
    }
    const long long base = static_cast<long long>(head) * s_len;
#pragma unroll
    for (int j = 0; j < DN / 2; j += 2) {
      const int r = (j >> 1) & 1;
      const int row = row_a + 8 * r, col = 8 * (j >> 2) + col_t;
      if (row < s_len && col < d)  // d is a multiple of 8, so col + 1 < d too
        *reinterpret_cast<__nv_bfloat162*>(out + (base + row) * d + col) =
            __floats2bfloat162_rn(o[j] / denom[r], o[j + 1] / denom[r]);
    }
  }
}

template <int DN>
int launch_tma(const void* q, const void* k, const void* v, void* out, int bh, int s_len, int d,
               float scale, int causal, void* stream) {
  // (D, S, BH) maps: a box never crosses into the next head, and rows past
  // S arrive as zeros.
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s_len),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(s_len) * d * 2};
  const cuuint32_t q_box[3] = {64, kTBQ, 1}, kv_box[3] = {64, kTBK, 1};
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int err = hopper::bf16_tensor_map(&maps[i], ptrs[i], 3, dims, strides, i ? kv_box : q_box);
    if (err) return err;
  }
  auto kernel = flash_attention_tma_kernel<DN>;
  const int err = allow_shared_bytes(kernel, TmaFlash<DN>::kSharedBytes);
  if (err) return err;
  const dim3 grid(bh, (s_len + kTBQ - 1) / kTBQ);
  kernel<<<grid, kTThreads, TmaFlash<DN>::kSharedBytes, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(out), s_len, d,
      scale * 1.4426950408889634f, causal != 0);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename Kernel, typename T>
int launch(Kernel kernel, int threads, size_t smem, const void* q, const void* k, const void* v,
           void* out, int bh, int s_len, int d, float scale, int causal, void* stream) {
  if (d < 1 || d > kDMax) return static_cast<int>(cudaErrorInvalidValue);
  const int err = allow_shared_bytes(kernel, smem);
  if (err) return err;
  const dim3 grid((s_len + kBQ - 1) / kBQ, bh);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), s_len, d, scale, causal != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   int bh, int s_len, int d, float scale, int causal,
                                   void* stream) {
  return launch<decltype(&flash_attention_f32_kernel), float>(
      flash_attention_f32_kernel, kThreads, f32_shared_bytes(d), q, k, v, out, bh, s_len, d,
      scale, causal, stream);
}

extern "C" int flash_attention_bf16_tma(const void* q, const void* k, const void* v, void* out,
                                        int bh, int s_len, int d, float scale, int causal,
                                        void* stream) {
  if (d < 8 || d > kDMax || d % 8 || !aligned16(q) || !aligned16(k) || !aligned16(v) ||
      !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (d <= 64) return launch_tma<64>(q, k, v, out, bh, s_len, d, scale, causal, stream);
  if (d <= 96) return launch_tma<96>(q, k, v, out, bh, s_len, d, scale, causal, stream);
  return launch_tma<128>(q, k, v, out, bh, s_len, d, scale, causal, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int bh, int s_len, int d, float scale, int causal,
                                    void* stream) {
  return launch<decltype(&flash_attention_bf16_kernel), bf16>(
      flash_attention_bf16_kernel, kWThreads, Bf16Layout(d).bytes, q, k, v, out, bh, s_len, d,
      scale, causal, stream);
}
