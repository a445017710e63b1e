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
// inside a (BH, query tile) grid step.  Here one block owns a 64-row query
// tile of one head and loops over 64-row key tiles staged in shared memory.
// Key tiles wholly above the diagonal are skipped when causal (they change
// nothing).  Any S works: keys past S are masked and rows past S are not
// stored.  D runs from 1 to 128.
//
// * bf16 (the model's path): both products run on the tensor cores, WMMA
//   bf16 16x16x16 with float32 accumulation; four warps each own 16 query
//   rows.  S goes through shared memory for the softmax (two threads a row),
//   P is stored there already rounded to bf16, and the output accumulator
//   lives in shared memory as float32 so the softmax threads can rescale its
//   rows by alpha (WMMA fragments do not say which row an element is in).
//   D is zero-padded to a multiple of 16.  No pipelining or wgmma yet.
// * float32: computed on the CUDA cores (a tensor-core float32 product would
//   round to TF32).  256 threads, four to a query row: each scores 16 of the
//   tile's keys and owns every fourth output column; row maxima and sums go
//   through shuffles.

#include <math.h>

#include <cuda_bf16.h>
#include <mma.h>

#include "common.cuh"

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

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int bh, int s_len, int d, float scale, int causal,
                                    void* stream) {
  return launch<decltype(&flash_attention_bf16_kernel), bf16>(
      flash_attention_bf16_kernel, kWThreads, Bf16Layout(d).bytes, q, k, v, out, bh, s_len, d,
      scale, causal, stream);
}
