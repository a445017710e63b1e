// One position's GQA attention against a KV cache, for Hopper (sm_90a).
//
// Replaces the jnp of src/repro/layers/attention.py:155-185
// (decode_attention_incremental) and :188-209 (decode_attention), which the
// reference leaves to XLA: no Pallas kernel.
//
// What it computes: q (B, 1, H, D); caches (B, S_max, KVH, D) and
// (B, S_max, KVH, Dv); G = H / KVH query heads share a KV head.  The keys
// of (b, kv head) are the cache's positions 0 .. n_cache - 1 and, in the
// incremental mode, one more column from k_new / v_new (B, 1, KVH, D):
//   s_j = (q . k_j) * scale in float32 (upcast values, float32 sums);
//   p_j = e^(s_j - max) / sum_j e^(s_j - max), float32, never rounded;
//   out = sum_j p_j v_j in float32, rounded to q's type.
// The kernel never writes the cache.
//
// What bounds it on this card: the bytes.  Every K and V row up to the
// index is read once (2 (D + Dv) bytes a bf16 row) against 4 G (D + Dv)
// float32 operations; at G <= 16 that is far below the 67 TFLOP/s the CUDA
// cores give a 3.35 TB/s read.
//
// Design: the jnp upcasts the whole (B, S_max, KVH, D) cache to float32 and
// masks past the index.  Here a block owns one (b, kv head, split of the
// positions) and reads its split's rows once, in their stored type, with
// 16-byte cp.async copies into a double-buffered ring of 64-row tiles
// (rows padded to an odd number of 16-byte chunks, so the eight rows a
// quarter warp reads sit in eight bank groups).  All G query heads of the
// group stay in shared memory as float32, so GQA reads each row once for
// its G heads.  Per tile: 256 threads score (64 keys x 4 head groups, a
// thread a key and every fourth head), one warp per head takes the tile's
// max and sum and rescales (the online softmax), and each thread adds
// p_j v_j into the outputs it owns (G Dv of them over 256 threads).  A
// block ends with its split's (max, sum, unnormalised output) in float32
// scratch; a second, short launch combines the splits, since B x KVH alone
// does not fill 132 SMs (qwen3-moe: 4 x 4 pairs).  The wrapper sizes the
// splits for about 16 blocks an SM, so the last wave is a small share of
// the launch (kernels/decode_attention.py::splits_for).  Nothing is read past
// the index.  Rows of D % 8 (bf16) or % 4 (float32) != 0, or misaligned
// operands, are copied element by element.

#include <math.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kTile = 64;                    // keys per tile
constexpr int kGroups = kThreads / kTile;    // head groups of the scores
constexpr int kMaxG = 32;                    // query heads a KV head
constexpr int kMaxDim = 128;
constexpr int kHeadsPerThread = kMaxG / kGroups;
constexpr int kOutsPerThread = kMaxG * kMaxDim / kThreads;
constexpr int kCombineThreads = kMaxDim;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16_rn(x); }

// A row of `dim` elements in shared memory: whole 16-byte chunks, their
// count made odd.
template <typename T>
struct Rows {
  static constexpr int kPerChunk = 16 / sizeof(T);
  int chunks, ld;  // chunks holding `dim`; the row stride in elements
  __host__ __device__ explicit Rows(int dim) {
    chunks = (dim + kPerChunk - 1) / kPerChunk;
    ld = (chunks | 1) * kPerChunk;
  }
};

struct Args {
  const void* q;
  const void* k_cache;
  const void* v_cache;
  const void* k_new;
  const void* v_new;
  float* part_acc;   // (B, H, splits, Dv)
  float* part_ml;    // (B, H, splits, 2): max, sum
  long long k_sb, k_ss, v_sb, v_ss;  // the caches' batch and position strides, elements
  int heads, kv_heads, d, dv;
  int n_cache, has_new;          // keys: n_cache cache rows (+ the new column)
  int tiles_per_split, splits;
  float scale;
  int vec;                       // 16-byte copies
};

// Copy the K (or V) rows of positions [p0, p0 + kTile) below `end` of one
// (b, kv head) into `dst` (kTile rows of `rows.ld`); rows past `end` and
// columns past `dim` are zeros.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* cache, const T* fresh, int p0, int end,
                                          int n_cache, long long ss, int dim, Rows<T> rows, bool vec) {
  constexpr int pc = Rows<T>::kPerChunk;
  for (int i = threadIdx.x; i < kTile * rows.chunks; i += kThreads) {
    const int r = i / rows.chunks, c = i % rows.chunks;
    const int pos = p0 + r;
    const bool live = pos < end;
    const T* src = !live ? cache : pos < n_cache ? cache + pos * ss : fresh;
    T* out = dst + r * rows.ld + c * pc;
    if (vec) {
      cp_async16(out, src + (live ? c * pc : 0), live ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < pc; ++e) {
        const int col = c * pc + e;
        out[e] = live && col < dim ? src[col] : from_float<T>(0.f);
      }
    }
  }
  cp_async_commit();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int g_count = a.heads / a.kv_heads;
  const Rows<T> krows(a.d), vrows(a.dv);
  const int dpad = krows.chunks * Rows<T>::kPerChunk;
  T* ks = reinterpret_cast<T*>(smem_raw);          // 2 stages x kTile x krows.ld
  T* vs = ks + 2 * kTile * krows.ld;               // 2 stages x kTile x vrows.ld
  float* qs = reinterpret_cast<float*>(vs + 2 * kTile * vrows.ld);  // G x dpad
  float* ps = qs + g_count * dpad;                 // G x kTile: scores, then p
  float* m_s = ps + g_count * kTile;
  float* l_s = m_s + g_count;
  float* alpha_s = l_s + g_count;

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_keys = a.n_cache + a.has_new;
  const int start = split * a.tiles_per_split * kTile;
  const int end = min(n_keys, start + a.tiles_per_split * kTile);
  const int tiles = (end - start + kTile - 1) / kTile;

  const T* kc = static_cast<const T*>(a.k_cache) + b * a.k_sb + kvh * a.d;
  const T* vc = static_cast<const T*>(a.v_cache) + b * a.v_sb + kvh * a.dv;
  // The new column's rows; the caches' own where there is none (never read).
  const T* kn = a.has_new ? static_cast<const T*>(a.k_new) + (static_cast<long long>(b) * a.kv_heads + kvh) * a.d : kc;
  const T* vn = a.has_new ? static_cast<const T*>(a.v_new) + (static_cast<long long>(b) * a.kv_heads + kvh) * a.dv : vc;
  const bool vec = a.vec != 0;

  load_tile<T>(ks, kc, kn, start, end, a.n_cache, a.k_ss, a.d, krows, vec);
  load_tile<T>(vs, vc, vn, start, end, a.n_cache, a.v_ss, a.dv, vrows, vec);

  const T* qg = static_cast<const T*>(a.q) + (static_cast<long long>(b) * a.heads + kvh * g_count) * a.d;
  for (int i = threadIdx.x; i < g_count * dpad; i += kThreads) {
    const int g = i / dpad, c = i % dpad;
    qs[i] = c < a.d ? to_float(qg[g * a.d + c]) : 0.f;
  }
  for (int g = threadIdx.x; g < g_count; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }

  const int key = threadIdx.x % kTile, group = threadIdx.x / kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int outs = g_count * a.dv;
  float acc[kOutsPerThread];
#pragma unroll
  for (int j = 0; j < kOutsPerThread; ++j) acc[j] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < tiles) {
      const int p1 = start + (t + 1) * kTile;
      load_tile<T>(ks + (stage ^ 1) * kTile * krows.ld, kc, kn, p1, end, a.n_cache, a.k_ss, a.d, krows, vec);
      load_tile<T>(vs + (stage ^ 1) * kTile * vrows.ld, vc, vn, p1, end, a.n_cache, a.v_ss, a.dv, vrows, vec);
      cp_async_wait<2>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile's rows (and q, the row stats) are in place
    const T* kt = ks + stage * kTile * krows.ld;
    const T* vt = vs + stage * kTile * vrows.ld;
    const int p0 = start + t * kTile;

    // Scores: a thread's key against heads group, group + 4, ...
    {
      float s[kHeadsPerThread];
#pragma unroll
      for (int i = 0; i < kHeadsPerThread; ++i) s[i] = 0.f;
      const T* krow = kt + key * krows.ld;
      for (int c = 0; c < krows.chunks; ++c) {
        constexpr int pc = Rows<T>::kPerChunk;
        float x[pc];
        if constexpr (sizeof(T) == 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(krow + c * pc);
          x[0] = v4.x, x[1] = v4.y, x[2] = v4.z, x[3] = v4.w;
        } else {
          const uint4 u = *reinterpret_cast<const uint4*>(krow + c * pc);
          const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h2[e]);
            x[2 * e] = f.x, x[2 * e + 1] = f.y;
          }
        }
#pragma unroll
        for (int i = 0; i < kHeadsPerThread; ++i) {
          const int g = group + kGroups * i;
          if (g < g_count) {
            const float4* qrow = reinterpret_cast<const float4*>(qs + g * dpad + c * pc);
#pragma unroll
            for (int e = 0; e < pc / 4; ++e) {
              const float4 qv = qrow[e];
              s[i] = fmaf(qv.x, x[4 * e], s[i]);
              s[i] = fmaf(qv.y, x[4 * e + 1], s[i]);
              s[i] = fmaf(qv.z, x[4 * e + 2], s[i]);
              s[i] = fmaf(qv.w, x[4 * e + 3], s[i]);
            }
          }
        }
      }
      const bool live = p0 + key < end;
#pragma unroll
      for (int i = 0; i < kHeadsPerThread; ++i) {
        const int g = group + kGroups * i;
        if (g < g_count) ps[g * kTile + key] = live ? s[i] * a.scale : -INFINITY;
      }
    }
    __syncthreads();

    // The online softmax: a warp per head.
    for (int g = warp; g < g_count; g += kThreads / 32) {
      float* row = ps + g * kTile;
      const float s0 = row[lane], s1 = row[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const bool live = m_new > -INFINITY;
      const float p0v = live ? expf(s0 - m_new) : 0.f, p1v = live ? expf(s1 - m_new) : 0.f;
      row[lane] = p0v;
      row[lane + 32] = p1v;
      float sum = p0v + p1v;
#pragma unroll
      for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = live ? expf(m_old - m_new) : 0.f;
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V for the outputs this thread owns.
#pragma unroll
    for (int j = 0; j < kOutsPerThread; ++j) {
      const int o = threadIdx.x + kThreads * j;
      if (o < outs) {
        const int g = o / a.dv, c = o % a.dv;
        const float* prow = ps + g * kTile;
        float sum = acc[j] * alpha_s[g];
        for (int r = 0; r < kTile; ++r) sum = fmaf(prow[r], to_float(vt[r * vrows.ld + c]), sum);
        acc[j] = sum;
      }
    }
    __syncthreads();  // the stage and ps are free for the next tile
  }

  const long long head0 = static_cast<long long>(b) * a.heads + kvh * g_count;
#pragma unroll
  for (int j = 0; j < kOutsPerThread; ++j) {
    const int o = threadIdx.x + kThreads * j;
    if (o < outs) {
      const int g = o / a.dv, c = o % a.dv;
      a.part_acc[((head0 + g) * a.splits + split) * a.dv + c] = acc[j];
    }
  }
  for (int g = threadIdx.x; g < g_count; g += kThreads) {
    float* ml = a.part_ml + ((head0 + g) * a.splits + split) * 2;
    ml[0] = m_s[g];
    ml[1] = l_s[g];
  }
}

// out[b, h] = sum_i e^(m_i - M) acc_i / sum_i e^(m_i - M) l_i over the splits.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_attention_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                                T* __restrict__ out, int splits, int dv) {
  const long long bh = blockIdx.x;
  const float* ml = part_ml + bh * splits * 2;
  float m = -INFINITY;
  for (int i = 0; i < splits; ++i) m = fmaxf(m, ml[2 * i]);
  float l = 0.f;
  for (int i = 0; i < splits; ++i)
    if (ml[2 * i] > -INFINITY) l += ml[2 * i + 1] * expf(ml[2 * i] - m);
  for (int c = threadIdx.x; c < dv; c += kCombineThreads) {
    float acc = 0.f;
    for (int i = 0; i < splits; ++i)
      if (ml[2 * i] > -INFINITY) acc += part_acc[(bh * splits + i) * dv + c] * expf(ml[2 * i] - m);
    out[bh * dv + c] = from_float<T>(acc / l);
  }
}

template <typename T>
size_t shared_bytes(int g_count, int d, int dv) {
  const Rows<T> krows(d), vrows(dv);
  return 2 * kTile * static_cast<size_t>(krows.ld + vrows.ld) * sizeof(T) +
         (static_cast<size_t>(g_count) * (krows.chunks * Rows<T>::kPerChunk + kTile + 3)) * sizeof(float);
}

template <typename T>
int launch(Args a, int batch, void* out, void* stream) {
  const int g_count = a.heads / a.kv_heads;
  if (a.d < 1 || a.d > kMaxDim || a.dv < 1 || a.dv > kMaxDim || g_count < 1 || g_count > kMaxG ||
      a.heads % a.kv_heads || a.n_cache + a.has_new < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared_bytes<T>(g_count, a.d, a.dv);
  int err = allow_shared_bytes(decode_attention_kernel<T>, smem);
  if (err) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  decode_attention_kernel<T><<<dim3(a.splits, a.kv_heads, batch), kThreads, smem, s>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  decode_attention_combine_kernel<T><<<batch * a.heads, kCombineThreads, 0, s>>>(
      a.part_acc, a.part_ml, static_cast<T*>(out), a.splits, a.dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, 1, H, D); caches with batch strides k_sb, v_sb and position
// strides k_ss, v_ss (elements; the (KVH, D) of a position contiguous); k_new, v_new
// (B, 1, KVH, D) or null (has_new 0); out (B, 1, H, Dv); part_acc
// (B, H, splits, Dv) and part_ml (B, H, splits, 2) float32 scratch.  Split
// i of a (b, kv head) holds key tiles [i * tiles_per_split,
// (i + 1) * tiles_per_split) of the n_cache + has_new keys.
#define DECODE_ENTRY(name, T)                                                                        \
  extern "C" int name(const void* q, const void* k_cache, const void* v_cache, const void* k_new,    \
                      const void* v_new, void* out, float* part_acc, float* part_ml, int batch,      \
                      int heads, int kv_heads, int d, int dv, long long k_sb, long long k_ss,        \
                      long long v_sb, long long v_ss,                                              \
                      int n_cache, int has_new, int tiles_per_split, int splits, float scale,        \
                      int vec, void* stream) {                                                       \
    Args a{q, k_cache, v_cache, k_new, v_new, part_acc, part_ml, k_sb, k_ss, v_sb, v_ss, heads,      \
           kv_heads, d, dv, n_cache, has_new, tiles_per_split, splits, scale, vec};                  \
    return launch<T>(a, batch, out, stream);                                                         \
  }

DECODE_ENTRY(decode_attention_f32, float)
DECODE_ENTRY(decode_attention_bf16, bf16)
