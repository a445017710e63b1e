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
// operations; at G <= 16 that is far below what the CUDA cores give a
// 3.35 TB/s read.  What holds a kernel back from that read is latency: a
// block has to keep enough rows in flight, and no step of its key loop may
// wait for the others.
//
// Design: the jnp upcasts the whole (B, S_max, KVH, D) cache to float32 and
// masks past the index.  Here a block of four warps owns one (b, kv head,
// split of the positions) and reads its split's rows once, in their stored
// type.  Each warp works on its own 16-key tiles (tiles w, w + 4, ... of
// the split) with its own ring of stages in shared memory and its own
// float32 (max, sum, output) for the group's G heads: no block-wide
// barrier falls inside the key loop.
// * Loads: each lane of the warp issues one bulk copy (cp.async.bulk, the
//   TMA engine's 1-D form) of a K row (lanes 0-15) or a V row (16-31) of a
//   tile, completing on the stage's mbarrier; three stages (two for
//   float32) keep two tiles a warp in flight while the third is computed.
//   K rows land padded to an odd number of 16-byte chunks, so ldmatrix
//   reads no bank twice.  The new column's rows come from k_new / v_new.
//   Rows of D % 8 (bf16) or % 4 (float32) != 0, or misaligned operands,
//   are copied element by element by the warp instead.
// * Scores: bf16 on mma.sync m16n8k16 with the group's heads as the rows
//   (16 a tile, two tiles past G = 16; q's A fragments in registers) and
//   the tile's keys as the columns: bf16 products are exact in float32 and
//   the sums are float32, as the reference's upcast.  float32 caches score
//   on the CUDA cores in the same register layout.
// * Softmax: in the scores' registers, the online recurrence per head
//   (max over the four lanes of a row, 2^x with log2(e) folded into one
//   FMA); p (float32) and each head's rescale go to the warp's own shared
//   buffer.
// * PV on the CUDA cores in float32: lane l owns output column pairs l and
//   l + 32 of every head, reads each v pair of the tile once and adds it
//   into all G heads' accumulators.
// * Finishing: after the loop one barrier, and the four warps' (max, sum,
//   output) combine in shared memory.  With one split the block writes the
//   output; with more, each split's (max, sum, unnormalised output) goes
//   to float32 scratch and a second, short launch combines them.  The
//   wrapper sizes the splits (kernels/decode_attention.py::splits_for):
//   enough blocks for the card, but at least two tiles a warp, so a short
//   cache takes one split and one launch.

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;   // keys a warp's tile
constexpr int kMaxG = 32;   // query heads a KV head
constexpr int kMaxDim = 128;
constexpr int kCombineThreads = kMaxDim;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float2 to_float2(float2 x) { return x; }
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 x) { return __bfloat1622float2(x); }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16_rn(x); }
template <typename T>
struct Pair;
template <>
struct Pair<float> { using type = float2; };
template <>
struct Pair<bf16> { using type = __nv_bfloat162; };

__device__ __forceinline__ float fast_exp2(float x) {  // 2^x; 0 at -inf
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Where everything lies in a block's shared memory (bytes).  Each warp's
// region: kStages stages of kTile K rows (stride ldk) then kTile V rows
// (stride ldv), the stages' mbarriers, p (kG x kTile float32) and each
// head's rescale.  Then q as float32 (float32 caches) and each warp's
// (max, sum) per head, past the warps' outputs (kWarps x kG x Dv float32),
// which reuse the start after the key loop.
template <typename T>
struct Layout {
  static constexpr int kPerChunk = 16 / sizeof(T);
  static constexpr int kStages = sizeof(T) == 2 ? 3 : 2;
  int kdim, ldk, ldv;  // K columns read (zeros past D); K and V row strides, elements
  int stage, bars, p, alpha, warp, q, ml, bytes;
  __host__ __device__ Layout(int d, int dv, int g_pad) {
    kdim = sizeof(T) == 2 ? (d + 15) / 16 * 16 : (d + 3) / 4 * 4;
    ldk = ((kdim / kPerChunk) | 1) * kPerChunk;
    ldv = (dv + kPerChunk - 1) / kPerChunk * kPerChunk;
    stage = kTile * (ldk + ldv) * static_cast<int>(sizeof(T));
    bars = kStages * stage;
    p = bars + 32;
    alpha = p + g_pad * kTile * 4;
    warp = (alpha + g_pad * 4 + 15) / 16 * 16;
    q = kWarps * warp;
    const int q_end = q + (sizeof(T) == 2 ? 0 : g_pad * kdim * 4);
    const int combine = (kWarps * g_pad * dv * 4 + 15) / 16 * 16;
    ml = q_end > combine ? q_end : combine;
    bytes = ml + kWarps * g_pad * 2 * 4;
  }
};

struct Args {
  const void* q;
  const void* k_cache;
  const void* v_cache;
  const void* k_new;
  const void* v_new;
  void* out;
  float* part_acc;   // (B, H, splits, Dv), or null with one split
  float* part_ml;    // (B, H, splits, 2): max, sum
  long long k_sb, k_ss, v_sb, v_ss;  // the caches' batch and position strides, elements
  int heads, kv_heads, d, dv;
  int n_cache, has_new;          // keys: n_cache cache rows (+ the new column)
  int tiles_per_split, splits;
  float scale;
  int vec;                       // bulk copies
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) | static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16;
}

template <typename T, int kG>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(Args a) {
  using P2 = typename Pair<T>::type;
  constexpr int kM = kG > 16 ? 2 : 1;        // 16-head row tiles of the scores
  constexpr int kSteps = kMaxDim / 16;        // k-steps of the score product, at most
  constexpr int kStages = Layout<T>::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> lay(a.d, a.dv, kG);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int g_count = a.heads / a.kv_heads;
  const int n_keys = a.n_cache + a.has_new;
  const int start = split * a.tiles_per_split * kTile;
  const int end = min(n_keys, start + a.tiles_per_split * kTile);
  const int tiles = (end - start + kTile - 1) / kTile;
  const int count = tiles > warp ? (tiles - warp + kWarps - 1) / kWarps : 0;  // tiles warp, warp + kWarps, ...
  const bool vec = a.vec != 0;

  unsigned char* region = smem + warp * lay.warp;
  uint64_t* bars = reinterpret_cast<uint64_t*>(region + lay.bars);
  float* p_s = reinterpret_cast<float*>(region + lay.p);       // kG x kTile
  float* alpha_s = reinterpret_cast<float*>(region + lay.alpha);
  float* ml_s = reinterpret_cast<float*>(smem + lay.ml);      // kWarps x kG x (max, sum)
  auto k_stage = [&](int s) { return reinterpret_cast<T*>(region + s * lay.stage); };
  auto v_stage = [&](int s) { return k_stage(s) + kTile * lay.ldk; };

  // Zeros in the warp's stages where K rows have columns past D (D not a
  // multiple of the k-step): they add nothing to the scores.  Rows past a
  // tile's keys are never zeroed: their scores are masked and their v
  // never read.
  if (lay.kdim != a.d)
    for (int i = lane; i < lay.bars / 16; i += 32) reinterpret_cast<uint4*>(region)[i] = make_uint4(0, 0, 0, 0);
  const long long head0 = static_cast<long long>(b) * a.heads + kvh * g_count;
  const T* qg = static_cast<const T*>(a.q) + head0 * a.d;
  if constexpr (sizeof(T) == 4) {
    float* q_s = reinterpret_cast<float*>(smem + lay.q);
    for (int i = threadIdx.x; i < kG * lay.kdim; i += kThreads) {
      const int g = i / lay.kdim, c = i % lay.kdim;
      q_s[i] = g < g_count && c < a.d ? to_float(qg[g * a.d + c]) : 0.f;
    }
  }
  if (lane == 0)
    for (int s = 0; s < kStages; ++s) hopper::mbar_init(bars + s, 1);
  hopper::mbar_fence_init();
  hopper::fence_proxy_async();  // the zeros before any bulk copy into the stages
  __syncthreads();

  const T* kc = static_cast<const T*>(a.k_cache) + b * a.k_sb + kvh * a.d;
  const T* vc = static_cast<const T*>(a.v_cache) + b * a.v_sb + kvh * a.dv;
  // The new column's rows; the caches' own where there is none (never read).
  const T* kn = a.has_new ? static_cast<const T*>(a.k_new) + (static_cast<long long>(b) * a.kv_heads + kvh) * a.d : kc;
  const T* vn = a.has_new ? static_cast<const T*>(a.v_new) + (static_cast<long long>(b) * a.kv_heads + kvh) * a.dv : vc;
  const uint32_t k_bytes = a.d * sizeof(T), v_bytes = a.dv * sizeof(T);

  // The warp's i-th tile into stage i % kStages: with bulk copies a lane a
  // row, completing on the stage's barrier; else element by element, done
  // when this returns.
  auto issue = [&](int i) {
    const int s = i % kStages;
    const int p0 = start + (warp + i * kWarps) * kTile;
    const int rows = min(kTile, end - p0);
    T* ks = k_stage(s);
    T* vs = v_stage(s);
    if (vec) {
      hopper::fence_proxy_async();  // this lane's reads of the stage before the copies into it
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive_expect_tx(bars + s, rows * (k_bytes + v_bytes));
      const int r = lane % kTile, pos = p0 + r;
      if (r < rows) {
        if (lane < kTile)
          hopper::bulk_load(ks + r * lay.ldk, pos < a.n_cache ? kc + pos * a.k_ss : kn, k_bytes, bars + s);
        else
          hopper::bulk_load(vs + r * lay.ldv, pos < a.n_cache ? vc + pos * a.v_ss : vn, v_bytes, bars + s);
      }
    } else {
      for (int e = lane; e < rows * a.d; e += 32) {
        const int r = e / a.d, c = e % a.d, pos = p0 + r;
        ks[r * lay.ldk + c] = (pos < a.n_cache ? kc + pos * a.k_ss : kn)[c];
      }
      for (int e = lane; e < rows * a.dv; e += 32) {
        const int r = e / a.dv, c = e % a.dv, pos = p0 + r;
        vs[r * lay.ldv + c] = (pos < a.n_cache ? vc + pos * a.v_ss : vn)[c];
      }
      __syncwarp();
    }
  };

  // q's A fragments (bf16): rows are the group's heads, zeros past G and D.
  uint32_t qa[kM][kSteps][4];
  if constexpr (sizeof(T) == 2) {
    const bf16 zero = __float2bfloat16_rn(0.f);
    auto qv = [&](int g, int c) { return g < g_count && c < a.d ? qg[g * a.d + c] : zero; };
#pragma unroll
    for (int mt = 0; mt < kM; ++mt)
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const int g = 16 * mt + lane / 4, c = 16 * kk + 2 * (lane % 4);
        qa[mt][kk][0] = pack2(qv(g, c), qv(g, c + 1));
        qa[mt][kk][1] = pack2(qv(g + 8, c), qv(g + 8, c + 1));
        qa[mt][kk][2] = pack2(qv(g, c + 8), qv(g, c + 9));
        qa[mt][kk][3] = pack2(qv(g + 8, c + 8), qv(g + 8, c + 9));
      }
  }

  // Running max (this lane's rows: head 16 mt + lane / 4 + 8 r, the same on
  // the four lanes of a row) and this lane's share of the running sum.
  float m[kM][2], l[kM][2];
#pragma unroll
  for (int mt = 0; mt < kM; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) m[mt][r] = -INFINITY, l[mt][r] = 0.f;
  // Output column pairs lane and lane + 32 of every head.
  float acc[kG][4];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  const bool pair0 = 2 * lane < a.dv, pair1 = 2 * (lane + 32) < a.dv;

  for (int i = 0; i < min(count, kStages); ++i) issue(i);
  for (int i = 0; i < count; ++i) {
    const int s = i % kStages;
    if (vec) hopper::mbar_wait(bars + s, (i / kStages) & 1);
    const T* ks = k_stage(s);
    const T* vs = v_stage(s);
    const int valid = min(kTile, end - (start + (warp + i * kWarps) * kTile));

    // Scores: sc[mt][nt][e] is head 16 mt + lane / 4 + 8 (e / 2), key
    // 8 nt + 2 (lane % 4) + e % 2 of the tile (the mma accumulator layout).
    float sc[kM][2][4];
#pragma unroll
    for (int mt = 0; mt < kM; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][nt][e] = 0.f;
    if constexpr (sizeof(T) == 2) {
      const T* krow = ks + (lane % 8 + 8 * (lane / 16)) * lay.ldk + 8 * ((lane / 8) % 2);
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        if (16 * kk < lay.kdim) {
          uint32_t kb[4];
          hopper::ldmatrix_x4(kb, krow + 16 * kk);
#pragma unroll
          for (int mt = 0; mt < kM; ++mt) {
            mma_bf16(sc[mt][0], qa[mt][kk], kb[0], kb[1]);
            mma_bf16(sc[mt][1], qa[mt][kk], kb[2], kb[3]);
          }
        }
      }
    } else {
      const float* q_s = reinterpret_cast<const float*>(smem + lay.q);
#pragma unroll
      for (int mt = 0; mt < kM; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int g = 16 * mt + lane / 4 + 8 * r;
          if (g < g_count) {
            const float* qrow = q_s + g * lay.kdim;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float* krow = reinterpret_cast<const float*>(ks) + (8 * nt + 2 * (lane % 4) + h) * lay.ldk;
                float sum = 0.f;
                for (int c = 0; c < lay.kdim; c += 4) {
                  const float4 qv = *reinterpret_cast<const float4*>(qrow + c);
                  const float4 kv = *reinterpret_cast<const float4*>(krow + c);
                  sum = fmaf(qv.x, kv.x, sum);
                  sum = fmaf(qv.y, kv.y, sum);
                  sum = fmaf(qv.z, kv.z, sum);
                  sum = fmaf(qv.w, kv.w, sum);
                }
                sc[mt][nt][2 * r + h] = sum;
              }
          }
        }
    }

    // The online softmax of each head over the tile; p and the rescale to
    // the warp's buffer.
#pragma unroll
    for (int mt = 0; mt < kM; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x[2][2], tile_max = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int key = 8 * nt + 2 * (lane % 4) + h;
            x[nt][h] = key < valid ? sc[mt][nt][2 * r + h] * a.scale : -INFINITY;
            tile_max = fmaxf(tile_max, x[nt][h]);
          }
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
        const float m_new = fmaxf(m[mt][r], tile_max);
        const bool live = m_new > -INFINITY;
        const float m_sub = live ? m_new * kLog2e : 0.f;
        const float alpha = live ? fast_exp2(fmaf(m[mt][r], kLog2e, -m_sub)) : 0.f;
        m[mt][r] = m_new;
        const int g = 16 * mt + lane / 4 + 8 * r;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float p0 = fast_exp2(fmaf(x[nt][0], kLog2e, -m_sub));
          const float p1 = fast_exp2(fmaf(x[nt][1], kLog2e, -m_sub));
          sum += p0 + p1;
          if (g < kG) *reinterpret_cast<float2*>(p_s + g * kTile + 8 * nt + 2 * (lane % 4)) = make_float2(p0, p1);
        }
        l[mt][r] = l[mt][r] * alpha + sum;
        if (g < kG && lane % 4 == 0) alpha_s[g] = alpha;
      }
    __syncwarp();

    // acc = acc * alpha + sum_j p_j v_j: each v pair read once for all heads.
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float al = alpha_s[g];
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] *= al;
    }
#pragma unroll
    for (int j4 = 0; j4 < kTile; j4 += 4) {
      float2 v[4][2];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const P2* vrow = reinterpret_cast<const P2*>(vs + (j4 + jj) * lay.ldv);
        const bool live = j4 + jj < valid;  // a row past the tile's keys holds stale bytes
        v[jj][0] = live && pair0 ? to_float2(vrow[lane]) : make_float2(0.f, 0.f);
        v[jj][1] = live && pair1 ? to_float2(vrow[lane + 32]) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float4 p = *reinterpret_cast<const float4*>(p_s + g * kTile + j4);
        const float pj[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          acc[g][0] = fmaf(pj[jj], v[jj][0].x, acc[g][0]);
          acc[g][1] = fmaf(pj[jj], v[jj][0].y, acc[g][1]);
          acc[g][2] = fmaf(pj[jj], v[jj][1].x, acc[g][2]);
          acc[g][3] = fmaf(pj[jj], v[jj][1].y, acc[g][3]);
        }
      }
    }
    __syncwarp();  // p_s and the stage are read
    if (i + kStages < count) issue(i + kStages);
  }

  // Combine the four warps: each warp's (max, sum) per head, then its raw
  // outputs over the stages (every warp is past its loop), then each output
  // sum_w e^(m_w - M) acc_w, over sum_w e^(m_w - M) l_w.
#pragma unroll
  for (int mt = 0; mt < kM; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[mt][r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int g = 16 * mt + lane / 4 + 8 * r;
      if (g < kG && lane % 4 == 0) {
        ml_s[2 * (warp * kG + g)] = m[mt][r];
        ml_s[2 * (warp * kG + g) + 1] = sum;
      }
    }
  __syncthreads();
  float* comb = reinterpret_cast<float*>(smem);  // kWarps x kG x Dv
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    float* row = comb + (warp * kG + g) * a.dv;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 2 * lane + 64 * (e / 2) + e % 2;
      if (c < a.dv) row[c] = acc[g][e];
    }
  }
  __syncthreads();
  for (int o = threadIdx.x; o < g_count * a.dv; o += kThreads) {
    const int g = o / a.dv, c = o % a.dv;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, ml_s[2 * (w * kG + g)]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = ml_s[2 * (w * kG + g)];
      const float f = mw > -INFINITY ? expf(mw - mx) : 0.f;
      num += f * comb[(w * kG + g) * a.dv + c];
      den += f * ml_s[2 * (w * kG + g) + 1];
    }
    if (a.splits == 1) {
      static_cast<T*>(a.out)[(head0 + g) * a.dv + c] = from_float<T>(num / den);
    } else {
      const long long at = (head0 + g) * a.splits + split;
      a.part_acc[at * a.dv + c] = num;
      if (c == 0) {
        a.part_ml[2 * at] = mx;
        a.part_ml[2 * at + 1] = den;
      }
    }
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

template <typename T, int kG>
int launch_group(const Args& a, int batch, cudaStream_t s) {
  const Layout<T> lay(a.d, a.dv, kG);
  auto kernel = decode_attention_kernel<T, kG>;
  int err = allow_shared_bytes(kernel, lay.bytes);
  if (err) return err;
  kernel<<<dim3(a.splits, a.kv_heads, batch), kThreads, lay.bytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(Args a, int batch, void* stream) {
  const int g_count = a.heads / a.kv_heads;
  if (a.d < 1 || a.d > kMaxDim || a.dv < 1 || a.dv > kMaxDim || g_count < 1 || g_count > kMaxG ||
      a.heads % a.kv_heads || a.n_cache + a.has_new < 1 || a.splits < 1 || (a.splits > 1 && !a.part_acc) ||
      a.splits > 65535 || a.kv_heads > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (g_count <= 1) err = launch_group<T, 1>(a, batch, s);
  else if (g_count <= 2) err = launch_group<T, 2>(a, batch, s);
  else if (g_count <= 4) err = launch_group<T, 4>(a, batch, s);
  else if (g_count <= 8) err = launch_group<T, 8>(a, batch, s);
  else if (g_count <= 16) err = launch_group<T, 16>(a, batch, s);
  else err = launch_group<T, 32>(a, batch, s);
  if (err || a.splits == 1) return err;
  decode_attention_combine_kernel<T><<<batch * a.heads, kCombineThreads, 0, s>>>(
      a.part_acc, a.part_ml, static_cast<T*>(a.out), a.splits, a.dv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B, 1, H, D); caches with batch strides k_sb, v_sb and position
// strides k_ss, v_ss (elements; the (KVH, D) of a position contiguous); k_new, v_new
// (B, 1, KVH, D) or null (has_new 0); out (B, 1, H, Dv); with splits > 1,
// part_acc (B, H, splits, Dv) and part_ml (B, H, splits, 2) float32
// scratch (null with one split).  Split i of a (b, kv head) holds key
// tiles [i * tiles_per_split, (i + 1) * tiles_per_split) of the n_cache +
// has_new keys (16-key tiles).  vec: bulk copies (rows of 16-byte
// multiples, 16-byte aligned caches, strides and new columns).
#define DECODE_ENTRY(name, T)                                                                        \
  extern "C" int name(const void* q, const void* k_cache, const void* v_cache, const void* k_new,    \
                      const void* v_new, void* out, float* part_acc, float* part_ml, int batch,      \
                      int heads, int kv_heads, int d, int dv, long long k_sb, long long k_ss,        \
                      long long v_sb, long long v_ss,                                              \
                      int n_cache, int has_new, int tiles_per_split, int splits, float scale,        \
                      int vec, void* stream) {                                                       \
    Args a{q, k_cache, v_cache, k_new, v_new, out, part_acc, part_ml, k_sb, k_ss, v_sb, v_ss, heads, \
           kv_heads, d, dv, n_cache, has_new, tiles_per_split, splits, scale, vec};                  \
    return launch<T>(a, batch, stream);                                                              \
  }

DECODE_ENTRY(decode_attention_f32, float)
DECODE_ENTRY(decode_attention_bf16, bf16)
