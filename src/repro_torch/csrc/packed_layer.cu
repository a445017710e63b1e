// XNOR-popcount-threshold layer of the packed dataplane backend, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the reference computes this layer in jnp
// (src/repro/dataplane/executor.py:213-217, inside _packed_fn and
// _packed_scan_fn) and XLA lowers jax.lax.population_count.  PyTorch has no
// popcount op, so the port needs a kernel here.
//
// What it computes: for packet b and neuron j,
//   count = sum_w __popc(~(words[b, w] ^ weights[j, w]) & mask[j, w])
//   out[b, j] = count >= thr[j]        (unsigned compare, {0,1} int32)
// Pad neurons carry thr = 0xFFFFFFFF, far above the 32 * words a count can
// reach, so they never fire (read as a signed int32 that threshold is -1,
// which is why the compare is unsigned).
//
// What bounds it on this card: device-memory bytes, almost all of them
// stores.  Each (packet, neuron) pair writes a 4-byte output for a few
// integer operations per word, and a layer's weights, masks and thresholds
// are a few hundred bytes (the headline model writes 12.6 MB a chunk of
// 32768 packets and reads under 0.4 MB).
//
// Design: three kernels, one entry point each; the wrapper
// (kernels/packed_layer.py::route) picks one by what it can see.
//
// * quad (n_out a multiple of 4, at most 1024; NW = n_words of 1, 2 or 4,
//   a template parameter; words aligned to NW words).  Each thread owns 4
//   consecutive neurons and holds their weight, mask and threshold words in
//   registers, loaded once.  It then walks packets with a block stride: it
//   reads a packet's NW words in one load, computes four counts and writes
//   them as one 16-byte int4.  A block is a whole number of packets' worth of
//   threads, neurons fastest, so the threads of one packet write neighbouring
//   16-byte chunks and a block's stores cover one contiguous span.
// * general (any other layer: a ragged n_out such as FIVE_TUPLE's 2-neuron
//   output, more words, or a misaligned view, whose tables fit one block's
//   shared memory).  One thread per (packet, neuron), neurons fastest; each
//   block stages the layer's weights, masks and thresholds in shared memory
//   once, then strides over the outputs.
// * tiled (the general route's layers whose tables are past one block's
//   shared memory: the block-diagonal layer of 32 merged tenants, 916
//   neurons x 32 words, and of 128 tenants, 3540 x 128 and 1510 x 150).
//   Such a layer is a small binary GEMM with a threshold, and there what
//   bounds it is the popcounts (30 M for 1024 packets x 916 neurons x 32
//   words), not the bytes.  A block takes a tile of 64 packets x 64 neurons
//   and walks K in stages of 32 words: the packets' words and the neurons'
//   weight and mask rows go into shared memory by cp.async (16-byte copies
//   where a row is whole 16-byte vectors and every operand is aligned, else
//   4-byte ones; zeros past every edge, and a zero mask adds nothing), two
//   stages in flight.  Thread (tm, tn) of 16 x 16 counts packets tm + 16i
//   against neurons 4tn + j (i, j < 4) in registers, reading 16-byte vectors
//   of 4 words: a staged row is 36 words (9 vectors, odd), so the 8 lanes of
//   a quarter warp read 8 rows in 8 different bank groups, and they share
//   their neurons (one broadcast).  Each packet's 4 neurons are stored as
//   one int4 where n_out is a multiple of 4, one int at a time at ragged
//   edges.
// * cached (kept as a forced route: the earlier design for those layers).  The
//   general kernel without the staging: the tables are read through the
//   read-only cache, each lane its own row 128 B from its neighbour's.
//
// All index with 32-bit integers (the wrapper keeps every index below 2^31).
//
// packed_layer_routed is the per-tenant layer of the multi-tenant
// scheduler's stacked dispatch.  It replaces no TPU kernel either: the
// reference computes it in jnp (src/repro/dataplane/executor.py:839-851,
// routed_packed_stacked_fn) with jax.lax.population_count.  Each packet b
// carries a tenant id t_b, and its neurons read that tenant's tables of a
// (T, N, W) stack:
//   count = sum_w __popc(~(words[b, w] ^ weights[t_b, j, w]) & mask[t_b, j, w])
//   out[b, j] = count >= thr[t_b, j]   (unsigned, {0,1} int32)
// An id outside [0, T) reads nothing and writes 0 (the public wrapper
// refuses such ids before it launches).  What bounds it is the same as the
// packed layer's: the output stores (13 MB a chunk of 32768 packets for the
// benchmark pool's (T, 64, 1) and (T, 32, 2) layers).  The tables are read
// through the read-only cache and not staged in shared memory: a 128-tenant
// stack (about 130 KB) stays in L1 and L2, and a packet's neurons read one
// tenant's rows.  Two kernels, one entry point each; the wrapper
// (kernels/packed_layer.py::routed_route) picks one by what it can see:
//
// * quad (n_out a multiple of 4, at most 1024; NW of 1, 2 or 4; words aligned
//   to NW words, the tables to 16 bytes).  One thread owns (packet, 4
//   consecutive neurons), neurons fastest, so a packet's threads write
//   neighbouring 16-byte chunks.  It reads the packet's id (one address for
//   all of the packet's threads) and its NW words in one load.  The tables
//   are neuron-major, so the 4 neurons' weight words are one contiguous
//   16*NW-byte span of the tenant's block, read as NW int4 loads; so are
//   their mask words, and the 4 thresholds are one int4.  One int4 store a
//   thread, with a block stride over the packets.
// * general (any other layer: a ragged n_out, other word counts, misaligned
//   views).  One thread per (packet, neuron), neurons fastest, with a grid
//   stride; scalar 4-byte loads and store.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxBlocks = 132 * 8;  // 8 blocks of 256 fill an SM's 2048 threads

template <int NW>
__device__ __forceinline__ void load_words(uint32_t (&x)[NW], const uint32_t* p) {
  if constexpr (NW == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (NW == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = __ldg(p);
  }
}

template <int NW>
__device__ __forceinline__ int fires(const uint32_t (&x)[NW], const uint32_t (&w)[NW],
                                     const uint32_t (&mk)[NW], uint32_t thr) {
  uint32_t count = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) count += static_cast<uint32_t>(__popc(~(x[k] ^ w[k]) & mk[k]));
  return count >= thr ? 1 : 0;
}

template <int NW>
__global__ void __launch_bounds__(kThreads)
packed_layer_quad_kernel(const uint32_t* __restrict__ words, const uint32_t* __restrict__ weights,
                         const uint32_t* __restrict__ mask, const uint32_t* __restrict__ thr,
                         int4* __restrict__ out, uint32_t batch, uint32_t quads) {
  const uint32_t per_block = blockDim.x / quads;  // packets a block step covers
  const uint32_t q = threadIdx.x % quads, p = threadIdx.x / quads;
  uint32_t w[4][NW], mk[4][NW], th[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t neuron = 4 * q + j;
    th[j] = __ldg(thr + neuron);
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      w[j][k] = __ldg(weights + neuron * NW + k);
      mk[j][k] = __ldg(mask + neuron * NW + k);
    }
  }
  for (uint32_t b = blockIdx.x * per_block + p; b < batch; b += gridDim.x * per_block) {
    uint32_t x[NW];
    load_words<NW>(x, words + b * NW);
    out[b * quads + q] = make_int4(fires<NW>(x, w[0], mk[0], th[0]), fires<NW>(x, w[1], mk[1], th[1]),
                                   fires<NW>(x, w[2], mk[2], th[2]), fires<NW>(x, w[3], mk[3], th[3]));
  }
}

// kStaged: the tables are copied into shared memory first (route general);
// else they are read through the read-only cache (route cached).
template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
packed_layer_general_kernel(const uint32_t* __restrict__ words, const uint32_t* __restrict__ weights,
                            const uint32_t* __restrict__ mask, const uint32_t* __restrict__ thr,
                            int* __restrict__ out, uint32_t batch, uint32_t n_out, uint32_t n_words) {
  extern __shared__ uint32_t smem[];
  const uint32_t* sw = weights;
  const uint32_t* sm = mask;
  const uint32_t* st = thr;
  if constexpr (kStaged) {
    const uint32_t table = n_out * n_words;
    uint32_t* w = smem;
    uint32_t* mk = smem + table;
    uint32_t* th = smem + 2 * table;
    for (uint32_t i = threadIdx.x; i < table; i += blockDim.x) {
      w[i] = weights[i];
      mk[i] = mask[i];
    }
    for (uint32_t i = threadIdx.x; i < n_out; i += blockDim.x) th[i] = thr[i];
    sw = w;
    sm = mk;
    st = th;
    __syncthreads();
  }

  const uint32_t total = batch * n_out;
  for (uint32_t idx = blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += gridDim.x * blockDim.x) {
    const uint32_t b = idx / n_out;
    const uint32_t j = idx - b * n_out;
    const uint32_t* x = words + b * n_words;
    const uint32_t* w = sw + j * n_words;
    const uint32_t* mk = sm + j * n_words;
    uint32_t count = 0;
    for (uint32_t k = 0; k < n_words; ++k) {
      count += static_cast<uint32_t>(__popc(~(x[k] ^ w[k]) & mk[k]));
    }
    out[idx] = count >= st[j] ? 1 : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
packed_layer_routed_general_kernel(const uint32_t* __restrict__ words, const int* __restrict__ ids,
                           const uint32_t* __restrict__ weights, const uint32_t* __restrict__ mask,
                           const uint32_t* __restrict__ thr, int* __restrict__ out, uint32_t batch,
                           uint32_t n_out, uint32_t n_words, uint32_t n_tenants) {
  const uint32_t total = batch * n_out;
  for (uint32_t idx = blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += gridDim.x * blockDim.x) {
    const uint32_t b = idx / n_out;
    const uint32_t j = idx - b * n_out;
    const uint32_t t = static_cast<uint32_t>(__ldg(ids + b));  // a negative id wraps past n_tenants
    if (t >= n_tenants) {
      out[idx] = 0;
      continue;
    }
    const uint32_t row = t * n_out + j;
    const uint32_t* x = words + b * n_words;
    const uint32_t* w = weights + row * n_words;
    const uint32_t* mk = mask + row * n_words;
    uint32_t count = 0;
    for (uint32_t k = 0; k < n_words; ++k) {
      count += static_cast<uint32_t>(__popc(~(__ldg(x + k) ^ __ldg(w + k)) & __ldg(mk + k)));
    }
    out[idx] = count >= __ldg(thr + row) ? 1 : 0;
  }
}

// 4 * NW consecutive table words (4 neurons' rows) from a 16-byte aligned p.
template <int NW>
__device__ __forceinline__ void load_rows(uint32_t (&v)[4 * NW], const uint32_t* p) {
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + i);
    v[4 * i] = u.x; v[4 * i + 1] = u.y; v[4 * i + 2] = u.z; v[4 * i + 3] = u.w;
  }
}

template <int NW>
__device__ __forceinline__ int fires_row(const uint32_t (&x)[NW], const uint32_t* w,
                                         const uint32_t* mk, uint32_t thr) {
  uint32_t count = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) count += static_cast<uint32_t>(__popc(~(x[k] ^ w[k]) & mk[k]));
  return count >= thr ? 1 : 0;
}

template <int NW>
__global__ void __launch_bounds__(kThreads)
packed_layer_routed_quad_kernel(const uint32_t* __restrict__ words, const int* __restrict__ ids,
                                const uint32_t* __restrict__ weights, const uint32_t* __restrict__ mask,
                                const uint32_t* __restrict__ thr, int4* __restrict__ out, uint32_t batch,
                                uint32_t quads, uint32_t n_tenants) {
  const uint32_t per_block = blockDim.x / quads;  // packets a block step covers
  const uint32_t q = threadIdx.x % quads, p = threadIdx.x / quads;
  for (uint32_t b = blockIdx.x * per_block + p; b < batch; b += gridDim.x * per_block) {
    const uint32_t t = static_cast<uint32_t>(__ldg(ids + b));  // a negative id wraps past n_tenants
    int4 o = make_int4(0, 0, 0, 0);
    if (t < n_tenants) {
      const uint32_t row = (t * quads + q) * 4;  // the first of the 4 neurons in the (T * N) rows
      uint32_t x[NW], w[4 * NW], mk[4 * NW];
      load_words<NW>(x, words + b * NW);
      load_rows<NW>(w, weights + row * NW);
      load_rows<NW>(mk, mask + row * NW);
      const uint4 th = __ldg(reinterpret_cast<const uint4*>(thr + row));
      o = make_int4(fires_row<NW>(x, w, mk, th.x), fires_row<NW>(x, w + NW, mk + NW, th.y),
                    fires_row<NW>(x, w + 2 * NW, mk + 2 * NW, th.z),
                    fires_row<NW>(x, w + 3 * NW, mk + 3 * NW, th.w));
    }
    out[b * quads + q] = o;
  }
}

constexpr int kTileRows = 64;                 // packets (and neurons) of a tiled-route tile
constexpr int kTileWords = 32;                // words of K a stage holds
constexpr int kTileStride = kTileWords + 4;   // words a staged row takes: 9 vectors, an odd count
constexpr int kTiledThreads = 256;            // 16 x 16 threads, 4 x 4 outputs each
constexpr size_t kTiledSharedBytes = 2 * 3 * kTileRows * kTileStride * sizeof(uint32_t);

__device__ __forceinline__ uint32_t xnor_popc4(uint4 x, uint4 w, uint4 m) {
  return static_cast<uint32_t>(__popc(~(x.x ^ w.x) & m.x) + __popc(~(x.y ^ w.y) & m.y) +
                               __popc(~(x.z ^ w.z) & m.z) + __popc(~(x.w ^ w.w) & m.w));
}

// kVec: n_words a multiple of 4 and words, weights and mask 16-byte aligned.
template <bool kVec>
__global__ void __launch_bounds__(kTiledThreads)
packed_layer_tiled_kernel(const uint32_t* __restrict__ words, const uint32_t* __restrict__ weights,
                          const uint32_t* __restrict__ mask, const uint32_t* __restrict__ thr,
                          int* __restrict__ out, uint32_t batch, uint32_t n_out, uint32_t n_words) {
  extern __shared__ uint4 tiles4[];
  uint32_t* tiles = reinterpret_cast<uint32_t*>(tiles4);  // [stage][x, w, m][row][kTileStride]
  const uint32_t t = threadIdx.x, tm = t % 16, tn = t / 16;
  const uint32_t m0 = blockIdx.x * kTileRows, n0 = blockIdx.y * kTileRows;
  constexpr int kArray = kTileRows * kTileStride;

  // K words [c * kTileWords, +kTileWords) of the tile's packets, weights and
  // masks into stage s; zeros past the batch, n_out and n_words.
  auto stage = [&](uint32_t c, int s) {
    const uint32_t k0 = c * kTileWords;
    constexpr uint32_t kPer = kVec ? kTileWords / 4 : kTileWords;  // copies a row
    for (uint32_t i = t; i < 3 * kTileRows * kPer; i += kTiledThreads) {
      const uint32_t a = i / (kTileRows * kPer), row = i / kPer % kTileRows, j = i % kPer;
      const uint32_t g = (a == 0 ? m0 : n0) + row, k = k0 + (kVec ? 4 * j : j);
      const uint32_t* base = a == 0 ? words : a == 1 ? weights : mask;
      const bool ok = g < (a == 0 ? batch : n_out) && k < n_words;
      const uint32_t* src = ok ? base + g * n_words + k : base;
      uint32_t* dst = tiles + (s * 3 + a) * kArray + row * kTileStride + (kVec ? 4 * j : j);
      if (kVec) {
        cp_async16(dst, src, ok ? 16u : 0u);
      } else {
        cp_async4(dst, src, ok ? 4u : 0u);
      }
    }
    cp_async_commit();
  };

  uint32_t cnt[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) cnt[i][j] = 0;
  }
  const uint32_t stages = (n_words + kTileWords - 1) / kTileWords;
  stage(0, 0);
  for (uint32_t c = 0; c < stages; ++c) {
    if (c + 1 < stages) {
      stage(c + 1, (c + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage c is in for every thread
    const uint32_t* xs = tiles + ((c & 1) * 3) * kArray;
    const uint32_t* ws = xs + kArray;
    const uint32_t* ms = xs + 2 * kArray;
#pragma unroll
    for (int kq = 0; kq < kTileWords / 4; ++kq) {
      uint4 x[4], w[4], m[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = *reinterpret_cast<const uint4*>(xs + (tm + 16 * i) * kTileStride + 4 * kq);
        w[i] = *reinterpret_cast<const uint4*>(ws + (4 * tn + i) * kTileStride + 4 * kq);
        m[i] = *reinterpret_cast<const uint4*>(ms + (4 * tn + i) * kTileStride + 4 * kq);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) cnt[i][j] += xnor_popc4(x[i], w[j], m[j]);
      }
    }
    __syncthreads();  // every thread is done with stage c before stage c + 2 overwrites it
  }

  const uint32_t n = n0 + 4 * tn;
  uint32_t th[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) th[j] = n + j < n_out ? __ldg(thr + n + j) : 0u;
  const bool whole = (n_out & 3u) == 0 && n + 3 < n_out && (reinterpret_cast<uintptr_t>(out) & 15u) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t b = m0 + tm + 16 * i;
    if (b >= batch) continue;
    int* o = out + b * n_out + n;
    if (whole) {
      *reinterpret_cast<int4*>(o) = make_int4(cnt[i][0] >= th[0], cnt[i][1] >= th[1], cnt[i][2] >= th[2],
                                              cnt[i][3] >= th[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (n + j < n_out) o[j] = cnt[i][j] >= th[j] ? 1 : 0;
      }
    }
  }
}

// Blocks of a quad-route launch: a whole number of packets' quads a block,
// enough blocks to cover the batch, at most kMaxBlocks (they stride).
inline uint32_t quad_blocks(uint32_t batch, uint32_t quads) {
  const uint32_t per_block = kThreads / quads;
  const uint32_t wanted = (batch + per_block - 1) / per_block;
  return wanted < kMaxBlocks ? wanted : kMaxBlocks;
}

template <int NW>
int launch_routed_quad(const void* words, const void* ids, const void* weights, const void* mask,
                       const void* thr, void* out, uint32_t batch, uint32_t n_out, uint32_t n_tenants,
                       cudaStream_t stream) {
  const uint32_t quads = n_out / 4;
  packed_layer_routed_quad_kernel<NW><<<quad_blocks(batch, quads), (kThreads / quads) * quads, 0, stream>>>(
      static_cast<const uint32_t*>(words), static_cast<const int*>(ids),
      static_cast<const uint32_t*>(weights), static_cast<const uint32_t*>(mask),
      static_cast<const uint32_t*>(thr), static_cast<int4*>(out), batch, quads, n_tenants);
  return static_cast<int>(cudaGetLastError());
}

template <int NW>
int launch_quad(const void* words, const void* weights, const void* mask, const void* thr,
                void* out, uint32_t batch, uint32_t n_out, cudaStream_t stream) {
  const uint32_t quads = n_out / 4;
  packed_layer_quad_kernel<NW><<<quad_blocks(batch, quads), (kThreads / quads) * quads, 0, stream>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(weights),
      static_cast<const uint32_t*>(mask), static_cast<const uint32_t*>(thr),
      static_cast<int4*>(out), batch, quads);
  return static_cast<int>(cudaGetLastError());
}

template <bool kStaged>
int launch_general(const void* words, const void* weights, const void* mask, const void* thr,
                   void* out, int batch, int n_out, int n_words, size_t smem, cudaStream_t stream) {
  const uint32_t total = static_cast<uint32_t>(batch) * static_cast<uint32_t>(n_out);
  const uint32_t wanted = (total + kThreads - 1) / kThreads;
  const uint32_t blocks = wanted < kMaxBlocks * 2 ? wanted : kMaxBlocks * 2;
  packed_layer_general_kernel<kStaged><<<blocks, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(weights),
      static_cast<const uint32_t*>(mask), static_cast<const uint32_t*>(thr),
      static_cast<int*>(out), batch, n_out, n_words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int packed_layer_quad(const void* words, const void* weights, const void* mask,
                                 const void* thr, void* out, int batch, int n_out, int n_words,
                                 void* stream) {
  if (n_out <= 0 || n_out % 4 || n_out > 4 * kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (n_words) {
    case 1: return launch_quad<1>(words, weights, mask, thr, out, batch, n_out, s);
    case 2: return launch_quad<2>(words, weights, mask, thr, out, batch, n_out, s);
    case 4: return launch_quad<4>(words, weights, mask, thr, out, batch, n_out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int packed_layer_general(const void* words, const void* weights, const void* mask,
                                    const void* thr, void* out, int batch, int n_out, int n_words,
                                    void* stream) {
  const size_t smem =
      (2 * static_cast<size_t>(n_out) * n_words + n_out) * sizeof(uint32_t);
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = allow_shared_bytes(&packed_layer_general_kernel<true>, smem);
  if (rc) return rc;
  return launch_general<true>(words, weights, mask, thr, out, batch, n_out, n_words, smem,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int packed_layer_cached(const void* words, const void* weights, const void* mask,
                                   const void* thr, void* out, int batch, int n_out, int n_words,
                                   void* stream) {
  return launch_general<false>(words, weights, mask, thr, out, batch, n_out, n_words, 0,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int packed_layer_tiled(const void* words, const void* weights, const void* mask,
                                  const void* thr, void* out, int batch, int n_out, int n_words,
                                  void* stream) {
  if (batch <= 0 || n_out <= 0 || n_words <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((batch + kTileRows - 1) / kTileRows, (n_out + kTileRows - 1) / kTileRows);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = n_words % 4 == 0 && (reinterpret_cast<uintptr_t>(words) & 15u) == 0 &&
                   (reinterpret_cast<uintptr_t>(weights) & 15u) == 0 &&
                   (reinterpret_cast<uintptr_t>(mask) & 15u) == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint32_t*>(words);
  const auto* wt = static_cast<const uint32_t*>(weights);
  const auto* mk = static_cast<const uint32_t*>(mask);
  const auto* th = static_cast<const uint32_t*>(thr);
  auto* o = static_cast<int*>(out);
  int rc;
  if (vec) {
    rc = allow_shared_bytes(packed_layer_tiled_kernel<true>, kTiledSharedBytes);
    if (rc) return rc;
    packed_layer_tiled_kernel<true><<<grid, kTiledThreads, kTiledSharedBytes, s>>>(w, wt, mk, th, o, batch, n_out,
                                                                                  n_words);
  } else {
    rc = allow_shared_bytes(packed_layer_tiled_kernel<false>, kTiledSharedBytes);
    if (rc) return rc;
    packed_layer_tiled_kernel<false><<<grid, kTiledThreads, kTiledSharedBytes, s>>>(w, wt, mk, th, o, batch, n_out,
                                                                                   n_words);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int packed_layer_routed_general(const void* words, const void* ids, const void* weights,
                                           const void* mask, const void* thr, void* out, int batch,
                                           int n_out, int n_words, int n_tenants, void* stream) {
  if (batch < 0 || n_out <= 0 || n_words <= 0 || n_tenants <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint32_t total = static_cast<uint32_t>(batch) * static_cast<uint32_t>(n_out);
  if (total == 0) return 0;
  const uint32_t wanted = (total + kThreads - 1) / kThreads;
  const uint32_t blocks = wanted < kMaxBlocks * 2 ? wanted : kMaxBlocks * 2;
  packed_layer_routed_general_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int*>(ids),
      static_cast<const uint32_t*>(weights), static_cast<const uint32_t*>(mask),
      static_cast<const uint32_t*>(thr), static_cast<int*>(out), batch, n_out, n_words, n_tenants);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int packed_layer_routed_quad(const void* words, const void* ids, const void* weights,
                                        const void* mask, const void* thr, void* out, int batch,
                                        int n_out, int n_words, int n_tenants, void* stream) {
  if (batch < 0 || n_out <= 0 || n_out % 4 || n_out > 4 * kThreads || n_tenants <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (n_words) {
    case 1: return launch_routed_quad<1>(words, ids, weights, mask, thr, out, batch, n_out, n_tenants, s);
    case 2: return launch_routed_quad<2>(words, ids, weights, mask, thr, out, batch, n_out, n_tenants, s);
    case 4: return launch_routed_quad<4>(words, ids, weights, mask, thr, out, batch, n_out, n_tenants, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
