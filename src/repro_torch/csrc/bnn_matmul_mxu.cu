// ±1 binary GEMM on the tensor cores, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bnn_matmul_mxu.py::
// bnn_matmul_mxu (the MXU variant of the binary GEMM).
//
// What it computes: out (M, N) float32 = binarize(x) @ w, with x (M, K)
// float32 or bf16 and w (K, N) bf16 (pre-binarized ±1 weights), accumulated
// in float32.  binarize(x) is +1 where x >= 0 (so -0.0 gives +1) and -1
// elsewhere (so NaN gives -1), as jnp.where(x >= 0, 1, -1) computes it with
// subnormals flushed to zero: a negative subnormal gives +1 (sign_bit in
// common.cuh); with binarize_x = 0, x is rounded to bf16 (round to nearest
// even) instead.
// With ±1 operands every partial sum is an integer below 2^24, so the result
// is exact whatever the order of the sums.
//
// What bounds it on this card: at the shapes of a prefill or a training
// step (M, N, K in the thousands) the tensor cores' operations, 989 TFLOP/s
// dense bf16; bytes only when M is small.
//
// Design: the TPU kernel carried an f32 accumulator across a sequential K
// grid axis.  Here a block owns an output tile and loops over K itself.  Two
// kernels; the wrapper (kernels/bnn_matmul_mxu.py::route) picks one by what
// it can see, with one entry point each:
//
// * tma (bf16 x, K and N multiples of 8, 16-byte aligned operands: the
//   model's path): persistent, one block per SM walking 128 x 256 output
//   tiles (M fastest, so the blocks in flight share a few column tiles of
//   w), K in slices of 64 through a four-stage ring in shared memory fed by
//   TMA with the 128B swizzle (x as one 128 x 64 box, w as four 64 x 64
//   boxes, which wgmma reads MN-major).  One producer thread keeps the ring
//   full across tiles; two consumer warpgroups each run wgmma m64n256k16
//   into float32 registers for 64 rows of the tile.  The sign stays fused:
//   each consumer loads its x fragments from the landed slice with
//   ldmatrix, signs them in registers (one bf16x2 compare and one FMA a
//   word) and feeds them to wgmma as its register A operand, so x is never
//   written back signed, not even to shared memory.  TMA fills zeros past
//   every edge: a zero x past K is signed into +1, but the w rows past K are
//   zero too, so it adds 0.  Stores go straight from registers, masked at
//   ragged M and N, and drain while the block's next tile multiplies.
//   (hopper.cuh holds the TMA, mbarrier and wgmma pieces.)
// * staged (float32 x, or K or N not a multiple of 8, or misaligned
//   operands): WMMA bf16 16x16x16, 64 x 64 tiles, four warps of 32 x 32;
//   x is signed (or rounded to bf16) while it is copied into shared memory,
//   anything past an edge is stored as 0 in both operands, and the tile is
//   written through shared memory to mask the ragged edges.

#include <cuda_bf16.h>
#include <mma.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;  // 4 warps, 2 x 2 over the tile
constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kLdA = kBK + 8;  // bf16 row strides: multiples of 8 elements,
constexpr int kLdB = kBN + 8;  // fragment rows 32-byte aligned
constexpr int kLdC = kBN + 4;  // float stride: a multiple of 4

// sign_bit, not v >= 0: the reference's signs are computed with subnormals
// flushed to zero (XLA's CPU backend and the TPU), so a negative subnormal
// binarizes to +1.
__device__ __forceinline__ __nv_bfloat16 to_operand(float v, bool binarize) {
  if (binarize) return __float2bfloat16_rn(sign_bit(v) ? 1.f : -1.f);
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ __nv_bfloat16 to_operand(__nv_bfloat16 v, bool binarize) {
  if (binarize) return __float2bfloat16_rn(sign_bit(__bfloat162float(v)) ? 1.f : -1.f);
  return v;
}

template <typename TX>
__global__ void __launch_bounds__(kThreads)
bnn_matmul_mxu_kernel(const TX* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                      float* __restrict__ out, int m, int n, int k, bool binarize) {
  __shared__ __align__(128) __nv_bfloat16 as[kBM * kLdA];
  __shared__ __align__(128) __nv_bfloat16 bs[kBK * kLdB];
  __shared__ __align__(128) float cs[kBM * kLdC];
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < k; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int gm = m0 + r, gk = k0 + c;
      as[r * kLdA + c] = (gm < m && gk < k)
          ? to_operand(x[static_cast<long long>(gm) * k + gk], binarize) : zero;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      const int gk = k0 + r, gn = n0 + c;
      bs[r * kLdB + c] = (gk < k && gn < n) ? w[static_cast<long long>(gk) * n + gn] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], as + (wm + 16 * i) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], bs + kk * kLdB + wn + 16 * j, kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm + 16 * i) * kLdC + wn + 16 * j, acc[i][j], kLdC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i % kBN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < m && gn < n) out[static_cast<long long>(gm) * n + gn] = cs[r * kLdC + c];
  }
}

template <typename TX>
int launch(const void* x, const void* w, void* out, int m, int n, int k, int binarize,
           void* stream) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  bnn_matmul_mxu_kernel<TX><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TX*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<float*>(out), m, n, k, binarize != 0);
  return static_cast<int>(cudaGetLastError());
}


// ---- TMA + wgmma kernel: bf16 x, K % 8 == 0, N % 8 == 0 -----------------------

constexpr int kTBM = 128, kTBN = 256, kTBK = 64, kTStages = 4;
constexpr int kTThreads = 384;                     // two consumer warpgroups + a producer
constexpr int kConsumerWarps = 8;
constexpr int kABytes = kTBM * kTBK * 2;           // one 128 x 64 box of x
constexpr int kBBoxBytes = kTBK * 64 * 2;          // one 64 (k) x 64 (n) box of w
constexpr int kStageBytes = kABytes + kTBN / 64 * kBBoxBytes;
constexpr size_t kTSharedBytes = static_cast<size_t>(kTStages) * kStageBytes +
                                 2 * kTStages * sizeof(uint64_t) + 1024;  // + alignment slack

// +1 where a bf16 x >= 0, -1 elsewhere, for both halves of a word: one
// bf16x2 compare (sign_bits_bf16x2: 1.0 where x > -FLT_MIN, so -0.0 and a
// negative subnormal give +1, as the reference's signs computed with
// subnormals flushed to zero do; 0.0 where x <= -FLT_MIN or x is NaN) and
// one bf16x2 FMA, 2 * ge - 1, exact.
__device__ __forceinline__ uint32_t sign_bf16x2(uint32_t w) {
  const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&w);
  const __nv_bfloat162 ge = sign_bits_bf16x2(x);
  const __nv_bfloat162 r = __hfma2(ge, __float2bfloat162_rn(2.f), __float2bfloat162_rn(-1.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The A fragments of one x slice for this thread, signed when `binarize`:
// a[kk] holds its part of the warpgroup's 64 rows x k 16kk .. 16kk + 15, as
// wgmma's register A operand takes it (warp w: rows 16w .. 16w + 15).
// `rows` is the warpgroup's 64 rows of the slice as TMA stored them
// (128-byte rows, 128B swizzle: the 16-byte chunk c of row r sits at chunk
// c ^ (r % 8)).
__device__ __forceinline__ void x_fragments(uint32_t (&a)[kTBK / 16][4], const unsigned char* rows,
                                            int warp, int lane, bool binarize) {
  const int q = lane >> 3, r = 16 * warp + 8 * (q & 1) + (lane & 7);
#pragma unroll
  for (int kk = 0; kk < kTBK / 16; ++kk) {
    const int chunk = 2 * kk + (q >> 1);
    hopper::ldmatrix_x4(a[kk], rows + r * 128 + ((chunk ^ (r & 7)) << 4));
    if (binarize) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[kk][e] = sign_bf16x2(a[kk][e]);
    }
  }
}

__global__ void __launch_bounds__(kTThreads, 1)
bnn_matmul_mxu_tma_kernel(const __grid_constant__ CUtensorMap x_map,
                          const __grid_constant__ CUtensorMap w_map, float* __restrict__ out,
                          int m, int n, int k, bool binarize) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_shared(smem_raw, 1024);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kTStages * kStageBytes);
  uint64_t* empty = full + kTStages;
  const int slices = (k + kTBK - 1) / kTBK;
  // Persistent: the block walks the output tiles blockIdx.x, + gridDim.x, ...
  // M fastest, so the blocks in flight share a few column tiles of w.
  const int m_tiles = (m + kTBM - 1) / kTBM;
  const int tiles = m_tiles * ((n + kTBN - 1) / kTBN);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The warpgroup index, broadcast from lane 0 so that the compiler sees it
  // is uniform across each warp and setmaxnreg applies to each branch: the
  // consumers' 128 accumulators and fragments need more than 168 registers.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {  // the producer warpgroup: one thread issues every load
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      tma_prefetch_map(&x_map);
      tma_prefetch_map(&w_map);
      int it = 0;  // slices loaded so far, over all of this block's tiles
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile % m_tiles * kTBM, n0 = tile / m_tiles * kTBN;
        for (int t = 0; t < slices; ++t, ++it) {
          const int s = it % kTStages;
          mbar_wait(empty + s, ((it / kTStages) & 1) ^ 1);
          unsigned char* st = smem + s * kStageBytes;
          mbar_arrive_expect_tx(full + s, kStageBytes);
          tma_load_2d(st, &x_map, full + s, t * kTBK, m0);
#pragma unroll
          for (int b = 0; b < kTBN / 64; ++b)
            tma_load_2d(st + kABytes + b * kBBoxBytes, &w_map, full + s, n0 + 64 * b, t * kTBK);
        }
      }
    }
  } else {  // two consumer warpgroups, 64 rows of each tile each
    setmaxnreg_inc<232>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    // Slice i (counted over all of this block's tiles) sits in stage
    // i % kTStages.  Each slice's x fragments are loaded, signed in
    // registers and fed to wgmma as its register A operand (x is never
    // written back signed); that slice's products finish before the next
    // slice's fragments are loaded, and the other warpgroup's products fill
    // the gap.  A tile's stores drain while the next tile's products run.
    int it = 0;
    float acc[kTBN / 2];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile % m_tiles * kTBM, n0 = tile / m_tiles * kTBN;
#pragma unroll
      for (int j = 0; j < kTBN / 2; ++j) acc[j] = 0.f;
      for (int t = 0; t < slices; ++t, ++it) {
        const int s = it % kTStages;
        unsigned char* st = smem + s * kStageBytes;
        mbar_wait(full + s, (it / kTStages) & 1);
        uint32_t a[kTBK / 16][4];
        x_fragments(a, st + wg * 64 * 128, warp, lane, binarize);
        reg_fence(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTBK / 16; ++kk)
          Wgmma<kTBN>::rs<1>(acc, a[kk],
                             desc_mn_major_128b(st + kABytes + 2048 * kk, kBBoxBytes), 1);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);
      }

      const int row_a = m0 + 64 * wg + 16 * warp + lane / 4;
#pragma unroll
      for (int j = 0; j < kTBN / 2; j += 2) {
        const int row = row_a + 8 * ((j >> 1) & 1);
        const int col = n0 + 8 * (j >> 2) + 2 * (lane % 4);
        if (row < m && col < n)  // n is even, so col + 1 < n too
          *reinterpret_cast<float2*>(out + static_cast<long long>(row) * n + col) =
              make_float2(acc[j], acc[j + 1]);
      }
    }
  }
}

int sm_count() {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    return 0;
  return sms;
}

bool aligned(const void* p, unsigned bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

int launch_tma(const void* x, const void* w, void* out, int m, int n, int k, int binarize,
               void* stream) {
  if (k % 8 || n % 8 || !aligned(x, 16) || !aligned(w, 16) || !aligned(out, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap x_map, w_map;
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(m)};
  const cuuint64_t x_strides[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t x_box[2] = {kTBK, kTBM};
  const cuuint64_t w_dims[2] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(k)};
  const cuuint64_t w_strides[1] = {static_cast<cuuint64_t>(n) * 2};
  const cuuint32_t w_box[2] = {64, kTBK};
  int err = hopper::bf16_tensor_map(&x_map, x, 2, x_dims, x_strides, x_box);
  if (!err) err = hopper::bf16_tensor_map(&w_map, w, 2, w_dims, w_strides, w_box);
  if (!err) err = allow_shared_bytes(bnn_matmul_mxu_tma_kernel, kTSharedBytes);
  if (err) return err;
  const int tiles = (m + kTBM - 1) / kTBM * ((n + kTBN - 1) / kTBN);
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const dim3 grid(tiles < sms ? tiles : sms);  // one block per SM
  bnn_matmul_mxu_tma_kernel<<<grid, kTThreads, kTSharedBytes, static_cast<cudaStream_t>(stream)>>>(
      x_map, w_map, static_cast<float*>(out), m, n, k, binarize != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bnn_matmul_mxu_f32(const void* x, const void* w, void* out, int m, int n,
                                  int k, int binarize, void* stream) {
  return launch<float>(x, w, out, m, n, k, binarize, stream);
}

extern "C" int bnn_matmul_mxu_bf16(const void* x, const void* w, void* out, int m, int n,
                                   int k, int binarize, void* stream) {
  return launch<__nv_bfloat16>(x, w, out, m, n, k, binarize, stream);
}

extern "C" int bnn_matmul_mxu_tma(const void* x, const void* w, void* out, int m, int n, int k,
                                  int binarize, void* stream) {
  return launch_tma(x, w, out, m, n, k, binarize, stream);
}
