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
// What bounds it on this card: device-memory bytes.  Each (packet, neuron)
// pair writes a 4-byte output for a few integer operations per word, and a
// layer's weights, masks and thresholds are a few hundred bytes.
//
// Design: one thread per (packet, neuron), neurons fastest, so a warp's
// output stores are contiguous.  Each block stages the layer's weights,
// masks and thresholds in shared memory once and then strides over the
// grid, so the staging is paid once per block, not per output.  Threads of
// one packet read the same input words: a broadcast from L1.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 16;
constexpr int kSms = 132;

__global__ void packed_layer_kernel(
    const uint32_t* __restrict__ words, const uint32_t* __restrict__ weights,
    const uint32_t* __restrict__ mask, const uint32_t* __restrict__ thr,
    int* __restrict__ out, long long batch, int n_out, int n_words) {
  extern __shared__ uint32_t smem[];
  const int table = n_out * n_words;
  uint32_t* sw = smem;
  uint32_t* sm = smem + table;
  uint32_t* st = smem + 2 * table;
  for (int i = threadIdx.x; i < table; i += blockDim.x) {
    sw[i] = weights[i];
    sm[i] = mask[i];
  }
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) st[i] = thr[i];
  __syncthreads();

  const long long total = batch * n_out;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const long long b = idx / n_out;
    const int j = static_cast<int>(idx % n_out);
    const uint32_t* x = words + b * n_words;
    const uint32_t* w = sw + j * n_words;
    const uint32_t* mk = sm + j * n_words;
    uint32_t count = 0;
    for (int k = 0; k < n_words; ++k) {
      count += static_cast<uint32_t>(__popc(~(x[k] ^ w[k]) & mk[k]));
    }
    out[idx] = count >= st[j] ? 1 : 0;
  }
}

}  // namespace

extern "C" int packed_layer(const void* words, const void* weights,
                            const void* mask, const void* thr, void* out,
                            long long batch, int n_out, int n_words,
                            void* stream) {
  const size_t smem =
      (2 * static_cast<size_t>(n_out) * n_words + n_out) * sizeof(uint32_t);
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = allow_shared_bytes(packed_layer_kernel, smem);
  if (rc) return rc;
  const long long total = batch * n_out;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kSms * kBlocksPerSm) blocks = kSms * kBlocksPerSm;
  packed_layer_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const uint32_t*>(weights),
      static_cast<const uint32_t*>(mask), static_cast<const uint32_t*>(thr),
      static_cast<int*>(out), batch, n_out, n_words);
  return static_cast<int>(cudaGetLastError());
}
