// Op-table ALU of the dataplane executor, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/optable_exec.py::optable_run
// (and its per-opcode-run wrapper optable_run_segmented).
//
// What it computes: a lowered program's op-table over a transposed
// (num_regs, batch) uint32 register file.  Tables are (elements, max_rows):
// opcode/dst/src0/src1/first_write int32, imm0/imm1/mask uint32.  Per element,
// pass 1 computes every row from the register file as it stood entering the
// element (`& mask`); pass 2 writes back in row order: a first_write row
// overwrites its destination, a FOLD continuation row adds to it.
//
// What bounds it on this card: every row is a few integer operations per
// packet on registers that live in shared memory, and each packet's register
// file is read from and written to device memory once.  For the paper's
// headline model the two are of one order (about 1,500 true rows of integer
// work per packet against 2 x 129 x 4 bytes moved per packet).
//
// Design: one thread per packet.  A block stages its packets' register files
// in dynamic shared memory as [reg][thread] (consecutive threads, consecutive
// banks: no conflicts), with a [row][thread] scratch for pass 1, and walks
// ALL elements in one launch, so the register file crosses device memory
// once per program instead of once per element.  Threads never touch
// another thread's column, so no block-level barrier is needed.  Every
// thread of a block reads the same table row at the same time: one broadcast
// load, served from L1 after the first block.  The opcode `switch` is
// uniform across the warp, so it does not diverge; the TPU kernel's per-
// opcode-run narrowing existed only to shorten XLA's where-select chain and
// has no counterpart here.  The block size (128, 64 or 32 threads) is chosen
// by the wrapper so that (num_regs + max_rows) * 4 B * threads fits the
// 227 KB of shared memory one block may use.
//
// uint32 semantics match XLA's: shifts by 32 or more give 0 (undefined in
// C++, so guarded), ADD wraps, GE_IMM compares unsigned, POPCNT is __popc.
// The wrapper rejects opcodes outside 0-5 and slot indices outside the
// register file before launching.

#include "common.cuh"

namespace {

enum : int { kXorImm = 0, kShrAndImm = 1, kAdd = 2, kGeImm = 3, kShlImm = 4, kPopcnt = 5 };

__device__ __forceinline__ uint32_t alu(int op, uint32_t a, uint32_t b,
                                        uint32_t i0, uint32_t i1) {
  switch (op) {
    case kXorImm: return a ^ i0;
    case kShrAndImm: return (i0 >= 32u ? 0u : a >> i0) & i1;
    case kAdd: return a + b;
    case kGeImm: return a >= i0 ? 1u : 0u;
    case kShlImm: return i0 >= 32u ? 0u : a << i0;
    case kPopcnt: return static_cast<uint32_t>(__popc(a));
    default: return 0u;  // unreachable: the wrapper rejects other opcodes
  }
}

__global__ void optable_kernel(
    const int* __restrict__ opcode, const int* __restrict__ dst,
    const int* __restrict__ src0, const int* __restrict__ src1,
    const uint32_t* __restrict__ imm0, const uint32_t* __restrict__ imm1,
    const uint32_t* __restrict__ mask, const int* __restrict__ first_write,
    const uint32_t* __restrict__ regs_in, uint32_t* __restrict__ regs_out,
    int num_regs, int batch, int num_elements, int max_rows) {
  extern __shared__ uint32_t smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const long long b = static_cast<long long>(blockIdx.x) * T + t;
  if (b >= batch) return;  // no barriers below, so a ragged tail may leave
  uint32_t* R = smem;                                  // [num_regs][T]
  uint32_t* S = smem + static_cast<size_t>(num_regs) * T;  // [max_rows][T]

  for (int r = 0; r < num_regs; ++r) {
    R[r * T + t] = regs_in[static_cast<size_t>(r) * batch + b];
  }
  for (int e = 0; e < num_elements; ++e) {
    const int base = e * max_rows;
    for (int r = 0; r < max_rows; ++r) {
      const int i = base + r;
      const uint32_t a = R[src0[i] * T + t];
      const uint32_t c = R[src1[i] * T + t];
      S[r * T + t] = alu(opcode[i], a, c, imm0[i], imm1[i]) & mask[i];
    }
    for (int r = 0; r < max_rows; ++r) {
      const int i = base + r;
      uint32_t* d = &R[dst[i] * T + t];
      const uint32_t v = S[r * T + t];
      *d = first_write[i] ? v : *d + v;
    }
  }
  for (int r = 0; r < num_regs; ++r) {
    regs_out[static_cast<size_t>(r) * batch + b] = R[r * T + t];
  }
}

}  // namespace

extern "C" int optable_run(
    const void* opcode, const void* dst, const void* src0, const void* src1,
    const void* imm0, const void* imm1, const void* mask,
    const void* first_write, const void* regs_in, void* regs_out,
    int num_regs, int batch, int num_elements, int max_rows, int threads,
    void* stream) {
  const size_t smem =
      static_cast<size_t>(num_regs + max_rows) * sizeof(uint32_t) * threads;
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = allow_shared_bytes(optable_kernel, smem);
  if (rc) return rc;
  const int blocks = (batch + threads - 1) / threads;
  optable_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(opcode), static_cast<const int*>(dst),
      static_cast<const int*>(src0), static_cast<const int*>(src1),
      static_cast<const uint32_t*>(imm0), static_cast<const uint32_t*>(imm1),
      static_cast<const uint32_t*>(mask), static_cast<const int*>(first_write),
      static_cast<const uint32_t*>(regs_in), static_cast<uint32_t*>(regs_out),
      num_regs, batch, num_elements, max_rows);
  return static_cast<int>(cudaGetLastError());
}
