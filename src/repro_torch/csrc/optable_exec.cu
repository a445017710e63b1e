// Op-table ALU of the dataplane executor, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/optable_exec.py::optable_run
// (and its per-opcode-run wrapper optable_run_segmented).
//
// What it computes: a lowered program's op-table over a transposed
// (num_regs, batch) uint32 register file.  Per element every row computes
// its value from the register file as it stood entering the element
// (`& mask`), then the rows write back in row order: a first_write row
// overwrites its destination, a FOLD continuation row adds to it.
//
// What bounds it on this card: every row is a few integer operations per
// packet on registers that live in shared memory, and each packet's register
// file is read from and written to device memory once.  For the paper's
// headline model the two are of one order (3,168 true rows of integer work
// per packet against 2 x 129 x 4 bytes moved per packet).  In practice the
// shared-memory accesses of each row, and their latency with few warps an
// SM (the register files fill its shared memory), bound it.
//
// Design.  The wrapper (kernels/optable_exec.py::make_plan) turns the tables
// into a plan once on the host; this kernel walks the plan:
// - Pad rows are cut: an element runs only its true rows, then zeroes the
//   register its pads overwrote (the null register), so that register ends
//   as the pads left it.
// - Each row is one 16-byte record: src0 | src1 << 16, target | opcode << 16
//   | store << 20, imm0, and the AND mask (SHR_AND_IMM's imm1 folded in).
// - Only rows whose destination a later row of the element reads are
//   deferred: they store into a scratch slot (target num_regs + k) and are
//   written back, in row order, at the element's end.  Every other row
//   writes its destination at once, since nothing in the element reads it
//   afterwards.  So the scratch is as tall as the most deferred rows of any
//   element (64 on the headline model, not its 128 rows), and more packets
//   fit an SM.
// - No row reads what an earlier row of the element wrote, so a thread takes
//   rows in groups of kRowGroup: their records into registers, every value
//   (all the shared-memory reads in flight together), then the writes.  The
//   plan pads each run of one opcode to whole groups (lowering sorts an
//   element's rows by opcode, so the headline model needs no padding), and a
//   group branches once on its opcode, the same across the block.
// - One thread per packet.  A block keeps its packets' register files and
//   scratch in dynamic shared memory as [slot][thread] (consecutive threads,
//   consecutive banks) and walks ALL elements in one launch, so the register
//   file crosses device memory once per program.  Each element's records are
//   staged in shared memory by cp.async, double-buffered: the next element's
//   arrive while this one runs, and every thread reads a record by broadcast
//   instead of eight global loads per row.  Threads past the batch run on
//   zeros and store nothing (they take part in the barriers).  The wrapper
//   picks the block size that keeps the most packets resident on an SM.
//
// uint32 semantics match XLA's: shifts by 32 or more give 0 (the clamped
// funnel shifts), ADD wraps, GE_IMM compares unsigned, POPCNT is __popc.
// The wrapper rejects opcodes outside 0-5 and slots outside the register
// file while planning, before any launch.

#include "common.cuh"

namespace {

enum : uint32_t { kXorImm = 0, kShrAndImm = 1, kAdd = 2, kGeImm = 3, kShlImm = 4, kPopcnt = 5 };
constexpr int kRowGroup = 32;  // kernels/optable_exec.py ROW_GROUP

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

template <uint32_t OP>
__device__ __forceinline__ uint32_t alu(uint32_t a, uint32_t b, uint32_t i0) {
  if (OP == kXorImm) return a ^ i0;
  if (OP == kShrAndImm) return __funnelshift_rc(a, 0u, i0);  // a >> i0, 0 from 32 up
  if (OP == kAdd) return a + b;
  if (OP == kGeImm) return static_cast<uint32_t>(a >= i0);
  if (OP == kShlImm) return __funnelshift_lc(0u, a, i0);  // a << i0, 0 from 32 up
  return static_cast<uint32_t>(__popc(a));
}

// One group of kRowGroup rows of opcode OP over this thread's packet (R
// points at its column, slot k at R[k * T]).  The records are read into
// registers first (a store into R could alias them, so reading them later
// would wait on each store), then every row's value, then the writes in row
// order.
template <uint32_t OP>
__device__ __forceinline__ void run_group(const uint4* __restrict__ q, uint32_t* R, int T) {
  uint4 r[kRowGroup];
  uint32_t v[kRowGroup];
#pragma unroll
  for (int g = 0; g < kRowGroup; ++g) r[g] = q[g];
#pragma unroll
  for (int g = 0; g < kRowGroup; ++g) {
    const uint32_t a = R[(r[g].x & 0xFFFFu) * T];
    const uint32_t c = OP == kAdd ? R[(r[g].x >> 16) * T] : 0u;
    v[g] = alu<OP>(a, c, r[g].z) & r[g].w;
  }
#pragma unroll
  for (int g = 0; g < kRowGroup; ++g) {
    uint32_t* d = R + (r[g].y & 0xFFFFu) * T;
    uint32_t x = v[g];
    if (!((r[g].y >> 20) & 1u)) x += *d;  // a FOLD continuation adds (a load only then)
    *d = x;
  }
}

__global__ void optable_kernel(const uint4* __restrict__ plan, const uint32_t* __restrict__ regs_in,
                               uint32_t* __restrict__ regs_out, int num_regs, int batch,
                               int num_elements, int stride) {
  extern __shared__ uint4 smem4[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const long long b = static_cast<long long>(blockIdx.x) * T + t;
  const bool live = b < batch;
  uint32_t* R = reinterpret_cast<uint32_t*>(smem4 + 2 * stride) + t;  // [slot][T], this thread's column

  auto stage = [&](int e) {  // element e's records into buffer e % 2
    if (e < num_elements) {
      const uint4* src = plan + static_cast<size_t>(e) * stride;
      uint4* dst = smem4 + (e & 1) * stride;
      for (int i = t; i < stride; i += T) cp_async16(dst + i, src + i);
    }
    cp_async_commit();
  };

  stage(0);
  // The register file in: kRowGroup loads in flight before their stores.
  for (int r0 = 0; r0 < num_regs; r0 += kRowGroup) {
    uint32_t in[kRowGroup];
#pragma unroll
    for (int g = 0; g < kRowGroup; ++g) {
      in[g] = live && r0 + g < num_regs ? regs_in[static_cast<size_t>(r0 + g) * batch + b] : 0u;
    }
#pragma unroll
    for (int g = 0; g < kRowGroup; ++g) {
      if (r0 + g < num_regs) R[(r0 + g) * T] = in[g];
    }
  }
  for (int e = 0; e < num_elements; ++e) {
    cp_async_wait_all();
    // Element e's records are in, and every thread is done with e - 1, whose
    // buffer element e + 1's records now overwrite while e runs.
    __syncthreads();
    stage(e + 1);
    const uint4* rec = smem4 + (e & 1) * stride;
    const uint4 head = rec[0];
    const int rows = static_cast<int>(head.x), deferred = static_cast<int>(head.y);
    const int zero_reg = static_cast<int>(head.z);
    for (int r0 = 1; r0 <= rows; r0 += kRowGroup) {
      const uint4* q = rec + r0;
      switch ((q[0].y >> 16) & 0xFu) {  // one opcode per group, the same for the whole block
        case kXorImm: run_group<kXorImm>(q, R, T); break;
        case kShrAndImm: run_group<kShrAndImm>(q, R, T); break;
        case kAdd: run_group<kAdd>(q, R, T); break;
        case kGeImm: run_group<kGeImm>(q, R, T); break;
        case kShlImm: run_group<kShlImm>(q, R, T); break;
        default: run_group<kPopcnt>(q, R, T); break;
      }
    }
    // Deferred rows, in row order: their (dst | first_write << 16) list
    // starts head.w words into the element's records, their values sit in
    // scratch slots num_regs + k.  kRowGroup entries and values are read
    // before any of them is written back.
    const uint32_t* back = reinterpret_cast<const uint32_t*>(rec) + head.w;
    for (int k0 = 0; k0 < deferred; k0 += kRowGroup) {
      uint32_t ent[kRowGroup], val[kRowGroup];
#pragma unroll
      for (int i = 0; i < kRowGroup; ++i) {
        const bool ok = k0 + i < deferred;
        ent[i] = ok ? back[k0 + i] : 0u;
        val[i] = ok ? R[(num_regs + k0 + i) * T] : 0u;
      }
#pragma unroll
      for (int i = 0; i < kRowGroup; ++i) {
        if (k0 + i < deferred) {
          uint32_t* d = R + (ent[i] & 0xFFFFu) * T;
          uint32_t x = val[i];
          if (!(ent[i] >> 16)) x += *d;
          *d = x;
        }
      }
    }
    if (zero_reg >= 0) R[zero_reg * T] = 0u;
  }
  if (live) {
    for (int r = 0; r < num_regs; ++r) regs_out[static_cast<size_t>(r) * batch + b] = R[r * T];
  }
}

}  // namespace

extern "C" int optable_run(const void* plan, const void* regs_in, void* regs_out, int num_regs,
                           int batch, int num_elements, int stride, int scratch_rows, int threads,
                           void* stream) {
  const size_t smem = 2 * static_cast<size_t>(stride) * sizeof(uint4) +
                      static_cast<size_t>(num_regs + scratch_rows) * sizeof(uint32_t) * threads;
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = allow_shared_bytes(optable_kernel, smem);
  if (rc) return rc;
  optable_kernel<<<(batch + threads - 1) / threads, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(plan), static_cast<const uint32_t*>(regs_in),
      static_cast<uint32_t*>(regs_out), num_regs, batch, num_elements, stride);
  return static_cast<int>(cudaGetLastError());
}
