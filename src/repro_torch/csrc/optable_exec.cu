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
//   (all the register-file reads in flight together), then the writes.  The
//   plan pads each run of one opcode to whole groups (lowering sorts an
//   element's rows by opcode, so the headline model needs no padding), and a
//   group branches once on its opcode, the same across the block.
// - Three routes (the wrapper's route() picks one from the plan before it
//   launches); the first two run one thread per packet:
//   * shared (optable_kernel): a block keeps its packets' register files and
//     scratch in dynamic shared memory as [slot][thread] (consecutive
//     threads, consecutive banks) and walks ALL elements in one launch, so
//     the register file crosses device memory once per program.  Each
//     element's records are staged in shared memory by cp.async,
//     double-buffered: the next element's arrive while this one runs, and
//     every thread reads a record by broadcast instead of eight global loads
//     per row.  Threads past the batch run on zeros and store nothing (they
//     take part in the barriers).  The wrapper picks the block size that
//     keeps the most packets resident on an SM.
//   * global (optable_global_kernel), for a program whose register file fits
//     neither the shared route (one packet's share of a block at 32 packets)
//     nor the split route below (a file past about 7,000 to 14,500
//     registers).  Each packet's registers and scratch live in device memory,
//     slot-major as (num_regs + scratch, batch), so the 32 packets of a warp
//     touch one 128-byte line a slot; the file stays in L2 while a chunk of
//     1024 packets runs (11 MB at 32 tenants).  Only the records are staged
//     in shared memory, double-buffered by cp.async as on the shared route,
//     but in tiles of kTile records: an element of a 128-tenant merge holds
//     7,989 records, more than two of them fit a block.  Headers and the
//     write-back list are read through the read-only cache.  Threads past
//     the batch take part in the barriers and never load or store.  Slots
//     are indexed in 64 bits (slot * batch passes 2^31 on large files).
//   Both routes run the same row groups and write-back (run_rows,
//   write_back) over a base pointer and a slot stride: this thread's column
//   of the shared block with stride blockDim.x, or of the global file with
//   stride batch.
//   On a merge of 32 tenants (1,833 registers, 32,920 rows) the global route
//   walks every row one packet a thread, so a chunk of 1024 packets is 32
//   warps on the whole card, and every row's traffic goes to L2 or device
//   memory.
// - split (optable_split_kernel), the route for such merges: a block holds
//   the register files of 4 or 8 packets in shared memory (7,332 B a packet
//   at 32 tenants, 28,324 B at 128), and spreads each element's rows over
//   its threads instead of its packets.  The wrapper's plan
//   (kernels/optable_exec.py::make_split) turns each element into chains,
//   one per register it writes: the last first write and the FOLD rows
//   after it (rows a later first write supersedes are dropped; the cut pads
//   become their last row, a first write of 0).  Each chain goes whole to
//   one thread (lane), the lanes' runs balanced by rows and sorted by
//   opcode, so a warp mostly branches alike.  Every row reads the file as
//   it stood entering the element, and nearly every row of a merge writes a
//   register some row of its element reads, so a phase has two steps:
//   every lane sums each of its chains over its rows into a value buffer in
//   shared memory (one 16-byte value per chain and group of 4 packets),
//   then, after a barrier, each chain's value is stored or added into its
//   register.  A thread reads each record once, through the read-only
//   cache, and computes it for all of its block's packets: the file is
//   [group of 4][slot] uint4, so one 16-byte load brings a slot of 4
//   packets.  Elements that the plan can run side by side share a phase
//   (two barriers a phase, not an element: the concat layout's 766 elements
//   of at most 128 rows fill 30 phases, as the interleave layout's 30 do).
//   The next phase's lane starts and write list are loaded before the
//   barrier that ends a phase.
//
// uint32 semantics match XLA's: shifts by 32 or more give 0 (the clamped
// funnel shifts), ADD wraps, GE_IMM compares unsigned, POPCNT is __popc.
// The wrapper rejects opcodes outside 0-5 and slots outside the register
// file while planning, before any launch; the records' 16-bit slot fields
// bound a file at 65,536 slots, registers and scratch together.

#include "common.cuh"

namespace {

enum : uint32_t { kXorImm = 0, kShrAndImm = 1, kAdd = 2, kGeImm = 3, kShlImm = 4, kPopcnt = 5 };
constexpr int kRowGroup = 32;  // kernels/optable_exec.py ROW_GROUP
constexpr int kTile = 1024;    // records of one element a global-route block stages at once
constexpr int kSplitWrites = 8;  // kernels/optable_exec.py SPLIT_WRITES: a phase's chains a thread


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
template <uint32_t OP, typename Index>
__device__ __forceinline__ void run_group(const uint4* __restrict__ q, uint32_t* R, Index T) {
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

// `rows` records (a multiple of kRowGroup) of one element, group by group.
template <typename Index>
__device__ __forceinline__ void run_rows(const uint4* rec, int rows, uint32_t* R, Index T) {
  for (int r0 = 0; r0 < rows; r0 += kRowGroup) {
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
}

// An element's end: its deferred rows, in row order (their dst |
// first_write << 16 list at `back`, their values in scratch slots
// num_regs + k; kRowGroup entries and values are read before any of them is
// written back), then the register its cut pads leave 0.
template <typename Index>
__device__ __forceinline__ void write_back(const uint32_t* back, int deferred, int zero_reg,
                                           int num_regs, uint32_t* R, Index T) {
  for (int k0 = 0; k0 < deferred; k0 += kRowGroup) {
    uint32_t ent[kRowGroup], val[kRowGroup];
#pragma unroll
    for (int i = 0; i < kRowGroup; ++i) {
      const bool ok = k0 + i < deferred;
      ent[i] = ok ? back[k0 + i] : 0u;
      val[i] = ok ? R[static_cast<Index>(num_regs + k0 + i) * T] : 0u;
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
  if (zero_reg >= 0) R[static_cast<Index>(zero_reg) * T] = 0u;
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
    cp_async_wait<0>();
    // Element e's records are in, and every thread is done with e - 1, whose
    // buffer element e + 1's records now overwrite while e runs.
    __syncthreads();
    stage(e + 1);
    const uint4* rec = smem4 + (e & 1) * stride;
    const uint4 head = rec[0];  // records, deferred, zero_reg, write-back list's word offset
    run_rows(rec + 1, static_cast<int>(head.x), R, T);
    write_back(reinterpret_cast<const uint32_t*>(rec) + head.w, static_cast<int>(head.y),
               static_cast<int>(head.z), num_regs, R, T);
  }
  if (live) {
    for (int r = 0; r < num_regs; ++r) regs_out[static_cast<size_t>(r) * batch + b] = R[r * T];
  }
}

// The global route: this thread's packet is column b of `file`, a
// (num_regs + scratch, batch) slot-major array in device memory that holds
// the incoming registers in its first num_regs rows and the result after.
// Each element's records are staged kTile at a time into one of two
// shared-memory tiles (step s uses tile s % 2), the next step's records in
// flight while this step's rows run.
__global__ void optable_global_kernel(const uint4* __restrict__ plan, uint32_t* __restrict__ file,
                                      int num_regs, int batch, int num_elements, int stride) {
  extern __shared__ uint4 tiles[];
  const int t = threadIdx.x;
  const long long b = static_cast<long long>(blockIdx.x) * blockDim.x + t;
  const bool live = b < batch;
  const size_t T = static_cast<size_t>(batch);
  uint32_t* R = file + (live ? b : 0);  // dereferenced only when live

  auto steps = [](int rows) { return rows > 0 ? (rows + kTile - 1) / kTile : 1; };
  // Records [k * kTile, (k + 1) * kTile) of element e's body into tile `buf`.
  auto stage = [&](int e, int k, int buf) {
    if (e < num_elements) {
      const uint4* src = plan + static_cast<size_t>(e) * stride;
      const int n = min(kTile, static_cast<int>(__ldg(&src->x)) - k * kTile);
      src += 1 + static_cast<size_t>(k) * kTile;
      uint4* dst = tiles + buf * kTile;
      for (int i = t; i < n; i += blockDim.x) cp_async16(dst + i, src + i);
    }
    cp_async_commit();
  };

  stage(0, 0, 0);
  int s = 0;
  for (int e = 0; e < num_elements; ++e) {
    const uint4* el = plan + static_cast<size_t>(e) * stride;
    const uint4 head = __ldg(el);
    const int rows = static_cast<int>(head.x);
    const int n_steps = steps(rows);
    for (int k = 0; k < n_steps; ++k, ++s) {
      cp_async_wait<0>();
      // This step's records are in, and every thread is done with the
      // previous step, whose tile the next step's records now overwrite.
      __syncthreads();
      if (k + 1 < n_steps) {
        stage(e, k + 1, (s + 1) & 1);
      } else {
        stage(e + 1, 0, (s + 1) & 1);
      }
      if (live) run_rows(tiles + (s & 1) * kTile, min(kTile, rows - k * kTile), R, T);
    }
    if (live) {
      write_back(reinterpret_cast<const uint32_t*>(el) + head.w, static_cast<int>(head.y),
                 static_cast<int>(head.z), num_regs, R, T);
    }
  }
}

template <uint32_t OP>
__device__ __forceinline__ uint4 alu4(uint4 a, uint4 b, uint32_t i0) {
  return make_uint4(alu<OP>(a.x, b.x, i0), alu<OP>(a.y, b.y, i0), alu<OP>(a.z, b.z, i0), alu<OP>(a.w, b.w, i0));
}

// One row of the split route over a group of 4 packets: the op on each
// packet's slots (src1 read only by ADD), masked.
__device__ __forceinline__ uint4 row4(const uint4* __restrict__ F, uint4 r) {
  const uint4 a = F[r.x & 0xFFFFu];
  uint4 v;
  switch ((r.y >> 16) & 0xFu) {
    case kXorImm: v = alu4<kXorImm>(a, a, r.z); break;
    case kShrAndImm: v = alu4<kShrAndImm>(a, a, r.z); break;
    case kAdd: v = alu4<kAdd>(a, F[r.x >> 16], r.z); break;
    case kGeImm: v = alu4<kGeImm>(a, a, r.z); break;
    case kShlImm: v = alu4<kShlImm>(a, a, r.z); break;
    default: v = alu4<kPopcnt>(a, a, r.z); break;
  }
  return make_uint4(v.x & r.w, v.y & r.w, v.z & r.w, v.w & r.w);
}

__device__ __forceinline__ uint4 add4(uint4 a, uint4 b) {
  return make_uint4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// What a thread needs of a phase before its rows: its lane's rows and its
// entries of the write list (chains t, t + T, ...).
struct SplitPhase {
  const uint4* rows;
  int chains, r0, r1;
  uint32_t ent[kSplitWrites];
};

__device__ __forceinline__ SplitPhase split_phase(const uint4* __restrict__ plan, int ph, int t, int T) {
  SplitPhase p;
  const uint4* at = plan + __ldg(reinterpret_cast<const uint32_t*>(plan) + ph);
  const uint4 head = __ldg(at);  // chains, rows
  p.chains = static_cast<int>(head.x);
  const uint32_t* start = reinterpret_cast<const uint32_t*>(at + 1);
  p.rows = at + 1 + (T + 1 + 3) / 4;
  p.r0 = static_cast<int>(__ldg(start + t));
  p.r1 = static_cast<int>(__ldg(start + t + 1));
  const uint32_t* write = reinterpret_cast<const uint32_t*>(p.rows + head.y);
#pragma unroll
  for (int k = 0; k < kSplitWrites; ++k) {
    const int c = t + k * T;
    p.ent[k] = c < p.chains ? __ldg(write + c) : 0u;
  }
  return p;
}

// The split route: block blockIdx.x holds packets [4Q * blockIdx.x, +4Q) as
// Q groups of 4, F = [Q][num_regs] uint4 then the value buffer V = [Q][chains]
// uint4 in dynamic shared memory.  Thread t is lane t of every phase.
// Packets past the batch run on zeros and store nothing.
template <int Q>
__global__ void __launch_bounds__(1024)
optable_split_kernel(const uint4* __restrict__ plan, const uint32_t* __restrict__ regs_in,
                     uint32_t* __restrict__ regs_out, int num_regs, int batch, int num_phases,
                     int chains) {
  extern __shared__ uint4 smem4[];
  uint4* F = smem4;
  uint4* V = smem4 + Q * num_regs;
  const int T = blockDim.x, t = threadIdx.x;
  constexpr int P = 4 * Q;
  constexpr int U = 4 / Q;  // rows a lane loads at once
  const long long b0 = static_cast<long long>(blockIdx.x) * P;
  uint32_t* Fw = reinterpret_cast<uint32_t*>(F);
  // The registers in, packets fastest (P consecutive words of one slot).
  for (int i = t; i < num_regs * P; i += T) {
    const int p = i % P, s = i / P;
    const long long b = b0 + p;
    Fw[((p >> 2) * num_regs + s) * 4 + (p & 3)] = b < batch ? regs_in[static_cast<size_t>(s) * batch + b] : 0u;
  }
  SplitPhase ph = num_phases > 0 ? split_phase(plan, 0, t, T) : SplitPhase{};
  __syncthreads();
  for (int k = 0; k < num_phases; ++k) {
    // Every value from the file as it entered the phase: each of this lane's
    // chains summed over its rows (a FOLD adds mod 2^32), into V.
    // U rows at a time: their records, then all their values (the loads in
    // flight together), then the sums in row order (a lane's long FOLD chain
    // is 32 rows, where most lanes have a few).
    uint4 cur[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) cur[q] = make_uint4(0u, 0u, 0u, 0u);
    for (int i = ph.r0; i < ph.r1; i += U) {
      uint4 r[U], v[U][Q];
#pragma unroll
      for (int u = 0; u < U; ++u) r[u] = i + u < ph.r1 ? __ldg(ph.rows + i + u) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int q = 0; q < Q; ++q) v[u][q] = row4(F + q * num_regs, r[u]);  // a zero record gives 0
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int q = 0; q < Q; ++q) cur[q] = add4(cur[q], v[u][q]);
        if ((r[u].y >> 20) & 1u) {  // the chain's last row
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            V[q * chains + (r[u].y & 0xFFFFu)] = cur[q];
            cur[q] = make_uint4(0u, 0u, 0u, 0u);
          }
        }
      }
    }
    __syncthreads();
    // Then each chain's value into its register: stored by a first write,
    // else added to what the register held.
#pragma unroll
    for (int j = 0; j < kSplitWrites; ++j) {
      const int c = t + j * T;
      if (c < ph.chains) {
        const uint32_t d = ph.ent[j] & 0xFFFFu;
        const bool store = (ph.ent[j] >> 16) & 1u;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const uint4 v = V[q * chains + c];
          F[q * num_regs + d] = store ? v : add4(v, F[q * num_regs + d]);
        }
      }
    }
    if (k + 1 < num_phases) ph = split_phase(plan, k + 1, t, T);
    __syncthreads();
  }
  for (int i = t; i < num_regs * P; i += T) {
    const int p = i % P, s = i / P;
    const long long b = b0 + p;
    if (b < batch) regs_out[static_cast<size_t>(s) * batch + b] = Fw[((p >> 2) * num_regs + s) * 4 + (p & 3)];
  }
}

}  // namespace

extern "C" int optable_run_split(const void* plan, const void* regs_in, void* regs_out, int num_regs,
                                 int batch, int num_phases, int chains, int packets, int threads,
                                 void* stream) {
  if (batch <= 0 || threads < 32 || threads > 1024 || (packets != 4 && packets != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(packets) * 4 * (static_cast<size_t>(num_regs) + chains);
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(batch) + packets - 1) / packets);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint4*>(plan);
  const auto* in = static_cast<const uint32_t*>(regs_in);
  auto* out = static_cast<uint32_t*>(regs_out);
  int rc;
  if (packets == 8) {
    rc = allow_shared_bytes(optable_split_kernel<2>, smem);
    if (rc) return rc;
    optable_split_kernel<2><<<blocks, threads, smem, s>>>(p, in, out, num_regs, batch, num_phases, chains);
  } else {
    rc = allow_shared_bytes(optable_split_kernel<1>, smem);
    if (rc) return rc;
    optable_split_kernel<1><<<blocks, threads, smem, s>>>(p, in, out, num_regs, batch, num_phases, chains);
  }
  return static_cast<int>(cudaGetLastError());
}

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

extern "C" int optable_run_global(const void* plan, void* file, int num_regs, int batch,
                                  int num_elements, int stride, int threads, void* stream) {
  if (batch <= 0 || threads <= 0 || threads > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(kTile) * sizeof(uint4);
  const int rc = allow_shared_bytes(optable_global_kernel, smem);
  if (rc) return rc;
  optable_global_kernel<<<(batch + threads - 1) / threads, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(plan), static_cast<uint32_t*>(file), num_regs, batch, num_elements,
      stride);
  return static_cast<int>(cudaGetLastError());
}
