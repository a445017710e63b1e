"""Batched executor for lowered pipeline programs, on PyTorch tensors.

Runs a :class:`~repro_torch.dataplane.lowering.LoweredProgram` over
``(num_regs, batch)`` register files: parse the packet bits into registers,
run the op-table, deparse the output registers back into bits.  Bit-exact
with ``core.interpreter.run_program`` by construction: same read-before-write
element semantics, same width masking.

Backends (the reference's strings):

* ``"auto"``, ``"jnp"``, ``"fused"`` and ``"pallas"`` — the **op-table**
  path: the ``kernels.optable_exec`` ALU walks every element in one launch.
* ``"packed"`` — the bit-packed path: per layer, pack the incoming bits into
  uint32 words (``kernels.bitpack``) and run the XNOR-popcount-threshold
  layer (``kernels.packed_layer``).  Requires a ``LoweredProgram.packed``
  plan (compiler-built programs have one); operates on whole packets, so it
  has no ``run_hop`` form.

The backend picks the algorithm, never the implementation: the tensors'
device does.  On a CUDA device every kernel wrapper launches its kernel or
raises; on the CPU it runs the kernel's plain PyTorch version.

Register files and tables hold uint32 values as int32 bit views (see
``core.bitops``), so the kernels read them as they are.

Routed dispatch (:func:`routed_fn`, :func:`routed_packed_fn`,
:func:`routed_packed_stacked_fn`) runs a merged multi-tenant program over a
mixed stream whose packets each carry a tenant (program) id: the serving
path of ``dataplane.multitenant.SwitchScheduler``.

Streaming (:func:`execute_stream`) re-chunks any packet iterator into
fixed-size blocks so millions of packets run at constant device memory.  The
stream path is instrumented through ``repro_torch.obs`` (packets/chunk
counters, chunk-latency histogram, ``compile:``/``execute:`` spans, and the
``roofline.*`` gauges of the dispatch's bound) — all no-ops unless the
global observability switch is on.

Invariants:

* **Bit-exactness** — every backend, chunking, and streaming path returns
  exactly what ``core.interpreter.run_program`` (and hence the
  ``core.bnn.forward`` oracle) returns for the same program and packets.
* **One ALU table** — the plain op-table path evaluates opcodes through
  :func:`alu_variants`; a new dense opcode is added there and in the CUDA
  kernel's ``alu`` or nowhere.
* **Register file == PHV** — the ``(num_regs, batch)`` file produced by
  :func:`parse_packets` is the packet state on the wire; :func:`run_hop`
  threads it unchanged in meaning and :func:`deparse_regs` only reads it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import bitops
from repro_torch.dataplane import lowering
from repro_torch.dataplane.lowering import LoweredProgram
from repro_torch.dataplane.plan import Backend
from repro_torch.device import resolve_device
from repro_torch.kernels.bitpack import pack_bits_words
from repro_torch.kernels.optable_exec import optable_run, optable_run_segmented
from repro_torch.kernels.optable_exec import prepare as prepare_optable
from repro_torch.kernels.packed_layer import _check_routed_args, _routed, packed_layer

DEFAULT_CHUNK = 1 << 15  # 32768 packets per device dispatch

def resolve_backend(backend="auto") -> str:
    """Normalize a backend choice: ``"jnp"`` (the op-table path, whatever
    alias named it) or ``"packed"``.

    Accepts whatever :meth:`repro_torch.dataplane.plan.Backend.coerce` does:
    the reference's strings and :class:`~repro_torch.dataplane.plan.Backend`
    members alike (``Backend.PALLAS`` is the op-table path, as ``"pallas"``
    is).  ``Backend.INTERPRETER`` is a reference path, reached only through
    ``plan.run``.
    """
    backend = Backend.coerce(backend)
    if backend is Backend.INTERPRETER:
        raise ValueError(
            "the interpreter backend is a reference path, not an executor: "
            "reach it through repro_torch.dataplane.plan.run(program, packets, "
            "plan=ExecutionPlan(backend=Backend.INTERPRETER))"
        )
    return "packed" if backend is Backend.PACKED else "jnp"


def _i32(a: np.ndarray) -> torch.Tensor:
    """A numpy int32/uint32 table as an int32 (bit view) CPU tensor."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


# ---------------------------------------------------------------------------
# Device-side tables (moved once per program and device, keyed on content)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _DeviceTables:
    """Everything the hot loop needs, uploaded/derived once per program."""

    ops: tuple          # 7 (num_elements, max_rows) int32 tensors
    first_write: torch.Tensor
    io: tuple           # in_slot, in_shift, out_slot, out_shift
    runs: tuple         # (start, stop, used) opcode-homogeneous runs


_TABLE_CACHE: dict[tuple[str, str], _DeviceTables] = {}


def _device_tables(lp: LoweredProgram, device: torch.device) -> _DeviceTables:
    key = (lp.fingerprint(), str(device))
    t = _TABLE_CACHE.get(key)
    if obs.enabled():
        obs.registry().counter(
            "dataplane.table_cache_hits_total"
            if t is not None
            else "dataplane.table_cache_misses_total"
        ).inc()
    if t is None:
        ops = (lp.opcode, lp.dst, lp.src0, lp.src1, lp.imm0, lp.imm1, lp.mask)
        t = _DeviceTables(
            ops=tuple(_i32(a).to(device) for a in ops),
            first_write=_i32(lp.first_write).to(device),
            io=(
                torch.from_numpy(lp.in_slot_per_bit.astype(np.int64)).to(device),
                torch.from_numpy(lp.in_shift_per_bit.astype(np.int64)).to(device),
                torch.from_numpy(lp.out_slot_per_bit.astype(np.int64)).to(device),
                _i32(lp.out_shift_per_bit).to(device),
            ),
            runs=lp.opcode_runs(),
        )
        if t.first_write.device.type == "cuda":  # the kernel's plan, made from the host copy
            prepare_optable((*t.ops, t.first_write), lp.num_regs, (*ops, lp.first_write))
        _TABLE_CACHE[key] = t
    return t


# ---------------------------------------------------------------------------
# Bit-packed PHV path (the "packed" backend)
# ---------------------------------------------------------------------------

def _no_packed_plan() -> ValueError:
    return ValueError(
        "program has no bit-packed plan (LoweredProgram.packed is None "
        "for hand-assembled tables and element slices); use the "
        "op-table backends"
    )


def _trivial_layout(pl: lowering.PackedLayer) -> bool:
    bit = np.arange(pl.n_in)
    return bool(
        np.array_equal(pl.in_word, bit // 32) and np.array_equal(pl.in_shift, bit % 32)
    )


def _scatter_words(
    h: torch.Tensor, in_word: torch.Tensor, in_shift: torch.Tensor, n_words: int
) -> torch.Tensor:
    """Bits (batch, n_in) -> (batch, n_words) words through an arbitrary
    word layout (one-hot scatter-add; the layout's bits are disjoint)."""
    words = torch.zeros((h.shape[0], n_words), dtype=torch.int64, device=h.device)
    words.index_add_(1, in_word, h.to(torch.int64) << in_shift)
    return bitops.u32_to_i32(words)


_PACKED_CACHE: dict[tuple[str, str], Callable] = {}


def _packed_fn(lp: LoweredProgram, device: torch.device) -> Callable:
    """``lp.packed`` as a (batch, input_bits) int32 {0,1} -> (batch,
    output_bits) int32 function on ``device``, cached per program and device.

    Per layer: pack the incoming bits into ``n_words`` uint32 lanes
    (``pack_bits_words`` when the layer has the trivial contiguous layout,
    which every compiler-built layer has; a scatter-add otherwise), then one
    ``packed_layer`` launch counts agreements and applies the thresholds.
    """
    key = (lp.fingerprint(), str(device))
    fn = _PACKED_CACHE.get(key)
    if fn is not None:
        return fn
    pp = lp.packed
    if pp is None:
        raise _no_packed_plan()
    layers = []
    for pl in pp.layers:
        layers.append((
            _i32(pl.weights).to(device),
            _i32(pl.thresholds).to(device),
            _i32(pl.mask).to(device),
            torch.from_numpy(pl.in_word.astype(np.int64)).to(device),
            torch.from_numpy(pl.in_shift.astype(np.int64)).to(device),
            pl.n_words,
            _trivial_layout(pl),
        ))

    def run(packets: torch.Tensor) -> torch.Tensor:
        h = packets
        for w, thr, mask, in_word, in_shift, n_words, trivial in layers:
            if trivial:
                words = pack_bits_words(h)
            else:
                words = _scatter_words(h, in_word, in_shift, n_words)
            h = packed_layer(words, w, mask, thr)
        return h

    _PACKED_CACHE[key] = run
    return run


_PACKED_SCAN_CACHE: dict[tuple[str, str], Callable] = {}


def _packed_scan_fn(lp: LoweredProgram, device: torch.device) -> Callable:
    """Scan-over-layers variant of the packed executor.

    Layers are padded to common shapes and stacked
    (``lowering.stack_packed_layers``), and one loop body runs every layer
    over a carried ``max_bits``-wide bit vector.  Bit-exact with
    :func:`_packed_fn` because padding is inert by construction: pad
    neurons have zero masks and the unreachable threshold ``0xFFFFFFFF``,
    so carried bits past a layer's true width are 0.
    """
    key = (lp.fingerprint(), str(device))
    fn = _PACKED_SCAN_CACHE.get(key)
    if fn is not None:
        return fn
    if lp.packed is None:
        raise _no_packed_plan()
    sp = lowering.stack_packed_layers(lp.packed)
    weights = _i32(sp.weights).to(device)
    thresholds = _i32(sp.thresholds).to(device)
    mask = _i32(sp.mask).to(device)
    in_word = torch.from_numpy(sp.in_word.astype(np.int64)).to(device)
    in_shift = torch.from_numpy(sp.in_shift.astype(np.int64)).to(device)
    # Carried bits past each layer's true width are 0, so contiguous packing
    # equals the stacked scatter whenever every true layout is contiguous.
    trivial = all(_trivial_layout(pl) for pl in lp.packed.layers)
    max_bits, max_words, out_bits = sp.max_bits, sp.max_words, sp.output_bits

    def run(packets: torch.Tensor) -> torch.Tensor:
        h = torch.nn.functional.pad(packets, (0, max_bits - packets.shape[1]))
        for li in range(sp.num_layers):
            if trivial:
                words = pack_bits_words(h)[:, :max_words].contiguous()
            else:
                words = _scatter_words(h, in_word[li], in_shift[li], max_words)
            nxt = packed_layer(words, weights[li], mask[li], thresholds[li])
            h = torch.nn.functional.pad(nxt, (0, max_bits - nxt.shape[1]))
        return h[:, :out_bits].contiguous()

    _PACKED_SCAN_CACHE[key] = run
    return run


# ---------------------------------------------------------------------------
# Parser / ALU / deparser (op-table backend)
# ---------------------------------------------------------------------------

def parse_packets(
    packets: torch.Tensor, in_slot: torch.Tensor, in_shift: torch.Tensor, *, num_regs: int
) -> torch.Tensor:
    """(batch, input_bits) {0,1} -> (num_regs, batch) int32 register files.

    The register file is transposed — registers on the leading axis — so
    each register is one contiguous row of packets, the layout the
    op-table kernel stages into shared memory.
    """
    pkt = packets.T.to(torch.int64)  # (input_bits, batch)
    regs = torch.zeros((num_regs, packets.shape[0]), dtype=torch.int64, device=packets.device)
    regs.index_add_(0, in_slot, pkt << in_shift[:, None])
    return bitops.u32_to_i32(regs)


def deparse_regs(
    regs: torch.Tensor, out_slot: torch.Tensor, out_shift: torch.Tensor
) -> torch.Tensor:
    """(num_regs, batch) -> (batch, output_bits) {0,1} int32."""
    words = regs.index_select(0, out_slot)  # (output_bits, batch)
    # Shifts are < 32, so the int32 view's arithmetic shift keeps bit k intact.
    return ((words >> out_shift[:, None]) & 1).T.contiguous()


def parse_packets_routed(
    packets: torch.Tensor,
    program_ids: torch.Tensor,
    slot_table: torch.Tensor,
    shift_table: torch.Tensor,
    valid_table: torch.Tensor,
    *,
    num_regs: int,
) -> torch.Tensor:
    """Per-packet-program parser for a shared register file.

    ``packets``: (batch, max_bits) {0,1}; ``program_ids``: (batch,) integer
    ids selecting each packet's row of the ``(num_programs, max_bits)``
    integer parser tables.  Bits whose ``valid_table`` entry is 0 (width
    padding for narrower programs) land harmlessly in the null slot with
    value 0.  Returns the (num_regs, batch) int32 register files.  The
    merged dispatch (:func:`routed_fn`) parses through the inverse gather
    tables instead; this scatter is their definition.
    """
    pid = program_ids.long()
    slots = slot_table.long()[pid]                      # (batch, max_bits)
    shifts = shift_table.long()[pid]
    vals = bitops.shl(packets.long() & valid_table.long()[pid], shifts)
    regs = torch.zeros((num_regs, packets.shape[0]), dtype=torch.int64, device=packets.device)
    cols = torch.arange(packets.shape[0], device=packets.device)[:, None].expand_as(slots)
    regs.index_put_((slots, cols), vals, accumulate=True)
    return bitops.u32_to_i32(regs)


def deparse_regs_routed(
    regs: torch.Tensor,
    program_ids: torch.Tensor,
    out_slot_table: torch.Tensor,
    out_shift_table: torch.Tensor,
) -> torch.Tensor:
    """(num_regs, batch) -> (batch, max_out_bits) {0,1} int32, reading each
    packet's bits through its own program's deparser table.  Width-padding
    entries point at the null register and deparse as 0."""
    pid = program_ids.long()
    slots = out_slot_table.long()[pid]                  # (batch, bits)
    shifts = out_shift_table.long()[pid]
    cols = torch.arange(regs.shape[1], device=regs.device)[:, None]
    words = bitops.i32_to_u32(regs[slots, cols])
    return (bitops.shr(words, shifts) & 1).to(torch.int32)


def route_bits_in(
    packets: torch.Tensor,
    program_ids: torch.Tensor,
    bit_table: torch.Tensor,
    valid_table: torch.Tensor,
    *,
    total_bits: int,
) -> torch.Tensor:
    """Dense-bit analogue of :func:`parse_packets_routed` for the packed
    backend: scatter each packet's bits to its program's window of a
    ``(batch, total_bits)`` merged input-bit vector ({0,1} int32).

    ``bit_table``/``valid_table`` are ``(num_programs, max_bits)``; invalid
    (width-padding) entries carry index 0 and valid 0, so they add nothing.
    """
    pid = program_ids.long()
    out = torch.zeros((packets.shape[0], total_bits), dtype=torch.int64, device=packets.device)
    out.scatter_add_(1, bit_table.long()[pid], packets.long() & valid_table.long()[pid])
    return out.to(torch.int32)


def route_bits_out(
    bits: torch.Tensor, program_ids: torch.Tensor, bit_table: torch.Tensor
) -> torch.Tensor:
    """Gather each packet's output bits back out of a merged dense bit
    vector through its program's ``(num_programs, max_out_bits)`` routing
    table.  Width-padding entries gather bit 0; callers slice them off per
    tenant just as with :func:`deparse_regs_routed`."""
    idx = bit_table.long()[program_ids.long()]          # (batch, max_out)
    return torch.gather(bits, 1, idx).to(torch.int32)


def alu_variants(r0, r1, i0, i1, used: tuple) -> list:
    """The dense-opcode ALU on uint32 carriers: ``[(code, value), ...]`` for
    the opcodes in ``used``.  The plain op-table path computes from this
    table; the CUDA kernel's ``alu`` mirrors it line for line."""
    table = (
        (lowering.XOR_IMM, lambda: r0 ^ i0),
        (lowering.SHR_AND_IMM, lambda: bitops.shr(r0, i0) & i1),
        (lowering.ADD, lambda: bitops.add(r0, r1)),
        (lowering.GE_IMM, lambda: bitops.ge(r0, i0)),
        (lowering.SHL_IMM, lambda: bitops.shl(r0, i0)),
        (lowering.POPCNT, lambda: bitops.hakmem_popcount(r0)),
    )
    return [(code, expr()) for code, expr in table if code in used]


def run_elements(regs: torch.Tensor, tables: tuple, first_write: torch.Tensor) -> torch.Tensor:
    """Run an op-table (or an element slice of one) over the register file:
    ``tables`` are the 7 (elements, rows) tables of ``_DeviceTables.ops``."""
    return optable_run(regs, *tables, first_write)


def run_hop(lowered: LoweredProgram, regs: torch.Tensor, *, backend: str = "jnp") -> torch.Tensor:
    """Run one program (or fabric-hop slice) over parsed register files.

    The (num_regs, batch) register file in/out *is* the PHV on the wire.
    """
    if resolve_backend(backend) == "packed":
        raise ValueError(
            "the packed backend consumes whole packets (execute / "
            "execute_stream), not register-file hops"
        )
    t = _device_tables(lowered, regs.device)
    return optable_run_segmented(regs, *t.ops, t.first_write, runs=t.runs)


_HOP_TABLES = ("opcode", "dst", "src0", "src1", "imm0", "imm1", "mask", "first_write")
_STACKED_CACHE: dict[tuple[str, str], tuple] = {}


def _stacked_tables(stacked: lowering.StackedHops, device: torch.device) -> tuple:
    """Each hop's 8 tables of ``stacked`` as tensors on ``device``, made once
    per chain and device.  The kernel's plans are cached by table tensor, so
    the same tensors serve every chunk (a fresh view a chunk would plan
    every hop again); on a CUDA device they are planned here, from the host
    copies."""
    key = (stacked.fingerprint, str(device))
    hops = _STACKED_CACHE.get(key)
    if hops is None:
        hops = []
        for h in range(stacked.num_hops):
            host = tuple(np.ascontiguousarray(getattr(stacked, name)[h]) for name in _HOP_TABLES)
            tables = tuple(_i32(a).to(device) for a in host)
            if device.type == "cuda":
                prepare_optable(tables, stacked.num_regs, host)
            hops.append(tables)
        hops = _STACKED_CACHE[key] = tuple(hops)
    return hops


def run_hops_scanned(
    stacked: lowering.StackedHops, regs: torch.Tensor, *, backend: str = "jnp"
) -> torch.Tensor:
    """Run a :class:`~repro_torch.dataplane.lowering.StackedHops` chain over
    parsed register files, hop after hop.

    The reference scans one ``optable_run`` over the hop axis; here each hop
    is one ``optable_run`` over its padded plane of the stack, which is that
    scan unrolled, so bit-exact with it and with :func:`run_hop` per hop
    slice (pad elements write 0 into the null register, which stays 0).
    """
    if resolve_backend(backend) == "packed":
        raise ValueError(
            "the packed backend scans layers, not register-file hops "
            "(see execute(..., scan_hops=True))"
        )
    if regs.shape[0] != stacked.num_regs:
        raise ValueError(f"register file has {regs.shape[0]} registers, the hops {stacked.num_regs}")
    for tables in _stacked_tables(stacked, regs.device):
        regs = optable_run(regs, *tables)
    return regs


# ---------------------------------------------------------------------------
# Fused routed dispatch (merged multi-tenant programs)
# ---------------------------------------------------------------------------

_ROUTED_CACHE: dict[tuple, Callable] = {}


def _routing_key(*tables: np.ndarray) -> int:
    """Content hash of per-tenant routing tables.

    Merged-program fingerprints are insertion-order canonical (so the table
    caches dedupe permuted tenant sets), but the tenant-id-indexed routing
    tables are NOT order-invariant — two schedulers admitting the same
    programs in different orders share op-tables yet route differently.  The
    routed caches therefore key on fingerprint *plus* routing content (and
    the device, as every table cache here does).
    """
    return hash(tuple(np.asarray(t).tobytes() for t in tables))


def _invert_bit_routing(bit_table, valid_table, total_bits: int):
    """Forward scatter tables -> inverse gather tables.

    The routing is a bijection from each program's valid packet columns
    onto its disjoint window, so it inverts exactly: for every dense
    position, which packet column feeds it (``src``) and whether it is fed
    at all (``ok``).  The fused dispatch then needs only gathers, with no
    scatter-add into a per-chunk buffer.
    """
    bt = np.asarray(bit_table)
    vt = np.asarray(valid_table).astype(bool)
    src = np.zeros((bt.shape[0], total_bits), np.int32)
    ok = np.zeros((bt.shape[0], total_bits), np.uint32)
    for p in range(bt.shape[0]):
        cols = np.nonzero(vt[p])[0]
        src[p, bt[p, cols]] = cols
        ok[p, bt[p, cols]] = 1
    return src, ok


def _invert_parse_routing(slot_table, shift_table, valid_table):
    """Register-file analogue of :func:`_invert_bit_routing`.

    Each program maps its valid packet columns onto distinct
    ``(slot, shift)`` pairs; only a handful of slots (the input registers)
    ever receive parser bits.  Returns ``(slots, col, ok)`` where ``slots``
    is that receiving set and ``col``/``ok`` are ``(programs, len(slots),
    32)`` gather tables: word ``s`` of a packet's register file is the
    OR over ``k`` of ``packet[col[p, s, k]] << k``.
    """
    st = np.asarray(slot_table)
    sh = np.asarray(shift_table)
    vt = np.asarray(valid_table).astype(bool)
    num_programs = st.shape[0]
    slots = np.unique(st[vt]) if vt.any() else np.zeros(1, np.int64)
    index_of = {int(s): i for i, s in enumerate(slots)}
    col = np.zeros((num_programs, len(slots), 32), np.int32)
    ok = np.zeros((num_programs, len(slots), 32), np.uint32)
    for p in range(num_programs):
        for c in np.nonzero(vt[p])[0]:
            col[p, index_of[int(st[p, c])], int(sh[p, c])] = c
            ok[p, index_of[int(st[p, c])], int(sh[p, c])] = 1
    return slots.astype(np.int32), col, ok


def _index(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy table as an int64 tensor on ``device`` (gather indices)."""
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)


def routed_fn(
    lp: LoweredProgram,
    in_slot: np.ndarray,
    in_shift: np.ndarray,
    in_valid: np.ndarray,
    out_slot: np.ndarray,
    out_shift: np.ndarray,
    *,
    backend: str = "jnp",
    device="cuda",
) -> Callable:
    """Merged dispatch on ``device``: routed parse -> the op-table over the
    shared register file -> routed deparse, as one ``(packets, program_ids)
    -> (batch, max_out_bits)`` function.

    The parse gathers through the inverse tables
    (:func:`_invert_parse_routing`), the program runs as one
    ``optable_run`` launch (``optable_run_segmented`` over the merged
    plan), and the register file never leaves the device between phases.
    Cached per (program fingerprint, device, routing content).
    """
    if resolve_backend(backend) == "packed":
        raise ValueError(
            "the packed backend routes dense bits, not register files; use "
            "routed_packed_fn"
        )
    device = resolve_device(device)
    key = (
        lp.fingerprint(), str(device),
        _routing_key(in_slot, in_shift, in_valid, out_slot, out_shift),
    )
    fn = _ROUTED_CACHE.get(key)
    if fn is not None:
        return fn
    t = _device_tables(lp, device)
    reg_slots, parse_col, parse_ok = _invert_parse_routing(in_slot, in_shift, in_valid)
    n_slots = len(reg_slots)
    d_reg_slots = _index(reg_slots, device)
    d_col = _index(parse_col.reshape(parse_col.shape[0], -1), device)
    d_ok = torch.from_numpy(parse_ok.reshape(parse_ok.shape[0], -1).astype(np.int32)).to(device)
    d_out_slot = _index(out_slot, device)
    d_out_shift = _index(out_shift, device)
    shifts = torch.arange(32, dtype=torch.int64, device=device)
    num_regs = lp.num_regs

    def fn(packets: torch.Tensor, program_ids: torch.Tensor) -> torch.Tensor:
        pid = program_ids.long()  # once a chunk: every gather below indexes with it
        batch = packets.shape[0]
        bits = packets.gather(1, d_col[pid]) & d_ok[pid]    # (batch, slots * 32)
        words = bitops.shl(bits.long().view(batch, n_slots, 32), shifts).sum(2)
        regs = torch.zeros((num_regs, batch), dtype=torch.int32, device=packets.device)
        regs[d_reg_slots] = bitops.u32_to_i32(words.T)
        regs = optable_run_segmented(regs, *t.ops, t.first_write, runs=t.runs)
        return deparse_regs_routed(regs, pid, d_out_slot, d_out_shift)

    _ROUTED_CACHE[key] = fn
    return fn


def routed_packed_fn(
    lp: LoweredProgram,
    packed_in_bit: np.ndarray,
    packed_out_bit: np.ndarray,
    in_valid: np.ndarray,
    *,
    device="cuda",
) -> Callable:
    """Packed-backend twin of :func:`routed_fn`: route dense bits into the
    merged packed program's input window, run the block-diagonal XNOR/popcnt
    chain (:func:`_packed_fn`: ``pack_bits_words`` or a scatter into words,
    then ``packed_layer``, per layer), and gather each packet's bits back
    out."""
    pp = lp.packed
    if pp is None:
        raise ValueError(
            "merged program has no packed plan; every tenant must carry one "
            "(compiler-built programs do)"
        )
    device = resolve_device(device)
    key = (
        lp.fingerprint(), "packed", str(device),
        _routing_key(packed_in_bit, in_valid, packed_out_bit),
    )
    fn = _ROUTED_CACHE.get(key)
    if fn is not None:
        return fn
    inner = _packed_fn(lp, device)
    src_tbl, ok_tbl = _invert_bit_routing(packed_in_bit, in_valid, pp.input_bits)
    d_src = _index(src_tbl, device)
    d_ok = torch.from_numpy(ok_tbl.astype(np.int32)).to(device)
    d_out = _index(packed_out_bit, device)

    def fn(packets: torch.Tensor, program_ids: torch.Tensor) -> torch.Tensor:
        pid = program_ids.long()
        dense = packets.gather(1, d_src[pid]) & d_ok[pid]
        return route_bits_out(inner(dense), pid, d_out)

    _ROUTED_CACHE[key] = fn
    return fn


_ROUTED_STACK_CACHE: dict[tuple, Callable] = {}


def stack_tenant_layers(lowereds) -> list[tuple] | None:
    """Each merged layer of :func:`routed_packed_stacked_fn` as numpy
    ``(weights, thresholds, mask, n_words)``: tables of shape (T, max_n,
    max_w) and (T, max_n), every tenant's layer padded to the widest block
    with never-firing neurons, shallower tenants depth-padded with
    identity layers.  ``None`` when a tenant has no packed plan or a layer
    whose bits are not laid out contiguously."""
    packs = [lp.packed for lp in lowereds]
    if any(pp is None for pp in packs):
        return None
    depth = max(len(pp.layers) for pp in packs)
    columns = []
    for pp in packs:
        ls = list(pp.layers)
        while len(ls) < depth:
            ls.append(lowering.PackedLayer.identity(ls[-1].n_out))
        if not all(_trivial_layout(pl) for pl in ls):
            return None
        columns.append(ls)
    stacked = []
    for layer_idx in range(depth):
        pls = [c[layer_idx] for c in columns]
        max_n = max(pl.n_out for pl in pls)
        max_w = max(pl.n_words for pl in pls)
        w = np.zeros((len(pls), max_n, max_w), np.uint32)
        m = np.zeros((len(pls), max_n, max_w), np.uint32)
        # Pad neurons can never fire: agreement tops out at 32 * words.
        thr = np.full((len(pls), max_n), 0xFFFFFFFF, np.uint32)
        for t, pl in enumerate(pls):
            w[t, : pl.n_out, : pl.n_words] = pl.weights
            m[t, : pl.n_out, : pl.n_words] = pl.mask
            thr[t, : pl.n_out] = pl.thresholds
        stacked.append((w, thr, m, max_w))
    return stacked


def routed_packed_stacked_fn(lowereds: tuple, *, device="cuda") -> Callable | None:
    """Widest-tenant packed dispatch for an interleaved merge.

    The block-diagonal merged packed program (``routed_packed_fn``) makes
    every packet XNOR against every tenant's words — per-chunk work scales
    with the *sum* of tenant widths.  Here each tenant's packed layers are
    instead stacked along a leading tenant axis, padded to the widest
    block per stage (pad neurons carry unreachable thresholds, so they
    emit 0), and each packet reads its own tenant's weight block by
    ``program_id`` (the ``packed_layer_routed`` kernel) — per-chunk work
    scales with the *widest/deepest* tenant per stage.  Inputs and outputs
    stay tenant-local (bit ``i`` of tenant ``t`` lives at position ``i``
    for every tenant), so no bit routing is needed at either end.

    Returns ``None`` when any tenant lacks a packed plan or uses a
    non-trivial word layout (hand-assembled programs) — callers fall back
    to the block-diagonal merged plan.  Cached per tenant fingerprints and
    device.

    The function's ``program_ids`` must lie in ``[0, len(lowereds))``: the
    caller checks them on the host before it uploads them, as
    ``SwitchScheduler`` does for every chunk, so a dispatch on the card
    reads nothing back from the device (``packed_layer._routed``; an id
    outside the range gives 0 bits there, and raises on the CPU).
    """
    device = resolve_device(device)
    key = (tuple(lp.fingerprint() for lp in lowereds), str(device))
    fn = _ROUTED_STACK_CACHE.get(key)
    if fn is not None:
        return fn
    host = stack_tenant_layers(lowereds)
    if host is None:
        return None
    stacked = [(_i32(w).to(device), _i32(thr).to(device), _i32(m).to(device), max_w)
               for w, thr, m, max_w in host]

    def fn(packets: torch.Tensor, program_ids: torch.Tensor) -> torch.Tensor:
        ids = program_ids.to(torch.int32)  # the kernel's ids; a no-op for the scheduler's
        h = packets                        # (batch, bits) {0,1}, tenant-local
        for w_tbl, thr_tbl, m_tbl, n_words in stacked:
            need = n_words * 32
            if h.shape[1] < need:
                h = torch.nn.functional.pad(h, (0, need - h.shape[1]))
            else:
                h = h[:, :need]
            words = pack_bits_words(h)
            _check_routed_args(words, ids, w_tbl, m_tbl, thr_tbl)
            h = _routed(words, ids, w_tbl, m_tbl, thr_tbl)
        return h

    _ROUTED_STACK_CACHE[key] = fn
    return fn


def _run_chunk(
    lp: LoweredProgram, packets: torch.Tensor, backend: str, scan_hops: bool = False
) -> torch.Tensor:
    if backend == "packed":
        fn = _packed_scan_fn(lp, packets.device) if scan_hops else _packed_fn(lp, packets.device)
        return fn(packets)
    t = _device_tables(lp, packets.device)
    in_slot, in_shift, out_slot, out_shift = t.io
    regs = parse_packets(packets, in_slot, in_shift, num_regs=lp.num_regs)
    regs = run_hop(lp, regs, backend=backend)
    return deparse_regs(regs, out_slot, out_shift)


def _to_device(block: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(block, dtype=np.int32)).to(device)


# ---------------------------------------------------------------------------
# Public batch / streaming API
# ---------------------------------------------------------------------------

def execute(
    lowered: LoweredProgram,
    packets,
    *,
    backend: str = "auto",
    chunk_size: int | None = None,
    scan_hops: bool = False,
    device="cuda",
) -> np.ndarray:
    """Run ``packets`` (N, input_bits) {0,1} through the program on ``device``.

    Returns (N, output_bits) int32 numpy, bit-exact with
    ``interpreter.run_program``.  Batches larger than ``chunk_size`` stream
    in fixed-size chunks (constant device memory).  ``scan_hops=True`` runs
    the packed backend's scan-over-layers plan (``_packed_scan_fn``)
    instead of the unrolled layer loop; the op-table backend ignores it.
    """
    packets = np.asarray(packets)
    if packets.ndim != 2 or packets.shape[1] != lowered.input_bits:
        raise ValueError(
            f"expected (batch, {lowered.input_bits}) packet bits, "
            f"got {packets.shape}"
        )
    backend = resolve_backend(backend)
    device = resolve_device(device)
    n = packets.shape[0]
    chunk = chunk_size or DEFAULT_CHUNK
    out = np.empty((n, lowered.output_bits), np.int32)
    for start in range(0, n, chunk):
        block = _to_device(packets[start : start + chunk], device)
        out[start : start + chunk] = _run_chunk(lowered, block, backend, scan_hops).cpu().numpy()
    return out


@dataclasses.dataclass
class StreamResult:
    """Outcome of a streamed run — the simulator's line-rate measurement."""

    packets: int
    chunks: int
    seconds: float
    bit_counts: np.ndarray            # (output_bits,) int64: ones per Y bit
    outputs: np.ndarray | None = None  # (packets, output_bits) uint8 if collected
    warmup_seconds: float = 0.0        # first-chunk warm call (incl. kernel build)

    @property
    def packets_per_second(self) -> float:
        return self.packets / self.seconds if self.seconds > 0 else float("inf")


def _rechunk(chunks: Iterable[np.ndarray], chunk_size: int) -> Iterator[np.ndarray]:
    """Re-slice an arbitrary chunk stream into exactly-``chunk_size`` blocks
    (last block may be short)."""
    buf: list[np.ndarray] = []
    have = 0
    for c in chunks:
        c = np.asarray(c)
        while c.shape[0]:
            take = min(chunk_size - have, c.shape[0])
            buf.append(c[:take])
            have += take
            c = c[take:]
            if have == chunk_size:
                yield np.concatenate(buf, axis=0) if len(buf) > 1 else buf[0]
                buf, have = [], 0
    if have:
        yield np.concatenate(buf, axis=0) if len(buf) > 1 else buf[0]


def _probe_roofline(lowered, backend, chunk, scan_hops):
    """Fail-soft ``roofline.dataplane`` probe of the dispatch — obs-only
    bookkeeping, never allowed to affect an execution path."""
    try:
        from repro_torch.roofline import dataplane as _roofline_dp

        return _roofline_dp.probe_stream(lowered, backend=backend, chunk=chunk, scan_hops=scan_hops)
    except Exception:  # noqa: BLE001 - observation must not break runs
        return None


def _record_roofline(roofline, measured_pps):
    """Fail-soft gauge publication for a probe (see ``_probe_roofline``)."""
    try:
        from repro_torch.roofline import dataplane as _roofline_dp

        _roofline_dp.record(roofline, measured_pps=measured_pps)
    except Exception:  # noqa: BLE001 - observation must not break runs
        pass


def execute_stream(
    lowered: LoweredProgram,
    chunks: Iterable[np.ndarray],
    *,
    backend: str = "auto",
    chunk_size: int = DEFAULT_CHUNK,
    collect: bool = False,
    scan_hops: bool = False,
    device="cuda",
) -> StreamResult:
    """Stream a packet-chunk iterator through the executor on ``device``.

    With ``collect=False`` (default) only aggregate statistics are kept —
    memory stays constant no matter how many packets flow.  Timing covers
    device execution including the copy of results to the host, not the
    first chunk's warm call — which builds the kernels and uploads the
    tables, and is reported separately as ``warmup_seconds``.
    """
    backend = resolve_backend(backend)
    device = resolve_device(device)
    bit_counts = np.zeros(lowered.output_bits, np.int64)
    collected: list[np.ndarray] = []
    total = 0
    n_chunks = 0
    seconds = 0.0
    warmup = 0.0
    roofline = None
    with obs.span(
        "stream:execute_stream", cat="stream",
        backend=backend, chunk_size=chunk_size,
    ):
        for block in _rechunk(chunks, chunk_size):
            n = block.shape[0]
            dev = _to_device(block, device)
            if n_chunks == 0:  # build kernels and upload tables outside the clock
                with obs.span(
                    "compile:stream_chunk", cat="compile",
                    backend=backend, packets=chunk_size,
                ):
                    w0 = time.perf_counter()
                    _run_chunk(lowered, dev, backend, scan_hops)
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    warmup = time.perf_counter() - w0
                if obs.enabled():  # cost the dispatch, once
                    roofline = _probe_roofline(lowered, backend, chunk_size, scan_hops)
            with obs.span("execute:stream_chunk", cat="execute", packets=n):
                t0 = time.perf_counter()
                res = _run_chunk(lowered, dev, backend, scan_hops).cpu().numpy()
                dt = time.perf_counter() - t0
            seconds += dt
            bit_counts += res.sum(axis=0, dtype=np.int64)
            if collect:
                collected.append(res.astype(np.uint8))
            total += n
            n_chunks += 1
            if obs.enabled():
                m = obs.registry()
                m.counter("dataplane.packets_total").inc(n)
                m.counter("dataplane.chunks_total").inc()
                m.histogram("dataplane.chunk_seconds").observe(dt)
    if obs.enabled() and seconds > 0:
        obs.registry().gauge("dataplane.stream_pps").set(total / seconds)
        if roofline is not None:
            _record_roofline(roofline, total / seconds)
    return StreamResult(
        packets=total,
        chunks=n_chunks,
        seconds=seconds,
        bit_counts=bit_counts,
        outputs=np.concatenate(collected, axis=0) if collected else None,
        warmup_seconds=warmup,
    )
