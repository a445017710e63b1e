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

Streaming (:func:`execute_stream`) re-chunks any packet iterator into
fixed-size blocks so millions of packets run at constant device memory.  The
stream path is instrumented through ``repro_torch.obs`` (packets/chunk
counters, chunk-latency histogram, and ``compile:``/``execute:`` spans) —
all no-ops unless the global observability switch is on.

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
from repro_torch.kernels.packed_layer import packed_layer

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
    return StreamResult(
        packets=total,
        chunks=n_chunks,
        seconds=seconds,
        bit_counts=bit_counts,
        outputs=np.concatenate(collected, axis=0) if collected else None,
        warmup_seconds=warmup,
    )
