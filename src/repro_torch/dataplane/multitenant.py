"""Multi-tenant switch scheduling: time-share one simulated chip across
several independently compiled programs.

A real deployment does not dedicate a switching chip to one classifier: the
same pipeline hosts a DDoS detector, an IoT profiler, and a flow tagger at
once (the Brain-on-Switch direction, arXiv:2403.11090).  This module is the
serving analogue of ``serving/engine.py`` for the dataplane: a
:class:`SwitchScheduler` admits N compiled :class:`PipelineProgram`s onto one
:class:`ChipSpec` and runs them over a *mixed* packet stream — packets tagged
with tenant ids (``traffic.mixed_tenant_stream``) — in one of two modes:

* **merged** — the tenants' op-tables fuse into one table over disjoint
  register windows (``LoweredProgram.with_slot_window``), so a *single*
  fused executor pass serves every tenant on the mixed stream at full line
  rate.  Windows are disjoint, so no tenant's rows can address another
  tenant's registers: per-tenant results are bit-exact with single-program
  runs by construction.  Two layouts (``merged=`` knob, default
  ``"interleave"``):

  - ``"interleave"`` — tenants' elements pack onto *shared physical
    stages*: merged stage ``e`` runs element ``e`` of every tenant at once
    (:func:`interleave_lowered`), so per-chunk work scales with the
    *deepest* tenant, not the sum — merging amortizes, which is the whole
    point of sharing a chip.  Budget: deepest tenant's elements <= element
    budget, summed peak PHV <= PHV bits, and the widest shared stage's
    summed rows <= ``ChipSpec.max_parallel_ops`` (the per-stage ALU count
    all co-resident elements share).
  - ``"concat"`` — tenants' tables concatenate stage-after-stage
    (:func:`merge_lowered`): per-chunk work scales with the *sum* of
    elements.  Budget: summed elements <= element budget, summed peak PHV
    <= PHV bits.  Wins only when tenants' opcode mixes are so heterogeneous
    that sharing stages would widen every opcode run (see
    docs/DATAPLANE.md).
* **time_sliced** — when the merged tables exceed the chip's element budget,
  the chip alternates between programs: packets are demultiplexed into
  per-tenant FIFO queues and served in weighted round-robin turns of at most
  ``quantum * weight / max(weight)`` packets each, each turn running the
  tenant's own program.  Queue overflow beyond ``max_queue`` drops packets
  (tail drop); backlog beyond a turn's quantum counts as *deferred* —
  per-tenant telemetry exposes both.

Invariants:

* **Per-tenant bit-exactness** — in both modes, each tenant's served packets
  produce exactly the outputs of a single-program ``executor.execute`` (and
  hence the interpreter and the ``bnn.forward`` oracle) on the same packets
  in the same order.  Merging relocates registers and interleaves element
  ranges; it never changes any tenant's results.
* **Admission before execution** — ``admit`` rejects programs that cannot
  run on the chip at all (elements or peak PHV over budget), and in forced
  ``merged`` mode programs whose merged footprint would overflow; ``auto``
  falls back to time-slicing instead of rejecting.
* **Conservation** — per tenant, ``arrived == served + dropped``; nothing is
  silently lost between the mixed stream and the per-tenant outputs.
* **Observation only** — both run paths are instrumented through
  ``repro_torch.obs`` (per-tenant packet/drop/defer counters, queue-delay
  histograms with p50/p99, and ``compile:``/``execute:`` spans), all
  no-ops while the global switch is off; enabling observability never
  changes any tenant's outputs (see ``docs/OBSERVABILITY.md``).

On a device: :meth:`SwitchScheduler.run` takes ``device=`` (default
``"cuda"``, which raises without a GPU).  Merged mode runs one routed
dispatch a chunk (``executor.routed_fn`` on the op-table kernel,
``executor.routed_packed_stacked_fn`` on the per-tenant packed-layer
kernel for interleaved packed merges, ``executor.routed_packed_fn``
otherwise); time-sliced mode runs each turn through the tenant's own
cached tables (``executor._run_chunk``).  Chunks and turns are not padded
to a fixed shape: nothing here compiles per shape, so the last chunk runs
at its own size.  Every timed dispatch ends with its outputs on the host.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.pipeline import RMT, ChipSpec, PipelineProgram
from repro_torch.dataplane import executor as _executor
from repro_torch.dataplane import telemetry as _telemetry
from repro_torch.dataplane.lowering import (
    LoweredProgram,
    PackedLayer,
    PackedProgram,
    interleave_tables,
    lower_program,
    peak_stage_rows,
)
from repro_torch.device import resolve_device
from repro_torch.obs.slo import SloSpec, SloTracker

SCHEDULER_MODES = ("auto", "merged", "time_sliced")
MERGED_LAYOUTS = ("interleave", "concat")
DEFAULT_QUANTUM = 4096


class AdmissionError(Exception):
    """A program cannot be admitted onto the shared chip."""


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One admitted program and its share of the chip."""

    tid: int
    name: str
    program: PipelineProgram
    lowered: LoweredProgram
    weight: float


@dataclasses.dataclass(frozen=True)
class MergedProgram:
    """N tenants' op-tables fused into one executable table.

    ``lowered`` is a real :class:`LoweredProgram` over the shared register
    file (``executor.run_hop`` executes it unchanged); the extra columns are
    the multi-tenant bookkeeping: which tenant owns each element
    (``element_program`` — the program-id column) and the per-tenant
    parser/deparser routing tables consumed by
    ``executor.parse_packets_routed`` / ``deparse_regs_routed``.
    """

    lowered: LoweredProgram
    element_program: np.ndarray              # (num_elements,) int32 tenant id
    slot_windows: tuple[tuple[int, int], ...]
    element_ranges: tuple[tuple[int, int], ...]
    in_slot: np.ndarray                      # (T, max_in_bits) int32
    in_shift: np.ndarray                     # (T, max_in_bits) uint32
    in_valid: np.ndarray                     # (T, max_in_bits) uint32 {0,1}
    out_slot: np.ndarray                     # (T, max_out_bits) int32
    out_shift: np.ndarray                    # (T, max_out_bits) uint32
    in_bits: np.ndarray                      # (T,) int32 true input widths
    out_bits: np.ndarray                     # (T,) int32 true output widths
    # Packed-backend routing (None when any tenant lacks a packed plan):
    # per-tenant indices into the merged dense input/output bit vectors
    # consumed by executor.route_bits_in / route_bits_out.  Width-padding
    # entries are 0 (masked by in_valid on the way in, sliced off by
    # ``out_bits`` on the way out).
    packed_in_bit: np.ndarray | None = None   # (T, max_in_bits) int32
    packed_out_bit: np.ndarray | None = None  # (T, max_out_bits) int32
    # Table layout ("concat" stage-after-stage, "interleave" shared stages)
    # and, for interleaved layouts, per-merged-row provenance: which tenant
    # each row came from and its (element, row) coordinates in that tenant's
    # own table (-1 for pad rows).  Provenance is what makes the interleave
    # auditable — un-interleaving by it must reproduce every tenant's rows
    # exactly (tenant_rows below; property-tested in test_multitenant.py).
    layout: str = "concat"
    row_tenant: np.ndarray | None = None      # (E, R) int32, -1 = pad
    row_src_elem: np.ndarray | None = None    # (E, R) int32, -1 = pad
    row_src_row: np.ndarray | None = None     # (E, R) int32, -1 = pad

    @property
    def num_tenants(self) -> int:
        return len(self.slot_windows)

    def tenant_rows(self, tid: int):
        """Un-interleave one tenant: its merged-table rows in (source
        element, source row) order.

        Returns ``(src_elem, src_row, fields)`` where ``fields`` maps each
        op-table column name to that tenant's extracted values — comparing
        them against the tenant's relocated single-program table proves the
        interleave dropped, duplicated, and reordered nothing.
        """
        if self.row_tenant is None:
            raise ValueError(
                "row provenance only exists for layout='interleave'"
            )
        sel = self.row_tenant == tid
        e = self.row_src_elem[sel]
        r = self.row_src_row[sel]
        order = np.lexsort((r, e))
        fields = {
            name: getattr(self.lowered, name)[sel][order]
            for name in (
                "opcode", "dst", "src0", "src1", "imm0", "imm1", "mask",
                "first_write",
            )
        }
        return e[order], r[order], fields


def _merge_packed(
    lowereds: Sequence[LoweredProgram], max_in: int, max_out: int
):
    """Fuse per-tenant packed plans into one block-diagonal plan.

    Tenants shallower than the deepest are depth-padded with
    :class:`PackedLayer.identity` layers so every tenant's bits traverse the
    same number of merged layers.  Per merged layer, each tenant occupies a
    word-aligned window: weights/mask are block-diagonal over the word axis
    (mask zeros outside the window, so foreign lanes contribute nothing),
    thresholds concatenate, and ``in_word`` shifts by the tenant's word
    offset.  Layer ``l``'s merged input-bit order is the concatenation of
    tenant layer-``l`` inputs — exactly layer ``l-1``'s concatenated output
    order, so the layers chain without any inter-layer routing.

    Returns ``(PackedProgram, packed_in_bit, packed_out_bit)`` or
    ``(None, None, None)`` when any tenant has no packed plan.
    """
    plans = [lp.packed for lp in lowereds]
    if any(p is None for p in plans):
        return None, None, None
    depth = max(len(p.layers) for p in plans)
    per_tenant: list[list[PackedLayer]] = []
    for p in plans:
        layers = list(p.layers)
        while len(layers) < depth:
            layers.append(PackedLayer.identity(p.output_bits))
        per_tenant.append(layers)

    t_count = len(per_tenant)
    merged_layers = []
    for li in range(depth):
        parts = [per_tenant[t][li] for t in range(t_count)]
        word_off = np.concatenate(
            ([0], np.cumsum([pl.n_words for pl in parts]))
        )
        total_words = int(word_off[-1])
        n_out_total = sum(pl.n_out for pl in parts)
        weights = np.zeros((n_out_total, total_words), np.uint32)
        mask = np.zeros((n_out_total, total_words), np.uint32)
        row = 0
        for t, pl in enumerate(parts):
            lo, hi = int(word_off[t]), int(word_off[t + 1])
            weights[row : row + pl.n_out, lo:hi] = pl.weights
            mask[row : row + pl.n_out, lo:hi] = pl.mask
            row += pl.n_out
        merged_layers.append(PackedLayer(
            weights=weights,
            mask=mask,
            thresholds=np.concatenate([pl.thresholds for pl in parts]),
            in_word=np.concatenate([
                pl.in_word + np.int32(word_off[t])
                for t, pl in enumerate(parts)
            ]).astype(np.int32),
            in_shift=np.concatenate([pl.in_shift for pl in parts]),
            n_in=sum(pl.n_in for pl in parts),
            n_out=n_out_total,
            n_words=total_words,
        ))

    in_off = np.concatenate(
        ([0], np.cumsum([t[0].n_in for t in per_tenant]))
    )
    out_off = np.concatenate(
        ([0], np.cumsum([t[-1].n_out for t in per_tenant]))
    )
    packed_in_bit = np.zeros((t_count, max_in), np.int32)
    packed_out_bit = np.zeros((t_count, max_out), np.int32)
    for t, layers in enumerate(per_tenant):
        packed_in_bit[t, : layers[0].n_in] = in_off[t] + np.arange(
            layers[0].n_in, dtype=np.int32
        )
        packed_out_bit[t, : layers[-1].n_out] = out_off[t] + np.arange(
            layers[-1].n_out, dtype=np.int32
        )
    pp = PackedProgram(
        layers=tuple(merged_layers),
        input_bits=int(in_off[-1]),
        output_bits=int(out_off[-1]),
    )
    return pp, packed_in_bit, packed_out_bit


def merge_lowered(
    lowereds: Sequence[LoweredProgram], chip: ChipSpec
) -> MergedProgram:
    """Concatenate lowered programs into one table over disjoint register
    windows.  Purely structural — no budget checks (the scheduler's
    admission/mode logic owns those)."""
    if not lowereds:
        raise ValueError("merge_lowered needs at least one program")
    total_slots = sum(lp.num_slots for lp in lowereds)
    max_rows = max(lp.max_rows for lp in lowereds)
    null = total_slots

    parts: list[LoweredProgram] = []
    windows: list[tuple[int, int]] = []
    offset = 0
    for lp in lowereds:
        parts.append(lp.with_slot_window(offset, total_slots).pad_rows(max_rows))
        windows.append((offset, offset + lp.num_slots))
        offset += lp.num_slots

    ranges: list[tuple[int, int]] = []
    start = 0
    for lp in lowereds:
        ranges.append((start, start + lp.num_elements))
        start += lp.num_elements

    def cat(field: str) -> np.ndarray:
        return np.concatenate([getattr(p, field) for p in parts], axis=0)

    counts = [p.opcode_counts for p in parts]
    packed_plan, packed_in_bit, packed_out_bit = _merge_packed(
        lowereds,
        int(max(lp.input_bits for lp in lowereds)),
        int(max(lp.output_bits for lp in lowereds)),
    )

    merged = LoweredProgram(
        source_fingerprint=(
            "merged(" + "+".join(p.fingerprint() for p in parts) + ")"
        ),
        chip_name=chip.name,
        num_slots=total_slots,
        input_bits=int(max(lp.input_bits for lp in lowereds)),
        output_bits=int(max(lp.output_bits for lp in lowereds)),
        opcode=cat("opcode"),
        dst=cat("dst"),
        src0=cat("src0"),
        src1=cat("src1"),
        imm0=cat("imm0"),
        imm1=cat("imm1"),
        mask=cat("mask"),
        first_write=cat("first_write"),
        rows_per_element=cat("rows_per_element"),
        element_stages=tuple(
            f"t{tid}:{stage}"
            for tid, p in enumerate(parts)
            for stage in p.element_stages
        ),
        num_ops=sum(p.num_ops for p in parts),
        # Per-packet-bit parser tables are ill-defined for a merged program
        # (each packet routes through its own tenant's tables); the routed
        # tables below replace them.  Left empty so any accidental use of the
        # single-program parse path fails loudly on shape.
        in_slot_per_bit=np.zeros(0, np.int32),
        in_shift_per_bit=np.zeros(0, np.uint32),
        out_slot_per_bit=np.zeros(0, np.int32),
        out_shift_per_bit=np.zeros(0, np.uint32),
        opcode_counts=(
            None
            if any(c is None for c in counts)
            else np.concatenate(counts, axis=0)
        ),
        packed=packed_plan,
    )

    max_in = merged.input_bits
    max_out = merged.output_bits
    t_count = len(parts)
    in_slot = np.full((t_count, max_in), null, np.int32)
    in_shift = np.zeros((t_count, max_in), np.uint32)
    in_valid = np.zeros((t_count, max_in), np.uint32)
    out_slot = np.full((t_count, max_out), null, np.int32)
    out_shift = np.zeros((t_count, max_out), np.uint32)
    for t, (p, lp) in enumerate(zip(parts, lowereds)):
        in_slot[t, : lp.input_bits] = p.in_slot_per_bit
        in_shift[t, : lp.input_bits] = p.in_shift_per_bit
        in_valid[t, : lp.input_bits] = 1
        out_slot[t, : lp.output_bits] = p.out_slot_per_bit
        out_shift[t, : lp.output_bits] = p.out_shift_per_bit

    return MergedProgram(
        lowered=merged,
        element_program=np.concatenate(
            [
                np.full(lp.num_elements, t, np.int32)
                for t, lp in enumerate(lowereds)
            ]
        ),
        slot_windows=tuple(windows),
        element_ranges=tuple(ranges),
        in_slot=in_slot,
        in_shift=in_shift,
        in_valid=in_valid,
        out_slot=out_slot,
        out_shift=out_shift,
        in_bits=np.array([lp.input_bits for lp in lowereds], np.int32),
        out_bits=np.array([lp.output_bits for lp in lowereds], np.int32),
        packed_in_bit=packed_in_bit,
        packed_out_bit=packed_out_bit,
    )


def interleave_lowered(
    lowereds: Sequence[LoweredProgram], chip: ChipSpec
) -> MergedProgram:
    """Interleave lowered programs onto shared physical stages.

    Merged stage ``e`` carries element ``e`` of every tenant at once
    (``lowering.interleave_tables``), so the merged element count is the
    *deepest* tenant's — per-chunk executor work stops scaling with the
    tenant count.  Register windows stay disjoint exactly as in
    :func:`merge_lowered`, so per-tenant bit-exactness still holds by
    construction.  Purely structural — no budget checks (the scheduler's
    admission/mode logic owns those, including the shared-stage
    ``max_parallel_ops`` row budget).

    Canonical construction: parts are relocated and interleaved in
    fingerprint-sorted order, so the merged tables — and the merged
    fingerprint, which keys every executor device cache — are invariant to
    tenant insertion order.  The tenant-id-indexed routing tables produced
    alongside are permuted back to admission order (they are *not*
    order-invariant; ``executor._routing_key`` accounts for that).
    """
    if not lowereds:
        raise ValueError("interleave_lowered needs at least one program")
    t_count = len(lowereds)
    order = sorted(range(t_count), key=lambda t: lowereds[t].fingerprint())
    total_slots = sum(lp.num_slots for lp in lowereds)
    null = total_slots

    parts_canon: list[LoweredProgram] = []
    windows_canon: list[tuple[int, int]] = []
    offset = 0
    for t in order:
        lp = lowereds[t]
        parts_canon.append(lp.with_slot_window(offset, total_slots))
        windows_canon.append((offset, offset + lp.num_slots))
        offset += lp.num_slots

    it = interleave_tables(parts_canon)
    max_in = int(max(lp.input_bits for lp in lowereds))
    max_out = int(max(lp.output_bits for lp in lowereds))
    packed_plan, pk_in_canon, pk_out_canon = _merge_packed(
        [lowereds[t] for t in order], max_in, max_out
    )

    merged = LoweredProgram(
        source_fingerprint=(
            "interleave("
            + "+".join(p.fingerprint() for p in parts_canon)
            + ")"
        ),
        chip_name=chip.name,
        num_slots=total_slots,
        input_bits=max_in,
        output_bits=max_out,
        opcode=it.opcode,
        dst=it.dst,
        src0=it.src0,
        src1=it.src1,
        imm0=it.imm0,
        imm1=it.imm1,
        mask=it.mask,
        first_write=it.first_write,
        rows_per_element=it.rows_per_element,
        element_stages=it.element_stages,
        num_ops=it.num_ops,
        # As in merge_lowered: per-packet-bit parser tables are ill-defined
        # for a merged program; the routed tables below replace them.
        in_slot_per_bit=np.zeros(0, np.int32),
        in_shift_per_bit=np.zeros(0, np.uint32),
        out_slot_per_bit=np.zeros(0, np.int32),
        out_shift_per_bit=np.zeros(0, np.uint32),
        opcode_counts=it.opcode_counts,
        packed=packed_plan,
    )

    # Canonical part position -> admission-order tenant id, and back.
    order_arr = np.asarray(order, np.int32)
    pos = np.empty(t_count, np.int64)
    pos[order_arr] = np.arange(t_count)
    row_tenant = np.where(
        it.row_part >= 0, order_arr[it.row_part], np.int32(-1)
    ).astype(np.int32)

    in_slot = np.full((t_count, max_in), null, np.int32)
    in_shift = np.zeros((t_count, max_in), np.uint32)
    in_valid = np.zeros((t_count, max_in), np.uint32)
    out_slot = np.full((t_count, max_out), null, np.int32)
    out_shift = np.zeros((t_count, max_out), np.uint32)
    for tid in range(t_count):
        p = parts_canon[pos[tid]]
        lp = lowereds[tid]
        in_slot[tid, : lp.input_bits] = p.in_slot_per_bit
        in_shift[tid, : lp.input_bits] = p.in_shift_per_bit
        in_valid[tid, : lp.input_bits] = 1
        out_slot[tid, : lp.output_bits] = p.out_slot_per_bit
        out_shift[tid, : lp.output_bits] = p.out_shift_per_bit

    return MergedProgram(
        lowered=merged,
        # Shared stages have no single owning tenant: the program-id column
        # is -1 everywhere (routing happens per packet, not per element).
        element_program=np.full(merged.num_elements, -1, np.int32),
        slot_windows=tuple(
            windows_canon[pos[tid]] for tid in range(t_count)
        ),
        element_ranges=tuple(
            (0, lowereds[tid].num_elements) for tid in range(t_count)
        ),
        in_slot=in_slot,
        in_shift=in_shift,
        in_valid=in_valid,
        out_slot=out_slot,
        out_shift=out_shift,
        in_bits=np.array([lp.input_bits for lp in lowereds], np.int32),
        out_bits=np.array([lp.output_bits for lp in lowereds], np.int32),
        packed_in_bit=None if pk_in_canon is None else pk_in_canon[pos],
        packed_out_bit=None if pk_out_canon is None else pk_out_canon[pos],
        layout="interleave",
        row_tenant=row_tenant,
        row_src_elem=it.row_src_elem,
        row_src_row=it.row_src_row,
    )


# ---------------------------------------------------------------------------
# Run results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TenantRunStats:
    """One tenant's traffic accounting for a scheduler run."""

    tid: int
    name: str
    packets: int = 0        # arrived on the mixed stream
    served: int = 0         # executed (== packets - dropped)
    dropped: int = 0        # tail-dropped at queue admission (time-sliced)
    deferred: int = 0       # packet-turns spent waiting past a quantum
    slices: int = 0         # scheduling turns executed (time-sliced)
    seconds: float = 0.0    # device time attributed to this tenant
    outputs: np.ndarray | None = None  # (served, out_bits) int32 if collected

    @property
    def packets_per_second(self) -> float:
        return self.served / self.seconds if self.seconds > 0 else float("inf")


@dataclasses.dataclass
class SchedulerRunResult:
    """Outcome of pushing a mixed stream through the shared chip."""

    mode: str
    packets: int
    seconds: float
    chunks: int
    tenants: list[TenantRunStats]
    warmup_seconds: float = 0.0  # warm calls: kernel build, table upload and planning
    merged_layout: str | None = None  # "interleave"/"concat" for merged runs

    @property
    def packets_per_second(self) -> float:
        served = sum(t.served for t in self.tenants)
        return served / self.seconds if self.seconds > 0 else float("inf")

    def stats_for(self, tid: int) -> TenantRunStats:
        for t in self.tenants:
            if t.tid == tid:
                return t
        raise KeyError(f"no tenant {tid} in this run")

    def outputs_for(self, tid: int) -> np.ndarray:
        out = self.stats_for(tid).outputs
        if out is None:
            raise ValueError("run was not collected; pass collect=True")
        return out


def _rechunk_mixed(
    chunks: Iterable[tuple[np.ndarray, np.ndarray]], chunk_size: int
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Re-slice a (tenant_ids, bits) chunk stream into exactly-``chunk_size``
    blocks (last may be short) — the mixed-stream twin of
    ``executor._rechunk``."""
    buf_t: list[np.ndarray] = []
    buf_b: list[np.ndarray] = []
    have = 0
    for tids, bits in chunks:
        tids, bits = np.asarray(tids), np.asarray(bits)
        if tids.shape[0] != bits.shape[0]:
            raise ValueError(
                f"tenant ids ({tids.shape[0]}) and packets ({bits.shape[0]}) "
                "disagree on chunk length"
            )
        while bits.shape[0]:
            take = min(chunk_size - have, bits.shape[0])
            buf_t.append(tids[:take])
            buf_b.append(bits[:take])
            have += take
            tids, bits = tids[take:], bits[take:]
            if have == chunk_size:
                yield np.concatenate(buf_t), np.concatenate(buf_b, axis=0)
                buf_t, buf_b, have = [], [], 0
    if have:
        yield np.concatenate(buf_t), np.concatenate(buf_b, axis=0)


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# The scheduler
# ---------------------------------------------------------------------------

class SwitchScheduler:
    """Admit N compiled programs onto one chip and serve a mixed stream.

    ``mode="auto"`` merges while the combined footprint fits the chip and
    falls back to weighted-round-robin time-slicing when it does not;
    ``"merged"``/``"time_sliced"`` force one strategy (forced merge makes
    admission reject overflowing programs instead of falling back).
    ``merged`` picks the merged-table layout: ``"interleave"`` (default —
    tenants' elements share physical stages, work scales with the deepest
    tenant) or ``"concat"`` (stage-after-stage, work scales with the sum).
    """

    def __init__(
        self,
        chip: ChipSpec = RMT,
        *,
        mode: str = "auto",
        merged: str = "interleave",
        quantum: int = DEFAULT_QUANTUM,
        max_queue: int | None = None,
        clock=None,
    ):
        if mode not in SCHEDULER_MODES:
            raise ValueError(
                f"mode must be one of {SCHEDULER_MODES}, got {mode!r}"
            )
        if merged not in MERGED_LAYOUTS:
            raise ValueError(
                f"merged layout must be one of {MERGED_LAYOUTS}, "
                f"got {merged!r}"
            )
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.chip = chip
        self.mode = mode
        self.merged_layout = merged
        self.quantum = quantum
        self.max_queue = max_queue
        self.tenants: list[Tenant] = []
        self._merged: dict[str, MergedProgram] = {}
        self._last_run: SchedulerRunResult | None = None
        # SLO tracking (repro_torch.obs.slo): per-tenant-name trackers fed from the
        # run paths with timestamps from ``clock`` (default perf_counter —
        # inject a deterministic clock to make burn rates reproducible).
        self._clock = clock or time.perf_counter
        self._slo_trackers: dict[str, SloTracker] = {}
        self._slo_last_now: float = 0.0

    # -- admission -----------------------------------------------------------

    def _merged_footprint(
        self,
        extra: PipelineProgram | None = None,
        layout: str | None = None,
    ):
        """(elements, PHV bits) one merged pass would occupy under
        ``layout``: interleaved stages host every tenant's element ``e`` at
        once, so elements is the *max* across tenants; concatenation stacks
        them, so it is the sum.  PHV windows are disjoint either way."""
        layout = layout or self.merged_layout
        progs = [t.program for t in self.tenants]
        if extra is not None:
            progs.append(extra)
        if not progs:
            return 0, 0
        elements = (
            max(p.num_elements for p in progs)
            if layout == "interleave"
            else sum(p.num_elements for p in progs)
        )
        return elements, sum(p.peak_phv_bits for p in progs)

    def _interleave_stage_rows(
        self, extra_lowered: LoweredProgram | None = None
    ) -> int:
        """Widest shared stage (summed op rows) an interleaved merge of the
        current tenants (plus ``extra_lowered``) would need — held against
        ``chip.max_parallel_ops``, the per-stage ALU budget."""
        lows = [t.lowered for t in self.tenants]
        if extra_lowered is not None:
            lows.append(extra_lowered)
        return peak_stage_rows(lows)

    def merge_feasible(
        self,
        extra: PipelineProgram | None = None,
        *,
        extra_lowered: LoweredProgram | None = None,
        layout: str | None = None,
    ) -> bool:
        """Would the current tenants (plus ``extra``) fit one merged pass
        under ``layout`` (default: the scheduler's configured layout)?

        Interleaved merges additionally hold the widest shared stage
        against ``chip.max_parallel_ops``; pass ``extra_lowered`` to reuse
        an already-lowered ``extra`` (it is lowered here otherwise).
        """
        layout = layout or self.merged_layout
        elements, phv = self._merged_footprint(extra, layout=layout)
        if elements > self.chip.num_elements or phv > self.chip.phv_bits:
            return False
        if layout == "interleave":
            if extra is not None and extra_lowered is None:
                extra_lowered = lower_program(extra, compact=True)
            return (
                self._interleave_stage_rows(extra_lowered)
                <= self.chip.max_parallel_ops
            )
        return True

    def admit(
        self,
        prog: PipelineProgram,
        *,
        name: str | None = None,
        weight: float = 1.0,
    ) -> Tenant:
        """Admit one compiled program, or raise :class:`AdmissionError`.

        Every program must fit the chip on its own (one pipeline pass, PHV
        within budget) — a program that cannot run alone cannot run in any
        shared mode.  Forced ``merged`` mode additionally requires the merged
        footprint to stay within the chip; ``auto`` falls back to
        time-slicing instead.
        """
        if weight <= 0:
            raise ValueError(f"weight must be positive, got {weight}")
        if prog.num_elements > self.chip.num_elements:
            raise AdmissionError(
                f"program needs {prog.num_elements} elements, chip "
                f"{self.chip.name!r} has {self.chip.num_elements} "
                "(recirculation is a single-program fabric concern, not a "
                "shared-chip one)"
            )
        if prog.peak_phv_bits > self.chip.phv_bits:
            raise AdmissionError(
                f"program peak PHV {prog.peak_phv_bits}b exceeds chip "
                f"{self.chip.name!r} PHV {self.chip.phv_bits}b"
            )
        lowered = lower_program(prog, compact=True)
        if self.mode == "merged" and not self.merge_feasible(
            prog, extra_lowered=lowered
        ):
            elements, phv = self._merged_footprint(prog)
            if (
                elements <= self.chip.num_elements
                and phv <= self.chip.phv_bits
            ):
                # Element and PHV budgets hold, so the interleave-specific
                # shared-stage row budget is what failed.
                rows = self._interleave_stage_rows(lowered)
                raise AdmissionError(
                    f"interleaved merge would need {rows} parallel ops in "
                    f"its widest shared stage against chip "
                    f"{self.chip.name!r} max_parallel_ops "
                    f"{self.chip.max_parallel_ops}; use mode='auto' to fall "
                    "back to time-slicing"
                )
            raise AdmissionError(
                f"merged footprint would be {elements} elements / {phv}b PHV "
                f"against a {self.chip.num_elements}-element / "
                f"{self.chip.phv_bits}b chip; use mode='auto' to fall back "
                "to time-slicing"
            )
        tenant = Tenant(
            tid=len(self.tenants),
            name=name or f"tenant{len(self.tenants)}",
            program=prog,
            lowered=lowered,
            weight=float(weight),
        )
        self.tenants.append(tenant)
        self._merged.clear()  # table layouts changed
        return tenant

    def set_slo(self, spec: SloSpec) -> SloTracker:
        """Attach (or replace) an SLO for the tenant named ``spec.tenant``.

        May be called before or after the tenant is admitted; the tracker
        starts collecting from the next run.  Burn rates and breach events
        surface through :meth:`telemetry` (``TenantTelemetry.slo`` /
        ``.breach_events``).
        """
        tracker = SloTracker(spec)
        self._slo_trackers[spec.tenant] = tracker
        return tracker

    def slo_tracker(self, tenant_name: str) -> SloTracker | None:
        """The live tracker for one tenant name (``None`` if no SLO set)."""
        return self._slo_trackers.get(tenant_name)

    def _slo_update_all(self) -> None:
        """End-of-run SLO evaluation: one deterministic update per tracker
        at a shared timestamp (breach events fire on ok -> breach here)."""
        if not self._slo_trackers:
            return
        now = self._clock()
        self._slo_last_now = now
        for tracker in self._slo_trackers.values():
            tracker.update(now)

    # -- mode / merged table -------------------------------------------------

    def resolve_mode(self) -> str:
        """The mode a run will actually use ("merged" or "time_sliced")."""
        if self.mode == "auto":
            return "merged" if self.merge_feasible() else "time_sliced"
        return self.mode

    def merged(self, layout: str | None = None) -> MergedProgram:
        """The fused table for the current tenant set (cached per layout)."""
        layout = layout or self.merged_layout
        if layout not in MERGED_LAYOUTS:
            raise ValueError(
                f"merged layout must be one of {MERGED_LAYOUTS}, "
                f"got {layout!r}"
            )
        if not self.tenants:
            raise ValueError("no tenants admitted")
        if self.mode != "merged" and not self.merge_feasible(layout=layout):
            raise ValueError(
                "merged footprint exceeds the chip; run() would time-slice"
            )
        mp = self._merged.get(layout)
        if mp is None:
            build = (
                interleave_lowered if layout == "interleave" else merge_lowered
            )
            mp = build([t.lowered for t in self.tenants], self.chip)
            self._merged[layout] = mp
        return mp

    def _quanta(self) -> list[int]:
        """Per-tenant packets per scheduling turn: the heaviest tenant gets
        the full quantum, the rest proportionally fewer (weighted RR)."""
        top = max(t.weight for t in self.tenants)
        return [
            max(1, int(round(self.quantum * t.weight / top)))
            for t in self.tenants
        ]

    # -- execution -----------------------------------------------------------

    def run(
        self,
        stream,
        *,
        mode: str | None = None,
        merged: str | None = None,
        backend: str = "auto",
        chunk_size: int | None = None,
        collect: bool = True,
        plan=None,
        device="cuda",
    ) -> SchedulerRunResult:
        """Serve a mixed stream on ``device``: an iterable of
        ``(tenant_ids, bits)`` chunks (e.g. ``traffic.mixed_tenant_stream``)
        or one such pair.

        Per-tenant outputs (``collect=True``) are bit-exact with each
        tenant's single-program ``executor.execute`` over its served packets.
        A ``plan`` (:class:`repro_torch.dataplane.plan.ExecutionPlan`)
        overrides ``backend``/``chunk_size``/``merged`` (its ``interpret`` is
        ignored); ``collect`` and ``mode`` stay scheduler-level knobs.
        ``merged`` overrides the scheduler's merged-table layout for this run
        only.
        """
        if plan is not None:
            backend = plan.backend_str
            if plan.chunk_size is not None:
                chunk_size = plan.chunk_size
            if plan.merged is not None:
                merged = plan.merged
        if not self.tenants:
            raise ValueError("no tenants admitted")
        layout = merged or self.merged_layout
        if layout not in MERGED_LAYOUTS:
            raise ValueError(
                f"merged layout must be one of {MERGED_LAYOUTS}, "
                f"got {layout!r}"
            )
        mode = mode or self.resolve_mode()
        if mode not in ("merged", "time_sliced"):
            raise ValueError(
                f"run mode must be 'merged' or 'time_sliced', got {mode!r}"
            )
        if mode == "merged" and not self.merge_feasible(layout=layout):
            raise ValueError(
                "merged footprint exceeds the chip; use mode='time_sliced'"
            )
        backend = _executor.resolve_backend(backend)
        device = resolve_device(device)
        if isinstance(stream, tuple) and len(stream) == 2:
            stream = [stream]
        chunk = chunk_size or _executor.DEFAULT_CHUNK

        stats = [TenantRunStats(t.tid, t.name) for t in self.tenants]
        if mode == "merged":
            result = self._run_merged(
                stream, stats, backend, chunk, collect, device, layout
            )
        else:
            result = self._run_time_sliced(
                stream, stats, backend, collect, device
            )
        self._last_run = result
        self._slo_update_all()
        return result

    def _check_chunk(self, tids: np.ndarray, bits: np.ndarray, width: int):
        if bits.ndim != 2 or bits.shape[1] != width:
            raise ValueError(
                f"expected (batch, {width}) mixed packet bits, got {bits.shape}"
            )
        if tids.size and (tids.min() < 0 or tids.max() >= len(self.tenants)):
            raise ValueError(
                f"tenant ids out of range [0, {len(self.tenants)})"
            )

    def _run_merged(
        self, stream, stats, backend, chunk, collect, device, layout
    ) -> SchedulerRunResult:
        mp = self.merged(layout)
        lp = mp.lowered
        width = mp.in_slot.shape[1]
        collected: list[list[np.ndarray]] = [[] for _ in self.tenants]

        # One routed dispatch per chunk: routed parse -> run -> routed
        # deparse on the device (executor.routed_fn / routed_packed_fn), so
        # the register file never leaves the device between phases.
        if backend == "packed":
            if lp.packed is None or mp.packed_in_bit is None:
                raise ValueError(
                    "packed backend needs every tenant to carry a packed "
                    "plan (compiler-built programs do); use an op-table "
                    "backend"
                )
            fn = None
            if layout == "interleave":
                # Widest-tenant dispatch: stack per-tenant packed layers and
                # gather each packet's weight block by tenant id, so chunk
                # work scales with the widest/deepest tenant instead of the
                # block-diagonal sum.  Declines (returns None) for
                # hand-assembled layouts; fall back to the merged plan.
                fn = _executor.routed_packed_stacked_fn(
                    tuple(t.lowered for t in self.tenants), device=device
                )
            if fn is None:
                fn = _executor.routed_packed_fn(
                    lp, mp.packed_in_bit, mp.packed_out_bit, mp.in_valid,
                    device=device,
                )
        else:
            fn = _executor.routed_fn(
                lp,
                mp.in_slot, mp.in_shift, mp.in_valid,
                mp.out_slot, mp.out_shift,
                backend=backend, device=device,
            )

        def push(tids_dev, bits_dev):
            return fn(bits_dev, tids_dev)

        seconds = 0.0
        warmup = 0.0
        n_chunks = 0
        with obs.span(
            "stream:mt_merged", cat="stream",
            tenants=len(self.tenants), backend=backend, layout=layout,
        ):
            for tids, bits in _rechunk_mixed(stream, chunk):
                # The ids are checked here, on the host, once a chunk: the
                # dispatch then reads nothing back before its copy out.
                self._check_chunk(tids, bits, width)
                n = bits.shape[0]
                bits_dev = _executor._to_device(bits, device)
                tids_dev = _executor._to_device(tids, device)
                if n_chunks == 0:  # build kernels, upload tables outside the clock
                    with obs.span(
                        "compile:mt_merged", cat="compile", backend=backend
                    ):
                        w0 = time.perf_counter()
                        push(tids_dev, bits_dev)
                        _sync(device)
                        warmup = time.perf_counter() - w0
                with obs.span("execute:mt_chunk", cat="execute", packets=n):
                    t0 = time.perf_counter()
                    res = push(tids_dev, bits_dev).cpu().numpy()
                    dt = time.perf_counter() - t0
                seconds += dt
                slo_now = (
                    self._clock() if self._slo_trackers else 0.0
                )
                for t, st in enumerate(stats):
                    rows = np.nonzero(tids == t)[0]
                    if not rows.size:
                        continue
                    st.packets += int(rows.size)
                    st.served += int(rows.size)
                    tracker = self._slo_trackers.get(self.tenants[t].name)
                    if tracker is not None:
                        tracker.observe_packets(slo_now, int(rows.size))
                        tracker.observe_queue_delay(
                            slo_now, dt, int(rows.size)
                        )
                    # Attribute this chunk's latency by the tenant's actual
                    # packet share of THIS chunk — bursty streams put a
                    # tenant in some chunks and not others, so assuming a
                    # run-uniform mix (the old ``st.seconds = seconds``)
                    # over/under-charged tenants whose packets cluster in
                    # fast or slow chunks.
                    st.seconds += dt * (rows.size / n)
                    if collect:
                        collected[t].append(res[rows, : mp.out_bits[t]])
                    if obs.enabled():
                        m = obs.registry()
                        name = self.tenants[t].name
                        m.counter("mt.packets_total", tenant=name).inc(
                            int(rows.size)
                        )
                        m.counter("mt.served_total", tenant=name).inc(
                            int(rows.size)
                        )
                        # One fused dispatch serves the whole chunk: every
                        # packet in it waits exactly the dispatch latency.
                        m.histogram(
                            "mt.queue_delay_seconds", tenant=name
                        ).observe(dt, count=int(rows.size))
                n_chunks += 1

        for t, st in enumerate(stats):
            if collect:
                st.outputs = (
                    np.concatenate(collected[t])
                    if collected[t]
                    else np.zeros((0, int(mp.out_bits[t])), np.int32)
                )
        return SchedulerRunResult(
            mode="merged",
            packets=sum(st.packets for st in stats),
            seconds=seconds,
            chunks=n_chunks,
            tenants=stats,
            warmup_seconds=warmup,
            merged_layout=layout,
        )

    def _run_time_sliced(
        self, stream, stats, backend, collect, device
    ) -> SchedulerRunResult:
        quanta = self._quanta()
        width = max(int(t.lowered.input_bits) for t in self.tenants)
        queues: list[list[np.ndarray]] = [[] for _ in self.tenants]
        queued = [0] * len(self.tenants)
        collected: list[list[np.ndarray]] = [[] for _ in self.tenants]
        warmed = [False] * len(self.tenants)
        seconds_total = 0.0
        warmup_total = 0.0
        n_chunks = 0
        observing = obs.enabled()
        # Per-packet enqueue timestamps (same chunking as ``queues``), kept
        # while observing or while any tenant carries an SLO: serve time
        # minus arrival time is the real queueing delay each packet
        # experienced in the simulator — the per-tenant p99 both the
        # ``mt.queue_delay_seconds`` histograms and the SLO burn rates key
        # on.  Timestamps come from the scheduler clock so an injected
        # deterministic clock reproduces them.
        track = observing or bool(self._slo_trackers)
        arrivals: list[list[np.ndarray]] = [[] for _ in self.tenants]

        def serve_turn(t: int) -> None:
            """One weighted-RR turn: run up to ``quanta[t]`` queued packets
            through tenant t's own program."""
            nonlocal warmup_total
            st = stats[t]
            take = min(queued[t], quanta[t])
            if take == 0:
                return
            deferred_now = queued[t] - take  # backlog waits >= 1 more turn
            st.deferred += deferred_now
            batch = np.concatenate(queues[t])[:queued[t]]
            head, tail = batch[:take], batch[take:]
            queues[t] = [tail] if tail.size else []
            if track:
                times = np.concatenate(arrivals[t])[:queued[t]]
                head_times, tail_times = times[:take], times[take:]
                arrivals[t] = [tail_times] if tail_times.size else []
            queued[t] -= take
            dev = _executor._to_device(head, device)
            tenant = self.tenants[t]
            lp = tenant.lowered
            if not warmed[t]:
                with obs.span(
                    "compile:mt_tenant", cat="compile",
                    tenant=tenant.name, backend=backend,
                ):
                    w0 = time.perf_counter()
                    _executor._run_chunk(lp, dev, backend)
                    _sync(device)
                    warmup_total += time.perf_counter() - w0
                warmed[t] = True
            with obs.span(
                "execute:mt_turn", cat="execute",
                tenant=tenant.name, packets=take,
            ):
                t0 = time.perf_counter()
                res = _executor._run_chunk(lp, dev, backend).cpu().numpy()
                t1 = time.perf_counter()
            st.seconds += t1 - t0
            st.served += take
            st.slices += 1
            if collect:
                collected[t].append(res)
            if track:
                slo_t = self._clock()
                delays = np.maximum(slo_t - head_times, 0.0)
                if observing:
                    m = obs.registry()
                    m.counter("mt.served_total", tenant=tenant.name).inc(take)
                    m.counter("mt.slices_total", tenant=tenant.name).inc()
                    if deferred_now:
                        m.counter(
                            "mt.deferred_total", tenant=tenant.name
                        ).inc(deferred_now)
                    m.histogram(
                        "mt.queue_delay_seconds", tenant=tenant.name
                    ).observe_array(delays)
                tracker = self._slo_trackers.get(tenant.name)
                if tracker is not None:
                    tracker.observe_packets(slo_t, take)
                    # Arrival chunks share timestamps, so the delay array
                    # collapses to a few distinct values — feed those as
                    # weighted observations instead of a per-packet loop.
                    vals, cnts = np.unique(delays, return_counts=True)
                    for v, c in zip(vals.tolist(), cnts.tolist()):
                        tracker.observe_queue_delay(slo_t, float(v), int(c))

        with obs.span(
            "stream:mt_time_sliced", cat="stream",
            tenants=len(self.tenants), backend=backend,
        ):
            for tids, bits in stream:
                tids, bits = np.asarray(tids), np.asarray(bits)
                self._check_chunk(
                    tids, bits, bits.shape[1] if bits.ndim == 2 else -1
                )
                if bits.shape[1] < width:
                    raise ValueError(
                        f"mixed packets are {bits.shape[1]}b wide; widest "
                        f"tenant needs {width}b"
                    )
                n_chunks += 1
                now = self._clock() if track else 0.0
                for t, tenant in enumerate(self.tenants):
                    rows = np.nonzero(tids == t)[0]
                    if not rows.size:
                        continue
                    st = stats[t]
                    st.packets += int(rows.size)
                    arrived = bits[rows, : int(tenant.lowered.input_bits)]
                    dropped_now = 0
                    if self.max_queue is not None:
                        space = self.max_queue - queued[t]
                        if arrived.shape[0] > space:  # tail drop at admission
                            dropped_now = int(arrived.shape[0] - space)
                            st.dropped += dropped_now
                            arrived = arrived[:space]
                    if arrived.shape[0]:
                        queues[t].append(arrived)
                        queued[t] += int(arrived.shape[0])
                        if track:
                            arrivals[t].append(
                                np.full(arrived.shape[0], now, np.float64)
                            )
                    if observing:
                        m = obs.registry()
                        m.counter(
                            "mt.packets_total", tenant=tenant.name
                        ).inc(int(rows.size))
                        if dropped_now:
                            m.counter(
                                "mt.dropped_total", tenant=tenant.name
                            ).inc(dropped_now)
                # The chip alternates tenants while anyone has a full
                # quantum waiting; sub-quantum remainders wait for more
                # arrivals (they are served — quantum-padded — only in the
                # end-of-stream drain).
                while any(q >= quanta[t] for t, q in enumerate(queued)):
                    for t in range(len(self.tenants)):
                        if queued[t] >= quanta[t]:
                            serve_turn(t)

            while any(queued):  # end of stream: drain every backlog
                for t in range(len(self.tenants)):
                    serve_turn(t)

        for t, st in enumerate(stats):
            seconds_total += st.seconds
            if collect:
                st.outputs = (
                    np.concatenate(collected[t])
                    if collected[t]
                    else np.zeros(
                        (0, int(self.tenants[t].lowered.output_bits)), np.int32
                    )
                )
        return SchedulerRunResult(
            mode="time_sliced",
            packets=sum(st.packets for st in stats),
            seconds=seconds_total,
            chunks=n_chunks,
            tenants=stats,
            warmup_seconds=warmup_total,
        )

    # -- accounting ----------------------------------------------------------

    def analytic_pps(self, mode: str | None = None) -> list[float]:
        """Chip-model packets/s available to each tenant under ``mode``.

        Merged: one pass serves the mixed stream, so every tenant sees the
        full line rate (its *offered* load is governed by arrival shares).
        Time-sliced: the chip is a shared server — each tenant gets its
        weighted share of the line rate.
        """
        mode = mode or self.resolve_mode()
        if mode == "merged":
            return [self.chip.packets_per_second] * len(self.tenants)
        total = sum(t.weight for t in self.tenants)
        return [
            self.chip.packets_per_second * t.weight / total
            for t in self.tenants
        ]

    def telemetry(
        self, run: SchedulerRunResult | None = None
    ) -> _telemetry.MultiTenantTelemetry:
        """Per-tenant rollup (static footprints + the latest run's traffic)."""
        if not self.tenants:
            raise ValueError("no tenants admitted")
        run = run or self._last_run
        mode = run.mode if run is not None else self.resolve_mode()
        pps = self.analytic_pps(mode)
        merged_ok = self.merge_feasible()
        mp = self.merged() if (mode == "merged" and merged_ok) else None

        # Tenants admitted after the recorded run have no stats in it: report
        # them with zeroed traffic counters instead of failing the lookup.
        by_tid = {s.tid: s for s in run.tenants} if run is not None else {}
        rows = []
        for i, tenant in enumerate(self.tenants):
            stages = _telemetry.stage_telemetry(tenant.program, self.chip)
            st = by_tid.get(tenant.tid)
            if mp is not None:
                window = mp.slot_windows[i]
                el_range = mp.element_ranges[i]
            else:
                window = (0, tenant.lowered.num_slots)
                el_range = None
            tracker = self._slo_trackers.get(tenant.name)
            rows.append(
                _telemetry.TenantTelemetry(
                    tid=tenant.tid,
                    name=tenant.name,
                    elements=tenant.program.num_elements,
                    slot_window=window,
                    element_range=el_range,
                    weight=tenant.weight,
                    analytic_pps=pps[i],
                    peak_occupancy_bits=max(
                        s.occupancy_bits for s in stages
                    ),
                    peak_alu_utilization=max(
                        s.alu_utilization for s in stages
                    ),
                    packets=st.packets if st else 0,
                    served=st.served if st else 0,
                    dropped=st.dropped if st else 0,
                    deferred=st.deferred if st else 0,
                    slices=st.slices if st else 0,
                    measured_pps=st.packets_per_second if st else None,
                    slo=(
                        tracker.status(self._slo_last_now)
                        if tracker is not None else None
                    ),
                    breach_events=(
                        tuple(tracker.events)
                        if tracker is not None else ()
                    ),
                )
            )
        elements, phv = self._merged_footprint()
        return _telemetry.MultiTenantTelemetry(
            mode=mode,
            chip_name=self.chip.name,
            elements_used=elements,
            elements_available=self.chip.num_elements,
            phv_bits_used=phv,
            phv_bits_available=self.chip.phv_bits,
            tenants=tuple(rows),
            measured_pps=run.packets_per_second if run is not None else None,
        )
