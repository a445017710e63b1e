"""Lower a :class:`PipelineProgram` into dense uint32 op-tables.

The interpreter (``core.interpreter``) walks the compiled program op-by-op in
Python — fine as a correctness witness, hopeless as a traffic simulator.  This
module turns a program into a *table*: one row per primitive ALU operation,
stored as flat ``(num_elements, max_rows)`` numpy arrays (opcode / dst / src /
imm / width-mask), so an executor can run the whole program as data, with no
per-op Python dispatch (``dataplane.executor``).

Two transformations happen on the way down:

* **Opcode normalization** — the 8 front-end opcodes collapse onto 6 dense
  ALU ops.  ``COPY`` is ``XOR imm=0``; ``XNOR_IMM w`` is ``XOR imm=~w``
  (``~(r ^ w) == r ^ ~w`` in uint32); ``AND_IMM m`` is ``SHR_AND imm=(0, m)``.
  ``FOLD`` (variadic deposit) is decomposed into one ``SHL`` micro-row per
  sign bit; the executor combines same-destination rows additively, which
  equals OR because each row contributes disjoint bits.
* **Register compaction** — the compiler allocates an SSA-style fresh field
  id per value, so ``PipelineProgram.num_fields`` counts every temporary ever
  created (thousands for a paper-sized net).  A liveness pass renames fields
  onto a small recycled slot file sized by the *peak* number of simultaneously
  live fields (hundreds), cutting executor memory and gather width ~10x.
  Read-before-write element semantics make it safe for an element's outputs
  to reuse slots its own inputs die in, mirroring RMT's PHV overlay.

Row layout invariants (relied on by executor + CUDA kernel):

* every row of element ``e`` reads the register file as it stood *entering*
  ``e`` and rows writing the same destination slot are additive after the
  first (``first_write`` flag);
* slot ``num_slots`` (one past the compacted file) is the always-zero null
  register: padding rows write 0 to it and absent src1 operands read it.

Cross-module invariants:

* **Bit-exactness** — executing the lowered tables (any backend, any
  compaction mode, any chunking) equals ``core.interpreter.run_program`` on
  the source program, bit for bit.  Compaction changes slot numbering only,
  never results.
* **Opcode-table stability** — the dense opcode ids below are a contract
  with ``executor.alu_variants`` and ``kernels.optable_exec``; extend the
  ISA by appending ids, never by renumbering.  The compaction mode is part
  of ``LoweredProgram.fingerprint()``, which keys executor device caches.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.pipeline import Op, OpCode, PipelineProgram

# Dense ALU opcodes (the executor's instruction set).
XOR_IMM = 0      # dst = src0 ^ imm0            (COPY, XNOR_IMM)
SHR_AND_IMM = 1  # dst = (src0 >> imm0) & imm1  (AND_IMM, HAKMEM marshal, pad)
ADD = 2          # dst = src0 + src1
GE_IMM = 3       # dst = src0 >= imm0
SHL_IMM = 4      # dst = src0 << imm0           (FOLD micro-op)
POPCNT = 5       # dst = popcount(src0)

DENSE_OPCODE_NAMES = ("xor", "shr_and", "add", "ge", "shl", "popcnt")
NUM_DENSE_OPCODES = len(DENSE_OPCODE_NAMES)
U32 = np.uint32
FULL = np.uint32(0xFFFFFFFF)
WORD = 32


def _mask(width: int) -> np.uint32:
    return FULL if width >= 32 else U32((1 << width) - 1)


def pack_bit_rows(bits: np.ndarray, n_words: int | None = None) -> np.ndarray:
    """Pack ``(..., n)`` {0,1} bits into ``(..., n_words)`` uint32 words.

    Little-endian within a word: logical bit ``k`` lands in word ``k // 32``
    at shift ``k % 32`` — the packed-PHV word layout shared by the executor's
    packed backend and ``kernels.bitpack`` (see docs/DATAPLANE.md).  Bits past
    ``n`` are zero padding.
    """
    bits = np.asarray(bits)
    n = bits.shape[-1]
    words = n_words if n_words is not None else max(1, -(-n // WORD))
    if words * WORD < n:
        raise ValueError(f"{n} bits do not fit {words} words")
    pad = words * WORD - n
    b = np.pad(bits.astype(np.uint32), [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    b = b.reshape(bits.shape[:-1] + (words, WORD))
    weights = U32(1) << np.arange(WORD, dtype=np.uint32)
    return (b * weights).sum(axis=-1, dtype=np.uint64).astype(np.uint32)


@dataclasses.dataclass(frozen=True, eq=False)
class PackedLayer:
    """One BNN layer in bit-packed form: a packed weight matrix plus the
    word layout its input bits occupy.

    Execution contract (``executor`` packed backend): scatter the layer's
    input bits into ``n_words`` uint32 lanes via ``in_word``/``in_shift``,
    then per neuron ``j`` the agreement count is
    ``popcount(~(x_words ^ weights[j]) & mask[j]).sum()`` and the output bit
    is ``count >= thresholds[j]``.  ``mask`` zeroes padding lanes (x-pad and
    w-pad are both 0, so unmasked ``~(0 ^ 0)`` would inflate counts) and, for
    merged multi-tenant layers, every word outside the neuron's tenant
    window.
    """

    weights: np.ndarray     # (n_out, n_words) uint32 packed weight bits
    thresholds: np.ndarray  # (n_out,) uint32: fire iff agreement >= thr
    mask: np.ndarray        # (n_out, n_words) uint32 valid-bit mask
    in_word: np.ndarray     # (n_in,) int32: input bit k -> word index
    in_shift: np.ndarray    # (n_in,) uint32: input bit k -> shift in word
    n_in: int
    n_out: int
    n_words: int

    @classmethod
    def from_dense(cls, w_bits: np.ndarray, thresholds: np.ndarray) -> "PackedLayer":
        """Pack a dense ``(n_out, n_in)`` {0,1} weight matrix with the
        trivial contiguous word layout."""
        w = np.asarray(w_bits)
        if w.ndim != 2:
            raise ValueError(f"weights must be (n_out, n_in), got {w.shape}")
        n_out, n_in = w.shape
        n_words = max(1, -(-n_in // WORD))
        bit = np.arange(n_in)
        mask_row = pack_bit_rows(np.ones((1, n_in), np.uint8), n_words)
        return cls(
            weights=pack_bit_rows(w, n_words),
            thresholds=np.asarray(thresholds, np.uint32).reshape(n_out),
            mask=np.broadcast_to(mask_row, (n_out, n_words)).copy(),
            in_word=(bit // WORD).astype(np.int32),
            in_shift=(bit % WORD).astype(np.uint32),
            n_in=n_in,
            n_out=n_out,
            n_words=n_words,
        )

    @classmethod
    def identity(cls, width: int) -> "PackedLayer":
        """A pass-through layer: neuron ``j`` reproduces input bit ``j``
        (single-bit weight, threshold 1).  Used to depth-pad shallower
        tenants in a merged packed program."""
        if width < 1:
            raise ValueError(f"identity layer needs width >= 1, got {width}")
        n_words = max(1, -(-width // WORD))
        eye = np.zeros((width, n_words), np.uint32)
        bit = np.arange(width)
        eye[bit, bit // WORD] = U32(1) << (bit % WORD).astype(np.uint32)
        return cls(
            weights=eye,
            thresholds=np.ones(width, np.uint32),
            mask=eye.copy(),
            in_word=(bit // WORD).astype(np.int32),
            in_shift=(bit % WORD).astype(np.uint32),
            n_in=width,
            n_out=width,
            n_words=n_words,
        )


@dataclasses.dataclass(frozen=True, eq=False)
class PackedProgram:
    """A whole program as a chain of :class:`PackedLayer`s — the bit-packed
    execution plan the ``"packed"`` executor backend runs instead of the
    op-table scan.  Layer ``l``'s ``n_in`` equals layer ``l-1``'s total
    ``n_out``; output bits are in neuron order (== deparser order == oracle
    order)."""

    layers: tuple[PackedLayer, ...]
    input_bits: int
    output_bits: int


def _packed_program(prog: PipelineProgram) -> PackedProgram | None:
    """Build the packed plan from compiler-attached layer metadata (weights
    + SIGN thresholds); ``None`` when the program carries none (hand-built
    programs, merged tables — those get plans elsewhere or fall back to the
    op-table path)."""
    meta = getattr(prog, "packed_layers", None)
    if meta is None:
        return None
    layers = []
    n_bits = prog.input_bits
    for li, (w, thr) in enumerate(meta):
        w = np.asarray(w)
        if w.shape[1] != n_bits:
            raise ValueError(
                f"packed layer {li}: fan-in {w.shape[1]} != incoming "
                f"{n_bits} bits"
            )
        layers.append(PackedLayer.from_dense(w, thr))
        n_bits = w.shape[0]
    if n_bits != prog.output_bits:
        raise ValueError(
            f"packed plan ends at {n_bits} bits; program outputs "
            f"{prog.output_bits}"
        )
    return PackedProgram(tuple(layers), prog.input_bits, prog.output_bits)


@dataclasses.dataclass(frozen=True)
class LoweredProgram:
    """A pipeline program as dense data.  All tables are numpy; the executor
    moves them on-device once per program (see ``executor._device_tables``)."""

    source_fingerprint: str
    chip_name: str
    num_slots: int               # compacted register file size (excl. null)
    input_bits: int
    output_bits: int

    # (num_elements, max_rows) tables; rows past rows_per_element[e] are pads.
    opcode: np.ndarray           # int32
    dst: np.ndarray              # int32 slot index
    src0: np.ndarray             # int32 slot index
    src1: np.ndarray             # int32 slot index (null slot when unused)
    imm0: np.ndarray             # uint32
    imm1: np.ndarray             # uint32
    mask: np.ndarray             # uint32 destination width mask (0 for pads)
    first_write: np.ndarray      # int32 — 0 only for FOLD continuation rows

    rows_per_element: np.ndarray  # (num_elements,) int32, true rows per element
    element_stages: tuple[str, ...]
    num_ops: int                  # true (unpadded) row count

    # Parser / deparser tables: one entry per packet bit.
    in_slot_per_bit: np.ndarray   # (input_bits,) int32
    in_shift_per_bit: np.ndarray  # (input_bits,) uint32
    out_slot_per_bit: np.ndarray  # (output_bits,) int32
    out_shift_per_bit: np.ndarray  # (output_bits,) uint32

    # (num_elements, NUM_DENSE_OPCODES) int32 — true-row opcode histogram per
    # element (pads excluded).  Rows within an element are stably sorted by
    # dense opcode (see lower_program), so opcode_runs() can hand executors
    # opcode-homogeneous element ranges.  None for hand-assembled tables.
    opcode_counts: np.ndarray | None = None
    # Bit-packed execution plan (the "packed" backend); None when the source
    # program carried no layer metadata or after element slicing.
    packed: PackedProgram | None = None

    @property
    def num_elements(self) -> int:
        return self.opcode.shape[0]

    @property
    def max_rows(self) -> int:
        return self.opcode.shape[1]

    @property
    def num_regs(self) -> int:
        """Register-file width including the trailing null register."""
        return self.num_slots + 1

    @property
    def null_slot(self) -> int:
        return self.num_slots

    def fingerprint(self) -> str:
        return self.source_fingerprint

    def slice_elements(self, start: int, stop: int) -> "LoweredProgram":
        """A view of elements ``[start, stop)`` — one fabric hop's table.

        Parser/deparser tables and the register file are inherited whole: the
        register file *is* the PHV carried between hops, so a hop executes its
        element range over the same slot space.
        """
        if not (0 <= start < stop <= self.num_elements):
            raise ValueError(
                f"element slice [{start}, {stop}) out of range "
                f"[0, {self.num_elements})"
            )
        rows = self.rows_per_element[start:stop]
        return dataclasses.replace(
            self,
            source_fingerprint=f"{self.source_fingerprint}[{start}:{stop}]",
            opcode=self.opcode[start:stop],
            dst=self.dst[start:stop],
            src0=self.src0[start:stop],
            src1=self.src1[start:stop],
            imm0=self.imm0[start:stop],
            imm1=self.imm1[start:stop],
            mask=self.mask[start:stop],
            first_write=self.first_write[start:stop],
            rows_per_element=rows,
            element_stages=self.element_stages[start:stop],
            num_ops=int(rows.sum()),
            opcode_counts=(
                None if self.opcode_counts is None
                else self.opcode_counts[start:stop]
            ),
            # A slice is one hop of a layer-level plan; the whole-program
            # packed shortcut no longer applies.
            packed=None,
        )

    def with_slot_window(self, offset: int, total_slots: int) -> "LoweredProgram":
        """Relocate this program's register file to slots ``[offset, offset +
        num_slots)`` of a ``total_slots``-wide shared file.

        Every slot reference (dst/src/parser/deparser) shifts by ``offset``;
        references to this program's own null register retarget the shared
        file's null (``total_slots``).  This is the table half of multi-tenant
        merging (``dataplane.multitenant``): programs relocated to disjoint
        windows can share one register file — and one executor pass — without
        interfering, because no remapped row can address another window.
        """
        if offset < 0 or offset + self.num_slots > total_slots:
            raise ValueError(
                f"window [{offset}, {offset + self.num_slots}) does not fit "
                f"a {total_slots}-slot file"
            )

        def remap(tbl: np.ndarray) -> np.ndarray:
            return np.where(
                tbl == self.null_slot, np.int32(total_slots), tbl + offset
            ).astype(np.int32)

        return dataclasses.replace(
            self,
            source_fingerprint=(
                f"{self.source_fingerprint}@{offset}/{total_slots}"
            ),
            num_slots=total_slots,
            dst=remap(self.dst),
            src0=remap(self.src0),
            src1=remap(self.src1),
            in_slot_per_bit=remap(self.in_slot_per_bit),
            out_slot_per_bit=remap(self.out_slot_per_bit),
        )

    def pad_rows(self, max_rows: int) -> "LoweredProgram":
        """Widen the row axis to ``max_rows`` with no-op pad rows (write 0 to
        the null register, mask 0).  Needed before concatenating programs
        whose elements have different row widths."""
        if max_rows < self.max_rows:
            raise ValueError(
                f"cannot shrink row axis {self.max_rows} -> {max_rows}"
            )
        if max_rows == self.max_rows:
            return self
        extra = max_rows - self.max_rows
        null = self.null_slot

        def pad(tbl: np.ndarray, value) -> np.ndarray:
            return np.pad(tbl, ((0, 0), (0, extra)), constant_values=value)

        return dataclasses.replace(
            self,
            source_fingerprint=f"{self.source_fingerprint}|rows{max_rows}",
            opcode=pad(self.opcode, SHR_AND_IMM),
            dst=pad(self.dst, null),
            src0=pad(self.src0, null),
            src1=pad(self.src1, null),
            imm0=pad(self.imm0, U32(0)),
            imm1=pad(self.imm1, U32(0)),
            mask=pad(self.mask, U32(0)),
            first_write=pad(self.first_write, 1),
        )

    def used_opcodes(self) -> tuple[int, ...]:
        """Dense opcodes actually present (pads are SHR_AND; always included
        so padded rows evaluate)."""
        present = set(np.unique(self.opcode).tolist())
        present.add(SHR_AND_IMM)
        return tuple(sorted(present))

    def opcode_runs(
        self, max_variants: int = 3
    ) -> tuple[tuple[int, int, tuple[int, ...]], ...]:
        """Opcode-homogeneous element runs for narrowed-ALU execution.

        Returns ``(start_element, stop_element, used_opcodes)`` triples
        covering ``[0, num_elements)`` in order.  Executors evaluate each run
        with an ALU narrowed to that run's opcodes, killing the
        branchless-select overhead of materialising all six variants per row
        (the op-table scan's dominant cost for single-opcode elements, which
        is what the compiler emits).  Elements carrying pad rows include
        ``SHR_AND_IMM`` (the pad opcode) so padded rows still evaluate.

        Consecutive elements coalesce greedily while the merged opcode set
        stays within ``max_variants`` — the select chain stays short while
        the dispatch/compile count stays bounded (a compiled BNN alternates
        marshal/ADD elements; exact runs would mean one dispatch per
        element).  Falls back to one whole-table run when ``opcode_counts``
        is absent.
        """
        if self.opcode_counts is None:
            return ((0, self.num_elements, self.used_opcodes()),)
        has_pad = self.rows_per_element < self.max_rows
        runs: list[tuple[int, int, tuple[int, ...]]] = []
        start = 0
        cur: frozenset[int] | None = None
        for e in range(self.num_elements):
            used = frozenset(np.nonzero(self.opcode_counts[e])[0].tolist())
            if has_pad[e] or not used:
                used |= {SHR_AND_IMM}
            if cur is None:
                cur, start = used, e
            elif not (used <= cur) and len(cur | used) > max_variants:
                runs.append((start, e, tuple(sorted(cur))))
                cur, start = used, e
            else:
                cur = cur | used
        if cur is not None:
            runs.append((start, self.num_elements, tuple(sorted(cur))))
        return tuple(runs)

    def summary(self) -> str:
        return (
            f"lowered[{self.chip_name}]: elements={self.num_elements} "
            f"ops={self.num_ops} max_rows={self.max_rows} "
            f"regs={self.num_regs} io={self.input_bits}b->{self.output_bits}b"
        )


# ---------------------------------------------------------------------------
# Stacked execution plans (scan-over-hops / scan-over-layers)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class StackedHops:
    """Fabric-hop tables stacked on a leading hop axis.

    The executor runs every hop on one register file, one ``optable_run``
    per hop over this stack's equal-shaped planes
    (``executor.run_hops_scanned``) — the scan-over-layers idiom applied to
    switch chains.  Hops shorter than ``elements_per_hop`` are element-padded with whole
    no-op elements (every row the standard pad row: ``SHR_AND`` writing 0 to
    the null register), so padding can never change results, only waste
    lanes.  Built by :func:`stack_hops`; ``None`` from there means the hop
    shapes genuinely differ and callers must fall back to unrolled dispatch.
    """

    fingerprint: str
    num_hops: int
    elements_per_hop: int        # padded per-hop element count
    num_regs: int
    used: tuple[int, ...]        # union of per-hop used opcodes (+ pad op)

    # (num_hops, elements_per_hop, max_rows) tables.
    opcode: np.ndarray           # int32
    dst: np.ndarray              # int32
    src0: np.ndarray             # int32
    src1: np.ndarray             # int32
    imm0: np.ndarray             # uint32
    imm1: np.ndarray             # uint32
    mask: np.ndarray             # uint32
    first_write: np.ndarray      # int32


def stack_hops(hops: "list[LoweredProgram]") -> StackedHops | None:
    """Stack fabric-hop table slices into one scan-compatible plan.

    Returns ``None`` when the hops cannot share one compiled body: different
    row widths or different register files (never the case for
    ``slice_elements`` views of one program, always the case for slices of
    *different* programs).  Differing element counts (the last hop of a
    partition is short) are fine — short hops are padded with no-op
    elements.
    """
    if not hops:
        return None
    head = hops[0]
    if any(
        h.max_rows != head.max_rows or h.num_regs != head.num_regs
        for h in hops
    ):
        return None
    e_pad = max(h.num_elements for h in hops)
    null = head.null_slot
    pads = {
        "opcode": (np.int32, SHR_AND_IMM),
        "dst": (np.int32, null),
        "src0": (np.int32, null),
        "src1": (np.int32, null),
        "imm0": (np.uint32, 0),
        "imm1": (np.uint32, 0),
        "mask": (np.uint32, 0),
        "first_write": (np.int32, 1),
    }
    stacked: dict[str, np.ndarray] = {}
    for name, (dtype, fill) in pads.items():
        planes = []
        for h in hops:
            a = np.asarray(getattr(h, name), dtype)
            short = e_pad - a.shape[0]
            if short:
                a = np.concatenate(
                    [a, np.full((short, a.shape[1]), fill, dtype)]
                )
            planes.append(a)
        stacked[name] = np.stack(planes)
    used: set[int] = {SHR_AND_IMM}  # pad elements/rows always evaluate
    for h in hops:
        used.update(h.used_opcodes())
    return StackedHops(
        fingerprint="stack(" + "+".join(h.fingerprint() for h in hops) + ")",
        num_hops=len(hops),
        elements_per_hop=e_pad,
        num_regs=head.num_regs,
        used=tuple(sorted(used)),
        **stacked,
    )


@dataclasses.dataclass(frozen=True, eq=False)
class StackedPackedLayers:
    """A :class:`PackedProgram` with every layer padded to common shapes and
    stacked on a leading layer axis — the packed backend's scan plan.

    Padding is inert by construction: pad neurons carry an all-zero mask and
    a never-reachable threshold (``0xFFFFFFFF`` agreements, far above the
    ``32 * n_words`` maximum), so their output bits are always 0; pad input
    bits scatter a guaranteed-zero bit into word 0 (the carried bit vector
    is zero beyond every layer's true width).  Built by
    :func:`stack_packed_layers`.
    """

    num_layers: int
    max_bits: int                # carried bit-vector width (>= every n_in/n_out)
    max_words: int
    max_out: int
    input_bits: int
    output_bits: int

    # (num_layers, ...) stacked layer parameters.
    weights: np.ndarray          # (L, max_out, max_words) uint32
    thresholds: np.ndarray       # (L, max_out) uint32
    mask: np.ndarray             # (L, max_out, max_words) uint32
    in_word: np.ndarray          # (L, max_bits) int32
    in_shift: np.ndarray         # (L, max_bits) uint32


def stack_packed_layers(pp: PackedProgram) -> StackedPackedLayers:
    """Pad + stack a packed program's layers for the scan-over-layers
    executor (``executor._packed_scan_fn``)."""
    layers = pp.layers
    max_out = max(pl.n_out for pl in layers)
    max_words = max(pl.n_words for pl in layers)
    max_bits = max(
        max(pl.n_in for pl in layers), max(pl.n_out for pl in layers)
    )
    L = len(layers)
    weights = np.zeros((L, max_out, max_words), np.uint32)
    mask = np.zeros((L, max_out, max_words), np.uint32)
    # Pad neurons never fire: agreement counts are bounded by 32*max_words.
    thresholds = np.full((L, max_out), FULL, np.uint32)
    in_word = np.zeros((L, max_bits), np.int32)
    in_shift = np.zeros((L, max_bits), np.uint32)
    for li, pl in enumerate(layers):
        weights[li, : pl.n_out, : pl.n_words] = pl.weights
        mask[li, : pl.n_out, : pl.n_words] = pl.mask
        thresholds[li, : pl.n_out] = pl.thresholds
        in_word[li, : pl.n_in] = pl.in_word
        in_shift[li, : pl.n_in] = pl.in_shift
    return StackedPackedLayers(
        num_layers=L,
        max_bits=max_bits,
        max_words=max_words,
        max_out=max_out,
        input_bits=pp.input_bits,
        output_bits=pp.output_bits,
        weights=weights,
        thresholds=thresholds,
        mask=mask,
        in_word=in_word,
        in_shift=in_shift,
    )


# ---------------------------------------------------------------------------
# Interleaved multi-tenant merge planning
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class InterleavedTables:
    """Op-tables for N relocated programs interleaved onto shared stages.

    Merged stage ``e`` carries element ``e`` of *every* part at once — the
    multi-tenant analogue of RMT packing several match-action entries into
    one physical stage — so the merged element count is the *deepest* part,
    not the sum of parts.  ``row_part``/``row_src_elem``/``row_src_row``
    record where each merged row came from (-1 for pad rows), which is what
    makes the merge auditable: un-interleaving by provenance must reproduce
    every part's tables exactly (property-tested in
    ``tests/test_multitenant.py``).  Built by :func:`interleave_tables`.
    """

    opcode: np.ndarray           # (max_elements, peak_rows) int32
    dst: np.ndarray              # int32
    src0: np.ndarray             # int32
    src1: np.ndarray             # int32
    imm0: np.ndarray             # uint32
    imm1: np.ndarray             # uint32
    mask: np.ndarray             # uint32
    first_write: np.ndarray      # int32
    rows_per_element: np.ndarray  # (max_elements,) int32 true rows per stage
    element_stages: tuple[str, ...]
    num_ops: int
    opcode_counts: np.ndarray | None
    row_part: np.ndarray         # (max_elements, peak_rows) int32, -1 = pad
    row_src_elem: np.ndarray     # source element within the part, -1 = pad
    row_src_row: np.ndarray      # source row within that element, -1 = pad


def peak_stage_rows(lowereds: Sequence[LoweredProgram]) -> int:
    """Widest shared stage of an element-interleaved merge: the max over
    stages of the summed true row counts of every program's element at that
    stage.  This is the quantity admission control holds against
    ``ChipSpec.max_parallel_ops`` — the per-stage ALU budget all tenants
    share once their elements occupy the same physical stage."""
    if not lowereds:
        return 0
    max_e = max(lp.num_elements for lp in lowereds)
    totals = np.zeros(max_e, np.int64)
    for lp in lowereds:
        totals[: lp.num_elements] += lp.rows_per_element
    return max(1, int(totals.max()))


def interleave_tables(parts: Sequence[LoweredProgram]) -> InterleavedTables:
    """Interleave relocated programs' elements onto shared physical stages.

    Merged stage ``e`` concatenates the true rows of every part's element
    ``e`` (parts shallower than ``e`` contribute nothing), stably re-sorts
    the combined rows by dense opcode — preserving the opcode-run coalescing
    contract ``lower_program`` established per program — and pads the stage
    to the global peak row count.  The re-sort is safe: every row reads the
    register state *entering* the stage, parts write disjoint slot windows,
    and the stable sort keeps each part's FOLD first-write -> continuation
    order intact (all FOLD micro-rows share opcode ``SHL_IMM``), which the
    CUDA kernel's sequential write pass relies on.

    Parts must already share one register file: callers relocate each onto
    a disjoint window via ``with_slot_window`` first.
    """
    if not parts:
        raise ValueError("interleave_tables needs at least one program")
    num_slots = parts[0].num_slots
    if any(p.num_slots != num_slots for p in parts):
        raise ValueError(
            "interleave parts must share one relocated register file "
            "(apply with_slot_window onto disjoint windows first)"
        )
    max_e = max(p.num_elements for p in parts)
    peak = peak_stage_rows(parts)
    null = num_slots
    specs = (
        ("opcode", np.int32, SHR_AND_IMM),
        ("dst", np.int32, null),
        ("src0", np.int32, null),
        ("src1", np.int32, null),
        ("imm0", np.uint32, 0),
        ("imm1", np.uint32, 0),
        ("mask", np.uint32, 0),
        ("first_write", np.int32, 1),
    )
    tables = {n: np.full((max_e, peak), fill, dt) for n, dt, fill in specs}
    row_part = np.full((max_e, peak), -1, np.int32)
    row_src_elem = np.full((max_e, peak), -1, np.int32)
    row_src_row = np.full((max_e, peak), -1, np.int32)
    rows_per = np.zeros(max_e, np.int32)
    have_counts = all(p.opcode_counts is not None for p in parts)
    counts = (
        np.zeros((max_e, NUM_DENSE_OPCODES), np.int32) if have_counts else None
    )
    stages: list[str] = []
    for e in range(max_e):
        cols: dict[str, list[np.ndarray]] = {n: [] for n, _, _ in specs}
        prov_p: list[np.ndarray] = []
        prov_r: list[np.ndarray] = []
        names: list[str] = []
        for pi, p in enumerate(parts):
            if e >= p.num_elements:
                continue
            if counts is not None:
                counts[e] += p.opcode_counts[e]
            names.append(f"p{pi}:{p.element_stages[e]}")
            r = int(p.rows_per_element[e])
            if r == 0:
                continue
            for n, _, _ in specs:
                cols[n].append(getattr(p, n)[e, :r])
            prov_p.append(np.full(r, pi, np.int32))
            prov_r.append(np.arange(r, dtype=np.int32))
        stages.append("+".join(names) if names else "pad")
        if not prov_p:
            continue
        order = np.argsort(np.concatenate(cols["opcode"]), kind="stable")
        k = order.size
        rows_per[e] = k
        for n, _, _ in specs:
            tables[n][e, :k] = np.concatenate(cols[n])[order]
        row_part[e, :k] = np.concatenate(prov_p)[order]
        row_src_elem[e, :k] = e
        row_src_row[e, :k] = np.concatenate(prov_r)[order]
    return InterleavedTables(
        rows_per_element=rows_per,
        element_stages=tuple(stages),
        num_ops=int(rows_per.sum()),
        opcode_counts=counts,
        row_part=row_part,
        row_src_elem=row_src_elem,
        row_src_row=row_src_row,
        **tables,
    )


# ---------------------------------------------------------------------------
# Liveness + slot renaming
# ---------------------------------------------------------------------------

def _liveness(prog: PipelineProgram) -> tuple[dict[int, int], dict[int, int]]:
    """Per-field ``def`` element (-1 for inputs) and last-use element
    (``num_elements`` for outputs — the deparser reads them)."""
    def_elem: dict[int, int] = {f.fid: -1 for f in prog.input_fields}
    last_use: dict[int, int] = {}
    for e, el in enumerate(prog.elements):
        for op in el.ops:
            for s in op.srcs:
                last_use[s.fid] = e
            def_elem.setdefault(op.dst.fid, e)
    for fid, d in def_elem.items():
        last_use.setdefault(fid, d)  # never-read values die where they're born
    for f in prog.output_fields:
        last_use[f.fid] = len(prog.elements)
    return def_elem, last_use


class _SlotFile:
    """Recycling slot allocator.  ``assigned`` records every fid's slot
    permanently (a fid occupies exactly one slot for its whole lifetime);
    ``release`` only returns the slot to the free pool for a *later* fid."""

    def __init__(self) -> None:
        self._free: list[int] = []
        self._next = 0
        self._live: set[int] = set()
        self.assigned: dict[int, int] = {}

    def alloc(self, fid: int) -> int:
        if self._free:
            self._free.sort()
            s = self._free.pop(0)
        else:
            s = self._next
            self._next += 1
        self.assigned[fid] = s
        self._live.add(fid)
        return s

    def release(self, fid: int) -> None:
        if fid in self._live:
            self._live.discard(fid)
            self._free.append(self.assigned[fid])

    @property
    def high_water(self) -> int:
        return self._next


def _rename_fields(prog: PipelineProgram) -> tuple[dict[int, int], int]:
    """Liveness-driven rename: fid -> compact executor slot."""
    def_elem, last_use = _liveness(prog)
    # Group deaths by element so each element's pass is O(deaths), not O(fields).
    deaths: dict[int, list[int]] = {}
    for fid, lu in last_use.items():
        deaths.setdefault(lu, []).append(fid)

    slots = _SlotFile()
    for f in prog.input_fields:
        slots.alloc(f.fid)
    for e, el in enumerate(prog.elements):
        # Reads of element e happen before its writes (read-before-write), so
        # anything last *read* at or before e frees before e's dsts allocate.
        # A never-read value written at e (last_use == def == e) must survive
        # its own write; it frees one element later.
        for fid in deaths.get(e, ()):
            if def_elem.get(fid, -1) < e:
                slots.release(fid)
            else:
                deaths.setdefault(e + 1, []).append(fid)
        for op in el.ops:
            if op.dst.fid not in slots.assigned:
                slots.alloc(op.dst.fid)
    return slots.assigned, slots.high_water


# ---------------------------------------------------------------------------
# Lowering proper
# ---------------------------------------------------------------------------

def _lower_op(op: Op, slot: dict[int, int], null: int) -> list[tuple]:
    """One front-end op -> dense rows (opcode, dst, s0, s1, i0, i1, mask, first)."""
    m = _mask(op.dst.width)
    d = slot.get(op.dst.fid, op.dst.fid)

    def s(i: int) -> int:
        return slot.get(op.srcs[i].fid, op.srcs[i].fid)

    code = op.opcode
    if code == OpCode.COPY:
        return [(XOR_IMM, d, s(0), null, U32(0), U32(0), m, 1)]
    if code == OpCode.XNOR_IMM:
        return [(XOR_IMM, d, s(0), null, ~U32(op.imm[0]), U32(0), m, 1)]
    if code == OpCode.AND_IMM:
        return [(SHR_AND_IMM, d, s(0), null, U32(0), U32(op.imm[0]), m, 1)]
    if code == OpCode.SHR_AND_IMM:
        return [(SHR_AND_IMM, d, s(0), null, U32(op.imm[0]), U32(op.imm[1]), m, 1)]
    if code == OpCode.ADD:
        return [(ADD, d, s(0), s(1), U32(0), U32(0), m, 1)]
    if code == OpCode.GE_IMM:
        return [(GE_IMM, d, s(0), null, U32(op.imm[0]), U32(0), m, 1)]
    if code == OpCode.POPCNT:
        return [(POPCNT, d, s(0), null, U32(0), U32(0), m, 1)]
    if code == OpCode.FOLD:
        # One SHL micro-row per sign bit; rows after the first accumulate
        # (additive == OR: each row deposits a disjoint bit).
        return [
            (SHL_IMM, d, s(k), null, U32(k), U32(0), m, 1 if k == 0 else 0)
            for k in range(len(op.srcs))
        ]
    raise ValueError(f"unknown opcode {code}")  # pragma: no cover


def lower_program(prog: PipelineProgram, compact: bool = True) -> LoweredProgram:
    """Lower ``prog`` to dense op-tables.

    ``compact=True`` (default) renames SSA field ids onto a recycled slot
    file; ``compact=False`` keeps slot == fid (debugging aid — bitwise
    identical results, much larger register file).
    """
    # The compaction mode changes slot numbering, so it is part of the
    # lowered identity (executor caches are keyed on this fingerprint).
    fingerprint = f"{prog.fingerprint()}:{'compact' if compact else 'full'}"
    num_el = len(prog.elements)

    if compact:
        slot_map, num_slots = _rename_fields(prog)
    else:
        slot_map, num_slots = {}, prog.num_fields
    null = num_slots

    per_element_rows: list[list[tuple]] = []
    stages: list[str] = []
    opcode_counts = np.zeros((num_el, NUM_DENSE_OPCODES), np.int32)
    for e, el in enumerate(prog.elements):
        rows: list[tuple] = []
        for op in el.ops:
            rows.extend(_lower_op(op, slot_map, null))
        # Opcode-sorted segments: within an element every row reads the
        # *incoming* register state and writes its own destination, so row
        # order is free — except FOLD continuation rows (first_write=0),
        # which must follow their first_write row on the sequential-write
        # kernel path.  All of a FOLD's micro-rows share opcode SHL and
        # Python's sort is stable, so sorting by opcode preserves that order
        # while giving opcode_runs() homogeneous segments.
        rows.sort(key=lambda r: r[0])
        for r in rows:
            opcode_counts[e, r[0]] += 1
        per_element_rows.append(rows)
        stages.append(el.stage)

    num_ops = sum(len(r) for r in per_element_rows)
    max_rows = max((len(r) for r in per_element_rows), default=1)
    max_rows = max(max_rows, 1)
    pad_row = (SHR_AND_IMM, null, null, null, U32(0), U32(0), U32(0), 1)

    def table(idx: int, dtype) -> np.ndarray:
        out = np.empty((num_el, max_rows), dtype=dtype)
        for e, rows in enumerate(per_element_rows):
            padded = rows + [pad_row] * (max_rows - len(rows))
            out[e, :] = [r[idx] for r in padded]
        return out

    # Parser/deparser bit tables.
    in_slot, in_shift = [], []
    for f in prog.input_fields:
        s = slot_map.get(f.fid, f.fid)
        in_slot.extend([s] * f.width)
        in_shift.extend(range(f.width))
    out_slot, out_shift = [], []
    for f in prog.output_fields:
        s = slot_map.get(f.fid, f.fid)
        out_slot.extend([s] * f.width)
        out_shift.extend(range(f.width))
    if len(in_slot) != prog.input_bits or len(out_slot) != prog.output_bits:
        raise AssertionError("parser/deparser table width mismatch")

    return LoweredProgram(
        source_fingerprint=fingerprint,
        chip_name=prog.chip.name,
        num_slots=num_slots,
        input_bits=prog.input_bits,
        output_bits=prog.output_bits,
        opcode=table(0, np.int32),
        dst=table(1, np.int32),
        src0=table(2, np.int32),
        src1=table(3, np.int32),
        imm0=table(4, np.uint32),
        imm1=table(5, np.uint32),
        mask=table(6, np.uint32),
        first_write=table(7, np.int32),
        rows_per_element=np.array(
            [len(r) for r in per_element_rows], np.int32
        ),
        element_stages=tuple(stages),
        num_ops=num_ops,
        in_slot_per_bit=np.array(in_slot, np.int32),
        in_shift_per_bit=np.array(in_shift, np.uint32),
        out_slot_per_bit=np.array(out_slot, np.int32),
        out_shift_per_bit=np.array(out_shift, np.uint32),
        opcode_counts=opcode_counts,
        packed=_packed_program(prog),
    )
