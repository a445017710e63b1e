"""RMT switching-chip model: instruction set, elements, pipeline programs.

The instruction set is restricted to what the paper says an RMT action unit
supports: bitwise logic, shifts, and simple arithmetic (increment/sum), plus
a compare-against-immediate (the SIGN step's ``>= N/2`` test, which RMT
expresses as a match/range-compare) and FOLD (deposit-bit placement — RMT
action units provide deposit-field/funnel-shift, which is what the paper's
folding step uses to concatenate the per-neuron sign bits into the Y vector).

An :class:`Element` models one match-action stage: every op in an element
reads the *incoming* PHV and writes a distinct destination field
(read-before-write, one write per field, parallel-op budget 224 at 32-bit ALU
granularity).
"""
from __future__ import annotations

import dataclasses
import enum
import hashlib
import math
from typing import Sequence

from repro_torch.core.phv import MAX_FIELDS, PHV_BITS, Field


class OpCode(enum.Enum):
    COPY = "copy"            # dst = src0
    XNOR_IMM = "xnor_imm"    # dst = ~(src0 ^ imm)           (weights as immediates)
    AND_IMM = "and_imm"      # dst = src0 & imm
    SHR_AND_IMM = "shr_and"  # dst = (src0 >> imm0) & imm1   (HAKMEM level op)
    ADD = "add"              # dst = src0 + src1
    GE_IMM = "ge_imm"        # dst = (src0 >= imm) ? 1 : 0   (SIGN)
    FOLD = "fold"            # dst = sum_k (src_k << k)      (deposit sign bits)
    POPCNT = "popcnt"        # dst = popcount(src0)          (§3 ablation only)


@dataclasses.dataclass(frozen=True)
class Op:
    opcode: OpCode
    dst: Field
    srcs: tuple[Field, ...] = ()
    imm: tuple[int, ...] = ()

    def alu_words(self) -> int:
        """ALU lanes consumed, at 32-bit granularity (sub-word fields share)."""
        return 1


@dataclasses.dataclass
class Element:
    """One pipeline stage: a set of parallel ops."""

    stage: str                      # which of the paper's 5 steps this belongs to
    ops: list[Op] = dataclasses.field(default_factory=list)

    def add(self, op: Op) -> None:
        self.ops.append(op)

    def validate(self, max_parallel_ops: int = MAX_FIELDS) -> None:
        dsts = [op.dst.fid for op in self.ops]
        if len(dsts) != len(set(dsts)):
            raise ProgramConstraintError(
                f"element '{self.stage}': field written more than once"
            )
        # ALU budget at word granularity: sub-word fields written by ops of the
        # same stage pack into shared 32-bit lanes (RMT SIMD-in-word), which is
        # what lets 128 16-bit neurons XNOR in one element (Table 1, N=16).
        bits = sum(op.dst.width for op in self.ops)
        lanes = math.ceil(bits / 32)
        if lanes > max_parallel_ops:
            raise ProgramConstraintError(
                f"element '{self.stage}': {lanes} ALU lanes > budget "
                f"{max_parallel_ops}"
            )


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Hardware constants of the target switching chip (RMT defaults)."""

    phv_bits: int = PHV_BITS
    num_elements: int = 32
    max_parallel_ops: int = MAX_FIELDS
    packets_per_second: float = 960e6
    native_popcnt: bool = False   # §3 ablation: 32-bit POPCNT primitive
    name: str = "rmt"

    @property
    def max_activation_bits(self) -> int:
        # Duplication halves the usable PHV; a native POPCNT removes the
        # duplication step and doubles it back (paper §3).
        return self.phv_bits if self.native_popcnt else self.phv_bits // 2


RMT = ChipSpec()
RMT_NATIVE_POPCNT = ChipSpec(native_popcnt=True, name="rmt+popcnt32")


@dataclasses.dataclass
class LayerPlan:
    """Compiler bookkeeping for one BNN layer (possibly several neuron groups)."""

    layer_index: int
    n_in: int
    n_out: int
    parallel: int           # neurons per group
    groups: int             # ceil(n_out / parallel)
    elements_per_group: int
    element_range: tuple[int, int]  # [start, end) indices into program.elements


@dataclasses.dataclass(eq=False)  # identity eq/hash: programs are cache keys
class PipelineProgram:
    """A compiled N2Net program: a straight-line sequence of elements.

    Programs are built by the compiler and treated as **structurally
    immutable** from the first time they are fingerprinted, executed, or
    lowered — the fingerprint is memoized then, and the jit/lowering caches
    it keys would go stale under later mutation.  Mutate freely only before
    first use.
    """

    chip: ChipSpec
    elements: list[Element]
    num_fields: int                      # interpreter register-file size
    input_fields: list[Field]            # packed input activation words
    input_bits: int
    output_fields: list[Field]           # packed output Y words
    output_bits: int
    layer_plans: list[LayerPlan]
    peak_phv_bits: int
    # Optional per-layer (weight_bits (n_out, n_in) uint8, thresholds (n_out,)
    # int32) metadata the compiler attaches so lowering can build a bit-packed
    # execution plan (``dataplane.lowering.PackedProgram``).  Purely derived
    # from data already hashed by ``fingerprint()`` (XNOR/GE immediates), so
    # it does not participate in the hash.
    packed_layers: tuple[tuple, ...] | None = None

    @property
    def num_elements(self) -> int:
        return len(self.elements)

    @property
    def passes(self) -> int:
        """Pipeline passes needed on this program's chip — i.e. ``passes - 1``
        recirculations; a program that fits runs in 1 pass (0 recirculations).
        """
        return max(1, math.ceil(self.num_elements / self.chip.num_elements))

    def fingerprint(self) -> str:
        """Structural content hash of the program.

        Two programs with identical execution semantics (same ops over the
        same fields, same I/O layout, same chip) share a fingerprint even if
        they are distinct Python objects.  Used to key jit/lowering caches —
        unlike ``id()``, a fingerprint can never alias a dead program's key,
        and recompiling an identical program hits the cache.  Memoized on
        first call (O(num_ops) once, O(1) on the hot dispatch path); see the
        class docstring for the resulting immutability contract.
        """
        memo = self.__dict__.get("_fingerprint_memo")
        if memo is not None:
            return memo
        h = hashlib.blake2b(digest_size=16)

        def put(*items) -> None:
            h.update(repr(items).encode())

        put(
            self.chip.phv_bits,
            self.chip.num_elements,
            self.chip.max_parallel_ops,
            self.chip.native_popcnt,
            self.num_fields,
            self.input_bits,
            self.output_bits,
        )
        put(tuple((f.fid, f.width) for f in self.input_fields))
        put(tuple((f.fid, f.width) for f in self.output_fields))
        for el in self.elements:
            for op in el.ops:
                put(
                    op.opcode.value,
                    op.dst.fid,
                    op.dst.width,
                    tuple(s.fid for s in op.srcs),
                    op.imm,
                )
            put("|")  # element boundary
        memo = h.hexdigest()
        self.__dict__["_fingerprint_memo"] = memo
        return memo

    def lower(self, compact: bool = True):
        """Lower to a dense op-table for the fused dataplane executor.

        Returns a :class:`repro_torch.dataplane.lowering.LoweredProgram`.  Imported
        lazily so ``core`` stays dependency-free of the dataplane subsystem.
        """
        from repro_torch.dataplane.lowering import lower_program

        return lower_program(self, compact=compact)

    def validate(self) -> None:
        for el in self.elements:
            el.validate(self.chip.max_parallel_ops)
        if self.peak_phv_bits > self.chip.phv_bits:
            raise ProgramConstraintError(
                f"peak PHV usage {self.peak_phv_bits}b exceeds {self.chip.phv_bits}b"
            )

    def summary(self) -> str:
        lines = [
            f"chip={self.chip.name} elements={self.num_elements} "
            f"passes={self.passes} peak_phv_bits={self.peak_phv_bits}",
        ]
        for lp in self.layer_plans:
            lines.append(
                f"  layer {lp.layer_index}: {lp.n_in}->{lp.n_out} "
                f"parallel={lp.parallel} groups={lp.groups} "
                f"elements/group={lp.elements_per_group}"
            )
        return "\n".join(lines)


class ProgramConstraintError(Exception):
    """A compiled program violates a chip constraint."""


def elements_for_neuron_group(n_act: int, parallel: int, chip: ChipSpec = RMT) -> int:
    """The paper's element-cost model for one group of neurons.

    Standard RMT (no POPCNT primitive):
        replication(1) + XNOR&dup(1) + POPCNT(2*log2(N)) + SIGN(1)
        + folding(1 iff parallel > 1)
    = ``3 + 2*log2(N)`` for a single neuron (paper text) and Table 1's
      12/14/16/18/20/22/24/25 for N = 16..2048 with parallelism.

    With a native 32-bit POPCNT (§3): replication(1) + XNOR(1, no dup)
    + POPCNT(1) + cross-word ADD tree(log2(ceil(N/32))) + SIGN(1)
    + folding(1 iff parallel > 1) — the paper's 5..10 range.
    """
    if n_act < 2 or n_act & (n_act - 1):
        raise ValueError(f"activation width must be a power of two >= 2, got {n_act}")
    fold = 1 if parallel > 1 else 0
    if chip.native_popcnt:
        words = math.ceil(n_act / 32)
        add_levels = int(math.log2(words)) if words > 1 else 0
        return 1 + 1 + 1 + add_levels + 1 + fold
    return 3 + 2 * int(math.log2(n_act)) + fold


def max_parallel_neurons(n_act: int, chip: ChipSpec = RMT) -> int:
    """Table 1, row 'Parallel neur. (max)': PHV-capacity-derived parallelism."""
    return max(1, chip.max_activation_bits // n_act)
