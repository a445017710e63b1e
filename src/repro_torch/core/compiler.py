"""The N2Net compiler: BNN weights -> RMT pipeline program.

Implements the paper's five-step schedule per neuron group:

  1. *Replication* — the layer's activation vector is copied once per neuron
     processed in parallel (1 element).
  2. *XNOR and Duplication* — each copy is XNOR-ed against that neuron's
     weight bits (weights are immediates, pre-configured like BrainWave);
     the result is written **twice** because the HAKMEM POPCNT needs two
     operand sets and an element applies one op per field (1 element).
     With a native POPCNT primitive (§3 ablation) duplication is skipped.
  3. *POPCNT* — HAKMEM tree: per level, element A marshals the two operand
     sets (shift/AND on the duplicated copies), element B sums and
     re-duplicates; cross-word levels pair up per-word counts the same way
     (2 elements per level, ``log2(N)`` levels).  Native-POPCNT path: one
     POPCNT element + an ADD tree (1 element per level).
  4. *SIGN* — compare the count against ``ceil(n_in/2)`` (1 element).
  5. *Folding* — deposit the parallel neurons' sign bits into the packed
     Y vector (1 element, only when parallel > 1).

Cost identity (validated in tests against ``pipeline.elements_for_neuron_group``
and the paper's Table 1): for power-of-two N and a single group,
``elements = 3 + 2*log2(N) + (parallel > 1)``.

PHV accounting uses free-before-alloc overlay (RMT elements read the whole
incoming PHV before writing, so a stage's outputs may land in containers its
inputs occupied).  This reproduces the paper's bound exactly: the duplication
stage holds ``2*P*N`` live bits, hence max activation length 2048 on a 512B
PHV (4096 with native POPCNT).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core import bnn
from repro_torch.core.phv import PhvAllocator
from repro_torch.core.pipeline import (
    RMT,
    ChipSpec,
    Element,
    LayerPlan,
    Op,
    OpCode,
    PipelineProgram,
    ProgramConstraintError,
)

_HAKMEM_MASKS = (0x55555555, 0x33333333, 0x0F0F0F0F, 0x00FF00FF, 0x0000FFFF)


@dataclasses.dataclass(frozen=True)
class _FieldRef:
    """A live field plus the bit-range of the logical vector it carries."""

    field: object          # phv.Field
    offset: int            # bit offset into the logical vector
    width: int


def _chunk_layout(n_bits: int) -> list[tuple[int, int]]:
    """Split an n-bit vector into (offset, width<=32) field chunks."""
    out, off = [], 0
    while off < n_bits:
        w = min(32, n_bits - off)
        out.append((off, w))
        off += w
    return out


def _imm_from_bits(bits: np.ndarray) -> int:
    """Little-endian bits -> immediate value."""
    return int(sum(int(b) << i for i, b in enumerate(bits)))


def _normalize_thresholds(
    weights: Sequence[np.ndarray], thresholds: Sequence | None
) -> list[np.ndarray]:
    """Per-layer ``(n_out,)`` int32 SIGN thresholds, defaults filled in.

    A neuron fires iff its XNOR-popcount agreement is ``>= thr``; the default
    ``ceil(n_in/2)`` is the paper's SIGN (``sum >= 0`` in ±1 arithmetic).
    """
    if thresholds is None:
        thresholds = [None] * len(weights)
    if len(thresholds) != len(weights):
        raise ValueError(
            f"{len(thresholds)} threshold entries for {len(weights)} layers"
        )
    out = []
    for li, (w, thr) in enumerate(zip(weights, thresholds)):
        n_out, n_in = w.shape
        if thr is None:
            vec = np.full(n_out, (n_in + 1) // 2, np.int32)
        else:
            vec = np.broadcast_to(
                np.asarray(thr, np.int64), (n_out,)
            ).astype(np.int32)
            if vec.size and (vec.min() < 0 or vec.max() > n_in + 1):
                raise ValueError(
                    f"layer {li}: thresholds must lie in [0, {n_in + 1}], "
                    f"got [{vec.min()}, {vec.max()}]"
                )
        out.append(vec)
    return out


class Compiler:
    """Compiles a fully-connected BNN into a :class:`PipelineProgram`."""

    def __init__(self, chip: ChipSpec = RMT):
        self.chip = chip
        self.alloc = PhvAllocator(chip.phv_bits)
        self.elements: list[Element] = []
        self.layer_plans: list[LayerPlan] = []
        self._thresholds: list[np.ndarray] = []

    # -- public -------------------------------------------------------------

    def compile(
        self,
        weights: Sequence[np.ndarray],
        thresholds: Sequence | None = None,
    ) -> PipelineProgram:
        """Compile weight bit-matrices; ``thresholds`` optionally overrides
        the SIGN step's per-neuron fire threshold (default ``ceil(n_in/2)``)
        — one entry per layer, each ``None``, a scalar, or ``(n_out,)`` ints
        in ``[0, n_in + 1]``."""
        weights = [np.asarray(w, dtype=np.int64) for w in weights]
        for w in weights:
            if w.ndim != 2:
                raise ValueError("each weight matrix must be (n_out, n_in)")
            if not np.isin(w, (0, 1)).all():
                raise ValueError("weights must be {0,1} bit matrices")
        self._thresholds = _normalize_thresholds(weights, thresholds)

        n_in = weights[0].shape[1]
        in_refs = [
            _FieldRef(self.alloc.alloc(f"x[{off}:{off + w}]", w), off, w)
            for off, w in _chunk_layout(n_in)
        ]
        input_fields = [r.field for r in in_refs]

        acts = in_refs
        for li, w in enumerate(weights):
            if w.shape[1] != sum(r.width for r in acts):
                raise ValueError(
                    f"layer {li}: weight fan-in {w.shape[1]} != activation "
                    f"bits {sum(r.width for r in acts)}"
                )
            acts = self._emit_layer(li, w, acts)

        prog = PipelineProgram(
            chip=self.chip,
            elements=self.elements,
            num_fields=self.alloc.num_fields_created,
            input_fields=input_fields,
            input_bits=n_in,
            output_fields=[r.field for r in acts],
            output_bits=sum(r.width for r in acts),
            layer_plans=self.layer_plans,
            peak_phv_bits=self.alloc.peak_live_bits,
            packed_layers=tuple(
                (w.astype(np.uint8), thr)
                for w, thr in zip(weights, self._thresholds)
            ),
        )
        prog.validate()
        return prog

    # -- internals ----------------------------------------------------------

    def _element(self, stage: str) -> Element:
        el = Element(stage=stage)
        self.elements.append(el)
        return el

    def _plan_parallel(self, n_act: int, remaining: int, extra_live: int) -> int:
        """How many neurons fit in one group given current PHV pressure.

        ``extra_live`` is what must stay resident besides this group's working
        set (layer input when more groups follow, accumulated Y bits, ...).
        The dup stage is the high-water mark: dup_factor * P * n_act bits,
        plus one sign bit per neuron.
        """
        dup = 1 if self.chip.native_popcnt else 2
        avail = self.chip.phv_bits - extra_live
        p = max(1, avail // (dup * n_act))
        return min(remaining, p)

    def _emit_layer(
        self, li: int, w: np.ndarray, in_refs: list[_FieldRef]
    ) -> list[_FieldRef]:
        n_out, n_in = w.shape
        out_refs: list[_FieldRef] = []
        done = 0
        groups = 0
        first_group_parallel = 0
        el_start = len(self.elements)

        while done < n_out:
            remaining = n_out - done
            produced_bits = sum(r.width for r in out_refs)
            # Input must survive this group's consumption unless this group
            # finishes the layer (free-at-last-use overlay): if freeing the
            # input lets the whole remainder fit one group, do that.
            p = self._plan_parallel(n_in, remaining, produced_bits)
            if p < remaining:  # not last group: input must stay resident
                p = self._plan_parallel(n_in, remaining, n_in + produced_bits)
            last_group = done + p >= n_out
            if groups == 0:
                first_group_parallel = p

            out_refs += self._emit_group(
                li, w[done : done + p], in_refs, done, last_group
            )
            done += p
            groups += 1

        self.layer_plans.append(
            LayerPlan(
                layer_index=li,
                n_in=n_in,
                n_out=n_out,
                parallel=first_group_parallel,
                groups=groups,
                elements_per_group=(len(self.elements) - el_start) // groups,
                element_range=(el_start, len(self.elements)),
            )
        )
        return out_refs

    def _emit_group(
        self,
        li: int,
        w_group: np.ndarray,
        in_refs: list[_FieldRef],
        neuron_base: int,
        last_group: bool,
    ) -> list[_FieldRef]:
        p, n_in = w_group.shape
        a = self.alloc
        name = f"L{li}g{neuron_base}"

        # ---- step 1: replication ------------------------------------------
        if last_group:
            a.free(r.field for r in in_refs)  # overlay: outputs may reuse input
        el = self._element("replication")
        repl = [
            [
                _FieldRef(a.alloc(f"{name}.r{j}.{r.offset}", r.width), r.offset, r.width)
                for r in in_refs
            ]
            for j in range(p)
        ]
        for j in range(p):
            for src, dst in zip(in_refs, repl[j]):
                el.add(Op(OpCode.COPY, dst.field, (src.field,)))

        # ---- step 2: XNOR (+ duplication) ---------------------------------
        a.free(f.field for row in repl for f in row)
        el = self._element("xnor_dup" if not self.chip.native_popcnt else "xnor")
        copies = 2 if not self.chip.native_popcnt else 1
        xn = [
            [
                [
                    _FieldRef(
                        a.alloc(f"{name}.x{j}c{c}.{r.offset}", r.width), r.offset, r.width
                    )
                    for r in in_refs
                ]
                for c in range(copies)
            ]
            for j in range(p)
        ]
        for j in range(p):
            for fi, r in enumerate(in_refs):
                imm = _imm_from_bits(w_group[j, r.offset : r.offset + r.width])
                for c in range(copies):
                    el.add(Op(OpCode.XNOR_IMM, xn[j][c][fi].field, (repl[j][fi].field,), (imm,)))

        # ---- step 3: POPCNT ------------------------------------------------
        if self.chip.native_popcnt:
            counts = self._emit_popcnt_native(name, p, xn)
        else:
            counts = self._emit_popcnt_hakmem(name, p, xn, in_refs)

        # ---- step 4: SIGN ---------------------------------------------------
        # Default: popcount >= ceil(n_in/2)  <=>  sum >= 0; learned per-neuron
        # thresholds (compile(..., thresholds=...)) override per SIGN imm.
        thr_vec = self._thresholds[li]
        a.free(counts)  # sign bits overlay the consumed count containers
        el = self._element("sign")
        signs = []
        for j in range(p):
            dst = a.alloc(f"{name}.s{j}", 1)
            thr = int(thr_vec[neuron_base + j])
            el.add(Op(OpCode.GE_IMM, dst, (counts[j],), (thr,)))
            signs.append(dst)

        # ---- step 5: folding -------------------------------------------------
        if p == 1:
            return [_FieldRef(signs[0], neuron_base, 1)]
        a.free(signs)
        el = self._element("folding")
        out: list[_FieldRef] = []
        for off in range(0, p, 32):
            chunk = signs[off : off + 32]
            dst = a.alloc(f"{name}.y{off}", len(chunk))
            el.add(Op(OpCode.FOLD, dst, tuple(chunk)))
            out.append(_FieldRef(dst, neuron_base + off, len(chunk)))
        return out

    def _emit_popcnt_hakmem(
        self, name: str, p: int, xn, in_refs: list[_FieldRef]
    ) -> list:
        """Paper POPCNT: per level, (marshal, sum+dup) element pairs.

        PHV overlay discipline: fields consumed by a level are freed *before*
        the level's outputs are allocated (read-before-write lets outputs land
        in the consumed containers), so the working set never exceeds the
        duplication stage's ``2*P*N`` bits.
        """
        a = self.alloc
        # cur[j] = (copyA_fields, copyB_fields) — per-word working counts.
        cur = [([r for r in xn[j][0]], [r for r in xn[j][1]]) for j in range(p)]
        max_w = max(r.width for r in in_refs)
        in_word_levels = max(1, math.ceil(math.log2(max_w))) if max_w > 1 else 0
        n_words = len(in_refs)
        cross_levels = max(0, math.ceil(math.log2(n_words))) if n_words > 1 else 0

        for lvl in range(in_word_levels):
            shift, mask = 1 << lvl, _HAKMEM_MASKS[lvl]
            # element A: marshal the two operand sets from the dup copies.
            active = [
                [fa.width > (1 << lvl) for fa in cur[j][0]] for j in range(p)
            ]
            a.free(
                f.field
                for j in range(p)
                for copy in cur[j]
                for f, act in zip(copy, active[j])
                if act
            )
            el_a = self._element(f"popcnt_l{lvl}a")
            nxt_a, nxt_b = [], []
            for j in range(p):
                ca, cb = cur[j]
                ra, rb = [], []
                for fa, fb, act in zip(ca, cb, active[j]):
                    if not act:  # field already fully counted; carried through
                        ra.append(fa)
                        rb.append(fb)
                        continue
                    da = _FieldRef(a.alloc(f"{name}.p{lvl}a{j}.{fa.offset}", fa.width), fa.offset, fa.width)
                    db = _FieldRef(a.alloc(f"{name}.p{lvl}b{j}.{fb.offset}", fb.width), fb.offset, fb.width)
                    el_a.add(Op(OpCode.AND_IMM, da.field, (fa.field,), (mask,)))
                    el_a.add(Op(OpCode.SHR_AND_IMM, db.field, (fb.field,), (shift, mask)))
                    ra.append(da)
                    rb.append(db)
                nxt_a.append(ra)
                nxt_b.append(rb)
            # element B: SUM, re-duplicated for the next level.
            last_level = lvl == in_word_levels - 1 and cross_levels == 0
            a.free(
                f.field
                for j in range(p)
                for row in (nxt_a[j], nxt_b[j])
                for f, act in zip(row, active[j])
                if act
            )
            el_b = self._element(f"popcnt_l{lvl}sum")
            new_cur = []
            for j in range(p):
                ca, cb, sa, sb = nxt_a[j], nxt_b[j], [], []
                for fa, fb, act in zip(ca, cb, active[j]):
                    if not act:
                        sa.append(fa)
                        sb.append(fb)
                        continue
                    na = _FieldRef(a.alloc(f"{name}.c{lvl}a{j}.{fa.offset}", fa.width), fa.offset, fa.width)
                    el_b.add(Op(OpCode.ADD, na.field, (fa.field, fb.field)))
                    sa.append(na)
                    if last_level:
                        sb.append(na)
                    else:
                        nb = _FieldRef(a.alloc(f"{name}.c{lvl}b{j}.{fa.offset}", fa.width), fa.offset, fa.width)
                        el_b.add(Op(OpCode.ADD, nb.field, (fa.field, fb.field)))
                        sb.append(nb)
                new_cur.append((sa, sb))
            cur = new_cur

        # cross-word levels: pair word counts, same (marshal, sum+dup) shape.
        for lvl in range(cross_levels):
            last_level = lvl == cross_levels - 1
            # Pre-compute pairings, free consumed fields, then allocate.
            n_pairs = {j: len(cur[j][0]) // 2 for j in range(p)}
            a.free(
                f.field
                for j in range(p)
                for copy in cur[j]
                for f in copy[: 2 * n_pairs[j]]
            )
            el_a = self._element(f"popcnt_x{lvl}a")
            # marshaled[j] = list of ("pair", da, db) | ("carry", fa, fb)
            marshaled: list[list[tuple]] = []
            for j in range(p):
                ca, cb = cur[j]
                row: list[tuple] = []
                for i in range(0, 2 * n_pairs[j], 2):
                    da = _FieldRef(a.alloc(f"{name}.q{lvl}a{j}.{i}", 16), ca[i].offset, 16)
                    db = _FieldRef(a.alloc(f"{name}.q{lvl}b{j}.{i}", 16), cb[i + 1].offset, 16)
                    el_a.add(Op(OpCode.COPY, da.field, (ca[i].field,)))
                    el_a.add(Op(OpCode.COPY, db.field, (cb[i + 1].field,)))
                    row.append(("pair", da, db))
                if len(ca) % 2:  # odd word carried through untouched
                    row.append(("carry", ca[-1], cb[-1]))
                marshaled.append(row)
            a.free(
                e[k].field
                for row in marshaled
                for e in row
                if e[0] == "pair"
                for k in (1, 2)
            )
            el_b = self._element(f"popcnt_x{lvl}sum")
            new_cur = []
            for j in range(p):
                sa, sb = [], []
                for kind, fa, fb in marshaled[j]:
                    if kind == "carry":
                        sa.append(fa)
                        sb.append(fb)
                        continue
                    na = _FieldRef(a.alloc(f"{name}.d{lvl}a{j}.{fa.offset}", 16), fa.offset, 16)
                    el_b.add(Op(OpCode.ADD, na.field, (fa.field, fb.field)))
                    sa.append(na)
                    if last_level:
                        sb.append(na)
                    else:
                        nb = _FieldRef(a.alloc(f"{name}.d{lvl}b{j}.{fa.offset}", 16), fa.offset, 16)
                        el_b.add(Op(OpCode.ADD, nb.field, (fa.field, fb.field)))
                        sb.append(nb)
                new_cur.append((sa, sb))
            cur = new_cur

        counts = []
        for j in range(p):
            sa, sb = cur[j]
            assert len(sa) == 1, f"popcount tree did not reduce: {len(sa)} words left"
            counts.append(sa[0].field)
            extra = {f.field.fid for f in sb if f.field.fid != sa[0].field.fid}
            self.alloc.free([f.field for f in sb if f.field.fid in extra])
        return counts

    def _emit_popcnt_native(self, name: str, p: int, xn) -> list:
        """§3 ablation: POPCNT primitive + plain ADD reduction tree."""
        a = self.alloc
        a.free(r.field for j in range(p) for r in xn[j][0])
        el = self._element("popcnt_native")
        cur = []
        for j in range(p):
            row = []
            for r in xn[j][0]:
                dst = _FieldRef(a.alloc(f"{name}.pc{j}.{r.offset}", 16), r.offset, 16)
                el.add(Op(OpCode.POPCNT, dst.field, (r.field,)))
                row.append(dst)
            cur.append(row)
        while max(len(row) for row in cur) > 1:
            a.free(
                f.field
                for row in cur
                for f in row[: 2 * (len(row) // 2)]
            )
            el = self._element("popcnt_add")
            new = []
            for j, row in enumerate(cur):
                nrow = []
                for i in range(0, len(row) - 1, 2):
                    dst = _FieldRef(a.alloc(f"{name}.ad{j}.{i}", 16), row[i].offset, 16)
                    el.add(Op(OpCode.ADD, dst.field, (row[i].field, row[i + 1].field)))
                    nrow.append(dst)
                if len(row) % 2:
                    nrow.append(row[-1])
                new.append(nrow)
            cur = new
        return [row[0].field for row in cur]


def compile_bnn(
    weights: Sequence[np.ndarray],
    chip: ChipSpec = RMT,
    *,
    thresholds: Sequence | None = None,
) -> PipelineProgram:
    """Compile {0,1} weight bit-matrices into an RMT pipeline program.

    ``thresholds`` optionally sets per-layer (scalar or per-neuron) SIGN fire
    thresholds; the default is the paper's ``ceil(n_in/2)``.
    """
    return Compiler(chip).compile(weights, thresholds=thresholds)


def compile_spec(
    spec: bnn.BnnSpec, params: Sequence, chip: ChipSpec = RMT
) -> PipelineProgram:
    """Compile a :class:`~repro_torch.core.bnn.BnnSpec` with {0,1} bit params
    (CPU tensors or numpy arrays)."""
    return compile_bnn([np.asarray(w) for w in params], chip)
