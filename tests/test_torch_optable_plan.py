"""The op-table kernel's plans (``kernels/optable_exec.py::make_plan`` and
``make_split``) on the CPU.

The CUDA kernel walks the plan's records, not the raw tables: pad rows cut,
the rows whose destination a later row reads deferred to the element's end,
the others written back at once.  Here a plain numpy emulation decodes those same
records as the kernel does (row groups, immediate and deferred write-back,
the pads' register zeroed) and must give exactly what ``optable_run_plain``
and the reference Pallas kernel in interpret mode give.  So must a second
emulation, of the split route's plan (:func:`run_split`), on the same
programs; ``tests/test_torch_optable_split.py`` holds the rest of that
route.  The kernels themselves are held against the plain version on a card
by ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strategies import build_case, given, program_cases, settings

from repro_torch.configs.n2net_paper import FIVE_TUPLE, HEADLINE
from repro_torch.core import bitops as tb
from repro_torch.core import bnn as tbnn
from repro_torch.core import compiler as tcompiler
from repro_torch.core import pipeline as tpipe
from repro_torch.dataplane import lowering as tlow
from repro_torch.kernels import _build
from repro_torch.kernels import optable_exec as topt

from repro.kernels import optable_exec as jopt

TABLES = ("opcode", "dst", "src0", "src1", "imm0", "imm1", "mask", "first_write")
FULL = 0xFFFFFFFF


def _paper(spec, seed, chip=tpipe.RMT):
    """The paper model's program with weights as ``chip_smoke.py`` makes them."""
    params = tbnn.init_params(spec, torch.Generator().manual_seed(seed))
    return tcompiler.compile_bnn([w.numpy() for w in params], chip).lower()


PAPER = {
    "HEADLINE/rmt": lambda: _paper(HEADLINE, 0),
    "HEADLINE/rmt+popcnt32": lambda: _paper(HEADLINE, 0, tpipe.RMT_NATIVE_POPCNT),
    "FIVE_TUPLE/rmt": lambda: _paper(FIVE_TUPLE, 1),
}


def _plan(lp):
    return topt.make_plan(*(getattr(lp, n) for n in TABLES), lp.num_regs)


def _regs(num_regs, batch, seed):
    """Arbitrary uint32 registers, the null (last) register included."""
    rng = np.random.default_rng(seed)
    regs = rng.integers(0, 1 << 32, (num_regs, batch), dtype=np.uint64).astype(np.uint32)
    regs[0, :2] = (0x80000000, FULL)
    return regs


def _alu(op, a, b, i0):
    with np.errstate(over="ignore"):
        if op == tlow.XOR_IMM:
            return a ^ i0
        if op == tlow.SHR_AND_IMM:
            return a >> i0 if i0 < 32 else np.zeros_like(a)
        if op == tlow.ADD:
            return a + b
        if op == tlow.GE_IMM:
            return (a >= i0).astype(np.uint32)
        if op == tlow.SHL_IMM:
            return a << i0 if i0 < 32 else np.zeros_like(a)
        assert op == tlow.POPCNT
        return np.array([bin(int(v)).count("1") for v in a], np.uint32)


def run_planned(plan, regs: np.ndarray) -> np.ndarray:
    """What the kernel does with ``plan.records``, over a (num_regs, batch)
    uint32 register file: per element, groups of ``ROW_GROUP`` rows of one
    opcode, each group computed before any of its rows writes, immediate rows stored or added into their register,
    deferred rows into scratch slots past the register file, then the
    write-back list in row order and the pads' register zeroed."""
    num_regs, batch = regs.shape
    with np.errstate(over="ignore"):
        file = np.concatenate([regs, np.zeros((plan.max_deferred, batch), np.uint32)])
        for rec in plan.records:
            rows, deferred, zero, back = (int(v) for v in rec[:4].view(np.int32))
            assert rows % topt.ROW_GROUP == 0
            for r0 in range(0, rows, topt.ROW_GROUP):
                group = [rec[4 + 4 * r:8 + 4 * r] for r in range(r0, r0 + topt.ROW_GROUP)]
                op = (group[0][1] >> 16) & 0xF  # the kernel reads a group's opcode once
                assert all((q[1] >> 16) & 0xF == op for q in group)
                vals = [_alu(op, file[q[0] & 0xFFFF], file[q[0] >> 16], q[2]) & q[3] for q in group]
                for q, v in zip(group, vals):
                    t = q[1] & 0xFFFF
                    file[t] = v if (q[1] >> 20) & 1 else file[t] + v
            for k, ent in enumerate(rec[back:back + deferred]):
                d = ent & 0xFFFF
                file[d] = file[num_regs + k] if ent >> 16 else file[d] + file[num_regs + k]
            if zero >= 0:
                file[zero] = 0
    return file[:num_regs]


def _split(lp):
    """The split route's plan of ``lp``'s tables."""
    return topt.make_split(_plan(lp), tuple(getattr(lp, n) for n in TABLES))


def _phase(sp, k):
    """Phase ``k``'s header, lane starts, row records and write list, as
    the split kernel finds them."""
    units = sp.records.reshape(-1, 4)
    at = int(sp.records[k])
    chains, n = int(units[at, 0]), int(units[at, 1])
    starts = sp.records[4 * (at + 1):4 * (at + 1) + sp.threads + 1].astype(np.int64)
    rows_at = at + 1 + (sp.threads + 4) // 4
    rows = units[rows_at:rows_at + n]
    write = sp.records[4 * (rows_at + n):4 * (rows_at + n) + chains]
    return chains, starts, rows, write


def run_split(sp, regs: np.ndarray) -> np.ndarray:
    """What the split kernel does with ``sp.records`` over a (num_regs,
    batch) uint32 register file: per phase, each lane sums its rows into
    its chains' values, reading only the file as it entered the phase; then
    each chain's value is stored (first write) or added into its register.
    Asserts the plan's structure on the way: lanes tile the rows in order,
    every chain lies whole in one lane and ends exactly once, and a phase's
    chains write distinct registers."""
    file = regs.copy()
    with np.errstate(over="ignore"):
        for k in range(sp.num_phases):
            chains, starts, rows, write = _phase(sp, k)
            assert starts[0] == 0 and starts[-1] == len(rows) and (np.diff(starts) >= 0).all()
            assert chains <= sp.chains and chains <= topt.SPLIT_WRITES * sp.threads
            assert len(np.unique(write & 0xFFFF)) == chains
            values = [None] * chains
            owner = {}
            for lane in range(sp.threads):
                cur = np.zeros(file.shape[1], np.uint32)
                a, b = int(starts[lane]), int(starts[lane + 1])
                for r in rows[a:b]:
                    op, chain = (int(r[1]) >> 16) & 0xF, int(r[1]) & 0xFFFF
                    assert owner.setdefault(chain, lane) == lane  # a chain whole to one lane
                    cur = cur + (_alu(op, file[r[0] & 0xFFFF], file[r[0] >> 16], r[2]) & r[3])
                    if (r[1] >> 20) & 1:
                        assert values[chain] is None
                        values[chain], cur = cur, np.zeros_like(cur)
                assert a == b or (rows[b - 1][1] >> 20) & 1  # a lane ends on a chain's last row
            assert all(v is not None for v in values)
            for c, ent in enumerate(write):
                d = int(ent) & 0xFFFF
                file[d] = values[c] if (ent >> 16) & 1 else file[d] + values[c]
    return file


def _plain(lp, regs: np.ndarray) -> np.ndarray:
    tables = [torch.from_numpy(np.ascontiguousarray(getattr(lp, n)).view(np.int32)) for n in TABLES]
    out = topt.optable_run_plain(tb.u32_to_i32(torch.from_numpy(regs.astype(np.int64))), *tables)
    return tb.i32_to_u32(out).numpy().astype(np.uint32)


def _pallas(lp, regs: np.ndarray) -> np.ndarray:
    out = jopt.optable_run(jnp.asarray(regs), *(jnp.asarray(getattr(lp, n)) for n in TABLES),
                           interpret=True)
    return np.asarray(out).astype(np.uint32)


def _brute_deferred(dst, src0, src1, rows):
    """Row r is deferred iff some row reads dst[r] after dst[r]'s first writer."""
    out = np.zeros(rows, bool)
    for r in range(rows):
        first = min(i for i in range(rows) if dst[i] == dst[r])
        out[r] = any(dst[r] in (src0[j], src1[j]) for j in range(first + 1, rows))
    return out


def _check_plan_structure(lp):
    plan = _plan(lp)
    np.testing.assert_array_equal(plan.rows, lp.rows_per_element)
    has_pad = lp.rows_per_element < lp.max_rows
    np.testing.assert_array_equal(plan.zero_reg, np.where(has_pad, lp.null_slot, -1))
    for e in range(lp.num_elements):
        n = int(plan.rows[e])
        want = _brute_deferred(lp.dst[e], lp.src0[e], lp.src1[e], n)
        np.testing.assert_array_equal(plan.deferred[e, :n], want)
        assert not plan.deferred[e, n:].any()
    assert plan.max_deferred == int(plan.deferred.sum(1).max(initial=0))
    return plan


@pytest.mark.parametrize("name", list(PAPER))
def test_plan_rows_and_deferred_set_on_the_paper_models(name):
    _check_plan_structure(PAPER[name]())


def test_plan_shapes_of_the_paper_models():
    """HEADLINE: 3,168 true rows of 3,840, 707 deferred, at most 64 in one
    element; FIVE_TUPLE: 10,096 of 39,040, 2,516 deferred, at most 160."""
    head, five = _plan(PAPER["HEADLINE/rmt"]()), _plan(PAPER["FIVE_TUPLE/rmt"]())
    assert (head.rows.sum(), head.deferred.sum(), head.max_deferred) == (3168, 707, 64)
    assert (five.rows.sum(), five.deferred.sum(), five.max_deferred) == (10096, 2516, 160)


@pytest.mark.parametrize("name", list(PAPER))
def test_planned_schedule_matches_plain_and_pallas_on_the_paper_models(name):
    lp = PAPER[name]()
    regs = _regs(lp.num_regs, 5, seed=7)
    regs[-1] = 0xDEADBEEF  # a nonzero incoming null register
    got = run_planned(_plan(lp), regs)
    np.testing.assert_array_equal(got, _plain(lp, regs))
    np.testing.assert_array_equal(got, _pallas(lp, regs))
    np.testing.assert_array_equal(run_split(_split(lp), regs), got)


@given(program_cases(max_layers=2, max_width=40))
@settings(max_examples=6)
def test_planned_schedule_matches_plain_and_pallas_on_random_programs(case):
    lp = build_case(case).lowered
    _check_plan_structure(lp)
    regs = _regs(lp.num_regs, 3, seed=case.weight_seed % 1000)
    regs[-1] = 0x1234  # a nonzero incoming null register
    got = run_planned(_plan(lp), regs)
    np.testing.assert_array_equal(got, _plain(lp, regs))
    np.testing.assert_array_equal(got, _pallas(lp, regs))
    np.testing.assert_array_equal(run_split(_split(lp), regs), got)


def test_stacked_hops_with_whole_pad_elements():
    """FIVE_TUPLE on the RMT chip partitions into hops of 32, 32, 32 and 26
    elements, and ``stack_hops`` pads the last hop with 6 whole pad elements
    (every row ``SHR_AND_IMM`` into the null register, mask 0, first_write
    1).  Their plan has no true rows and zeroes the null register; hop by
    hop the planned schedule equals the plain version (and Pallas on the
    padded hop), and the chain equals the unsliced program.  The split
    route's plan gives the same hop by hop, its pads leaving the null
    register 0."""
    lp = PAPER["FIVE_TUPLE/rmt"]()
    hops = [lp.slice_elements(a, min(a + 32, lp.num_elements)) for a in range(0, lp.num_elements, 32)]
    assert [h.num_elements for h in hops] == [32, 32, 32, 26]
    stacked = tlow.stack_hops(hops)
    regs = _regs(lp.num_regs, 5, seed=11)
    regs[-1] = 0xBEEF  # a nonzero incoming null register
    state = regs
    for h in range(stacked.num_hops):
        plane = types.SimpleNamespace(**{n: getattr(stacked, n)[h] for n in TABLES})
        plan = topt.make_plan(*(getattr(plane, n) for n in TABLES), stacked.num_regs)
        got = run_planned(plan, state)
        np.testing.assert_array_equal(got, _plain(plane, state))
        np.testing.assert_array_equal(run_split(topt.make_split(plan, tuple(getattr(plane, n) for n in TABLES)),
                                                state), got)
        if h == stacked.num_hops - 1:
            np.testing.assert_array_equal(plan.rows[26:], 0)
            np.testing.assert_array_equal(plan.zero_reg[26:], lp.null_slot)
            assert not plan.deferred[26:].any()
            np.testing.assert_array_equal(plan.records[26:, 0:2], 0)  # no records, nothing deferred
            np.testing.assert_array_equal(got, _pallas(plane, state))
        state = got
    assert not state[-1].any()
    np.testing.assert_array_equal(state, _plain(lp, regs))


def _hand_tables(elements, num_regs):
    """Tables from per-element row lists, each padded as ``lowering`` pads
    (SHR_AND_IMM into the null register, mask 0, first_write 1)."""
    null = num_regs - 1
    width = max(len(rows) for rows in elements) + 1
    pad = (tlow.SHR_AND_IMM, null, null, null, 0, 0, 0, 1)
    rows = np.array([list(el) + [pad] * (width - len(el)) for el in elements], np.int64)
    return {name: rows[:, :, i].astype(np.uint32 if name in ("imm0", "imm1", "mask") else np.int32)
            for i, name in enumerate(TABLES)}


def test_hand_made_in_place_chain_and_deferred_fold():
    """Element 0: r1's first writer and its FOLD continuation are deferred
    because row 2 reads r1; r2 is rewritten in place twice (rows 3, 4), so
    both are deferred and the later first write wins; r3 and r4 write back
    at once.  Element 1 then reads what element 0 left."""
    x, shr, add, shl = tlow.XOR_IMM, tlow.SHR_AND_IMM, tlow.ADD, tlow.SHL_IMM
    num_regs = 6  # r0..r4, null r5
    t = _hand_tables([
        [
            (x, 1, 0, 5, 0, 0, FULL, 1),      # r1 = r0
            (shl, 1, 2, 5, 1, 0, FULL, 0),    # r1 += r2 << 1  (FOLD continuation)
            (x, 3, 1, 5, 5, 0, FULL, 1),      # r3 = r1 ^ 5    (reads r1 after its first writer)
            (x, 2, 2, 5, 0xF, 0, FULL, 1),    # r2 = r2 ^ 0xF  (in place)
            (add, 2, 2, 4, 0, 0, FULL, 1),    # r2 = r2 + r4   (reads r2 after row 3)
            (shr, 4, 0, 5, 4, 0xFF, FULL, 1), # r4 = (r0 >> 4) & 0xFF
        ],
        [(add, 0, 1, 2, 0, 0, 0xFFFF, 1)],    # r0 = (r1 + r2) & 0xFFFF
    ], num_regs)
    lp_like = type("Tables", (), dict(t, num_regs=num_regs))
    plan = topt.make_plan(*(t[n] for n in TABLES), num_regs)
    np.testing.assert_array_equal(plan.rows, [6, 1])
    np.testing.assert_array_equal(plan.zero_reg, [5, 5])
    np.testing.assert_array_equal(plan.deferred[0, :6], [1, 1, 0, 1, 1, 0])
    assert plan.max_deferred == 4

    regs = np.array([[0x1234, 7], [100, 1], [3, 0xFFFFFFF0], [9, 9], [40, 2], [77, 1]], np.uint32)
    got = run_planned(plan, regs)
    r0, r1, r2, r3, r4 = (regs[i].astype(np.uint64) for i in range(5))
    e1 = (r0 + (r2 << 1)) & FULL
    e2 = (r2 + r4) & FULL
    e3 = r1 ^ 5
    e4 = (r0 >> 4) & 0xFF
    want = np.stack([(e1 + e2) & 0xFFFF, e1, e2, e3, e4, np.zeros(2, np.uint64)]).astype(np.uint32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _plain(lp_like, regs))
    np.testing.assert_array_equal(got, _pallas(lp_like, regs))


def test_plan_rejects_malformed_tables():
    lp = PAPER["HEADLINE/rmt+popcnt32"]()
    for name, value in (("opcode", 6), ("dst", lp.num_regs), ("src1", -1)):
        tables = {n: getattr(lp, n).copy() for n in TABLES}
        tables[name][0, 0] = value
        with pytest.raises(ValueError):
            topt.make_plan(*(tables[n] for n in TABLES), lp.num_regs)


def test_prepare_caches_by_table_tensor_and_replans_an_edited_table():
    lp = PAPER["HEADLINE/rmt+popcnt32"]()
    tables = tuple(torch.from_numpy(np.ascontiguousarray(getattr(lp, n)).view(np.int32).copy())
                   for n in TABLES)
    plan, records = topt.prepare(tables, lp.num_regs)
    again, records_again = topt.prepare(tables, lp.num_regs)
    assert again is plan and records_again is records
    assert records.dtype == torch.int32 and records.shape == (lp.num_elements, 4 * plan.stride)
    tables[0][0, 0] = 6  # an edit in place bumps the tensor's version
    with pytest.raises(ValueError):
        topt.prepare(tables, lp.num_regs)


@pytest.mark.parametrize("name,threads,resident", [
    ("HEADLINE/rmt", 256, 256), ("HEADLINE/rmt+popcnt32", 256, 768), ("FIVE_TUPLE/rmt", 32, 96),
])
def test_block_threads_of_the_planned_footprint(name, threads, resident):
    """Registers plus the deferred scratch per packet, and the two staged
    record buffers per block, fit one block's shared memory; the block size
    keeps the most packets resident on an SM (FIVE_TUPLE: three blocks of
    32, where one block of 64 fits)."""
    lp = PAPER[name]()
    plan = _plan(lp)
    fixed = 2 * plan.stride * 16
    assert topt.block_threads(lp.num_regs, plan.max_deferred, fixed) == threads
    smem = (lp.num_regs + plan.max_deferred) * 4 * threads + fixed
    assert smem <= _build.MAX_SHARED_BYTES
    blocks = min(_build.SM_SHARED_BYTES // (smem + _build.BLOCK_RESERVED_BYTES), 2048 // threads)
    assert blocks * threads == resident


def test_prepare_cache_entry_goes_with_its_tables():
    lp = PAPER["HEADLINE/rmt+popcnt32"]()
    tables = tuple(torch.from_numpy(np.ascontiguousarray(getattr(lp, n)).view(np.int32).copy())
                   for n in TABLES)
    topt.prepare(tables, lp.num_regs)
    before = len(topt._PLANS)
    del tables
    assert len(topt._PLANS) == before - 1
