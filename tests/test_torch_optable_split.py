"""The op-table kernel's split route (``kernels/optable_exec.py::make_split``) on the CPU.

The split route keeps a few packets' register files in shared memory and
spreads each element's rows over a block's threads.  Its plan groups an
element's rows into chains, one per register written (the last first write
and the FOLD rows after it), deals each chain whole to one lane, and runs
elements whose registers allow it in one phase.  The numpy emulation of
those records (``run_split`` in ``tests/test_torch_optable_plan.py``, which
also holds it on the paper models, random programs and stacked hops) must
give exactly what ``optable_run_plain`` and the reference Pallas kernel in
interpret mode give; here on a hand-made element and the tenant merges,
beside the plan's structure and limits.  The kernel itself is held against
the plain version on a card by ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from test_torch_optable_plan import (
    FULL, PAPER, TABLES, _hand_tables, _pallas, _phase, _plain, _plan, _regs, _split, run_split,
)
from test_torch_routes import _one_row_plan, _pool

from repro_torch.dataplane import lowering as tlow
from repro_torch.kernels import _build
from repro_torch.kernels import optable_exec as topt
from repro_torch.roofline import kernels as costs


def _check(lp, regs, pallas=True):
    sp = _split(lp)
    got = run_split(sp, regs)
    np.testing.assert_array_equal(got, _plain(lp, regs))
    if pallas:
        np.testing.assert_array_equal(got, _pallas(lp, regs))
    return sp


def test_hand_made_fold_chain_of_32_and_write_after_read():
    """Element 0: r1's first write and 31 FOLD rows (r1 = the sum of r2 << i,
    a chain of 32); row 32 reads r1 and r3 as they entered the element,
    though the chain writes r1 and row 33 writes r3 after it; a first write
    into r4 superseded by a later one; an add of a zero mask into r5.
    Element 1 reads what element 0 wrote, so it runs a phase later; element
    2 reads nothing element 0 or 1 writes and writes r2, which element 0
    reads, so it joins element 0's phase; element 3 reads what element 1
    wrote and writes r5, which element 2 reads."""
    x, shr, add, shl = tlow.XOR_IMM, tlow.SHR_AND_IMM, tlow.ADD, tlow.SHL_IMM
    num_regs = 8  # r0..r6, null r7
    chain = [(shl, 1, 2, 7, i, 0, FULL, int(i == 0)) for i in range(32)]
    t = _hand_tables([
        chain + [
            (add, 6, 1, 3, 0, 0, FULL, 1),      # r6 = r1 + r3
            (x, 3, 0, 7, 0xF0, 0, FULL, 1),     # r3 = r0 ^ 0xF0
            (x, 4, 0, 7, 1, 0, FULL, 1),        # r4 = r0 ^ 1   (superseded)
            (shr, 4, 2, 7, 3, 0xFF, FULL, 1),   # r4 = (r2 >> 3) & 0xFF
            (add, 5, 0, 0, 0, 0, 0, 0),         # r5 += 0       (a zero mask: dropped)
        ],
        [(add, 0, 1, 6, 0, 0, 0xFFFF, 1)],      # r0 = (r1 + r6) & 0xFFFF
        [(x, 2, 5, 7, 9, 0, FULL, 1)],          # r2 = r5 ^ 9
        [(x, 5, 0, 7, 1, 0, FULL, 1)],          # r5 = r0 ^ 1
    ], num_regs)
    tables = types.SimpleNamespace(**t, num_regs=num_regs)
    sp = _split(tables)
    np.testing.assert_array_equal(sp.phase_of, [0, 1, 0, 2])
    chains, starts, rows, write = _phase(sp, 0)
    # r1's chain (32 rows), r6, r3, r4 (one row: its first write superseded),
    # r2 and the null register's last pad; r5's zero add is gone.
    assert chains == 6 and len(rows) == 32 + 5
    assert sorted((write & 0xFFFF).tolist()) == [1, 2, 3, 4, 6, 7]
    regs = _regs(num_regs, 4, seed=3)
    regs[-1] = 0xDEADBEEF  # a nonzero incoming null register
    r = regs.astype(np.uint64)
    want = r.copy()
    want[1] = sum((r[2] << i) & FULL for i in range(32)) & FULL
    want[6] = (r[1] + r[3]) & FULL
    want[3], want[4], want[2] = r[0] ^ 0xF0, (r[2] >> 3) & 0xFF, r[5] ^ 9
    want[0] = (want[1] + want[6]) & 0xFFFF
    want[5] = want[0] ^ 1
    want[7] = 0
    got = run_split(sp, regs)
    np.testing.assert_array_equal(got, want.astype(np.uint32))
    np.testing.assert_array_equal(got, _plain(tables, regs))
    np.testing.assert_array_equal(got, _pallas(tables, regs))


@pytest.mark.parametrize("layout", ["interleave", "concat"])
def test_split_matches_plain_on_the_eight_tenant_merges(layout):
    lp = _pool(8).merged(layout).lowered
    regs = _regs(lp.num_regs, 3, seed=8)
    regs[-1] = 0xDEADBEEF
    _check(lp, regs, pallas=False)


@pytest.mark.parametrize("layout", ["interleave", "concat"])
def test_split_matches_plain_on_the_thirty_two_tenant_merges(layout):
    lp = _pool(32).merged(layout).lowered
    regs = _regs(lp.num_regs, 2, seed=32)
    regs[-1] = 0xDEADBEEF
    sp = _check(lp, regs, pallas=False)
    assert sp.rows <= 32920 + lp.num_elements  # dropped rows and one pad row an element


def _chains_whole(sp) -> bool:
    """Every chain's rows in one lane, each lane's rows ending on a chain's
    last row, every phase's chain count within the write list's reach."""
    for k in range(sp.num_phases):
        chains, starts, rows, _ = _phase(sp, k)
        lane = np.repeat(np.arange(sp.threads), np.diff(starts))
        chain = rows[:, 1] & 0xFFFF
        if len(rows) and not ((rows[np.diff(np.append(lane, sp.threads)) != 0, 1] >> 20) & 1).all():
            return False
        seen = {}
        for c, l in zip(chain.tolist(), lane.tolist()):
            if seen.setdefault(c, l) != l:
                return False
        if chains > topt.SPLIT_WRITES * sp.threads or len(seen) != chains:
            return False
    return True


@pytest.mark.parametrize("count,layout,num_regs,rows", [
    (32, "interleave", 1833, 32920), (32, "concat", 1833, 32920),
    (128, "interleave", 7081, 125464), (128, "concat", 7081, 125464),
])
def test_split_plan_of_the_wide_merges(count, layout, num_regs, rows):
    """32 and 128 merged tenants: past the shared route, on split.  The
    block (4 or 8 packets' registers and the value buffer) fits one block's
    shared memory; every chain is whole in one lane; merged phases:
    every layout's elements fill 30 phases (the concat layout's tenants side
    by side)."""
    lp = _pool(count).merged(layout).lowered
    plan = _plan(lp)
    assert lp.num_regs == num_regs and int(plan.rows.sum()) == rows
    assert topt.route(plan, num_regs) == "split"
    with pytest.raises(ValueError, match=f"{num_regs} registers"):
        topt.plan_threads(plan, num_regs)
    sp = _split(lp)
    assert sp.num_regs == num_regs and sp.table_rows == rows
    assert sp.packets in topt.SPLIT_PACKETS and sp.chains <= num_regs
    assert sp.shared_bytes(num_regs) <= _build.MAX_SHARED_BYTES
    assert 4 * min(topt.SPLIT_PACKETS) * (num_regs + plan.max_chains) <= _build.MAX_SHARED_BYTES
    assert -(-1024 // sp.packets) >= 132  # a chunk of 1024 gives every SM a block
    assert _chains_whole(sp)
    assert sp.num_phases == 30


def _one_row_tables() -> tuple:
    """The tables of ``_one_row_plan``: one element of one XOR row into r1."""
    zero = np.zeros((1, 1), np.int32)
    return (zero, zero + 1, zero, zero, zero, zero, np.full((1, 1), FULL, np.uint32), zero + 1)


def test_split_limits():
    """One element of one row over a file: split up to 14,527 registers at
    4 packets (16 B a register and one value), global past it; a forced
    split plan past it raises."""
    fits = _build.MAX_SHARED_BYTES // 16 - 1
    assert fits == 14527
    for num_regs, want in ((fits, "split"), (fits + 1, "global")):
        plan, tables = _one_row_plan(num_regs), _one_row_tables()
        assert plan.max_chains == 1 and topt.route(plan, num_regs) == want
        if want == "global":
            with pytest.raises(ValueError, match="shared memory"):
                topt.make_split(plan, tables)
        else:
            sp = topt.make_split(plan, tables)
            assert sp.shared_bytes(num_regs) <= _build.MAX_SHARED_BYTES


def _tensors(tables: dict) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(tables[n]).view(np.int32).copy()) for n in TABLES)


def test_prepare_split_caches_beside_the_plan():
    """``prepare`` makes the split plan with its own where the program
    routes to split (a one-row program over 2,000 registers), and not
    where it routes to shared (HEADLINE), where ``prepare_split`` makes it
    on its first call; later calls return the same plan and records, and
    an entry goes with its tables."""
    num_regs = 2000
    wide = _tensors(dict(zip(TABLES, _one_row_tables())))
    plan, _ = topt.prepare(wide, num_regs)
    assert topt.route(plan, num_regs) == "split" and plan in topt._SPLITS
    sp, records = topt.prepare_split(wide, num_regs)
    assert topt.prepare_split(wide, num_regs) == (sp, records)
    assert records.dtype == torch.int32 and np.array_equal(records.numpy().view(np.uint32), sp.records)
    assert (sp.num_regs, sp.num_phases, sp.table_rows) == (num_regs, 1, 1)

    lp = PAPER["HEADLINE/rmt"]()
    head = _tensors({n: getattr(lp, n) for n in TABLES})
    plan, _ = topt.prepare(head, lp.num_regs)
    assert topt.route(plan, lp.num_regs) == "shared" and plan not in topt._SPLITS
    sp, records = topt.prepare_split(head, lp.num_regs)
    assert topt._SPLITS[plan] == (sp, records) and topt.prepare_split(head, lp.num_regs)[0] is sp
    np.testing.assert_array_equal(sp.records, _split(lp).records)
    before = len(topt._SPLITS)
    del head, plan
    assert len(topt._SPLITS) == before - 1


def test_split_cost_charges_the_split_records():
    """A split launch's cost: the tables' true rows, as on every route, and
    the bytes of the records it reads, not those of the shared plan."""
    lp = PAPER["FIVE_TUPLE/rmt"]()
    tables = _tensors({n: getattr(lp, n) for n in TABLES})
    plan, records = topt.prepare(tables, lp.num_regs)
    sp, split_records = topt.prepare_split(tables, lp.num_regs)
    rows = int(plan.rows.sum())
    assert topt._cost(lp.num_regs, 64, sp, split_records) == costs.optable_run(
        lp.num_regs, 64, rows, split_records.nbytes)
    assert topt._cost(lp.num_regs, 64, plan, records) == costs.optable_run(lp.num_regs, 64, rows, records.nbytes)
    assert split_records.nbytes != records.nbytes


@pytest.mark.parametrize("chains,threads", [(1, 64), (256, 64), (257, 128), (1832, 512), (4096, 1024),
                                            (8192, 1024)])
def test_split_threads(chains, threads):
    assert topt.split_threads(chains) == threads
    assert chains <= topt.SPLIT_WRITES * threads


@pytest.mark.parametrize("num_regs,chains,threads,packets", [
    (1833, 1832, 512, 4),   # 32 tenants: three blocks of 4 (58.6 KB) beat one of 8
    (7081, 7081, 1024, 4),  # 128 tenants: only 4 fit (226.6 KB)
    (129, 128, 64, 8),      # HEADLINE: thread-bound, 8 a block
])
def test_split_packets(num_regs, chains, threads, packets):
    assert topt.split_packets(num_regs, chains, threads) == packets
