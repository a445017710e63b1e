"""Op-table ALU of the dataplane executor: CUDA kernel + plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/optable_exec.py::optable_run``
(source: ``csrc/optable_exec.cu``, whose header note says what bounds it and
how it is laid out).  The register file is transposed — ``(num_regs, batch)``
— and holds int32 bit views of uint32 values; the tables are those of
``dataplane.lowering.LoweredProgram`` with the uint32 ones (``imm0``,
``imm1``, ``mask``) as int32 bit views too.

``optable_run`` dispatches on the register file's device: a CPU tensor runs
:func:`optable_run_plain`, a CUDA tensor launches the kernel (or raises).
The kernel does not read the tables themselves but a :class:`Plan` made from
them once on the host (:func:`prepare`, cached by table tensor): pad rows
cut, each row packed into one record, and the rows whose results must wait
for the element's end marked.  Planning checks the tables, so a launch on
tables already planned reads nothing back from the device.

The kernel has three routes, chosen before the launch by :func:`route`, a
pure function of the plan and the register count:

* ``"shared"``: a packet's registers and scratch rows live in shared memory
  (a block of :func:`plan_threads` packets, one thread a packet);
* ``"split"``: they do not fit one packet's share of a block at 32 packets
  (a merge of 32 or more tenants), but a block holds the register files of
  4 or 8 packets beside a buffer of their element's values; each element's
  rows are spread over the block's threads (:class:`SplitPlan`, made from
  the tables once and cached beside the plan by :func:`prepare_split`);
* ``"global"``: beyond that (a file past about 7,000 to 14,500 registers,
  :func:`split_fits`), the registers live in device memory, in a
  ``(num_regs + max_deferred, batch)`` file the wrapper allocates, one
  thread a packet.

Each launch is counted in ``optable_run.launches`` and, by route, in
``optable_run.launches_by_route``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import weakref

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core import bitops
from repro_torch.dataplane import lowering
from repro_torch.kernels import _build
from repro_torch.roofline import kernels as costs, ops as op_counts

BLOCK_THREADS = (256, 128, 64, 32)
ROW_GROUP = 32  # rows of one opcode a thread computes before it writes any (csrc kRowGroup)
ROUTES = ("shared", "split", "global")
# The split route (csrc kSplitWrites): a phase has at most this many chains a
# thread, and a block at most SPLIT_MAX_THREADS threads.
SPLIT_WRITES = 8
SPLIT_MAX_THREADS = 1024
SPLIT_PACKETS = (8, 4)  # packets a split-route block may hold: 2 or 1 groups of 4

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "optable_run": ([_P, _P, _P] + [_I] * 6 + [_P], ctypes.c_int),
    "optable_run_global": ([_P, _P] + [_I] * 5 + [_P], ctypes.c_int),
    "optable_run_split": ([_P, _P, _P] + [_I] * 6 + [_P], ctypes.c_int),
}
_SLOT_LIMIT = 1 << 16  # a record's slot fields are 16 bits wide


def _fit_threads(num_regs: int, scratch_rows: int, fixed_bytes: int) -> int | None:
    """:func:`block_threads`, or None where no block size fits."""
    best, most = None, 0
    for threads in BLOCK_THREADS:
        smem = (num_regs + scratch_rows) * 4 * threads + fixed_bytes
        if smem > _build.MAX_SHARED_BYTES:
            continue
        blocks = min(_build.SM_SHARED_BYTES // (smem + _build.BLOCK_RESERVED_BYTES),
                     _build.SM_MAX_THREADS // threads, _build.SM_MAX_BLOCKS)
        if blocks * threads > most:
            best, most = threads, blocks * threads
    return best


def block_threads(num_regs: int, scratch_rows: int, fixed_bytes: int = 0) -> int:
    """Packets per block of the shared route: of ``BLOCK_THREADS``, the one
    that keeps the most packets resident on an SM (the larger block on a
    tie), where a block holds ``(num_regs + scratch_rows) * 4`` bytes of
    shared memory a packet beside ``fixed_bytes`` of its own.  Raises
    ``ValueError`` when one packet's share does not fit a block of the
    smallest size."""
    best = _fit_threads(num_regs, scratch_rows, fixed_bytes)
    if best is None:
        least = (num_regs + scratch_rows) * 4 * BLOCK_THREADS[-1] + fixed_bytes
        raise ValueError(
            f"{num_regs} registers + {scratch_rows} scratch rows need {least} B of shared memory "
            f"at {BLOCK_THREADS[-1]} packets per block, beyond the {_build.MAX_SHARED_BYTES} B "
            "limit of one block: the shared route keeps each packet's register file in "
            "shared memory"
        )
    return best


def plan_threads(plan: "Plan", num_regs: int) -> int:
    """Packets per block of a shared-route launch on ``plan`` over
    ``num_regs`` registers (the block also stages two elements' records);
    raises ``ValueError`` when one packet's registers and scratch do not fit
    a block of the smallest size."""
    return block_threads(num_regs, plan.max_deferred, 2 * plan.stride * 16)


def split_fits(plan: "Plan", num_regs: int) -> bool:
    """Whether a split-route block of the smallest size (4 packets) holds
    ``num_regs`` registers and a value buffer of the plan's most chains of
    one element, 16 bytes each a packet group of 4, and a phase's chains fit
    SPLIT_WRITES a thread at SPLIT_MAX_THREADS threads."""
    return (16 * (num_regs + plan.max_chains) <= _build.MAX_SHARED_BYTES
            and plan.max_chains <= SPLIT_WRITES * SPLIT_MAX_THREADS)


def route(plan: "Plan", num_regs: int) -> str:
    """The kernel a CUDA launch on ``plan`` over ``num_regs`` registers
    takes: ``"shared"`` where :func:`plan_threads` finds a block size, else
    ``"split"`` where :func:`split_fits`, else ``"global"``.  Pure: it reads
    the plan's sizes only."""
    if _fit_threads(num_regs, plan.max_deferred, 2 * plan.stride * 16) is not None:
        return "shared"
    return "split" if split_fits(plan, num_regs) else "global"


def global_threads(batch: int, sms: int) -> int:
    """Packets per block of a global-route launch: of ``BLOCK_THREADS``, the
    largest that still gives each of the card's ``sms`` SMs a block (the
    smallest where the batch is too small for that).  A packet is latency
    bound on its walk through the rows, so spreading a small batch over more
    SMs helps it and a large batch loses nothing."""
    for threads in BLOCK_THREADS:
        if -(-batch // threads) >= sms:
            return threads
    return BLOCK_THREADS[-1]


def _check_args(regs, tables) -> None:
    if regs.ndim != 2 or regs.dtype != torch.int32:
        raise ValueError(f"regs must be (num_regs, batch) int32, got {regs.dtype} {tuple(regs.shape)}")
    shape = tables[0].shape
    for t in tables:
        if t.dtype != torch.int32 or t.shape != shape or t.ndim != 2:
            raise ValueError("op-tables must be (num_elements, max_rows) int32, all one shape")
        if t.device != regs.device:
            raise ValueError(f"op-table on {t.device}, register file on {regs.device}")


def _bad_tables(num_regs: int) -> ValueError:
    return ValueError(
        f"op-table holds an opcode outside 0..{lowering.NUM_DENSE_OPCODES - 1} "
        f"or a slot outside 0..{num_regs - 1}"
    )


def _check_values(regs, opcode, dst, src0, src1) -> None:
    """Reject opcodes outside the dense ISA and slots outside the register
    file before any kernel can read or write out of bounds."""
    num_regs = regs.shape[0]
    bad = (opcode < 0) | (opcode >= lowering.NUM_DENSE_OPCODES)
    for slots in (dst, src0, src1):
        bad |= (slots < 0) | (slots >= num_regs)
    if bool(bad.any()):
        raise _bad_tables(num_regs)


# ---------------------------------------------------------------------------
# The plan: what the kernel walks instead of the raw tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Plan:
    """How the kernel runs one op-table, made once on the host.

    Per element: ``rows`` true rows (:func:`trailing_pads`), the register
    ``zero_reg`` that its cut pads leave 0 (-1 for none), and ``deferred``,
    the rows whose results wait in scratch for the element's end
    (:func:`deferred_rows`).  ``records`` is what the kernel reads: per
    element, ``stride`` 16-byte units holding a header (record count,
    deferred count, ``zero_reg``, the word offset of the write-back list),
    one record per row, each run of one opcode padded to whole groups of
    ``ROW_GROUP``, and the deferred rows' write-back list,
    ``dst | first_write << 16`` each.

    ``max_chains`` is the most registers one element writes (its pads'
    register included): the split route's value buffer holds one value per
    written register (:func:`split_fits`).
    """

    rows: np.ndarray          # (E,) int32
    zero_reg: np.ndarray      # (E,) int32
    deferred: np.ndarray      # (E, max_rows) bool, False past rows[e]
    max_deferred: int
    stride: int
    records: np.ndarray       # (E, 4 * stride) uint32
    num_regs: int
    max_chains: int


def trailing_pads(dst, mask, first_write) -> tuple[np.ndarray, np.ndarray]:
    """Per element: the rows before its trailing pads, and the register
    those pads zero (-1 where there are none).

    A row with mask 0 and first_write 1 overwrites its destination with 0,
    whatever its opcode and sources.  The longest trailing run of such rows
    into one register is cut; its one effect is that register being 0 after
    the element.  ``lowering`` pads with such rows into the null register, so
    the count is ``LoweredProgram.rows_per_element``.
    """
    num_el, max_rows = dst.shape
    rows = np.full(num_el, max_rows, np.int32)
    zero = np.full(num_el, -1, np.int32)
    is_pad = (mask == 0) & (first_write != 0)
    for e in range(num_el):
        r = max_rows
        while r > 0 and is_pad[e, r - 1] and dst[e, r - 1] == dst[e, max_rows - 1]:
            r -= 1
        if r < max_rows:
            rows[e], zero[e] = r, dst[e, max_rows - 1]
    return rows, zero


def deferred_rows(dst, src0, src1, rows: int) -> np.ndarray:
    """Which of an element's first ``rows`` rows must wait for its end.

    Every row reads the register file as it stood entering the element.
    A register X is a hazard when a row reads X (as src0 or src1) after X's
    first writer in the element; every row writing a hazard is deferred and
    written back at the element's end, in row order, so a FOLD continuation
    still follows its first writer.  Every other row writes back at once: no
    later row of the element reads its destination.
    """
    first: dict[int, int] = {}
    for r, x in enumerate(dst[:rows].tolist()):
        first.setdefault(x, r)
    hazard = {x for r, pair in enumerate(zip(src0[:rows].tolist(), src1[:rows].tolist()))
              for x in pair if first.get(x, rows) < r}
    return np.isin(dst[:rows], sorted(hazard))


def make_plan(opcode, dst, src0, src1, imm0, imm1, mask, first_write, num_regs: int) -> Plan:
    """The :class:`Plan` of numpy op-tables for a ``num_regs`` register file.

    Raises ``ValueError`` on an opcode outside the dense ISA or a slot
    outside the register file.
    """
    opcode, dst, src0, src1, first_write = (
        np.asarray(t).astype(np.int64) for t in (opcode, dst, src0, src1, first_write))
    imm0, imm1, mask = (np.ascontiguousarray(t).view(np.uint32) for t in (imm0, imm1, mask))
    if ((opcode < 0) | (opcode >= lowering.NUM_DENSE_OPCODES)).any() or any(
            ((s < 0) | (s >= num_regs)).any() for s in (dst, src0, src1)):
        raise _bad_tables(num_regs)
    num_el, max_rows = opcode.shape
    rows, zero = trailing_pads(dst, mask, first_write)
    deferred = np.zeros((num_el, max_rows), bool)
    for e in range(num_el):
        deferred[e, :rows[e]] = deferred_rows(dst[e], src0[e], src1[e], int(rows[e]))
    max_def = int(deferred.sum(1).max(initial=0))
    if num_regs + max_def > _SLOT_LIMIT:
        raise ValueError(f"{num_regs} registers + {max_def} scratch rows exceed {_SLOT_LIMIT} slots")

    bodies, backs = [], []
    for e in range(num_el):
        n = int(rows[e])
        dfr = deferred[e, :n]
        # A deferred row stores into scratch slot num_regs + k; the rest
        # store (first_write) or add into their destination.
        target = np.where(dfr, num_regs + np.cumsum(dfr) - 1, dst[e, :n])
        store = dfr | (first_write[e, :n] != 0)
        # SHR_AND_IMM's imm1 folds into the mask: one AND per row.
        keep = np.where(opcode[e, :n] == lowering.SHR_AND_IMM, imm1[e, :n] & mask[e, :n], mask[e, :n])
        body = np.stack([src0[e, :n] | (src1[e, :n] << 16),
                         target | (opcode[e, :n] << 16) | (store.astype(np.int64) << 20),
                         imm0[e, :n], keep], 1).astype(np.uint32)
        # Each run of one opcode is padded to whole groups of ROW_GROUP rows
        # (rows of that opcode adding 0 into r0), so a group has one opcode.
        cuts = np.flatnonzero(np.diff(opcode[e, :n])) + 1
        groups = []
        for run in np.split(np.arange(n), cuts):
            if len(run):
                pad = np.zeros((-len(run) % ROW_GROUP, 4), np.uint32)
                pad[:, 1] = opcode[e, run[0]] << 16
                groups += [body[run], pad]
        bodies.append(np.concatenate(groups) if groups else np.zeros((0, 4), np.uint32))
        backs.append(dst[e, :n][dfr] | ((first_write[e, :n][dfr] != 0).astype(np.int64) << 16))
    body_rows = max((len(b) for b in bodies), default=0)
    stride = 1 + body_rows + -(-max_def // 4)
    records = np.zeros((num_el, 4 * stride), np.uint32)
    for e, (body, back) in enumerate(zip(bodies, backs)):
        records[e, :4] = (len(body), len(back), int(zero[e]) & 0xFFFFFFFF, 4 + 4 * body_rows)
        records[e, 4:4 + body.size] = body.reshape(-1)
        records[e, 4 + 4 * body_rows:4 + 4 * body_rows + len(back)] = back
    max_chains = max((len(np.unique(d)) for d in dst), default=0)
    return Plan(rows=rows, zero_reg=zero, deferred=deferred, max_deferred=max_def,
                stride=stride, records=records, num_regs=num_regs, max_chains=max_chains)


# ---------------------------------------------------------------------------
# The split route's plan: each element's rows spread over a block's threads
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class SplitPlan:
    """How the split route runs one op-table, made once from its tables and
    :class:`Plan` by :func:`make_split` (cached by :func:`prepare_split`).

    The elements run in phases: ``phase_of[e]`` is element ``e``'s, the
    earliest phase after every phase that writes a register it reads, and no
    earlier than any phase that reads a register it writes or writes one (a
    phase keeps its elements' rows in element order); a store of 0, such as
    the pads', need only follow the other writes of its register.  A phase's
    rows group into chains, one per register it writes:
    the last first_write row of that register (if any) and the FOLD rows
    after it, in row order.  Rows a later first_write supersedes, and adds
    of a zero mask, are dropped.  Every row reads the file as it stood
    entering the phase; each chain's sum is a value, and once every value is
    computed each chain's owner writes it (a first write stores it, else it
    adds to the register).  So a phase computes what its elements compute
    one after another.  The pads' register gets its 0 from the last pad
    row, a first write of mask 0.

    A phase's chains are dealt to ``threads`` lanes, each chain whole to one
    lane, in runs balanced by rows.  ``records`` (uint32 words, in 16-byte
    units) holds, first, each phase's offset in units; then, per phase, a
    header (chains, rows), ``threads + 1`` lane starts (lane ``l`` runs rows
    ``[start[l], start[l + 1])``), one record per row (``src0 | src1 << 16``,
    ``chain | opcode << 16 | end << 20``, ``imm0``, the AND mask with
    SHR_AND_IMM's imm1 folded in; ``end`` marks a chain's last row) and the
    write list, ``dst | first_write << 16`` per chain.  ``chains`` is the
    most chains of a phase (the value buffer's height) and ``packets`` the
    packets a block holds; ``table_rows`` is the tables' true rows, the
    work whatever the route (``Plan.rows``).
    """

    num_regs: int
    threads: int
    packets: int
    chains: int
    phase_of: np.ndarray      # (E,) each element's phase
    num_phases: int
    rows: int                 # rows planned, after the dropped ones
    table_rows: int
    records: np.ndarray       # uint32 words, a multiple of 4

    def shared_bytes(self, num_regs: int) -> int:
        """Dynamic shared memory of one block: its packets' registers and
        the value buffer."""
        return 4 * self.packets * (num_regs + self.chains)


def _live_rows(opcode, dst, first_write, keep):
    """Of one run of rows, those that count: a destination's last
    first_write row and the rows after it (all its rows where there is no
    first_write row), less adds of a zero mask."""
    n = len(dst)
    fw = first_write != 0
    last = {}
    for r in np.flatnonzero(fw).tolist():
        last[int(dst[r])] = r
    start = np.array([last.get(int(d), -1) for d in dst.tolist()], np.int64) if n else np.zeros(0, np.int64)
    return (np.arange(n) >= start) & (fw | (keep != 0))


def _reads(opcode, src0, src1, keep) -> np.ndarray:
    """The registers rows read: src0, and src1 of ADD rows, where the mask
    keeps any bit (a zero mask gives 0 whatever it reads)."""
    some = keep != 0
    return np.unique(np.concatenate([src0[some], src1[some & (opcode == lowering.ADD)]]))


def _phase_records(rows, lanes: int) -> tuple[np.ndarray, int]:
    """One phase's records (uint32 words) from its live rows, in row order
    (opcode, dst, src0, src1, imm0, keep, first_write columns), and its
    chain count."""
    opcode, dst, src0, src1, imm0, keep, fw = rows
    n = len(dst)
    if n == 0:
        order, chain_dst, chain_fw, starts, lengths = (np.zeros(0, np.int64),) * 5
    else:
        # Chains: the rows of each destination, in row order; the head row
        # says whether the chain stores or adds.
        order = np.lexsort((np.arange(n), dst))
        d_sorted = dst[order]
        head = np.ones(n, bool)
        head[1:] = d_sorted[1:] != d_sorted[:-1]
        starts = np.flatnonzero(head)
        lengths = np.diff(np.append(starts, n))
        chain_dst = d_sorted[starts]
        chain_fw = fw[order[starts]] != 0
        # Chains with one opcode at their head side by side, so a warp's
        # lanes mostly branch alike.
        by = np.lexsort((-lengths, opcode[order[starts]]))
        starts, lengths, chain_dst, chain_fw = starts[by], lengths[by], chain_dst[by], chain_fw[by]
        order = np.concatenate([order[a:a + k] for a, k in zip(starts.tolist(), lengths.tolist())])
    chains = len(chain_dst)
    # Lanes take runs of chains balanced by rows: chain j goes to the lane
    # its first row falls in when the rows are cut into `lanes` equal runs.
    first = np.concatenate([[0], np.cumsum(lengths)[:-1]]) if chains else np.zeros(0, np.int64)
    lane_of = np.minimum(first * lanes // max(n, 1), lanes - 1)
    lane_start = np.searchsorted(lane_of, np.arange(lanes + 1), side="left")
    lane_start = np.where(np.arange(lanes + 1) == lanes, chains, lane_start)
    row_start = np.concatenate([first, [n]])[lane_start]
    chain_of_row = np.repeat(np.arange(chains), lengths)
    end = np.zeros(n, bool)
    end[np.cumsum(lengths) - 1] = True
    body = np.stack([
        src0[order] | (src1[order] << 16),
        chain_of_row | (opcode[order] << 16) | (end.astype(np.int64) << 20),
        imm0[order], keep[order]], 1).astype(np.uint32) if n else np.zeros((0, 4), np.uint32)
    write = (chain_dst | (chain_fw.astype(np.int64) << 16)).astype(np.uint32)
    words = [np.array([chains, n, 0, 0], np.uint32),
             _pad4(row_start.astype(np.uint32)), body.reshape(-1), _pad4(write)]
    return np.concatenate(words), chains


def _pad4(a: np.ndarray) -> np.ndarray:
    return np.concatenate([a, np.zeros(-len(a) % 4, a.dtype)])


def split_threads(chains: int) -> int:
    """Threads (lanes) of a split-route block for phases of at most
    ``chains`` chains: about 4 chains a lane, a power of two from 64 to
    SPLIT_MAX_THREADS."""
    want = -(-chains // 4)
    threads = 64
    while threads < want and threads < SPLIT_MAX_THREADS:
        threads *= 2
    return threads


def split_packets(num_regs: int, chains: int, threads: int) -> int:
    """Packets a split-route block holds: of ``SPLIT_PACKETS``, the one that
    keeps the most packets resident on an SM (the smaller on a tie: more
    blocks for a small batch), each block holding its packets' registers
    and value buffer."""
    best, most = None, 0
    for packets in sorted(SPLIT_PACKETS):
        smem = 4 * packets * (num_regs + chains)
        if smem > _build.MAX_SHARED_BYTES:
            continue
        blocks = min(_build.SM_SHARED_BYTES // (smem + _build.BLOCK_RESERVED_BYTES),
                     _build.SM_MAX_THREADS // threads, _build.SM_MAX_BLOCKS)
        if blocks * packets > most:
            best, most = packets, blocks * packets
    if best is None:
        raise ValueError(
            f"{num_regs} registers + {chains} chains need {16 * (num_regs + chains)} B of shared memory at "
            f"{min(SPLIT_PACKETS)} packets per block, beyond the {_build.MAX_SHARED_BYTES} B limit of one "
            "block: the split route keeps each packet's register file in shared memory")
    return best


def make_split(plan: Plan, tables: tuple) -> SplitPlan:
    """The :class:`SplitPlan` of ``tables`` (the 8 op-tables as numpy
    arrays, checked by :func:`make_plan`) over the register count of
    ``plan``, their plan.  Raises ``ValueError`` where the route cannot hold
    the file (:func:`split_fits`)."""
    num_regs = plan.num_regs
    if not split_fits(plan, num_regs):
        raise ValueError(
            f"{num_regs} registers + {plan.max_chains} chains of one element need "
            f"{16 * (num_regs + plan.max_chains)} B of shared memory at {min(SPLIT_PACKETS)} packets "
            f"per block, beyond the {_build.MAX_SHARED_BYTES} B limit of one block (or more than "
            f"{SPLIT_WRITES * SPLIT_MAX_THREADS} chains): the split route keeps each packet's register "
            "file in shared memory")
    opcode, dst, src0, src1, imm0, imm1, mask, first_write = tables
    keep = np.where(opcode == lowering.SHR_AND_IMM, imm1 & mask, mask).astype(np.int64)
    imm0 = imm0.astype(np.int64)
    # A merged phase's chains are distinct registers; the buffer stays
    # within what a block of 4 packets holds.
    cap = max(plan.max_chains, min(num_regs, _build.MAX_SHARED_BYTES // 16 - num_regs,
                                   SPLIT_WRITES * SPLIT_MAX_THREADS))
    num_el = opcode.shape[0]
    live = [_live_rows(opcode[e], dst[e], first_write[e], keep[e]) for e in range(num_el)]
    phase_of = np.zeros(num_el, np.int64)
    # The latest phase that writes each register, that writes it with
    # anything but a store of 0, and that reads it.  Stores of 0 (the pads'
    # register) may land in any order among themselves.
    last_write, last_value, last_read = (np.full(num_regs, -1, np.int64) for _ in range(3))
    written: list[set] = []
    for e in range(num_el):
        rows = live[e]
        reads = _reads(opcode[e][rows], src0[e][rows], src1[e][rows], keep[e][rows])
        d, k, f = dst[e][rows], keep[e][rows], first_write[e][rows] != 0
        writes, counts = np.unique(d, return_counts=True)
        zero = np.isin(writes, d[f & (k == 0)]) & (counts == 1)
        ph = int(max(last_write[reads].max(initial=-1) + 1, last_write[writes[~zero]].max(initial=0),
                     last_value[writes[zero]].max(initial=0), last_read[writes].max(initial=0)))
        new = set(writes.tolist())
        while ph < len(written) and len(written[ph] | new) > cap:
            ph += 1
        if ph == len(written):
            written.append(set())
        written[ph] |= new
        phase_of[e] = ph
        last_write[writes] = np.maximum(last_write[writes], ph)
        last_value[writes[~zero]] = np.maximum(last_value[writes[~zero]], ph)
        last_read[reads] = np.maximum(last_read[reads], ph)

    def phase_rows(members):
        cols = [np.concatenate([t[e][live[e]] for e in members]).astype(np.int64)
                for t in (opcode, dst, src0, src1, imm0, keep, first_write)]
        again = _live_rows(cols[0], cols[1], cols[6], cols[5])  # across the phase's elements
        return [c[again] for c in cols]

    num_phases = int(phase_of.max(initial=-1)) + 1
    members = [[] for _ in range(num_phases)]
    for e, ph in enumerate(phase_of.tolist()):
        members[ph].append(e)
    runs = [phase_rows(m) for m in members]
    chains = max((len(np.unique(r[1])) for r in runs), default=0)
    threads = split_threads(chains)
    bodies = [_phase_records(r, threads) for r in runs]
    head = _pad4(np.zeros(len(runs), np.uint32))
    offsets, at = [], len(head) // 4
    for words, _ in bodies:
        offsets.append(at)
        at += len(words) // 4
    if at >= 1 << 32:
        raise ValueError(f"a split plan of {at} 16-byte units is beyond its 32-bit offsets")
    head[:len(runs)] = offsets
    records = np.concatenate([head, *(w for w, _ in bodies)]) if bodies else head
    return SplitPlan(num_regs=num_regs, threads=threads, packets=split_packets(num_regs, chains, threads),
                     chains=chains, phase_of=phase_of, num_phases=num_phases,
                     rows=int(sum(len(r[1]) for r in runs)), table_rows=int(plan.rows.sum()), records=records)


# Plans of the table tensors kernels ran on, keyed by the opcode tensor.  An
# entry holds weak references to all eight tensors and their versions, so
# tables edited in place, or other tensors, are planned (and checked) anew,
# and an entry goes with its opcode tensor.
_PLANS = WeakIdKeyDictionary()
# The split route's plan and its device records, keyed by the Plan of the
# same tables: an entry goes with its plan.
_SPLITS = weakref.WeakKeyDictionary()


def prepare(tables: tuple, num_regs: int, host_tables: tuple | None = None) -> tuple[Plan, torch.Tensor]:
    """The plan of ``tables`` (the 8 op-table tensors, on one device) for a
    ``num_regs`` register file, and its records on that device; cached.

    ``host_tables``, the same tables as numpy arrays, spares the copy from
    the device (the executor passes its ``LoweredProgram``'s).  Where
    :func:`route` gives ``"split"``, the split plan is made from them too
    (:func:`prepare_split`).  Raises on malformed tables.
    """
    versions = (num_regs, *(t._version for t in tables))
    hit = _PLANS.get(tables[0])
    if hit is not None:
        refs, seen, plan, records = hit
        if seen == versions and all(ref() is t for ref, t in zip(refs, tables)):
            return plan, records
    if host_tables is None:
        host_tables = tuple(t.cpu().numpy() for t in tables)
    plan = make_plan(*host_tables, num_regs)
    records = torch.from_numpy(plan.records.view(np.int32)).to(tables[0].device)
    _PLANS[tables[0]] = (tuple(weakref.ref(t) for t in tables), versions, plan, records)
    if route(plan, num_regs) == "split":
        _split_entry(plan, host_tables, tables[0].device)
    return plan, records


def _split_entry(plan: Plan, host_tables: tuple, device) -> tuple[SplitPlan, torch.Tensor]:
    sp = make_split(plan, host_tables)
    entry = _SPLITS[plan] = (sp, torch.from_numpy(sp.records.view(np.int32)).to(device))
    return entry


def prepare_split(tables: tuple, num_regs: int, host_tables: tuple | None = None
                  ) -> tuple[SplitPlan, torch.Tensor]:
    """The split route's plan of ``tables`` and its records on their
    device, cached beside their :func:`prepare` plan; for a program that
    routes elsewhere it is made on the first call (copying the tables from
    the device unless ``host_tables`` is given).  Raises ``ValueError``
    where the route cannot hold the file."""
    plan, _ = prepare(tables, num_regs, host_tables)
    hit = _SPLITS.get(plan)
    if hit is not None:
        return hit
    if host_tables is None:
        host_tables = tuple(t.cpu().numpy() for t in tables)
    return _split_entry(plan, host_tables, tables[0].device)


def optable_run(
    regs: torch.Tensor,
    opcode: torch.Tensor,
    dst: torch.Tensor,
    src0: torch.Tensor,
    src1: torch.Tensor,
    imm0: torch.Tensor,
    imm1: torch.Tensor,
    mask: torch.Tensor,
    first_write: torch.Tensor,
) -> torch.Tensor:
    """Run the op-table over a transposed register file.

    ``regs``: (num_regs, batch) int32 bit views — parsed packets, one column
    each.  Tables: (num_elements, max_rows) int32.  Returns the final
    (num_regs, batch) register file as a new tensor.
    """
    tables = (opcode, dst, src0, src1, imm0, imm1, mask, first_write)
    _check_args(regs, tables)
    if regs.device.type == "cpu":
        return optable_run_plain(regs, *tables)
    if regs.device.type != "cuda":
        raise ValueError(f"optable_run runs on CPU or CUDA tensors, got {regs.device}")
    _build.refuse_grad("optable_run", regs, *tables)
    num_regs = regs.shape[0]
    plan, records = prepare(tables, num_regs)
    path = route(plan, num_regs)
    if path == "split":
        plan, records = prepare_split(tables, num_regs)
    return _launch(regs.contiguous(), plan, records, path)


def _launch(regs: torch.Tensor, plan: Plan | SplitPlan, records: torch.Tensor, path: str) -> torch.Tensor:
    """Launch route ``path``'s kernel on a checked, contiguous CUDA register
    file and a plan of its tables with its records: :func:`prepare`'s, or on
    ``"split"`` :func:`prepare_split`'s; returns the new file.  A
    ``"shared"`` launch whose file does not fit raises ``ValueError``
    (:func:`plan_threads`).  An empty batch or program launches nothing."""
    if path not in ROUTES:
        raise ValueError(f"optable_run has routes {ROUTES}, not {path!r}")
    if isinstance(plan, SplitPlan) != (path == "split"):
        raise ValueError(f"route {path!r} takes a {'SplitPlan' if path == 'split' else 'Plan'}, "
                         f"not a {type(plan).__name__}")
    num_regs, batch = regs.shape
    if num_regs != plan.num_regs:
        raise ValueError(f"a plan for {plan.num_regs} registers, a file of {num_regs}")
    if path == "shared":
        threads = plan_threads(plan, num_regs)
    elif path == "global":
        threads = global_threads(batch, torch.cuda.get_device_properties(regs.device).multi_processor_count)
    empty = plan.num_phases == 0 if path == "split" else plan.records.shape[0] == 0
    if batch == 0 or empty:
        return regs.clone()
    lib = _build.library("optable_exec", _SIGNATURES)
    stream = _build.stream_of(regs)
    with torch.cuda.device(regs.device):
        if path == "split":
            out = torch.empty_like(regs)
            code = lib.optable_run_split(
                records.data_ptr(), regs.data_ptr(), out.data_ptr(), num_regs, batch,
                plan.num_phases, plan.chains, plan.packets, plan.threads, stream,
            )
        elif path == "shared":
            out = torch.empty_like(regs)
            code = lib.optable_run(
                records.data_ptr(), regs.data_ptr(), out.data_ptr(),
                num_regs, batch, plan.records.shape[0], plan.stride, plan.max_deferred, threads, stream,
            )
        else:
            # Registers, then the scratch rows, slot-major in device memory:
            # the kernel runs in place and the first num_regs rows are the result.
            file = torch.empty((num_regs + plan.max_deferred, batch), dtype=torch.int32, device=regs.device)
            file[:num_regs].copy_(regs)
            out = file[:num_regs]
            code = lib.optable_run_global(
                records.data_ptr(), file.data_ptr(), num_regs, batch, plan.records.shape[0], plan.stride,
                threads, stream,
            )
    _build.check(lib, code, "optable_run")
    optable_run.launches += 1
    op_counts.charge("optable_run", _cost, num_regs, batch, plan, records)
    optable_run.launches_by_route[path] += 1
    return out


def _cost(num_regs: int, batch: int, plan: Plan | SplitPlan, records) -> costs.Cost:
    """``optable_run``'s cost: the tables' true rows (the same work whatever
    the route; a plan's row total is summed only when a count is open) and
    the records the launch reads."""
    rows = plan.table_rows if isinstance(plan, SplitPlan) else int(plan.rows.sum())
    return costs.optable_run(num_regs, batch, rows, records.nbytes)


optable_run.launches = 0
optable_run.launches_by_route = dict.fromkeys(ROUTES, 0)


def optable_run_segmented(
    regs: torch.Tensor,
    opcode: torch.Tensor,
    dst: torch.Tensor,
    src0: torch.Tensor,
    src1: torch.Tensor,
    imm0: torch.Tensor,
    imm1: torch.Tensor,
    mask: torch.Tensor,
    first_write: torch.Tensor,
    *,
    runs: tuple[tuple[int, int, tuple[int, ...]], ...],
) -> torch.Tensor:
    """Run opcode-homogeneous element segments back to back.

    ``runs`` is ``LoweredProgram.opcode_runs()``; it must cover the elements
    in order.  Bit-identical to one :func:`optable_run` over the whole table,
    which is what this does: the kernel branches once per group of rows on
    their opcode, alike across a block, so narrowing the ALU per run (the
    reference's reason for segments) buys nothing, and one launch keeps the
    register file on chip throughout.
    """
    expect = 0
    for start, stop, _ in runs:
        if start != expect or stop <= start:
            raise ValueError(f"opcode runs {runs} do not tile the elements in order")
        expect = stop
    if expect != opcode.shape[0]:
        raise ValueError(f"opcode runs end at {expect}, table has {opcode.shape[0]} elements")
    return optable_run(regs, opcode, dst, src0, src1, imm0, imm1, mask, first_write)


def optable_run_plain(
    regs: torch.Tensor,
    opcode: torch.Tensor,
    dst: torch.Tensor,
    src0: torch.Tensor,
    src1: torch.Tensor,
    imm0: torch.Tensor,
    imm1: torch.Tensor,
    mask: torch.Tensor,
    first_write: torch.Tensor,
) -> torch.Tensor:
    """The kernel's semantics in plain PyTorch, on any device.

    One vectorized step per element over uint32 carriers.  Pass 2 reproduces
    the in-order write-back exactly: a row counts unless a *later*
    first_write row targets the same slot, slots with a first_write row start
    from 0, the others from their incoming value.
    """
    from repro_torch.dataplane.executor import alu_variants

    _check_values(regs, opcode, dst, src0, src1)
    r = bitops.i32_to_u32(regs)
    i0s, i1s, ms = (bitops.i32_to_u32(t) for t in (imm0, imm1, mask))
    rows = opcode.shape[1]
    later = torch.ones((rows, rows), dtype=torch.bool, device=regs.device).triu(1)
    for e in range(opcode.shape[0]):
        opc = opcode[e]
        r0 = r[src0[e].long()]  # (rows, batch)
        r1 = r[src1[e].long()]
        variants = alu_variants(
            r0, r1, i0s[e][:, None], i1s[e][:, None], tuple(range(lowering.NUM_DENSE_OPCODES))
        )
        _, val = variants[0]
        for code, v in variants[1:]:
            val = torch.where((opc == code)[:, None], v, val)
        val = val & ms[e][:, None]

        d = dst[e].long()
        fw = first_write[e] != 0
        superseded = ((d[None, :] == d[:, None]) & later & fw[None, :]).any(1)
        r.index_fill_(0, d[fw], 0)
        r.index_add_(0, d, torch.where(superseded[:, None], 0, val))
        r &= bitops.MASK32
    return bitops.u32_to_i32(r)
