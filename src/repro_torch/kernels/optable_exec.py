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

The kernel has two routes, chosen before the launch by :func:`route`, a
pure function of the plan and the register count:

* ``"shared"``: a packet's registers and scratch rows live in shared memory
  (a block of :func:`plan_threads` packets);
* ``"global"``: they do not fit one packet's share of a block at 32 packets
  (a merge of 32 or more tenants), so they live in device memory, in a
  ``(num_regs + max_deferred, batch)`` file the wrapper allocates.

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
ROUTES = ("shared", "global")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "optable_run": ([_P, _P, _P] + [_I] * 6 + [_P], ctypes.c_int),
    "optable_run_global": ([_P, _P] + [_I] * 5 + [_P], ctypes.c_int),
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


def route(plan: "Plan", num_regs: int) -> str:
    """The kernel a CUDA launch on ``plan`` over ``num_regs`` registers
    takes: ``"shared"`` where :func:`plan_threads` finds a block size, else
    ``"global"``.  Pure: it reads the plan's sizes only."""
    fits = _fit_threads(num_regs, plan.max_deferred, 2 * plan.stride * 16) is not None
    return "shared" if fits else "global"


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
    """

    rows: np.ndarray          # (E,) int32
    zero_reg: np.ndarray      # (E,) int32
    deferred: np.ndarray      # (E, max_rows) bool, False past rows[e]
    max_deferred: int
    stride: int
    records: np.ndarray       # (E, 4 * stride) uint32


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
    return Plan(rows=rows, zero_reg=zero, deferred=deferred, max_deferred=max_def,
                stride=stride, records=records)


# Plans of the table tensors kernels ran on, keyed by the opcode tensor.  An
# entry holds weak references to all eight tensors and their versions, so
# tables edited in place, or other tensors, are planned (and checked) anew,
# and an entry goes with its opcode tensor.
_PLANS = WeakIdKeyDictionary()


def prepare(tables: tuple, num_regs: int, host_tables: tuple | None = None) -> tuple[Plan, torch.Tensor]:
    """The plan of ``tables`` (the 8 op-table tensors, on one device) for a
    ``num_regs`` register file, and its records on that device; cached.

    ``host_tables``, the same tables as numpy arrays, spares the copy from
    the device (the executor passes its ``LoweredProgram``'s).  Raises on
    malformed tables.
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
    return plan, records


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
    return _launch(regs.contiguous(), plan, records, route(plan, num_regs))


def _launch(regs: torch.Tensor, plan: Plan, records: torch.Tensor, path: str) -> torch.Tensor:
    """Launch route ``path``'s kernel on a checked, contiguous CUDA register
    file and a plan of its tables (:func:`prepare`); returns the new file.
    A ``"shared"`` launch whose file does not fit raises ``ValueError``
    (:func:`plan_threads`).  An empty batch or program launches nothing."""
    if path not in ROUTES:
        raise ValueError(f"optable_run has routes {ROUTES}, not {path!r}")
    num_regs, batch = regs.shape
    num_el = plan.records.shape[0]
    threads = plan_threads(plan, num_regs) if path == "shared" else global_threads(
        batch, torch.cuda.get_device_properties(regs.device).multi_processor_count)
    if batch == 0 or num_el == 0:
        return regs.clone()
    lib = _build.library("optable_exec", _SIGNATURES)
    stream = _build.stream_of(regs)
    with torch.cuda.device(regs.device):
        if path == "shared":
            out = torch.empty_like(regs)
            code = lib.optable_run(
                records.data_ptr(), regs.data_ptr(), out.data_ptr(),
                num_regs, batch, num_el, plan.stride, plan.max_deferred, threads, stream,
            )
        else:
            # Registers, then the scratch rows, slot-major in device memory:
            # the kernel runs in place and the first num_regs rows are the result.
            file = torch.empty((num_regs + plan.max_deferred, batch), dtype=torch.int32, device=regs.device)
            file[:num_regs].copy_(regs)
            out = file[:num_regs]
            code = lib.optable_run_global(
                records.data_ptr(), file.data_ptr(), num_regs, batch, num_el, plan.stride, threads, stream,
            )
    _build.check(lib, code, "optable_run")
    optable_run.launches += 1
    op_counts.charge("optable_run", _cost, num_regs, batch, plan, records)
    optable_run.launches_by_route[path] += 1
    return out


def _cost(num_regs: int, batch: int, plan: Plan, records) -> costs.Cost:
    """``optable_run``'s cost; the plan's row total is summed only when a
    count is open."""
    return costs.optable_run(num_regs, batch, int(plan.rows.sum()), records.nbytes)


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
