"""Op-table ALU of the dataplane executor: CUDA kernel + plain PyTorch version.

Replaces the Pallas TPU kernel ``repro/kernels/optable_exec.py::optable_run``
(source: ``csrc/optable_exec.cu``, whose header note says what bounds it and
how it is laid out).  The register file is transposed — ``(num_regs, batch)``
— and holds int32 bit views of uint32 values; the tables are those of
``dataplane.lowering.LoweredProgram`` with the uint32 ones (``imm0``,
``imm1``, ``mask``) as int32 bit views too.

``optable_run`` dispatches on the register file's device: a CPU tensor runs
:func:`optable_run_plain`, a CUDA tensor launches the kernel (or raises).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import bitops
from repro_torch.dataplane import lowering
from repro_torch.kernels import _build

BLOCK_THREADS = (128, 64, 32)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {"optable_run": ([_P] * 10 + [_I] * 5 + [_P], ctypes.c_int)}


def block_threads(num_regs: int, max_rows: int) -> int:
    """Packets per block: the most of ``BLOCK_THREADS`` whose register files
    and row scratch, ``(num_regs + max_rows) * 4`` bytes each, fit one block's
    shared memory."""
    for threads in BLOCK_THREADS:
        if (num_regs + max_rows) * 4 * threads <= _build.MAX_SHARED_BYTES:
            return threads
    raise ValueError(
        f"{num_regs} registers + {max_rows} rows do not fit shared memory "
        f"even at {BLOCK_THREADS[-1]} packets per block"
    )


def _check_args(regs, tables) -> None:
    if regs.ndim != 2 or regs.dtype != torch.int32:
        raise ValueError(f"regs must be (num_regs, batch) int32, got {regs.dtype} {tuple(regs.shape)}")
    shape = tables[0].shape
    for t in tables:
        if t.dtype != torch.int32 or t.shape != shape or t.ndim != 2:
            raise ValueError("op-tables must be (num_elements, max_rows) int32, all one shape")
        if t.device != regs.device:
            raise ValueError(f"op-table on {t.device}, register file on {regs.device}")


def _check_values(regs, opcode, dst, src0, src1) -> None:
    """Reject opcodes outside the dense ISA and slots outside the register
    file before any kernel can read or write out of bounds."""
    num_regs = regs.shape[0]
    bad = (opcode < 0) | (opcode >= lowering.NUM_DENSE_OPCODES)
    for slots in (dst, src0, src1):
        bad |= (slots < 0) | (slots >= num_regs)
    if bool(bad.any()):
        raise ValueError(
            f"op-table holds an opcode outside 0..{lowering.NUM_DENSE_OPCODES - 1} "
            f"or a slot outside 0..{num_regs - 1}"
        )


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
    _check_values(regs, opcode, dst, src0, src1)
    regs = regs.contiguous()
    tables = tuple(t.contiguous() for t in tables)
    num_regs, batch = regs.shape
    num_el, rows = opcode.shape
    out = torch.empty_like(regs)
    if batch == 0 or num_el == 0:
        out.copy_(regs)
        return out
    threads = block_threads(num_regs, rows)
    lib = _build.library("optable_exec", _SIGNATURES)
    with torch.cuda.device(regs.device):
        code = lib.optable_run(
            *(t.data_ptr() for t in tables), regs.data_ptr(), out.data_ptr(),
            num_regs, batch, num_el, rows, threads, _build.stream_of(regs),
        )
    _build.check(lib, code, "optable_run")
    optable_run.launches += 1
    return out


optable_run.launches = 0


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
    which is what this does: the kernel's opcode ``switch`` is warp-uniform,
    so narrowing the ALU per run (the reference's reason for segments) buys
    nothing, and one launch keeps the register file on chip throughout.
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
    the kernel's in-order write-back exactly: a row counts unless a *later*
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
