"""PyTorch executor for compiled RMT pipeline programs, op by op.

This is the "chip in software": it evaluates a :class:`PipelineProgram` on a
batch of packets using exactly the element semantics of RMT — every op of an
element reads the *incoming* PHV, all writes land simultaneously
(read-before-write), results are truncated to the destination field's width.

The interpreter is the port's own correctness witness: it walks the program
as the compiler emitted it, with no lowering and no kernel, so the dataplane
executor's op-table and packed paths are held against it.  Values are uint32
in int64 carriers (see ``core.bitops``).
"""
from __future__ import annotations

import torch

from repro_torch.core import bitops
from repro_torch.core.pipeline import Op, OpCode, PipelineProgram
from repro_torch.device import resolve_device


def _width_mask(width: int) -> int:
    return (1 << width) - 1 if width < 32 else bitops.MASK32


def _eval_op(op: Op, regs: torch.Tensor) -> torch.Tensor:
    """Evaluate one op against the element's incoming register file.

    ``regs``: (batch, num_fields) int64 carriers.  Returns the (batch,) result.
    """
    code = op.opcode
    src = [regs[:, s.fid] for s in op.srcs]
    if code == OpCode.COPY:
        val = src[0]
    elif code == OpCode.XNOR_IMM:
        val = bitops.xnor(src[0], op.imm[0])
    elif code == OpCode.AND_IMM:
        val = src[0] & op.imm[0]
    elif code == OpCode.SHR_AND_IMM:
        val = bitops.shr(src[0], op.imm[0]) & op.imm[1]
    elif code == OpCode.ADD:
        val = bitops.add(src[0], src[1])
    elif code == OpCode.GE_IMM:
        val = bitops.ge(src[0], op.imm[0])
    elif code == OpCode.FOLD:
        val = torch.zeros_like(regs[:, 0])
        for k, s in enumerate(src):
            val = val | bitops.shl(s, k)
    elif code == OpCode.POPCNT:
        val = bitops.hakmem_popcount(src[0])
    else:  # pragma: no cover
        raise ValueError(f"unknown opcode {code}")
    return val & _width_mask(op.dst.width)


def run_program(
    prog: PipelineProgram, packets, *, device="cuda"
) -> torch.Tensor:
    """Run a compiled program on a batch of packets.

    ``packets``: (batch, input_bits) {0,1} tensor or array — the parsed
    activation bits.  Returns (batch, output_bits) {0,1} int32 on ``device``
    — the network's Y vector.
    """
    device = resolve_device(device)
    packets = torch.as_tensor(packets, device=device)
    if packets.ndim != 2 or packets.shape[1] != prog.input_bits:
        raise ValueError(
            f"expected (batch, {prog.input_bits}) packet bits, got {tuple(packets.shape)}"
        )
    batch = packets.shape[0]
    regs = torch.zeros((batch, prog.num_fields), dtype=torch.int64, device=device)

    # Load the input activation bits into the input fields (parser step).
    off = 0
    for f in prog.input_fields:
        bits = packets[:, off : off + f.width].to(torch.int64)
        weights = 1 << torch.arange(f.width, device=device)
        regs[:, f.fid] = (bits * weights).sum(1)
        off += f.width

    # Execute elements: read-before-write within each element.
    for el in prog.elements:
        if not el.ops:
            continue
        vals = torch.stack([_eval_op(op, regs) for op in el.ops], dim=1)
        idx = torch.tensor([op.dst.fid for op in el.ops], device=device)
        regs[:, idx] = vals

    # Deparse: output fields -> flat bit vector.
    outs = []
    for f in prog.output_fields:
        shifts = torch.arange(f.width, device=device)
        outs.append((regs[:, f.fid, None] >> shifts) & 1)
    return torch.cat(outs, dim=1).to(torch.int32)
