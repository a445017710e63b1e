"""P4 source generation for compiled N2Net programs.

Emits a P4_16-flavoured program: one header carrying the PHV fields the
program uses, one action per pipeline element (each action body is the
element's parallel primitive ops), and an ``apply`` block that invokes the
element actions in pipeline order.  This is the artifact the paper's
compiler contributes ("creates a P4 description that modifies/replicates the
above five steps as needed").

The emitted code targets the v1model-style pipeline; it is meant to be
reviewed/compiled by a P4 toolchain, not executed here — the executable
semantics live in ``core.interpreter``.
"""
from __future__ import annotations

import io

from repro_torch.core.pipeline import Op, OpCode, PipelineProgram


def _c(field) -> str:
    """C-identifier for a field."""
    return "f" + str(field.fid)


def _stmt(op: Op) -> str:
    d = f"hdr.n2net.{_c(op.dst)}"
    s = [f"hdr.n2net.{_c(f)}" for f in op.srcs]
    mask = (1 << op.dst.width) - 1
    if op.opcode == OpCode.COPY:
        return f"{d} = {s[0]};"
    if op.opcode == OpCode.XNOR_IMM:
        return f"{d} = (~({s[0]} ^ {op.imm[0]:#x})) & {mask:#x};"
    if op.opcode == OpCode.AND_IMM:
        return f"{d} = {s[0]} & {op.imm[0]:#x};"
    if op.opcode == OpCode.SHR_AND_IMM:
        return f"{d} = ({s[0]} >> {op.imm[0]}) & {op.imm[1]:#x};"
    if op.opcode == OpCode.ADD:
        return f"{d} = ({s[0]} + {s[1]}) & {mask:#x};"
    if op.opcode == OpCode.GE_IMM:
        return f"{d} = ({s[0]} >= {op.imm[0]}) ? 1w1 : 1w0;"
    if op.opcode == OpCode.FOLD:
        parts = " | ".join(f"((bit<{op.dst.width}>){src} << {k})" for k, src in enumerate(s))
        return f"{d} = {parts};"
    if op.opcode == OpCode.POPCNT:
        return f"{d} = popcnt32({s[0]});  // requires POPCNT primitive (paper §3)"
    raise ValueError(f"unknown opcode {op.opcode}")


def generate_p4(prog: PipelineProgram, name: str = "n2net") -> str:
    """Generate P4 source for a compiled program."""
    out = io.StringIO()
    w = out.write
    w("// Auto-generated by the N2Net compiler (repro.core.compiler).\n")
    w(f"// elements={prog.num_elements} passes={prog.passes} ")
    w(f"peak_phv_bits={prog.peak_phv_bits}\n")
    w("#include <core.p4>\n#include <v1model.p4>\n\n")

    # Header: every field the program ever writes or reads, at true widths.
    seen: dict[int, object] = {}
    for f in prog.input_fields + prog.output_fields:
        seen[f.fid] = f
    for el in prog.elements:
        for op in el.ops:
            seen[op.dst.fid] = op.dst
            for srcf in op.srcs:
                seen[srcf.fid] = srcf
    w(f"header {name}_t {{\n")
    for fid in sorted(seen):
        f = seen[fid]
        w(f"    bit<{f.width}> {_c(f)};  // {f.name}\n")
    w("}\n\n")
    w(f"struct headers_t {{ {name}_t n2net; }}\n")
    w("struct metadata_t { }\n\n")

    w(
        f"control {name}_pipe(inout headers_t hdr, inout metadata_t meta,\n"
        f"                    inout standard_metadata_t std) {{\n"
    )
    for i, el in enumerate(prog.elements):
        w(f"    action element_{i}_{el.stage}() {{\n")
        for op in el.ops:
            w(f"        {_stmt(op)}\n")
        w("    }\n")
    w("    apply {\n")
    for i, el in enumerate(prog.elements):
        w(f"        element_{i}_{el.stage}();\n")
    w("    }\n}\n")
    return out.getvalue()
