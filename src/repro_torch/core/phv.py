"""Packet Header Vector (PHV) model and field allocator.

RMT's PHV is a 512-byte vector exposed to each pipeline element as a set of
containers.  We model fields at their true bit widths for *capacity
accounting* (the constraints that produce the paper's Table 1) while the
interpreter stores every logical field in its own uint32 slot for execution
simplicity — semantics are unaffected because RMT elements read the whole PHV
before writing (read-before-write), and each field is written at most once
per element.

Capacity rules enforced (from the paper / RMT):
  * total live bits at any pipeline stage <= 4096 (512 B);
  * one write per field per element;
  * per-element parallel-op budget accounted at 32-bit ALU granularity
    (sub-word fields share an ALU lane), max 224 ops.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

PHV_BYTES = 512
PHV_BITS = PHV_BYTES * 8  # 4096
MAX_FIELDS = 224           # RMT container count == per-element parallel ops


@dataclasses.dataclass(frozen=True)
class Field:
    """A logical PHV field: an id, a human-readable name, and a bit width."""

    fid: int
    name: str
    width: int  # bits, 1..32

    def __post_init__(self):
        if not (1 <= self.width <= 32):
            raise ValueError(f"field width must be in [1,32], got {self.width}")


class PhvAllocator:
    """Allocates logical fields and tracks live bits per pipeline stage.

    Fields are freed explicitly when a stage's outputs supersede its inputs
    (overlay reuse — RMT lets a stage's action results land in containers its
    match side already consumed).  ``peak_live_bits`` is the number the
    512-byte constraint applies to.
    """

    def __init__(self, phv_bits: int = PHV_BITS):
        self.phv_bits = phv_bits
        self._next = 0
        self._live: dict[int, Field] = {}
        self.peak_live_bits = 0
        self.peak_live_fields = 0

    def alloc(self, name: str, width: int) -> Field:
        f = Field(self._next, name, width)
        self._next += 1
        self._live[f.fid] = f
        self._update_peak()
        return f

    def alloc_vector(self, name: str, width: int, count: int) -> list[Field]:
        return [self.alloc(f"{name}[{i}]", width) for i in range(count)]

    def free(self, fields) -> None:
        for f in fields:
            self._live.pop(f.fid, None)

    def _update_peak(self) -> None:
        bits = sum(f.width for f in self._live.values())
        self.peak_live_bits = max(self.peak_live_bits, bits)
        self.peak_live_fields = max(self.peak_live_fields, len(self._live))

    @property
    def live_bits(self) -> int:
        return sum(f.width for f in self._live.values())

    @property
    def num_fields_created(self) -> int:
        return self._next

    def check(self) -> None:
        if self.peak_live_bits > self.phv_bits:
            raise PhvOverflowError(
                f"PHV overflow: peak live bits {self.peak_live_bits} > "
                f"{self.phv_bits} (512B)"
            )

    def iter_live(self) -> Iterator[Field]:
        return iter(self._live.values())


class PhvOverflowError(Exception):
    """Raised when a program's live fields exceed the 512-byte PHV."""
