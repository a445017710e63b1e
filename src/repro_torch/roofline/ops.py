"""Op-level FLOP and byte counts of one step (the counterpart of the
reference's ``roofline/hlo.py``, which reads them from compiled HLO).

:func:`count` opens a count around eager PyTorch code:

  * FLOPs — every aten op that ``torch.utils.flop_counter`` has a formula
    for (mm, addmm, bmm, baddbmm, convolutions, SDPA), by the same rules as
    ``FlopCounterMode``, split by the type of the product's output.  The
    port's layer loop runs each layer's ops once, so the count needs no
    loop trip counts: it is what the reference's scan-aware ``analyze``
    gets by multiplying a ``while`` body by its trip count.
  * bytes — every aten op that is not a view (nor a bare allocation)
    charges the bytes of its tensor operands and of its outputs, each
    tensor's distinct elements once (a broadcast stride-0 axis counts
    once): ``hlo.py``'s "per materialized op" rule, with nothing fused,
    because eager PyTorch fuses nothing; and by op (``top_ops``).
  * the hand-written kernels — launched through ``ctypes``, they are
    invisible to a dispatch mode.  Each kernel wrapper calls :func:`charge`
    where it counts a launch, with its ``roofline.kernels`` ``Cost``: the
    kernel's compulsory bytes, and its operations at their own peak.  The
    reference leaves its Pallas custom calls out (``"custom-call"`` is in
    ``hlo.py``'s ``_FREE_OPS``); the port counts them.

One device has no collectives, so there is no collective term.  The
dispatch mode costs host time on every op: time a step outside a count.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_aten = torch.ops.aten

# Size and stride queries: answered without running anything
# (``FlopCounterMode`` leaves them alone the same way).
_QUERIES = {
    _aten.sym_is_contiguous.default, _aten.is_contiguous.default, _aten.is_contiguous.memory_format,
    _aten.is_strides_like_format.default, _aten.is_non_overlapping_and_dense.default,
    _aten.size.default, _aten.sym_size.default, _aten.stride.default, _aten.sym_stride.default,
    _aten.storage_offset.default, _aten.sym_storage_offset.default, _aten.numel.default,
    _aten.sym_numel.default, _aten.dim.default, torch.ops.prim.layout.default,
}

# Ops that move no bytes: allocations, and views the schema does not mark
# as aliases.
_FREE = {
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
    _aten.new_empty.default, _aten.new_empty_strided.default, _aten._unsafe_view.default,
    _aten.lift_fresh.default,
}


TOP_OPS = 10   # ops by bytes that ``OpCounts.summary`` lists


@dataclasses.dataclass
class OpCounts:
    """What one count saw."""

    flops_by_dtype: dict = dataclasses.field(default_factory=lambda: collections.defaultdict(float))
    bytes: float = 0.0             # aten ops: operands + outputs
    aten_ops: int = 0              # aten ops that were charged bytes
    kernel_bytes: float = 0.0      # the hand-written kernels' compulsory bytes
    kernel_seconds: float = 0.0    # their operations over their own peaks
    kernel_launches: dict = dataclasses.field(default_factory=lambda: collections.defaultdict(int))
    bytes_by_op: dict = dataclasses.field(default_factory=lambda: collections.defaultdict(float))
    calls_by_op: dict = dataclasses.field(default_factory=lambda: collections.defaultdict(int))

    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    @property
    def total_bytes(self) -> float:
        return self.bytes + self.kernel_bytes

    def top_ops(self, n: int = TOP_OPS) -> list:
        """[op, bytes, calls] of the ``n`` aten ops that moved the most
        bytes, each op named with the type of its first output
        (``aten._to_copy:float32``)."""
        ranked = sorted(self.bytes_by_op, key=self.bytes_by_op.get, reverse=True)[:n]
        return [[op, self.bytes_by_op[op], self.calls_by_op[op]] for op in ranked]

    def summary(self) -> dict:
        return {
            "flops": self.flops,
            "flops_by_dtype": dict(self.flops_by_dtype),
            "aten_bytes": self.bytes,
            "aten_ops": self.aten_ops,
            "kernel_bytes": self.kernel_bytes,
            "kernel_seconds": self.kernel_seconds,
            "kernel_launches": dict(self.kernel_launches),
            "top_ops_by_bytes": self.top_ops(),
        }


_OPEN: list[OpCounts] = []


def charge(name: str, cost_fn, *shape) -> None:
    """Add one launch of kernel ``name`` and its cost, the
    ``roofline.kernels.Cost`` that ``cost_fn(*shape)`` gives, to every
    open count (a kernel wrapper calls this beside ``launches``; with no
    count open it computes nothing)."""
    if not _OPEN:
        return
    cost = cost_fn(*shape)
    for counts in _OPEN:
        counts.kernel_bytes += cost.bytes
        counts.kernel_seconds += cost.ops / cost.rate
        counts.kernel_launches[name] += 1


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements (an axis of stride 0 counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size() if t.numel() else 0


@functools.lru_cache(maxsize=None)
def _is_view(func) -> bool:
    """Whether ``func`` returns an alias of an input that it does not write."""
    return any(r.alias_info is not None and not r.alias_info.is_write for r in func._schema.returns)


class _CountMode(TorchDispatchMode):
    def __init__(self, counts: OpCounts):
        super().__init__()
        self.counts = counts

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES:
            return NotImplemented
        if func is not torch.ops.prim.device.default:
            # A composite op runs as its parts, each counted (as FlopCounterMode does).
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not outs:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.counts.flops_by_dtype[str(outs[0].dtype).removeprefix("torch.")] += float(
                flop_registry[packet](*args, **kwargs, out_val=out))
        if func not in _FREE and not _is_view(func):
            moved = sum(map(tensor_bytes, _tensors((args, kwargs)))) + sum(map(tensor_bytes, outs))
            name = f"{packet}:{str(outs[0].dtype).removeprefix('torch.')}"
            self.counts.aten_ops += 1
            self.counts.bytes += moved
            self.counts.bytes_by_op[name] += moved
            self.counts.calls_by_op[name] += 1
        return out


@contextlib.contextmanager
def count():
    """Count the FLOPs and bytes of what runs inside; yields the
    :class:`OpCounts`, complete when the block ends."""
    counts = OpCounts()
    _OPEN.append(counts)
    try:
        with _CountMode(counts):
            yield counts
    finally:
        _OPEN.remove(counts)
