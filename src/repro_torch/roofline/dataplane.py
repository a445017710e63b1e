"""Packets-per-second bound of a dataplane dispatch on one H100.

The reference costs the compiled HLO of a stream or fleet dispatch against
TPU constants.  The port has no HLO: it counts one dispatch of P packets
from the lowered program's tables instead, against the H100 peaks of
``roofline.hw``:

* **bytes** — only the compulsory ones: the int32 packet bits read once,
  the int32 output bits written once, and the tables the dispatch reads
  once (the op-table kernel's plan records and the parse / deparse tables;
  the packed layers' weights, masks and thresholds).  Register files and
  the words between layers stay on chip in the best case, so their round
  trips are not counted.
* **32-bit integer operations** — each kernel's operations as
  ``roofline.kernels`` counts them (population counts apart), and parse
  and deparse: a shift and an add per input bit, a shift and a mask per
  output bit.
* **population counts** — the packed layers', at their own rate.

``step_time_s`` is the largest of the three times, so ``roofline_pps`` is
an upper bound and ``fraction(measured_pps)`` cannot pass 1 unless the
count is wrong.  The gauges keep the reference's names
(``roofline.hlo_bytes``, ``roofline.hlo_flops`` carry these counts) and
``path`` labels (``"packed"``, ``"jnp"``, ``"packed+scan"``,
``"fleet64:packed"``), so ``tools/obs_report.py`` renders them unchanged.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.roofline import hw, kernels

__all__ = [
    "DataplaneRoofline",
    "dispatch_counts",
    "probe_fleet",
    "probe_stream",
    "record",
]

_CACHE: dict[tuple, "DataplaneRoofline"] = {}


@dataclasses.dataclass(frozen=True)
class DataplaneRoofline:
    """Counts and bound of one dataplane dispatch."""

    path: str            # e.g. "packed", "jnp", "packed+scan", "fleet64:packed"
    fingerprint: str     # LoweredProgram.fingerprint()
    chunk: int           # packets per stream per dispatch
    streams: int         # 1 for a single stream; N for a fleet
    bytes: int           # compulsory bytes
    int_ops: int         # 32-bit integer operations
    popcounts: int       # population counts

    @property
    def packets(self) -> int:
        """Packets per dispatch."""
        return self.chunk * self.streams

    @property
    def hlo_bytes(self) -> int:
        """The compulsory bytes, under the reference's gauge name."""
        return self.bytes

    @property
    def hlo_flops(self) -> int:
        """Every operation (integer and population count), under the
        reference's gauge name."""
        return self.int_ops + self.popcounts

    @property
    def memory_s(self) -> float:
        return self.bytes / hw.HBM_BYTES_PER_S

    @property
    def int_s(self) -> float:
        return self.int_ops / hw.INT32_OPS_PER_S

    @property
    def popcount_s(self) -> float:
        return self.popcounts / hw.POPC_PER_S

    @property
    def step_time_s(self) -> float:
        """Least seconds a dispatch could take: the largest of the three."""
        return max(self.memory_s, self.int_s, self.popcount_s)

    @property
    def bottleneck(self) -> str:
        terms = {"bytes": self.memory_s, "int32": self.int_s, "popcount": self.popcount_s}
        return max(terms, key=terms.get)

    @property
    def roofline_pps(self) -> float:
        """Packets per second the card could reach on this dispatch."""
        t = self.step_time_s
        return self.packets / t if t > 0 else math.inf

    @property
    def bytes_per_packet(self) -> float:
        return self.bytes / self.packets if self.packets else 0.0

    def fraction(self, measured_pps: float) -> float:
        """measured / bound."""
        bound = self.roofline_pps
        if not (measured_pps > 0) or not math.isfinite(bound) or bound <= 0:
            return 0.0
        return measured_pps / bound


def _packed_layers(lowered, scan_hops: bool) -> list[tuple]:
    """(input bits, words, outputs, table bytes) of each packed layer as the
    dispatch runs it: the layer's own shapes, or the stacked (padded) ones
    of the scan plan."""
    from repro_torch.dataplane.lowering import stack_packed_layers

    if lowered.packed is None:
        raise ValueError("program has no bit-packed plan")
    if not scan_hops:
        return [(pl.n_in, pl.n_words, pl.n_out, pl.weights.nbytes + pl.mask.nbytes + pl.thresholds.nbytes)
                for pl in lowered.packed.layers]
    sp = stack_packed_layers(lowered.packed)
    per_layer = (sp.weights.nbytes + sp.mask.nbytes + sp.thresholds.nbytes) // sp.num_layers
    return [(sp.max_bits, sp.max_words, sp.max_out, per_layer)] * sp.num_layers


def dispatch_counts(lowered, backend: str, packets: int, scan_hops: bool = False) -> tuple[int, int, int]:
    """(bytes, integer operations, population counts) of one dispatch of
    ``packets`` packets through ``lowered`` on ``backend`` (the module
    docstring says what is counted)."""
    nbytes = packets * (lowered.input_bits + lowered.output_bits) * 4
    if backend == "packed":
        int_ops = popcounts = 0
        for n_in, n_words, n_out, table_bytes in _packed_layers(lowered, scan_hops):
            popc = kernels.packed_layer_popcounts(packets, n_words, n_out)
            int_ops += kernels.bitpack(packets, n_in).ops + kernels.packed_layer(packets, n_words, n_out).ops - popc
            popcounts += popc
            nbytes += table_bytes
        return nbytes, int_ops, popcounts
    from repro_torch.kernels.optable_exec import make_plan

    lp = lowered
    records = make_plan(lp.opcode, lp.dst, lp.src0, lp.src1, lp.imm0, lp.imm1, lp.mask, lp.first_write,
                        lp.num_regs).records.nbytes
    # The parse tables (slot and shift, int64) and the deparse tables (slot
    # int64, shift int32), one entry a bit.
    nbytes += records + 16 * lp.input_bits + 12 * lp.output_bits
    int_ops = kernels.optable_run(lp.num_regs, packets, lp.num_ops, records).ops
    int_ops += packets * 2 * (lp.input_bits + lp.output_bits)
    return nbytes, int_ops, 0


def _probe(lowered, path: str, backend: str, chunk: int, streams: int, scan_hops: bool) -> DataplaneRoofline:
    key = (lowered.fingerprint(), path, chunk, streams)
    hit = _CACHE.get(key)
    if hit is None:
        nbytes, int_ops, popcounts = dispatch_counts(lowered, backend, chunk * streams, scan_hops)
        hit = _CACHE[key] = DataplaneRoofline(
            path=path, fingerprint=lowered.fingerprint(), chunk=chunk, streams=streams,
            bytes=nbytes, int_ops=int_ops, popcounts=popcounts,
        )
    return hit


def _resolve(backend) -> str:
    from repro_torch.dataplane.executor import resolve_backend

    return resolve_backend(backend)


def probe_stream(lowered, *, backend: str, chunk: int, scan_hops: bool = False) -> DataplaneRoofline:
    """Bound of one ``executor._run_chunk`` dispatch of ``chunk`` packets —
    what ``execute`` / ``execute_stream`` run."""
    backend = _resolve(backend)
    path = backend + ("+scan" if scan_hops else "")
    return _probe(lowered, path, backend, chunk, 1, scan_hops)


def probe_fleet(
    lowered, *, backend: str, streams: int, chunk: int, scan_hops: bool = False
) -> DataplaneRoofline:
    """Bound of one fleet dispatch: ``streams`` streams of ``chunk`` packets
    folded into one ``executor._run_chunk`` (``fleet.fleet_fn``)."""
    backend = _resolve(backend)
    path = f"fleet{streams}:{backend}" + ("+scan" if scan_hops else "")
    return _probe(lowered, path, backend, chunk, streams, scan_hops)


def record(rf: DataplaneRoofline, measured_pps: float | None = None) -> None:
    """Publish a probe's counts and bound (and the fraction of it reached,
    when a measured rate is known) as ``roofline.*`` gauges in the global
    obs registry; a no-op when observability is off."""
    from repro_torch import obs

    if not obs.enabled():
        return
    m = obs.registry()
    m.gauge("roofline.hlo_bytes", path=rf.path).set(rf.hlo_bytes)
    m.gauge("roofline.hlo_flops", path=rf.path).set(rf.hlo_flops)
    m.gauge("roofline.bytes_per_packet", path=rf.path).set(rf.bytes_per_packet)
    m.gauge("roofline.pps_bound", path=rf.path).set(rf.roofline_pps)
    if measured_pps is not None and measured_pps > 0:
        m.gauge("roofline.fraction", path=rf.path).set(rf.fraction(measured_pps))
