"""Per-stage and per-hop telemetry for simulated switch fabrics.

Answers the operator questions a real RMT deployment would ask of its
pipeline: how full is the PHV at each element (occupancy), how many ALU
lanes does each element burn (utilization), and how does the *measured*
simulator rate compare with the chip's analytic packets/s from
``core.throughput``.

Occupancy comes from a def/use liveness pass over the program: a field is
live from the element that writes it (the parser, for inputs) through its
last reader (the deparser, for outputs).  An element's occupancy is
``max(live-in, live-out)`` bits — read-before-write means a stage's inputs
and outputs share the PHV transiently without both counting, which is the
same overlay discipline the compiler's allocator enforces, so the peak here
is bounded by ``PipelineProgram.peak_phv_bits``.

Invariants:

* **Observation only** — telemetry never influences execution; it is
  derived from the program (static footprints) and from timings a fabric
  run hands over (measured rates).
* **One liveness rule** — occupancy uses the same def/use pass as the
  lowering's register compaction (``lowering._liveness``), so
  ``max(occupancy_bits) <= PipelineProgram.peak_phv_bits <= chip.phv_bits``
  holds by construction.
* **Budgets judged against the running chip** — utilization denominators
  come from the fabric's ``ChipSpec`` (the switches actually executing),
  not the program's compile-time target.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core import throughput
from repro_torch.core.pipeline import ChipSpec, PipelineProgram
from repro_torch.dataplane.lowering import _liveness
from repro_torch.obs.slo import BreachEvent, SloStatus


@dataclasses.dataclass(frozen=True)
class StageTelemetry:
    """One pipeline element's static footprint."""

    index: int
    stage: str                # which of the paper's 5 steps
    ops: int
    written_bits: int
    alu_lanes: int            # 32-bit lanes consumed (sub-word ops share)
    alu_utilization: float    # lanes / chip budget
    live_in_bits: int
    live_out_bits: int

    @property
    def occupancy_bits(self) -> int:
        return max(self.live_in_bits, self.live_out_bits)


def stage_telemetry(
    prog: PipelineProgram, chip: ChipSpec | None = None
) -> list[StageTelemetry]:
    """Static per-element footprint.  ``chip`` is the hardware the budgets
    are judged against — defaults to the program's compile-time target, but a
    fabric running the program on different switches passes its own."""
    chip = chip or prog.chip
    num_el = len(prog.elements)
    # Same def/use pass the lowering's register compaction runs on — one
    # source of truth for the liveness rules.
    def_elem, last_use = _liveness(prog)
    widths: dict[int, int] = {f.fid: f.width for f in prog.input_fields}
    for el in prog.elements:
        for op in el.ops:
            widths[op.dst.fid] = op.dst.width

    # live-out[e] = sum of widths of fields defined at or before e and used
    # strictly after e; live-in[e] = live-out[e-1].
    live_out = [0] * num_el
    for fid, d in def_elem.items():
        for e in range(max(d, 0), min(last_use[fid], num_el)):
            live_out[e] += widths[fid]
    live_in = [sum(f.width for f in prog.input_fields)] + live_out[:-1]

    out = []
    for e, el in enumerate(prog.elements):
        bits = sum(op.dst.width for op in el.ops)
        lanes = math.ceil(bits / 32)
        out.append(
            StageTelemetry(
                index=e,
                stage=el.stage,
                ops=len(el.ops),
                written_bits=bits,
                alu_lanes=lanes,
                alu_utilization=lanes / chip.max_parallel_ops,
                live_in_bits=live_in[e],
                live_out_bits=live_out[e],
            )
        )
    return out


@dataclasses.dataclass(frozen=True)
class HopTelemetry:
    """One switch in the fabric chain (or one recirculation pass)."""

    hop: int
    elements: int
    element_range: tuple[int, int]
    peak_occupancy_bits: int
    peak_alu_utilization: float
    measured_pps: float | None = None   # simulator rate, if a run was timed


@dataclasses.dataclass(frozen=True)
class FabricTelemetry:
    """Fabric-level rollup: stages, hops, analytic vs measured rate."""

    mode: str
    chip_name: str
    stages: tuple[StageTelemetry, ...]
    hops: tuple[HopTelemetry, ...]
    analytic: throughput.ThroughputReport
    measured_pps: float | None = None

    @property
    def peak_occupancy_bits(self) -> int:
        return max((s.occupancy_bits for s in self.stages), default=0)

    _phv_bits: int = 4096

    @property
    def phv_utilization(self) -> float:
        return self.peak_occupancy_bits / self._phv_bits

    def render(self) -> str:
        """Human-readable telemetry table (the demo/benchmark printout)."""
        lines = [
            f"fabric[{self.chip_name}] mode={self.mode} "
            f"hops={len(self.hops)} elements={self.analytic.elements_used} "
            f"peak_phv={self.peak_occupancy_bits}b",
            f"  analytic: {self.analytic.packets_per_second:.3e} pkt/s "
            f"({self.analytic.passes} pass(es), "
            f"{self.analytic.neurons_per_second:.3e} neurons/s)",
        ]
        if self.measured_pps is not None:
            ratio = self.measured_pps / self.analytic.packets_per_second
            lines.append(
                f"  measured: {self.measured_pps:.3e} pkt/s "
                f"(simulator = {ratio:.2e} x ASIC model)"
            )
        lines.append(
            "  hop  elements   peak-PHV(b)  peak-ALU-util   measured pkt/s"
        )
        for h in self.hops:
            m = f"{h.measured_pps:.3e}" if h.measured_pps is not None else "-"
            lines.append(
                f"  {h.hop:>3}  {h.element_range[0]:>3}..{h.element_range[1]:<4} "
                f" {h.peak_occupancy_bits:>8}     {h.peak_alu_utilization:>6.1%}"
                f"        {m:>10}"
            )
        by_stage: dict[str, int] = {}
        for s in self.stages:
            key = s.stage.split("_l")[0].split("_x")[0]
            by_stage[key] = by_stage.get(key, 0) + 1
        lines.append(
            "  stages: "
            + ", ".join(f"{k}x{v}" for k, v in sorted(by_stage.items()))
        )
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class TenantTelemetry:
    """One tenant's view of a shared chip (``dataplane.multitenant``).

    Static fields come from the tenant's own program (stage occupancy and
    ALU budgets are per-program — merging relocates registers, it never
    changes a tenant's footprint); traffic fields come from a scheduler run.
    """

    tid: int
    name: str
    elements: int
    slot_window: tuple[int, int]       # register window in the shared file
    element_range: tuple[int, int] | None  # rows in the merged table (merged mode)
    weight: float
    analytic_pps: float                # chip-model rate under the active mode
    peak_occupancy_bits: int
    peak_alu_utilization: float
    packets: int = 0
    served: int = 0
    dropped: int = 0
    deferred: int = 0
    slices: int = 0                    # scheduling turns (time-sliced mode)
    measured_pps: float | None = None
    # SLO posture (repro_torch.obs.slo), set when the scheduler has an SLO for
    # this tenant: windowed burn rates plus the deterministic breach log.
    slo: SloStatus | None = None
    breach_events: tuple[BreachEvent, ...] = ()

    @property
    def slo_breached(self) -> bool:
        return self.slo is not None and self.slo.breached


@dataclasses.dataclass(frozen=True)
class MultiTenantTelemetry:
    """Scheduler-level rollup: who shares the chip and what each got."""

    mode: str                          # "merged" | "time_sliced"
    chip_name: str
    elements_used: int                 # merged footprint (sum of tenants)
    elements_available: int
    phv_bits_used: int                 # sum of tenant peak PHV footprints
    phv_bits_available: int
    tenants: tuple[TenantTelemetry, ...]
    measured_pps: float | None = None  # aggregate over the mixed stream

    @property
    def total_packets(self) -> int:
        return sum(t.packets for t in self.tenants)

    @property
    def total_dropped(self) -> int:
        return sum(t.dropped for t in self.tenants)

    @property
    def total_deferred(self) -> int:
        return sum(t.deferred for t in self.tenants)

    @property
    def breached_tenants(self) -> tuple[str, ...]:
        """Names of tenants currently burning budget faster than allowed."""
        return tuple(t.name for t in self.tenants if t.slo_breached)

    def tenant(self, key: int | str) -> TenantTelemetry:
        """Look up one tenant's telemetry by tid or by name.

        The per-tenant query path: ``tel.tenant(0).dropped`` /
        ``tel.tenant("iot").deferred`` answer "who lost packets and who
        waited" without aggregating away the tenant axis — the counts that
        feed the per-tenant ``mt.dropped_total`` / ``mt.deferred_total``
        observability metrics.
        """
        for t in self.tenants:
            if (t.tid == key) if isinstance(key, int) else (t.name == key):
                return t
        raise KeyError(f"no tenant {key!r} in this telemetry")

    def dropped_for(self, key: int | str) -> int:
        """Tail-dropped packet count for one tenant (tid or name)."""
        return self.tenant(key).dropped

    def deferred_for(self, key: int | str) -> int:
        """Deferred packet-turn count for one tenant (tid or name)."""
        return self.tenant(key).deferred

    def render(self) -> str:
        lines = [
            f"scheduler[{self.chip_name}] mode={self.mode} "
            f"tenants={len(self.tenants)} "
            f"elements={self.elements_used}/{self.elements_available} "
            f"phv={self.phv_bits_used}/{self.phv_bits_available}b",
        ]
        if self.measured_pps is not None:
            lines.append(f"  aggregate measured: {self.measured_pps:.3e} pkt/s")
        lines.append(
            "  tid name             elems  window      weight  analytic pkt/s"
            "  packets  drop  defer  slices  measured pkt/s"
        )
        for t in self.tenants:
            m = f"{t.measured_pps:.3e}" if t.measured_pps is not None else "-"
            lines.append(
                f"  {t.tid:>3} {t.name:<16} {t.elements:>5} "
                f" {t.slot_window[0]:>4}..{t.slot_window[1]:<5} "
                f"{t.weight:>6.2f}  {t.analytic_pps:>14.3e} "
                f" {t.packets:>7}  {t.dropped:>4}  {t.deferred:>5} "
                f" {t.slices:>6}  {m:>14}"
            )
        with_slo = [t for t in self.tenants if t.slo is not None]
        if with_slo:
            lines.append(
                "  slo: tenant           state     delay-burn   pps-burn"
                "   breaches"
            )
            for t in with_slo:
                s = t.slo
                db = (
                    f"{s.delay_burn_rate:.2f}x"
                    if s.delay_burn_rate is not None else "-"
                )
                pb = (
                    f"{s.pps_burn_rate:.2f}x"
                    if s.pps_burn_rate is not None else "-"
                )
                state = "BREACHED" if s.breached else "ok"
                lines.append(
                    f"       {t.name:<16} {state:<9} {db:>10} {pb:>10} "
                    f" {len(t.breach_events):>8}"
                )
        return "\n".join(lines)


def fabric_telemetry(
    prog: PipelineProgram,
    mode: str,
    hop_ranges: list[tuple[int, int]],
    hop_pps: list[float] | None = None,
    measured_pps: float | None = None,
    chip: ChipSpec | None = None,
) -> FabricTelemetry:
    chip = chip or prog.chip
    stages = stage_telemetry(prog, chip)
    hops = []
    for i, (a, b) in enumerate(hop_ranges):
        seg = stages[a:b]
        hops.append(
            HopTelemetry(
                hop=i,
                elements=b - a,
                element_range=(a, b),
                peak_occupancy_bits=max(s.occupancy_bits for s in seg),
                peak_alu_utilization=max(s.alu_utilization for s in seg),
                measured_pps=hop_pps[i] if hop_pps else None,
            )
        )
    analytic = throughput.report_for_program(prog)
    return FabricTelemetry(
        mode=mode,
        chip_name=chip.name,
        stages=tuple(stages),
        hops=tuple(hops),
        analytic=analytic,
        measured_pps=measured_pps,
        _phv_bits=chip.phv_bits,
    )
