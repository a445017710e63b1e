"""Declarative fleet construction: one spec -> programs, chip, scheduler
(the reference's ``dataplane/factory.py``).

Every demo and benchmark used to hand-wire the same stack — init BNN params
per tenant, compile, sum element/PHV budgets into a shared ``ChipSpec``,
build a ``SwitchScheduler``, admit tenants in order, zip up
``TenantTrafficSpec``s for the stream generator.  That is construction
*policy* duplicated at every call site (and drift-prone: forget the ``+ 1``
headroom element and admission fails).  This module makes the whole stack a
value:

    fleet = build_fleet(FleetSpec(tenants=(
        TenantSpec("ddos", scenario="ddos_burst", shape=(32, 64, 32),
                   weight=2.0),
        TenantSpec("iot", scenario="iot_telemetry", shape=(16, 32, 8)),
    )))
    sched = fleet.scheduler(mode="merged")
    res = sched.run(fleet.stream(60_000, chunk_size=4096, seed=7),
                    chunk_size=4096)

``build_fleet`` also accepts the equivalent nested dict (config-file form).
A :class:`TenantSpec` either names a BNN ``shape`` to init+compile (seeded,
deterministic) or carries a pre-compiled ``program`` (e.g. a trained export
— the pcap replay example passes one).  A ``shape`` tenant draws its
weights from ``torch.Generator().manual_seed(seed)``, where the reference
uses ``jax.random.PRNGKey(seed)``: the same spec gives other weights in the
two packages, so a fleet that must match the reference's carries its
weights in ``program=`` tenants.  The built :class:`Fleet` hands out
*fresh* schedulers (state like admission and telemetry is per run-mode) and
per-tenant fabrics, while programs/chip/traffic specs are built once.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core import bnn
from repro_torch.core.compiler import compile_bnn
from repro_torch.core.pipeline import MAX_FIELDS, ChipSpec, PipelineProgram
from repro_torch.dataplane import traffic as _traffic
from repro_torch.dataplane.fabric import SwitchFabric
from repro_torch.dataplane.lowering import lower_program, peak_stage_rows
from repro_torch.dataplane.multitenant import SwitchScheduler


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant: a program source plus its traffic identity.

    Exactly one of ``shape`` (BNN layer sizes, init+compiled with
    ``torch.Generator().manual_seed(seed)``) or ``program`` (pre-compiled)
    must be set.
    """

    name: str
    scenario: str
    shape: tuple | None = None
    weight: float = 1.0
    seed: int = 0
    program: PipelineProgram | None = None

    def __post_init__(self) -> None:
        if (self.shape is None) == (self.program is None):
            raise ValueError(
                f"tenant {self.name!r}: set exactly one of shape= or "
                "program="
            )


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """The whole shared-chip fleet, declaratively.

    ``chip=None`` sizes the chip to exactly fit the tenant sum (every
    program's elements plus one headroom element, summed peak PHV bits, and
    a per-stage ALU budget wide enough for an interleaved merge of every
    tenant) — the admission-always-succeeds default the examples want.
    ``mode``, ``merged`` (merged-table layout), and ``quantum`` are
    scheduler defaults; all can be overridden per ``Fleet.scheduler`` call.
    """

    tenants: tuple
    chip: ChipSpec | None = None
    mode: str | None = None
    merged: str | None = None
    quantum: int | None = None
    chip_name: str = "shared"

    def __post_init__(self) -> None:
        if not self.tenants:
            raise ValueError("a fleet needs at least one tenant")
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {names}")

    @classmethod
    def from_dict(cls, d: dict) -> "FleetSpec":
        """Config-file form: ``{"tenants": [{"name": ..., ...}, ...],
        "mode": ..., "quantum": ..., "chip": {...} | None}``."""
        d = dict(d)
        tenants = tuple(
            t if isinstance(t, TenantSpec) else TenantSpec(**t)
            for t in d.pop("tenants")
        )
        chip = d.pop("chip", None)
        if isinstance(chip, dict):
            chip = ChipSpec(**chip)
        return cls(tenants=tenants, chip=chip, **d)


@dataclasses.dataclass
class Fleet:
    """A built fleet: compiled programs + sized chip + stream/scheduler
    factories.  Construction happened once in :func:`build_fleet`; the
    methods here only wire pieces together."""

    spec: FleetSpec
    programs: list
    traffic_specs: list
    chip: ChipSpec

    @property
    def num_tenants(self) -> int:
        return len(self.programs)

    def scheduler(
        self,
        *,
        mode: str | None = None,
        merged: str | None = None,
        quantum: int | None = None,
    ) -> SwitchScheduler:
        """A fresh scheduler with every tenant admitted in spec order
        (fresh because admission/telemetry state is per run)."""
        kw = {}
        m = mode if mode is not None else self.spec.mode
        if m is not None:
            kw["mode"] = m
        lay = merged if merged is not None else self.spec.merged
        if lay is not None:
            kw["merged"] = lay
        q = quantum if quantum is not None else self.spec.quantum
        if q is not None:
            kw["quantum"] = q
        sched = SwitchScheduler(self.chip, **kw)
        for t, prog in zip(self.spec.tenants, self.programs):
            sched.admit(prog, name=t.name, weight=t.weight)
        return sched

    def stream(self, n: int, *, chunk_size: int = 4096, seed: int = 0):
        """The fleet's mixed tenant stream (weights from the spec)."""
        return _traffic.mixed_tenant_stream(
            self.traffic_specs, n, chunk_size=chunk_size, seed=seed
        )

    def tenant_stream(
        self, tid: int, n: int, *, chunk_size: int = 4096, seed: int = 0
    ):
        """One tenant's scenario as a single-program chunk stream."""
        ts = self.traffic_specs[tid]
        return _traffic.stream(
            ts.scenario, n, ts.input_bits, chunk_size=chunk_size, seed=seed
        )

    def fabric(
        self,
        tid: int = 0,
        *,
        hops: int | None = None,
        mode: str = "multi_hop",
        chip: ChipSpec | None = None,
    ) -> SwitchFabric:
        """Partition one tenant's program across a switch chain.  ``hops``
        sizes a per-hop chip to split the program into exactly that many
        slices (mutually exclusive with an explicit ``chip``)."""
        prog = self.programs[tid]
        if hops is not None:
            if chip is not None:
                raise ValueError("pass hops= or chip=, not both")
            per_hop = -(-prog.num_elements // hops)  # ceil
            chip = ChipSpec(
                num_elements=per_hop,
                phv_bits=prog.chip.phv_bits,
                name=f"{prog.chip.name}/{hops}hop",
            )
        return SwitchFabric.partition(prog, mode=mode, chip=chip)


def build_fleet(spec: FleetSpec | dict | Sequence) -> Fleet:
    """Construct the fleet a spec describes.

    Accepts a :class:`FleetSpec`, its dict form, or just a sequence of
    :class:`TenantSpec`/dicts (all other knobs defaulted).
    """
    if isinstance(spec, dict):
        spec = FleetSpec.from_dict(spec)
    elif not isinstance(spec, FleetSpec):
        spec = FleetSpec.from_dict({"tenants": list(spec)})

    programs = []
    tspecs = []
    for t in spec.tenants:
        if t.program is not None:
            prog = t.program
        else:
            params = bnn.init_params(
                bnn.BnnSpec(tuple(t.shape)), torch.Generator().manual_seed(t.seed)
            )
            prog = compile_bnn([w.numpy() for w in params])
        programs.append(prog)
        tspecs.append(
            _traffic.TenantTrafficSpec(
                t.scenario, prog.layer_plans[0].n_in, t.weight
            )
        )

    chip = spec.chip or ChipSpec(
        num_elements=sum(p.num_elements for p in programs) + 1,
        phv_bits=sum(p.peak_phv_bits for p in programs),
        # Wide enough for the interleaved merged layout: its widest shared
        # stage sums every tenant's rows at that stage, which can exceed
        # one real chip's per-stage ALU count at high tenant counts.
        max_parallel_ops=max(
            MAX_FIELDS,
            peak_stage_rows(
                [lower_program(p, compact=True) for p in programs]
            ),
        ),
        name=spec.chip_name,
    )
    return Fleet(
        spec=spec, programs=programs, traffic_specs=tspecs, chip=chip
    )
