"""Multi-switch fabric: run programs that exceed one chip's element budget
(the reference's ``dataplane/fabric.py``).

A compiled program with more elements than ``ChipSpec.num_elements`` cannot
execute in one pipeline pass.  The paper's answer is recirculation (the
packet re-enters the same switch, halving throughput per extra pass); the
scale-out answer from the follow-on literature is a *chain* of switches, each
executing a contiguous slice of the program at full line rate, with the PHV
carried hop to hop in the packet itself.  This module simulates both:

* ``mode="recirculate"`` — one switch, ``ceil(E / num_elements)`` passes;
  analytic throughput divides by the pass count.
* ``mode="multi_hop"``   — one switch per slice; every switch forwards at
  line rate, so throughput stays at the chip rate and only latency grows.

Both modes execute identically bit-for-bit (the register file is the wire
format between hops); they differ in the telemetry/throughput accounting —
which is exactly the trade the paper's §2 discussion is about.

Hop chains run **stacked by default**: the hop slices are padded and
stacked (``lowering.stack_hops``) and every hop runs one ``optable_run``
over its plane of the stack (``executor.run_hops_scanned``), with no host
work between hops.  The unrolled per-hop loop (``executor.run_hop`` on each
slice, the device synchronised after each hop to time it) remains behind
``scan_hops=False``, and is the automatic fallback when hop shapes differ
and refuse to stack; the two paths are bit-exact by shared construction.
The packed backend runs as the scan-over-layers plan on whole packets.  In
stacked runs the per-hop wall-clock split is *attributed*: measured chunk
time is divided across hops proportionally to their element counts,
keeping the ``hop_seconds``/telemetry shape contract.

Invariants:

* **Bit-exactness** — ``SwitchFabric.run`` equals single-switch
  ``executor.execute``, the interpreter, and the oracle for every
  partitioning: hop boundaries can never change results, only accounting.
* **Exact tiling** — hop element ranges are contiguous, disjoint, and cover
  ``[0, num_elements)``; each hop executes at most ``chip.num_elements``
  elements.
* **Shared slot space** — every hop runs over the same compacted register
  file (the PHV); parser/deparser tables are inherited whole from the
  unsliced program.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.pipeline import ChipSpec, PipelineProgram
from repro_torch.core.throughput import report_for_program
from repro_torch.dataplane import executor as _executor
from repro_torch.dataplane import telemetry as _telemetry
from repro_torch.dataplane.lowering import (
    LoweredProgram,
    StackedHops,
    lower_program,
    stack_hops,
)
from repro_torch.dataplane.plan import ExecutionPlan
from repro_torch.device import resolve_device

MODES = ("recirculate", "multi_hop")


@dataclasses.dataclass(frozen=True)
class SwitchHop:
    """One simulated switch (or one recirculation pass) in the chain."""

    index: int
    element_range: tuple[int, int]
    lowered: LoweredProgram      # table slice for this hop's elements


@dataclasses.dataclass
class FabricRunResult:
    outputs: np.ndarray          # (n, output_bits) int32
    packets: int
    seconds: float
    hop_seconds: list[float]     # attributed by element count when scanned
    warmup_seconds: float = 0.0  # whole-chain warm call (incl. kernel build)
    scanned: bool = False        # hops ran over the stacked tables

    @property
    def packets_per_second(self) -> float:
        return self.packets / self.seconds if self.seconds > 0 else float("inf")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SwitchFabric:
    """A chain of simulated switches jointly executing one program."""

    def __init__(
        self,
        prog: PipelineProgram,
        hops: Sequence[SwitchHop],
        lowered: LoweredProgram,
        mode: str,
        chip: ChipSpec,
    ):
        self.program = prog
        self.hops = list(hops)
        self.lowered = lowered
        self.mode = mode
        self.chip = chip
        self._last_run: FabricRunResult | None = None
        self._analytic_memo = None
        self._stacked_memo: StackedHops | None | str = "unset"

    # -- construction -------------------------------------------------------

    @classmethod
    def partition(
        cls,
        prog: PipelineProgram,
        *,
        mode: str = "multi_hop",
        chip: ChipSpec | None = None,
        compact: bool = True,
    ) -> "SwitchFabric":
        """Slice ``prog`` into per-switch element ranges of at most
        ``chip.num_elements`` each.  ``chip`` defaults to the program's own
        target (pass a smaller one to force partitioning in tests)."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        chip = chip or prog.chip
        lowered = lower_program(prog, compact=compact)
        per_hop = chip.num_elements
        if per_hop < 1:
            raise ValueError("chip must have at least one element")
        hops = []
        for i, start in enumerate(range(0, lowered.num_elements, per_hop)):
            stop = min(start + per_hop, lowered.num_elements)
            hops.append(
                SwitchHop(
                    index=i,
                    element_range=(start, stop),
                    lowered=lowered.slice_elements(start, stop),
                )
            )
        return cls(prog, hops, lowered, mode, chip)

    @property
    def num_hops(self) -> int:
        return len(self.hops)

    def stacked_hops(self) -> StackedHops | None:
        """The chain's hop slices padded + stacked, memoized (hops are fixed
        at partition time).  ``None`` when hop shapes genuinely differ and
        refuse to stack — the stacked path then falls back to unrolled
        dispatch."""
        if isinstance(self._stacked_memo, str):
            self._stacked_memo = stack_hops([h.lowered for h in self.hops])
        return self._stacked_memo

    # -- execution ----------------------------------------------------------

    def run(
        self,
        packets,
        *,
        backend: str = "auto",
        chunk_size: int | None = None,
        scan_hops: bool | None = None,
        plan: ExecutionPlan | None = None,
        device="cuda",
    ) -> FabricRunResult:
        """Push packets through every hop on ``device``; bit-exact with
        single-switch :func:`dataplane.executor.execute` (and the
        interpreter/oracle).

        ``plan`` (an :class:`~repro_torch.dataplane.plan.ExecutionPlan`)
        overrides the individual keywords; its ``interpret``, ``fleet`` and
        ``devices`` are ignored, as in the reference.
        ``scan_hops``: True/None run the chain over the stacked hop tables
        (None falls back to unrolled only when the hops refuse to stack);
        False forces the unrolled per-hop loop.  The packed backend always
        runs its scan-over-layers plan (it has no per-hop form).

        Timing: the warm call (kernel build, table upload and planning) and
        each chunk's host-to-device copy are outside the clock; a chunk is
        timed to its output bits on the host.
        """
        if plan is not None:
            backend = plan.backend_str
            if plan.chunk_size is not None:
                chunk_size = plan.chunk_size
            if plan.scan_hops is not None:
                scan_hops = plan.scan_hops
        backend = _executor.resolve_backend(backend)
        device = resolve_device(device)
        packets = np.asarray(packets)
        if packets.ndim != 2 or packets.shape[1] != self.lowered.input_bits:
            raise ValueError(
                f"expected (batch, {self.lowered.input_bits}) packet bits, "
                f"got {packets.shape}"
            )
        chunk = chunk_size or _executor.DEFAULT_CHUNK
        n = packets.shape[0]
        out = np.empty((n, self.lowered.output_bits), np.int32)
        hop_seconds = [0.0] * self.num_hops
        total = 0.0
        lp = self.lowered
        in_slot, in_shift, out_slot, out_shift = _executor._device_tables(lp, device).io

        stacked = None
        if backend == "packed":
            if scan_hops is False:
                raise ValueError(
                    "the packed backend has no per-hop register-file form; "
                    "the fabric runs it as one scan over stacked layers "
                    "(scan_hops=True or None)"
                )
            scanned = True
        else:
            if scan_hops is not False:
                stacked = self.stacked_hops()
            scanned = stacked is not None

        # Wall-clock attribution for the stacked path: hops are not timed
        # apart, so chunk time is split proportionally to each hop's element
        # count (exact for the unrolled path by measurement).
        elems = np.array(
            [stop - start for (start, stop) in
             (h.element_range for h in self.hops)],
            np.float64,
        )
        hop_weights = elems / elems.sum()

        if scanned and backend == "packed":
            packed_run = _executor._packed_scan_fn(lp, device)

            def push(block: torch.Tensor, warm: bool = False) -> torch.Tensor:
                return packed_run(block)

        elif scanned:

            def push(block: torch.Tensor, warm: bool = False) -> torch.Tensor:
                regs = _executor.parse_packets(
                    block, in_slot, in_shift, num_regs=lp.num_regs
                )
                # The PHV runs through every hop's tables on the device.
                regs = _executor.run_hops_scanned(stacked, regs, backend=backend)
                return _executor.deparse_regs(regs, out_slot, out_shift)

        else:

            def push(block: torch.Tensor, warm: bool = False) -> torch.Tensor:
                regs = _executor.parse_packets(
                    block, in_slot, in_shift, num_regs=lp.num_regs
                )
                for hop in self.hops:
                    with obs.span(
                        "compile:hop" if warm else "execute:hop",
                        cat="compile" if warm else "execute",
                        hop=hop.index, mode=self.mode,
                    ):
                        h0 = time.perf_counter()
                        # The register file leaving this hop is the PHV on
                        # the wire.
                        regs = _executor.run_hop(hop.lowered, regs, backend=backend)
                        _sync(device)
                        h_dt = time.perf_counter() - h0
                    hop_seconds[hop.index] += h_dt
                    if obs.enabled() and not warm:
                        obs.registry().histogram(
                            "fabric.hop_seconds", hop=str(hop.index)
                        ).observe(h_dt)
                return _executor.deparse_regs(regs, out_slot, out_shift)

        with obs.span(
            "stream:fabric_run", cat="stream",
            mode=self.mode, hops=self.num_hops, packets=n, backend=backend,
            scanned=scanned,
        ):
            # Warm every hop outside the clock (kernel build, each hop's
            # table upload and plan), so measured pkt/s reflects the steady
            # state — matching execute_stream's timing discipline.
            with obs.span(
                "compile:fabric_chain", cat="compile",
                hops=self.num_hops, backend=backend,
            ):
                w0 = time.perf_counter()
                push(
                    torch.zeros((min(chunk, n), lp.input_bits), dtype=torch.int32, device=device),
                    warm=True,
                )
                _sync(device)
                warmup = time.perf_counter() - w0
            hop_seconds = [0.0] * self.num_hops

            for start in range(0, n, chunk):
                block = packets[start : start + chunk]
                valid = block.shape[0]
                pad = chunk - valid if n > chunk else 0
                if pad:
                    block = np.pad(block, ((0, pad), (0, 0)))
                # H2D outside the clock, as execute_stream
                dev = _executor._to_device(block, device)
                with obs.span(
                    "execute:fabric_chunk", cat="execute", packets=valid
                ):
                    t0 = time.perf_counter()
                    res = push(dev).cpu().numpy()
                    dt = time.perf_counter() - t0
                total += dt
                out[start : start + valid] = res[:valid]
                if scanned:
                    for i, w in enumerate(hop_weights):
                        hop_seconds[i] += dt * w
                if obs.enabled():
                    m = obs.registry()
                    m.counter("fabric.packets_total").inc(valid)
                    m.histogram("fabric.chunk_seconds").observe(dt)
                    if scanned:
                        for i, w in enumerate(hop_weights):
                            m.histogram(
                                "fabric.hop_seconds", hop=str(i)
                            ).observe(dt * w)

        result = FabricRunResult(
            outputs=out,
            packets=n,
            seconds=total,
            hop_seconds=hop_seconds,
            warmup_seconds=warmup,
            scanned=scanned,
        )
        self._last_run = result
        return result

    # -- accounting ---------------------------------------------------------

    def analytic_report(self):
        """Chip-rate model under this fabric's mode.

        ``multi_hop`` pipelines hops, so the fabric forwards at the full chip
        rate regardless of depth; ``recirculate`` divides by the pass count
        (``num_hops`` passes — i.e. ``num_hops - 1`` recirculations — against
        this fabric's chip, not the program's compile-time target).

        Memoized per fabric: hops and chip are fixed at partition time, and
        the telemetry path calls this on every ``run``.
        """
        if self._analytic_memo is not None:
            return self._analytic_memo
        rep = report_for_program(self.program)
        if self.mode == "multi_hop":
            passes = 1
        else:
            passes = self.num_hops
        pps = self.chip.packets_per_second / passes
        self._analytic_memo = dataclasses.replace(
            rep,
            passes=passes,
            packets_per_second=pps,
            networks_per_second=pps,
            neurons_per_second=pps * sum(lp.n_out for lp in self.program.layer_plans),
            elements_available=self.chip.num_elements,
        )
        return self._analytic_memo

    def telemetry(
        self, run: FabricRunResult | None = None
    ) -> _telemetry.FabricTelemetry:
        run = run or self._last_run
        hop_pps = None
        measured = None
        if run is not None:
            hop_pps = [
                run.packets / s if s > 0 else float("inf")
                for s in run.hop_seconds
            ]
            measured = run.packets_per_second
        tel = _telemetry.fabric_telemetry(
            self.program,
            self.mode,
            [h.element_range for h in self.hops],
            hop_pps=hop_pps,
            measured_pps=measured,
            chip=self.chip,  # judge budgets against the fabric's switches
        )
        return dataclasses.replace(tel, analytic=self.analytic_report())
