"""Typed execution plans: one entry point for the dataplane executors (the
reference's ``dataplane/plan.py``).

:class:`ExecutionPlan` gathers the *how* of a run into one frozen value and
:func:`run` dispatches the *what* (a program, a fabric, a scheduler) with
it::

    from repro_torch.dataplane.plan import Backend, ExecutionPlan, run

    result = run(program, stream,
                 plan=ExecutionPlan(backend=Backend.PACKED, fleet=64))

Dispatch is by program/stream type:

* ``PipelineProgram`` / ``LoweredProgram`` + a 2-D packet array ->
  ``executor.execute`` (returns the output bits);
* ... + a chunk iterator -> ``executor.execute_stream`` (returns
  :class:`~repro_torch.dataplane.executor.StreamResult`);
* ... + ``plan.fleet`` set -> ``fleet.execute_fleet`` over N streams or
  N replicas of one (returns
  :class:`~repro_torch.dataplane.fleet.FleetRunResult`);
* ``SwitchScheduler`` + a ``(tenant_ids, bits)`` mixed stream (or an
  iterator of such chunks) -> ``SwitchScheduler.run`` (returns
  :class:`~repro_torch.dataplane.multitenant.SchedulerRunResult`, outputs
  collected), in the plan's ``merged`` layout;
* ``SwitchFabric`` -> ``fabric.run`` (hop-scanned when the plan allows);
* ``Backend.INTERPRETER`` -> the per-op reference interpreter
  (``core.interpreter.run_program``) — the correctness witness, only
  reachable through :func:`run` (the executors never accept it).

As in the reference, a scheduler and a fabric run as they do without a
fleet: ``plan.fleet`` and ``plan.devices`` only shape a program's run.

The keyword surfaces stay: every ``backend=`` string the executors accept
still works, and ``executor.resolve_backend`` takes :class:`Backend`
members alike.
"""
from __future__ import annotations

import dataclasses
import enum


class Backend(enum.Enum):
    """Executor backend, replacing the stringly-typed ``backend=`` knob.

    Values are the reference's strings, so ``Backend.FUSED.value`` is a
    valid argument anywhere a string is accepted (and vice versa through
    :meth:`coerce`).  ``FUSED`` and ``PALLAS`` both name the port's one
    op-table path (the ``optable_run`` kernel on a card).
    """

    AUTO = "auto"
    FUSED = "jnp"          # op-table path (alias: "fused")
    PALLAS = "pallas"      # op-table path, as the reference's Pallas kernel
    PACKED = "packed"      # bit-packed PHV XNOR+popcount
    INTERPRETER = "interpreter"  # per-op reference (run() only)

    @classmethod
    def coerce(cls, value: "Backend | str") -> "Backend":
        """Accept a :class:`Backend`, its value, or a legacy alias."""
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            alias = _ALIASES.get(value.lower())
            if alias is not None:
                return alias
        raise ValueError(
            f"unknown backend {value!r}; expected one of "
            f"{sorted(_ALIASES)} or a Backend member"
        )


_ALIASES: dict[str, Backend] = {
    **{b.value: b for b in Backend},
    "fused": Backend.FUSED,
}


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Everything about *how* to run a program, in one frozen value.

    ``backend``     executor backend (:class:`Backend` or legacy string).
    ``chunk_size``  packets per device dispatch (None -> executor default).
    ``interpret``   kept for the reference's surface and ignored: the port
                    has no interpreter mode (a kernel runs on a CUDA tensor,
                    its plain version on a CPU tensor).
    ``scan_hops``   fabric hop execution: True -> the stacked hop tables
                    (``executor.run_hops_scanned``), False -> unrolled
                    per-hop dispatch, None -> stacked whenever the hops
                    stack (same row/register shapes; they always do for
                    slices of one program).
    ``fleet``       batch this many independent streams through one
                    dispatch (None -> single-stream paths).
    ``devices``     the reference shards a fleet's streams over this many
                    devices; the port runs on one GPU, so None or 1 (a
                    larger value is refused when a fleet runs).
    ``collect``     keep outputs (streaming paths default to stats-only).
    ``merged``      multi-tenant merged-table layout ("interleave" packs
                    tenants' elements onto shared stages, "concat" stacks
                    them; None -> the scheduler's configured layout).  Only
                    meaningful when running a ``SwitchScheduler``.
    """

    backend: Backend | str = Backend.AUTO
    chunk_size: int | None = None
    interpret: bool | None = None
    scan_hops: bool | None = None
    fleet: int | None = None
    devices: int | None = None
    collect: bool = False
    merged: str | None = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "backend", Backend.coerce(self.backend))
        if self.chunk_size is not None and self.chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {self.chunk_size}")
        if self.fleet is not None and self.fleet < 1:
            raise ValueError(f"fleet must be >= 1, got {self.fleet}")
        if self.devices is not None and self.devices < 1:
            raise ValueError(f"devices must be >= 1, got {self.devices}")
        if self.merged is not None and self.merged not in (
            "interleave", "concat"
        ):
            raise ValueError(
                "merged must be 'interleave', 'concat', or None, "
                f"got {self.merged!r}"
            )

    @property
    def backend_str(self) -> str:
        """The legacy string the executor keyword surface expects."""
        return self.backend.value


def run(program, stream, *, plan: ExecutionPlan | None = None, device="cuda"):
    """Execute ``stream`` through ``program`` according to ``plan``, on
    ``device``.

    See the module docstring for the dispatch table.  ``stream`` may be a
    ``(batch, input_bits)`` {0,1} array, an iterator of such chunks, a
    ``(tenant_ids, bits)`` mixed stream (for a scheduler), or a sequence of
    per-stream chunk iterators (for a fleet plan).
    """
    import numpy as np

    from repro_torch.core.interpreter import run_program
    from repro_torch.core.pipeline import PipelineProgram
    from repro_torch.dataplane import executor as _executor
    from repro_torch.dataplane import fabric as _fabric
    from repro_torch.dataplane import fleet as _fleet
    from repro_torch.dataplane import multitenant as _multitenant
    from repro_torch.dataplane.lowering import LoweredProgram, lower_program

    plan = plan or ExecutionPlan()

    if isinstance(program, _multitenant.SwitchScheduler):
        if plan.backend is Backend.INTERPRETER:
            raise ValueError("the interpreter backend serves single programs")
        return program.run(
            stream,
            backend=plan.backend_str,
            chunk_size=plan.chunk_size,
            collect=True,
            merged=plan.merged,
            device=device,
        )

    if isinstance(program, _fabric.SwitchFabric):
        if plan.backend is Backend.INTERPRETER:
            raise ValueError("the interpreter backend has no fabric form")
        return program.run(stream, plan=plan, device=device)

    if not isinstance(program, (PipelineProgram, LoweredProgram)):
        raise TypeError(
            "run() takes a PipelineProgram, LoweredProgram, SwitchFabric or "
            f"SwitchScheduler, got {type(program).__name__}"
        )

    if plan.backend is Backend.INTERPRETER:
        if isinstance(program, LoweredProgram):
            raise ValueError(
                "the interpreter runs source PipelinePrograms; pass the "
                "un-lowered program for Backend.INTERPRETER"
            )
        return run_program(program, np.asarray(stream), device=device).cpu().numpy()

    lowered = (
        program
        if isinstance(program, LoweredProgram)
        else lower_program(program)
    )

    if plan.fleet is not None:
        return _fleet.execute_fleet(lowered, stream, plan=plan, device=device)

    if hasattr(stream, "ndim") and getattr(stream, "ndim", 0) == 2:
        return _executor.execute(
            lowered,
            stream,
            backend=plan.backend_str,
            chunk_size=plan.chunk_size,
            device=device,
        )

    return _executor.execute_stream(
        lowered,
        stream,
        backend=plan.backend_str,
        chunk_size=plan.chunk_size or _executor.DEFAULT_CHUNK,
        collect=plan.collect,
        device=device,
    )
