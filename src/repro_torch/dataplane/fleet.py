"""Fleet execution: N independent packet streams through ONE dispatch (the
reference's ``dataplane/fleet.py``).

What starves the simulator is not compute but orchestration: one Python
dispatch per stream per chunk.  This module batches a *fleet* of
independent simulated switches (each with its own packet stream) through a
single executor call:

* every executor backend maps packet rows independently (parse -> op-table
  -> deparse, or the bit-packed XNOR/popcount layers), so a
  ``(streams, chunk, bits)`` block is viewed as ``(streams * chunk, bits)``
  packets, runs through ``executor._run_chunk`` as one batch, and its
  output is viewed back as ``(streams, chunk, out_bits)``.  The reference
  ``vmap``s the per-stream function instead; folding the stream axis into
  the packet axis is the same computation, so the fleet is bit-exact with
  running each stream alone through ``executor.execute``;
* per-stream chunk iterators of *different* lengths are zipped into fleet
  blocks by :func:`fleet_blocks`, zero-padding exhausted or short streams;
  pad rows cannot perturb real ones, and the valid counts slice them off.

The port runs on one GPU.  ``ExecutionPlan.devices`` of None or 1 runs the
fleet on it; a larger value raises ``ValueError``.  The reference's
``sharding.fleet_mesh`` and ``shard_streams`` (the stream axis sharded over
a device mesh) have no one-GPU meaning and are not ported.

Entry points: :func:`execute_fleet` (stats and optional per-stream outputs,
with ``execute_stream``'s timing discipline) and :func:`fleet_fn` (the raw
callable, used by ``serving.engine.FleetEngine``).  Reach both through
``repro_torch.dataplane.plan.run(program, streams,
plan=ExecutionPlan(fleet=N, ...))``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.dataplane import executor as _executor
from repro_torch.dataplane.lowering import LoweredProgram, lower_program
from repro_torch.dataplane.plan import ExecutionPlan
from repro_torch.device import resolve_device

# Per-stream packets per dispatch.  Smaller than executor.DEFAULT_CHUNK on
# purpose: the fleet dimension restores the device-saturating batch size
# (64 streams x 4096 = 256k packet rows per dispatch).
DEFAULT_STREAM_CHUNK = 1 << 12

_FLEET_CACHE: dict[tuple, Callable] = {}


def check_devices(plan: ExecutionPlan) -> None:
    """Refuse a plan that asks for more than the one GPU the port runs on."""
    if plan.devices is not None and plan.devices > 1:
        raise ValueError(
            f"plan.devices={plan.devices}: the PyTorch port runs a fleet on one GPU "
            "(devices=None or 1); the reference's sharded fleet is not ported"
        )


def fleet_fn(lowered: LoweredProgram, *, backend: str = "auto", scan_hops: bool = False,
             device="cuda") -> Callable:
    """The fleet executable: ``(streams, chunk, bits)`` {0,1} int32 ->
    ``(streams, chunk, out_bits)`` int32 on ``device``, cached per (program
    fingerprint, backend, scan_hops, device).

    The block is viewed as one batch of ``streams * chunk`` packets (no
    copy) for ``executor._run_chunk``, and the output viewed back.
    """
    backend = _executor.resolve_backend(backend)
    device = resolve_device(device)
    key = (lowered.fingerprint(), backend, bool(scan_hops), str(device))
    fn = _FLEET_CACHE.get(key)
    if fn is not None:
        return fn

    def fn(blocks: torch.Tensor) -> torch.Tensor:
        s, chunk, bits = blocks.shape
        out = _executor._run_chunk(lowered, blocks.view(s * chunk, bits), backend, bool(scan_hops))
        return out.view(s, chunk, out.shape[1])

    _FLEET_CACHE[key] = fn
    return fn


def fleet_blocks(
    streams: Sequence, chunk: int, input_bits: int
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Zip per-stream chunk iterators into ``(S, chunk, input_bits)`` int32
    blocks plus ``(S,)`` valid-row counts, until every stream is exhausted.

    Streams may have different lengths and chunkings: each is re-sliced to
    exactly ``chunk`` rows per block, and a stream that runs dry (or yields
    a short final chunk) is zero-padded — pad rows are dead weight the
    caller slices off via the valid counts.
    """
    its = [_executor._rechunk(s, chunk) for s in streams]
    n = len(its)
    done = [False] * n
    while True:
        blocks = np.zeros((n, chunk, input_bits), np.int32)
        valid = np.zeros(n, np.int64)
        got = False
        for i, it in enumerate(its):
            if done[i]:
                continue
            try:
                b = next(it)
            except StopIteration:
                done[i] = True
                continue
            blocks[i, : b.shape[0]] = b
            valid[i] = b.shape[0]
            got = True
        if not got:
            return
        yield blocks, valid


@dataclasses.dataclass
class FleetRunResult:
    """Outcome of a fleet run — the simulator's *aggregate* line rate."""

    streams: int
    packets: int                      # total across the fleet
    chunks: int                       # fleet blocks dispatched
    seconds: float
    per_stream_packets: np.ndarray    # (streams,) int64
    bit_counts: np.ndarray            # (output_bits,) int64, fleet-wide
    outputs: list | None = None       # per-stream (n_i, out_bits) uint8
    warmup_seconds: float = 0.0       # first-block warm call (kernel build, table upload)
    backend: str = "auto"
    devices: int = 1

    @property
    def packets_per_second(self) -> float:
        return self.packets / self.seconds if self.seconds > 0 else float("inf")

    @property
    def pps_per_stream(self) -> float:
        return self.packets_per_second / self.streams if self.streams else 0.0


def _normalize_streams(streams, fleet: int | None) -> list:
    """Accept a (S, n, bits) array, a (n, bits) array (replicated to
    ``fleet`` switches), or a sequence of per-stream arrays/chunk-iterables;
    return a list of per-stream chunk iterables."""
    if hasattr(streams, "ndim"):
        arr = np.asarray(streams)
        if arr.ndim == 3:
            streams = [arr[i] for i in range(arr.shape[0])]
        elif arr.ndim == 2:
            if fleet is None:
                raise ValueError(
                    "a single (batch, bits) array needs plan.fleet to say "
                    "how many switches replicate it"
                )
            streams = [arr] * fleet
        else:
            raise ValueError(f"expected 2-D or 3-D packets, got {arr.shape}")
    streams = list(streams)
    if fleet is not None and len(streams) != fleet:
        if len(streams) == 1:
            streams = streams * fleet
        else:
            raise ValueError(
                f"plan.fleet={fleet} but {len(streams)} streams were given"
            )
    return [
        [np.asarray(s)] if hasattr(s, "ndim") else s for s in streams
    ]


def _probe_fleet_roofline(lowered, backend, n_streams, chunk, plan):
    """Fail-soft roofline probe of the fleet dispatch — obs-only
    bookkeeping, never allowed to affect an execution path."""
    try:
        from repro_torch.roofline import dataplane as _roofline_dp

        return _roofline_dp.probe_fleet(
            lowered, backend=backend, streams=n_streams, chunk=chunk, scan_hops=bool(plan.scan_hops)
        )
    except Exception:  # noqa: BLE001 - observation must not break runs
        return None


def block_bit_counts(res: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Ones per output bit over the valid rows of a ``(S, chunk, out_bits)``
    block: the whole block's sums less those of the pad rows."""
    counts = res.sum(axis=(0, 1), dtype=np.int64)
    for i in np.flatnonzero(valid < res.shape[1]):
        counts -= res[i, valid[i]:].sum(axis=0, dtype=np.int64)
    return counts


def stream_outputs(blocks: list, per_stream: np.ndarray, output_bits: int) -> list:
    """Per-stream outputs from every block's ``(S, chunk, out_bits)`` uint8
    rows.  A stream fills whole chunks until its last (short) one and is
    then exhausted, so its outputs are the first ``per_stream[i]`` of its
    rows across the blocks."""
    if not blocks:
        return [np.zeros((0, output_bits), np.uint8) for _ in per_stream]
    rows = np.concatenate(blocks, axis=1)     # (S, blocks * chunk, out_bits)
    return [rows[i, :n] for i, n in enumerate(per_stream)]


def execute_fleet(
    lowered,
    streams,
    *,
    plan: ExecutionPlan | None = None,
    device="cuda",
) -> FleetRunResult:
    """Run N independent streams through one executor dispatch a block on
    ``device``; bit-exact per stream with ``executor.execute(lowered,
    stream_i)``.

    Timing follows ``execute_stream``'s discipline: the first block's warm
    call (kernel build, table upload and planning) happens outside the
    clock, with a synchronise, and is reported as ``warmup_seconds``; each
    block's host-to-device copy is also outside the clock, which runs to the
    block's outputs on the host.
    """
    if not isinstance(lowered, LoweredProgram):
        lowered = lower_program(lowered)
    plan = plan or ExecutionPlan()
    check_devices(plan)
    backend = _executor.resolve_backend(plan.backend_str)
    device = resolve_device(device)
    chunk = plan.chunk_size or DEFAULT_STREAM_CHUNK
    its = _normalize_streams(streams, plan.fleet)
    n_streams = len(its)
    fn = fleet_fn(lowered, backend=backend, scan_hops=bool(plan.scan_hops), device=device)

    bit_counts = np.zeros(lowered.output_bits, np.int64)
    per_stream = np.zeros(n_streams, np.int64)
    collected = [] if plan.collect else None
    seconds = 0.0
    warmup = 0.0
    n_blocks = 0
    roofline = None
    with obs.span(
        "stream:fleet_run", cat="stream",
        streams=n_streams, backend=backend, chunk_size=chunk, devices=1,
    ):
        for blocks, valid in fleet_blocks(its, chunk, lowered.input_bits):
            dev = _executor._to_device(blocks, device)
            if n_blocks == 0:  # build kernels and upload tables outside the clock
                with obs.span(
                    "compile:fleet_chunk", cat="compile",
                    streams=n_streams, packets=n_streams * chunk,
                ):
                    w0 = time.perf_counter()
                    fn(dev)
                    if device.type == "cuda":
                        torch.cuda.synchronize(device)
                    warmup = time.perf_counter() - w0
                if obs.enabled():  # cost the dispatch, once
                    roofline = _probe_fleet_roofline(lowered, backend, n_streams, chunk, plan)
            served = int(valid.sum())
            with obs.span(
                "execute:fleet_chunk", cat="execute", packets=served
            ):
                t0 = time.perf_counter()
                res = fn(dev).cpu().numpy()
                dt = time.perf_counter() - t0
            seconds += dt
            n_blocks += 1
            bit_counts += block_bit_counts(res, valid)
            per_stream += valid
            if collected is not None:
                collected.append(res.astype(np.uint8))
            if obs.enabled():
                m = obs.registry()
                m.counter("fleet.packets_total").inc(served)
                m.counter("fleet.chunks_total").inc()
                m.histogram("fleet.chunk_seconds").observe(dt)
    total = int(per_stream.sum())
    if obs.enabled() and seconds > 0:
        obs.registry().gauge("fleet.agg_pps").set(total / seconds)
        if roofline is not None:
            _executor._record_roofline(roofline, total / seconds)
    return FleetRunResult(
        streams=n_streams,
        packets=total,
        chunks=n_blocks,
        seconds=seconds,
        per_stream_packets=per_stream,
        bit_counts=bit_counts,
        outputs=None if collected is None else stream_outputs(collected, per_stream, lowered.output_bits),
        warmup_seconds=warmup,
        backend=backend,
        devices=1,
    )
