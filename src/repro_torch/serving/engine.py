"""Serving engines (the reference's ``serving/engine.py``): batched LM decode
slots and the dataplane fleet pipeline.

* :class:`Engine` — LM continuous batching.  ``max_batch`` decode slots;
  requests are prefilled (cache seeded at prompt length, right-padded to
  the decode budget) and inserted into free slots; every step decodes ALL
  active slots in one batched ``decode_step`` call; finished sequences free
  their slot for the next queued request.

  As in the reference, the batched cache has one shared ``index``:
  installing a prompt sets it to the largest slot position seen
  (``_install``), and a shorter slot attends over its zero-padded
  positions.  Also as in the reference, a decode step runs every slot, so
  an empty slot's stale token is routed through an MoE layer and takes
  expert capacity.  Both are kept so that the tokens equal the
  reference's.

  Prefill and decode steps run under ``torch.inference_mode()``: serving
  records no autograd graph (``models.forward`` is differentiable, and the
  kernels refuse inputs that require grad in grad mode).

  The engine also keeps its own clock: ``prefill_seconds`` and
  ``decode_seconds`` (host time of each call up to its sampled tokens on
  the host, which waits for the device), ``decode_steps`` and
  ``decode_tokens``.

* :class:`FleetEngine` — the dataplane's async chunk pipeline.  A producer
  thread assembles ``(streams, chunk, bits)`` numpy fleet blocks from the
  per-stream iterators into a bounded queue, and does nothing else; the
  main thread copies each block to the card and runs the
  ``dataplane.fleet`` executable — every torch and CUDA call stays on the
  main thread.  Ingest and execution overlap instead of alternating;
  bit-exactness is untouched (the pipeline only reorders *when* blocks are
  built, never their contents).  The producer is stopped and joined on
  every exit from ``serve``, an exception included.
"""
from __future__ import annotations

import dataclasses
import queue as _queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.dataplane import executor as _executor
from repro_torch.dataplane import fleet as _fleet
from repro_torch.dataplane.lowering import LoweredProgram, lower_program
from repro_torch.dataplane.plan import ExecutionPlan
from repro_torch.device import resolve_device
from repro_torch.models import decode_step, init_cache, prefill
from repro_torch.models.model import cache_tensors, set_index
from repro_torch.obs.slo import BreachEvent, SloSpec, SloStatus, SloTracker
from repro_torch.obs.windows import WindowedHistogram, WindowedRate


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the engine:
    output: list = dataclasses.field(default_factory=list)
    done: bool = False


class Engine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        *,
        max_batch: int = 4,
        max_len: int = 256,
        sampler: Optional[Callable] = None,
        device="cuda",
    ):
        if cfg.encoder_only:
            raise ValueError("encoder-only architectures cannot be served")
        if cfg.attn_impl != "xla":
            raise ValueError(
                f"attn_impl={cfg.attn_impl!r} cannot seed a decode cache; serve with "
                "attn_impl='xla' (the flash kernel is for full-sequence forward)"
            )
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.max_len = max_len
        self.sampler = sampler or (lambda logits: torch.argmax(logits, dim=-1))

        self.cache = init_cache(cfg, max_batch, max_len, device=self.device)
        self.slots: list[Optional[Request]] = [None] * max_batch
        self.slot_pos = np.zeros(max_batch, np.int32)       # next write index
        self.slot_budget = np.zeros(max_batch, np.int32)
        self.last_token = np.zeros(max_batch, np.int32)
        self.queue: list[Request] = []
        self.completed: list[Request] = []
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0
        self.decode_steps = 0
        self.decode_tokens = 0

    # -- API -------------------------------------------------------------

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Process until queue + slots drain (or step budget)."""
        for _ in range(max_steps):
            self._admit()
            if not any(s is not None for s in self.slots):
                if not self.queue:
                    break
                continue
            self._step()
        return self.completed

    # -- internals ---------------------------------------------------------

    @torch.inference_mode()
    def _admit(self) -> None:
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            s = len(req.prompt)
            t0 = time.perf_counter()
            tokens = torch.as_tensor(np.asarray(req.prompt, np.int64)[None, :], device=self.device)
            logits, pcache = prefill(self.params, {"tokens": tokens}, self.cfg)
            tok = int(self.sampler(logits)[0])
            self.prefill_seconds += time.perf_counter() - t0
            req.output.append(tok)
            # EOS / budget may already hit on the prefill-sampled token
            if (req.eos_id is not None and tok == req.eos_id) or req.max_new_tokens <= 1:
                req.done = True
                self.completed.append(req)
                continue
            self._install(slot, pcache, s)
            self.slots[slot] = req
            self.slot_pos[slot] = s
            self.slot_budget[slot] = req.max_new_tokens - 1
            self.last_token[slot] = tok

    def _install(self, slot: int, pcache, prompt_len: int) -> None:
        """Copy a prefilled (batch=1) cache into the slot axis of the
        batched cache, every tensor of it (``cache_tensors``: a
        ``KVCache``'s k and v, an ``MlaCache``'s c_kv and k_rope, an
        ``SsmCache``'s state and window tails, both of a ``HybridCache``).
        A sequence axis (axis 2) is zero-filled past the prompt up to
        max_len; an SSM tensor has none and is copied whole."""
        for dst, src in zip(cache_tensors(self.cache), cache_tensors(pcache)):
            dst[:, slot].zero_()
            dst[:, slot, : src.shape[2]] = src[:, 0].to(dst.dtype)
        # one index for every slot: the largest position (see module doc)
        self.cache = set_index(self.cache, int(max(self.slot_pos.max(), prompt_len)))

    @torch.inference_mode()
    def _step(self) -> None:
        t0 = time.perf_counter()
        tokens = torch.as_tensor(self.last_token.astype(np.int64), device=self.device)
        logits, self.cache = decode_step(self.params, tokens, self.cache, self.cfg)
        next_tok = self.sampler(logits).cpu().numpy()
        self.decode_seconds += time.perf_counter() - t0
        self.decode_steps += 1
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            self.decode_tokens += 1
            tok = int(next_tok[slot])
            req.output.append(tok)
            self.slot_pos[slot] += 1
            self.slot_budget[slot] -= 1
            if (req.eos_id is not None and tok == req.eos_id) or (
                self.slot_budget[slot] <= 0 or self.slot_pos[slot] >= self.max_len - 1
            ):
                req.done = True
                self.completed.append(req)
                self.slots[slot] = None


# ---------------------------------------------------------------------------
# Dataplane fleet serving: async ingest/execute pipeline
# ---------------------------------------------------------------------------

# How long a blocked ``put`` of the ingest thread waits before it looks at
# its stop event again.
_PUT_WAIT_S = 0.05

@dataclasses.dataclass
class FleetServeResult:
    """Outcome of a pipelined fleet serve.

    ``wall_seconds`` is end-to-end steady-state time (first-block warmup
    excluded, queue stalls included) — the honest serving number.
    ``ingest_seconds``/``execute_seconds`` are the per-side busy times; with
    perfect overlap ``wall ~= max(ingest, execute)``, serialized it would be
    their sum."""

    streams: int
    packets: int
    chunks: int
    wall_seconds: float
    ingest_seconds: float
    execute_seconds: float
    warmup_seconds: float
    per_stream_packets: np.ndarray
    outputs: list | None = None

    @property
    def packets_per_second(self) -> float:
        return (
            self.packets / self.wall_seconds
            if self.wall_seconds > 0
            else float("inf")
        )

    @property
    def overlap_ratio(self) -> float:
        """(ingest + execute) / wall — 1.0 is fully serialized, 2.0 is
        perfect two-stage overlap."""
        busy = self.ingest_seconds + self.execute_seconds
        return busy / self.wall_seconds if self.wall_seconds > 0 else 1.0


@dataclasses.dataclass(frozen=True)
class FleetHealth:
    """Live ``FleetEngine`` snapshot as of an explicit ``now``.

    The windowed fields (aggregate and per-stream pps, chunk-latency p99,
    SLO posture) come from the engine's explicit-timestamp windows — with
    an injected deterministic ``clock`` they are a pure function of the
    served blocks.  ``queue_depth`` is the one genuinely live field: the
    number of assembled blocks waiting in the ingest queue at call time.
    """

    now: float
    streams: int
    queue_depth: int                   # blocks waiting in the ingest queue
    queue_capacity: int
    chunks: int                        # blocks dispatched since construction
    packets: int                       # packets served since construction
    windowed_pps: float                # aggregate rate over the trailing window
    per_stream_pps: tuple[float, ...]  # same, per fleet stream
    chunk_p99_s: float | None          # windowed p99 dispatch latency
    overlap_ratio: float | None        # last completed serve() (None before)
    slo: SloStatus | None              # None when no SLO was configured
    breach_events: tuple[BreachEvent, ...]
    roofline_pps_bound: float | None   # the card's bound on the dispatch (roofline.dataplane)
    roofline_fraction: float | None    # windowed_pps / bound

    def render(self) -> str:
        lines = [
            f"fleet health @ {self.now:.3f}: {self.streams} stream(s), "
            f"queue {self.queue_depth}/{self.queue_capacity}, "
            f"{self.chunks} chunk(s) / {self.packets} packet(s) served",
            f"  windowed: {self.windowed_pps:.4g} pps aggregate, "
            f"chunk p99 "
            + (f"{self.chunk_p99_s * 1e3:.3f}ms"
               if self.chunk_p99_s is not None else "-"),
        ]
        if self.roofline_pps_bound is not None:
            frac = (
                f" ({self.roofline_fraction:.2e} of bound)"
                if self.roofline_fraction is not None else ""
            )
            lines.append(
                f"  roofline: {self.roofline_pps_bound:.4g} pps bound{frac}"
            )
        if self.slo is not None:
            s = self.slo
            burns = []
            if s.delay_burn_rate is not None:
                burns.append(f"delay burn {s.delay_burn_rate:.2f}x")
            if s.pps_burn_rate is not None:
                burns.append(f"pps burn {s.pps_burn_rate:.2f}x")
            state = "BREACHED" if s.breached else "ok"
            lines.append(
                f"  slo[{s.tenant}]: {state} "
                + (", ".join(burns) if burns else "no data")
                + f", {len(self.breach_events)} breach event(s)"
            )
        return "\n".join(lines)


class FleetEngine:
    """Async fleet pipeline: assemble blocks on a producer thread while the
    main thread runs the fleet executable on ``device``.

    ``plan`` carries backend/chunk/fleet exactly as in
    ``repro_torch.dataplane.plan.run`` (``devices`` of None or 1: the port
    runs on one GPU); ``queue_depth`` bounds how many assembled blocks may
    wait (bounded memory even when ingest outruns execution).

    ``health()`` is the live snapshot API: sliding-window pps (aggregate
    and per stream), queue depth, chunk-latency p99, and — when an
    :class:`~repro_torch.obs.slo.SloSpec` is passed — SLO burn rates and
    breach events.  All window/SLO timestamps come from ``clock`` (default
    ``time.perf_counter``), which is called only on the main dispatch
    thread, twice per served block: inject a deterministic clock and every
    windowed health field becomes reproducible bit-for-bit.
    """

    def __init__(
        self,
        program,
        *,
        plan: ExecutionPlan | None = None,
        queue_depth: int = 4,
        slo: SloSpec | None = None,
        clock: Callable[[], float] | None = None,
        window_s: float = 10.0,
        window_buckets: int = 10,
        device="cuda",
    ):
        self.lowered = (
            program
            if isinstance(program, LoweredProgram)
            else lower_program(program)
        )
        self.plan = plan or ExecutionPlan()
        _fleet.check_devices(self.plan)
        self.device = resolve_device(device)
        self.backend = _executor.resolve_backend(self.plan.backend_str)
        self.chunk = self.plan.chunk_size or _fleet.DEFAULT_STREAM_CHUNK
        self.queue_depth = queue_depth
        self.fn = _fleet.fleet_fn(
            self.lowered,
            backend=self.backend,
            scan_hops=bool(self.plan.scan_hops),
            device=self.device,
        )
        # -- health-snapshot state (explicit-timestamp windows + SLO) -------
        self._clock = clock or time.perf_counter
        self.window_s = float(window_s)
        self._window_buckets = int(window_buckets)
        self._agg_rate = WindowedRate(self.window_s, buckets=window_buckets)
        self._chunk_delay = WindowedHistogram(
            self.window_s, buckets=window_buckets
        )
        self._stream_rates: list[WindowedRate] = []
        self._slo = SloTracker(slo, buckets=window_buckets) if slo else None
        self._queue: _queue.Queue | None = None
        self._chunks_total = 0
        self._packets_total = 0
        self._last_result: FleetServeResult | None = None
        self._roofline = None
        self._last_now = 0.0

    def health(self, now: float | None = None) -> FleetHealth:
        """The live engine snapshot (see class docstring).  ``now`` defaults
        to the engine clock; pass the timestamp explicitly to re-read a
        window at a known instant (the deterministic-testing path)."""
        if now is None:
            now = self._clock()
        q = self._queue
        windowed = self._agg_rate.rate(now)
        bound = (
            self._roofline.roofline_pps if self._roofline is not None else None
        )
        return FleetHealth(
            now=now,
            streams=len(self._stream_rates),
            queue_depth=q.qsize() if q is not None else 0,
            queue_capacity=self.queue_depth,
            chunks=self._chunks_total,
            packets=self._packets_total,
            windowed_pps=windowed,
            per_stream_pps=tuple(
                r.rate(now) for r in self._stream_rates
            ),
            chunk_p99_s=self._chunk_delay.p99(now),
            overlap_ratio=(
                self._last_result.overlap_ratio
                if self._last_result is not None else None
            ),
            slo=self._slo.status(now) if self._slo is not None else None,
            breach_events=(
                tuple(self._slo.events) if self._slo is not None else ()
            ),
            roofline_pps_bound=bound,
            roofline_fraction=(
                windowed / bound if bound else None
            ),
        )

    def _observe_block(self, now: float, dt: float, valid, served: int) -> None:
        """Fold one dispatched block into the health windows (main thread
        only; ``now`` comes from the injectable engine clock)."""
        self._last_now = now
        self._chunks_total += 1
        self._packets_total += served
        self._agg_rate.add(now, served)
        self._chunk_delay.observe(now, dt, count=1)
        for i in np.flatnonzero(valid):
            self._stream_rates[i].add(now, int(valid[i]))
        if self._slo is not None:
            self._slo.observe_packets(now, served)
            # One fused dispatch serves the whole block: every packet in it
            # waits exactly the dispatch latency.
            self._slo.observe_queue_delay(now, dt, count=served)
            self._slo.update(now)

    def serve(self, streams, *, collect: bool = False) -> FleetServeResult:
        """Drain every stream through the pipelined fleet; bit-exact per
        stream with ``executor.execute`` (the pipeline reorders block
        *assembly*, never block contents).

        The producer thread is stopped and joined before ``serve`` returns
        or raises: an exception on the main thread (a failing dispatch)
        sets its stop event, so a ``put`` into a full queue gives up within
        ``_PUT_WAIT_S`` instead of blocking the process's exit.
        """
        its = _fleet._normalize_streams(streams, self.plan.fleet)
        n_streams = len(its)
        if len(self._stream_rates) != n_streams:  # fleet size changed: reset
            self._stream_rates = [
                WindowedRate(self.window_s, buckets=self._window_buckets)
                for _ in range(n_streams)
            ]
        q: _queue.Queue = _queue.Queue(maxsize=self.queue_depth)
        self._queue = q
        stop = threading.Event()
        ingest = [0.0]
        errors: list[BaseException] = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=_PUT_WAIT_S)
                    return True
                except _queue.Full:
                    continue
            return False

        def produce() -> None:
            try:
                mark = time.perf_counter()
                for block in _fleet.fleet_blocks(
                    its, self.chunk, self.lowered.input_bits
                ):
                    # Time spent *building* the block (featurization, pcap
                    # pulls, re-chunking) — not time blocked on a full queue.
                    ingest[0] += time.perf_counter() - mark
                    if not put(block):
                        return
                    mark = time.perf_counter()
            except Exception as e:  # noqa: BLE001 - surfaced on the main thread
                errors.append(e)
            finally:
                put(None)

        per_stream = np.zeros(n_streams, np.int64)
        collected = [] if collect else None
        execute_seconds = 0.0
        warmup = 0.0
        n_blocks = 0
        producer = threading.Thread(target=produce, name="fleet-ingest")
        with obs.span(
            "stream:fleet_serve", cat="stream",
            streams=n_streams, backend=self.backend, chunk_size=self.chunk,
        ):
            producer.start()
            try:
                t_start = time.perf_counter()
                while True:
                    item = q.get()
                    if item is None:
                        break
                    blocks, valid = item
                    dev = _executor._to_device(blocks, self.device)
                    if n_blocks == 0:  # build kernels and upload tables outside the clock
                        with obs.span(
                            "compile:fleet_chunk", cat="compile",
                            streams=n_streams,
                        ):
                            w0 = time.perf_counter()
                            self.fn(dev)
                            if self.device.type == "cuda":
                                torch.cuda.synchronize(self.device)
                            warmup = time.perf_counter() - w0
                        if obs.enabled():  # cost the dispatch, once
                            self._roofline = _fleet._probe_fleet_roofline(
                                self.lowered, self.backend, n_streams,
                                self.chunk, self.plan,
                            )
                    served_now = int(valid.sum())
                    with obs.span(
                        "execute:fleet_chunk", cat="execute",
                        packets=served_now,
                    ):
                        # Health observations use the engine clock on both
                        # sides of the dispatch (two calls per block, main
                        # thread only) so an injected deterministic clock
                        # makes every windowed health field reproducible;
                        # the serve result's bookkeeping stays on
                        # perf_counter.
                        h0 = self._clock()
                        t0 = time.perf_counter()
                        res = self.fn(dev).cpu().numpy()
                        execute_seconds += time.perf_counter() - t0
                        h1 = self._clock()
                    n_blocks += 1
                    self._observe_block(h1, max(h1 - h0, 0.0), valid, served_now)
                    per_stream += valid
                    if collected is not None:
                        collected.append(res.astype(np.uint8))
                wall = time.perf_counter() - t_start - warmup
            finally:
                stop.set()
                producer.join()
        if errors:
            raise errors[0]
        total = int(per_stream.sum())
        if obs.enabled() and wall > 0:
            obs.registry().gauge("fleet.serve_pps").set(total / wall)
            if self._roofline is not None:
                _executor._record_roofline(self._roofline, total / wall)
        result = FleetServeResult(
            streams=n_streams,
            packets=total,
            chunks=n_blocks,
            wall_seconds=wall,
            ingest_seconds=ingest[0],
            execute_seconds=execute_seconds,
            warmup_seconds=warmup,
            per_stream_packets=per_stream,
            outputs=(
                None if collected is None
                else _fleet.stream_outputs(collected, per_stream, self.lowered.output_bits)
            ),
        )
        self._last_result = result
        return result

