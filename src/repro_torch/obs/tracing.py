"""Span tracer: nested timing contexts exporting to Chrome Trace Event JSON.

Spans are context managers that nest — the dataplane's hot-path hierarchy
is ``stream > chunk > hop > execute`` — and every finished span records its
name, category, wall-clock interval, nesting depth, and free-form args.
The category is the phase axis the ROADMAP's 10,000x-gap work needs:
instrumented code opens ``cat="compile"`` spans around jit warm-up and
``cat="execute"`` spans around steady-state dispatch, so a trace decomposes
end-to-end time into named phases instead of one opaque wall-time number.

Export is the Chrome Trace Event format (one ``"X"`` complete event per
span, microsecond timestamps) — load the JSON in ``chrome://tracing`` or
Perfetto and the span nesting renders as a flame graph per thread.

Invariants:

* **Observation only** — entering/leaving a span never affects the traced
  code; exceptions propagate untouched (the span still records).
* **Well nested per thread** — spans track a per-thread stack, so depths
  and parent names are consistent even with the tracer shared across
  threads.
* **Monotonic clock** — all intervals come from ``time.perf_counter``
  against a per-tracer epoch; events are relative, not wall-dated.
"""
from __future__ import annotations

import dataclasses
import threading
import time

__all__ = [
    "Span",
    "SpanRecord",
    "Tracer",
]


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One finished span."""

    name: str
    cat: str
    start: float          # seconds since tracer epoch
    duration: float       # seconds
    thread_id: int
    depth: int
    parent: str | None
    args: dict


class Span:
    """Context manager recording one timed interval into its tracer."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_depth", "_parent")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0
        self._depth = 0
        self._parent: str | None = None

    def __enter__(self) -> "Span":
        stack = self._tracer._stack()
        self._depth = len(stack)
        self._parent = stack[-1] if stack else None
        stack.append(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        self._tracer._stack().pop()
        self._tracer._record(
            SpanRecord(
                name=self.name,
                cat=self.cat,
                start=self._t0 - self._tracer.epoch,
                duration=t1 - self._t0,
                thread_id=threading.get_ident(),
                depth=self._depth,
                parent=self._parent,
                args=self.args,
            )
        )
        return False


class Tracer:
    """Collects finished spans; export via :func:`chrome_trace_events`."""

    def __init__(self) -> None:
        self.epoch = time.perf_counter()
        self.records: list[SpanRecord] = []
        self._tls = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> list[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    def _record(self, record: SpanRecord) -> None:
        with self._lock:
            self.records.append(record)

    def span(self, name: str, cat: str = "span", **args) -> Span:
        return Span(self, name, cat, args)

    def reset(self) -> None:
        with self._lock:
            self.records.clear()
            self.epoch = time.perf_counter()

    def total_by_category(self) -> dict[str, float]:
        """Summed span seconds per category (top-level spans of each
        category only: a span's time is not double-counted under a same-
        category ancestor)."""
        totals: dict[str, float] = {}
        # Build per-record ancestor-category sets by replaying depth order
        # per thread; records list preserves completion order, so recompute
        # from the records' (thread, depth, interval) structure instead:
        # a span is "top-level for its category" if no other span of the
        # same category on the same thread strictly contains it.
        by_thread: dict[int, list[SpanRecord]] = {}
        for r in self.records:
            by_thread.setdefault(r.thread_id, []).append(r)
        for recs in by_thread.values():
            for r in recs:
                contained = any(
                    o is not r
                    and o.cat == r.cat
                    and o.start <= r.start
                    and o.start + o.duration >= r.start + r.duration
                    and o.depth < r.depth
                    for o in recs
                )
                if not contained:
                    totals[r.cat] = totals.get(r.cat, 0.0) + r.duration
        return totals

    def chrome_trace_events(self) -> list[dict]:
        """Finished spans as Chrome Trace Event ``"X"`` (complete) events,
        microsecond units, ready for ``chrome://tracing`` / Perfetto."""
        tids = {}
        events = []
        for r in self.records:
            tid = tids.setdefault(r.thread_id, len(tids))
            events.append(
                {
                    "name": r.name,
                    "cat": r.cat or "span",
                    "ph": "X",
                    "ts": r.start * 1e6,
                    "dur": r.duration * 1e6,
                    "pid": 1,
                    "tid": tid,
                    "args": {
                        **{k: _jsonable(v) for k, v in r.args.items()},
                        "depth": r.depth,
                        **({"parent": r.parent} if r.parent else {}),
                    },
                }
            )
        events.sort(key=lambda e: e["ts"])
        return events


def _jsonable(value):
    if isinstance(value, (bool, int, float, str)) or value is None:
        return value
    return str(value)
