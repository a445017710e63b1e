"""``repro_torch.obs`` — runtime observability for the dataplane hot path.

One global switch and two switched capabilities, plus their exporters
(``obs.export``: metrics JSONL, Prometheus text, Chrome trace):

* a **metrics registry** (``obs.metrics``): counters, gauges, and
  streaming histograms with p50/p95/p99 — packets/s, chunk latency,
  table cache hits;
* a **span tracer** (``obs.tracing``): nested context-manager spans
  (``stream > chunk``) with explicit ``compile`` vs ``execute``
  categories, exporting Chrome Trace Event JSON.

Usage — instrumented code (the executor) calls the module-level helpers,
which are no-ops until :func:`enable` flips the switch::

    from repro_torch import obs

    with obs.span("execute:chunk", cat="execute", packets=n):
        ...hot work...
    if obs.enabled():
        obs.registry().counter("dataplane.packets_total").inc(n)

Invariants:

* **Disabled means no-op** — with the switch off, :func:`span` returns a
  shared null context manager and instrumented code skips all metric
  work; the instrumented paths are bit-exact with uninstrumented code in
  *both* states (observability never touches data).
* **One global state** — helpers address a single process-wide registry +
  tracer pair, so instrumentation at any layer lands in one capture.
  :func:`enable`'s ``reset=True`` starts a clean capture.
* **Import-light** — this package imports only stdlib + numpy; dataplane
  modules can instrument without import cycles.
"""
from __future__ import annotations

import os

from repro_torch.obs import export as _export
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.tracing import Span, SpanRecord, Tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "SpanRecord",
    "Tracer",
    "disable",
    "enable",
    "enable_from_env",
    "enabled",
    "export_all",
    "registry",
    "reset",
    "span",
    "tracer",
]

OBS_ENV = "REPRO_OBS"           # truthy value enables at enable_from_env()

_enabled = False
_registry = MetricsRegistry()
_tracer = Tracer()


class _NullSpan:
    """Shared do-nothing context manager — the disabled hot path."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_SPAN = _NullSpan()


def enabled() -> bool:
    """Is the global observability switch on?"""
    return _enabled


def enable(*, reset: bool = False) -> None:
    """Turn observability on (``reset=True`` starts a clean capture)."""
    global _enabled
    if reset:
        globals()["_registry"] = MetricsRegistry()
        _tracer.reset()
    _enabled = True


def disable() -> None:
    """Turn observability off (captured state is kept)."""
    global _enabled
    _enabled = False


def reset() -> None:
    """Drop all captured metrics and spans (switch state unchanged)."""
    globals()["_registry"] = MetricsRegistry()
    _tracer.reset()


def enable_from_env() -> bool:
    """Enable iff ``$REPRO_OBS`` is set truthy; returns the switch state.

    The hook harnesses use so a job can opt a whole run into tracing
    without code changes.
    """
    val = os.environ.get(OBS_ENV, "").strip().lower()
    if val not in ("", "0", "false", "no", "off"):
        enable()
    return _enabled


def registry() -> MetricsRegistry:
    """The process-wide metrics registry."""
    return _registry


def tracer() -> Tracer:
    """The process-wide span tracer."""
    return _tracer


def span(name: str, cat: str = "span", **args):
    """A timed span when enabled, a shared no-op otherwise."""
    if not _enabled:
        return _NULL_SPAN
    return _tracer.span(name, cat, **args)


def export_all(out_dir: str, *, prefix: str = "obs") -> dict[str, str]:
    """Write metrics JSONL + Prometheus text + chrome trace to ``out_dir``
    (see ``repro_torch.obs.export.export_all``); returns the artifact paths."""
    return _export.export_all(out_dir, _registry, _tracer, prefix=prefix)
