"""Exporters: metrics JSONL, Prometheus-style text, Chrome Trace JSON.

Three on-disk formats, one source of truth (the live
:class:`~repro_torch.obs.metrics.MetricsRegistry` and
:class:`~repro_torch.obs.tracing.Tracer`):

* **metrics JSONL** (``*_metrics.jsonl``) — one JSON object per metric per
  line, the machine-readable artifact ``tools/obs_report.py`` renders and
  CI uploads.  Histogram lines carry count/sum/min/max/p50/p95/p99 plus the
  raw sparse buckets, so downstream tools can re-derive any quantile.
* **Prometheus text** (``*_metrics.prom``) — the text exposition format a
  scrape endpoint would serve: counters/gauges as single samples,
  histograms as summaries (``{quantile="..."}`` samples plus ``_count`` /
  ``_sum``).  Metric names are sanitized (dots -> underscores).
* **Chrome trace** (``*_trace.json``) — ``{"traceEvents": [...]}``, loadable
  in ``chrome://tracing`` / Perfetto (see ``repro_torch.obs.tracing``).

``export_all`` writes all three under one directory with one prefix — the
single call the benchmark harness and examples use.
"""
from __future__ import annotations

import json
import os
import re

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracing import Tracer

__all__ = [
    "export_all",
    "render_prometheus",
    "write_chrome_trace",
    "write_metrics_jsonl",
]

_PROM_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_QUANTILES = (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99"))


def write_metrics_jsonl(path: str, registry: MetricsRegistry) -> str:
    """One JSON object per metric per line; returns ``path``."""
    with open(path, "w") as fh:
        for row in registry.snapshot():
            fh.write(json.dumps(row, sort_keys=True) + "\n")
    return path


def _prom_escape(value: str) -> str:
    """Escape a label value per the Prometheus text exposition format:
    backslash, double-quote, and newline must be backslash-escaped."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _prom_labels(labels: dict[str, str], extra: dict[str, str] | None = None) -> str:
    merged = {**labels, **(extra or {})}
    if not merged:
        return ""
    inner = ",".join(
        f'{k}="{_prom_escape(v)}"' for k, v in sorted(merged.items())
    )
    return "{" + inner + "}"


def render_prometheus(registry: MetricsRegistry) -> str:
    """The registry in Prometheus text exposition format."""
    lines: list[str] = []
    seen_types: set[str] = set()
    for row in registry.snapshot():
        name = _PROM_NAME_RE.sub("_", row["name"])
        labels = row["labels"]
        if row["type"] in ("counter", "gauge"):
            if name not in seen_types:
                lines.append(f"# TYPE {name} {row['type']}")
                seen_types.add(name)
            lines.append(f"{name}{_prom_labels(labels)} {row['value']:.10g}")
        else:
            if name not in seen_types:
                lines.append(f"# TYPE {name} summary")
                seen_types.add(name)
            for q, key in _QUANTILES:
                val = row[key]
                if val is not None:
                    lines.append(
                        f"{name}{_prom_labels(labels, {'quantile': q})} "
                        f"{val:.10g}"
                    )
            lines.append(f"{name}_count{_prom_labels(labels)} {row['count']}")
            lines.append(f"{name}_sum{_prom_labels(labels)} {row['sum']:.10g}")
    return "\n".join(lines) + ("\n" if lines else "")


def write_prometheus(path: str, registry: MetricsRegistry) -> str:
    with open(path, "w") as fh:
        fh.write(render_prometheus(registry))
    return path


def write_chrome_trace(path: str, tracer: Tracer) -> str:
    """Chrome Trace Event JSON (``chrome://tracing`` / Perfetto)."""
    payload = {
        "traceEvents": tracer.chrome_trace_events(),
        "displayTimeUnit": "ms",
    }
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return path


def export_all(
    out_dir: str,
    registry: MetricsRegistry,
    tracer: Tracer,
    *,
    prefix: str = "obs",
) -> dict[str, str]:
    """Write all three artifacts under ``out_dir``; returns their paths
    keyed ``{"metrics_jsonl", "metrics_prom", "trace"}``."""
    os.makedirs(out_dir, exist_ok=True)
    return {
        "metrics_jsonl": write_metrics_jsonl(
            os.path.join(out_dir, f"{prefix}_metrics.jsonl"), registry
        ),
        "metrics_prom": write_prometheus(
            os.path.join(out_dir, f"{prefix}_metrics.prom"), registry
        ),
        "trace": write_chrome_trace(
            os.path.join(out_dir, f"{prefix}_trace.json"), tracer
        ),
    }
