"""Runtime metrics: counters, gauges, and streaming histograms.

The dataplane's observability substrate (``repro_torch.obs``).  Three metric
kinds, all cheap enough for per-chunk hot-path use and all label-aware so
one name can fan out per tenant / per hop / per scenario:

* :class:`Counter` — monotonically increasing float (packets served,
  drops, cache hits).
* :class:`Gauge`   — last-write-wins float (queue depth, loss, accuracy).
* :class:`Histogram` — streaming log-bucketed distribution with
  constant-memory percentile estimates (chunk latency, per-tenant queue
  delay, train-step time).

Histogram design: observations land in exponential buckets of width
``GROWTH = 2**(1/8)`` (8 buckets per octave), so any quantile estimate is
within ~4.4% relative error of the true sample quantile — while the state
is just a sparse ``{bucket_index: count}`` dict plus exact count/sum/
min/max.  Two histograms with the same growth merge by adding bucket
counts, which is what lets per-chunk or per-worker histograms roll up into
a run-level distribution without keeping samples.

Invariants:

* **Bounded memory** — a histogram never stores samples; state is O(number
  of distinct buckets touched), independent of observation count.
* **Exact extremes** — ``min``/``max``/``count``/``sum`` are exact;
  quantiles are clamped into ``[min, max]``, so a single-sample histogram
  reports that sample exactly at every quantile.
* **Mergeable** — ``merge`` is associative and commutative; merging equals
  having observed both streams into one histogram.
* **Observation only** — metrics never influence the code paths they
  measure (the ``repro_torch.obs`` contract).
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Iterable

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
]

# 8 buckets per octave: bucket edges grow by 2**(1/8) ~ 1.0905, so the
# geometric-midpoint estimate of any sample in a bucket is within
# sqrt(GROWTH) - 1 ~ 4.4% of its true value.
_GROWTH_LOG = math.log(2.0) / 8.0


def _bucket_index(value: float) -> int:
    return math.floor(math.log(value) / _GROWTH_LOG)


def _bucket_mid(index: int) -> float:
    return math.exp((index + 0.5) * _GROWTH_LOG)


class Counter:
    """Monotonic float counter."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up; got {amount}")
        self.value += amount


class Gauge:
    """Last-write-wins float gauge."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram:
    """Streaming log-bucketed histogram with percentile estimates.

    Observations must be finite and non-negative; zeros are tracked in a
    dedicated bucket (queue delays and latencies can legitimately round to
    0.0).  ``quantile`` returns ``None`` on an empty histogram.
    """

    __slots__ = ("count", "total", "vmin", "vmax", "zero_count", "buckets")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.zero_count = 0
        self.buckets: dict[int, int] = {}

    def observe(self, value: float, count: int = 1) -> None:
        """Record ``count`` observations of ``value`` (weighted observe is
        how e.g. a chunk dispatch latency is attributed to every packet in
        the chunk without a per-packet loop)."""
        if count <= 0:
            return
        value = float(value)
        if not math.isfinite(value) or value < 0:
            raise ValueError(f"histogram values must be finite >= 0, got {value}")
        self.count += count
        self.total += value * count
        self.vmin = min(self.vmin, value)
        self.vmax = max(self.vmax, value)
        if value == 0.0:
            self.zero_count += count
        else:
            idx = _bucket_index(value)
            self.buckets[idx] = self.buckets.get(idx, 0) + count

    def observe_array(self, values: Iterable[float]) -> None:
        """Vectorized :meth:`observe` for a numpy array of values."""
        vals = np.asarray(values, np.float64).ravel()
        if vals.size == 0:
            return
        if not np.isfinite(vals).all() or (vals < 0).any():
            raise ValueError("histogram values must be finite >= 0")
        self.count += int(vals.size)
        self.total += float(vals.sum())
        self.vmin = min(self.vmin, float(vals.min()))
        self.vmax = max(self.vmax, float(vals.max()))
        zero = int((vals == 0.0).sum())
        self.zero_count += zero
        pos = vals[vals > 0.0]
        if pos.size:
            idx = np.floor(np.log(pos) / _GROWTH_LOG).astype(np.int64)
            uniq, cnt = np.unique(idx, return_counts=True)
            for i, c in zip(uniq.tolist(), cnt.tolist()):
                self.buckets[i] = self.buckets.get(i, 0) + c

    @property
    def mean(self) -> float | None:
        return self.total / self.count if self.count else None

    def quantile(self, q: float) -> float | None:
        """Estimated ``q``-quantile (``0 <= q <= 1``); ``None`` if empty.

        Walks buckets in value order to the bucket containing the target
        rank and returns its geometric midpoint, clamped to the exact
        ``[min, max]`` — so single-sample (and single-bucket-extreme)
        histograms are exact.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return None
        rank = max(1, math.ceil(q * self.count))
        seen = self.zero_count
        if rank <= seen:
            return 0.0
        for idx in sorted(self.buckets):
            seen += self.buckets[idx]
            if rank <= seen:
                return min(max(_bucket_mid(idx), self.vmin), self.vmax)
        return self.vmax  # pragma: no cover - rank <= count by construction

    @property
    def p50(self) -> float | None:
        return self.quantile(0.50)

    @property
    def p95(self) -> float | None:
        return self.quantile(0.95)

    @property
    def p99(self) -> float | None:
        return self.quantile(0.99)

    def merge(self, other: "Histogram") -> None:
        """Fold ``other``'s state into this histogram (in place)."""
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        self.zero_count += other.zero_count
        for idx, c in other.buckets.items():
            self.buckets[idx] = self.buckets.get(idx, 0) + c


@dataclasses.dataclass(frozen=True)
class _Key:
    name: str
    labels: tuple[tuple[str, str], ...]


def _key(name: str, labels: dict[str, str]) -> _Key:
    return _Key(name, tuple(sorted((k, str(v)) for k, v in labels.items())))


class MetricsRegistry:
    """Get-or-create store of labeled metrics.

    ``registry.counter("mt.dropped_total", tenant="t0")`` returns the same
    :class:`Counter` on every call with the same name+labels; a name is
    bound to exactly one metric kind (mixing kinds raises).  ``snapshot``
    serializes everything for exporters.
    """

    def __init__(self) -> None:
        self._metrics: dict[_Key, object] = {}
        self._kinds: dict[str, type] = {}
        self._lock = threading.Lock()

    def _get(self, cls: type, name: str, labels: dict[str, str]):
        key = _key(name, labels)
        metric = self._metrics.get(key)
        if metric is None:
            with self._lock:
                metric = self._metrics.get(key)
                if metric is None:
                    bound = self._kinds.setdefault(name, cls)
                    if bound is not cls:
                        raise TypeError(
                            f"metric {name!r} is a {bound.__name__}, "
                            f"requested as {cls.__name__}"
                        )
                    metric = cls()
                    self._metrics[key] = metric
        if type(metric) is not cls:
            raise TypeError(
                f"metric {name!r} is a {type(metric).__name__}, "
                f"requested as {cls.__name__}"
            )
        return metric

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels: str) -> Histogram:
        return self._get(Histogram, name, labels)

    def __len__(self) -> int:
        return len(self._metrics)

    def snapshot(self) -> list[dict]:
        """Every metric as a JSON-ready dict (sorted by name, labels)."""
        out = []
        for key in sorted(
            self._metrics, key=lambda k: (k.name, k.labels)
        ):
            metric = self._metrics[key]
            row: dict = {"name": key.name, "labels": dict(key.labels)}
            if isinstance(metric, Counter):
                row["type"] = "counter"
                row["value"] = metric.value
            elif isinstance(metric, Gauge):
                row["type"] = "gauge"
                row["value"] = metric.value
            else:
                assert isinstance(metric, Histogram)
                row["type"] = "histogram"
                row["count"] = metric.count
                row["sum"] = metric.total
                row["min"] = metric.vmin if metric.count else None
                row["max"] = metric.vmax if metric.count else None
                row["mean"] = metric.mean
                row["p50"] = metric.p50
                row["p95"] = metric.p95
                row["p99"] = metric.p99
                row["zero_count"] = metric.zero_count
                row["buckets"] = {
                    str(i): c for i, c in sorted(metric.buckets.items())
                }
            out.append(row)
        return out
