"""Sliding time-windowed metrics: live rates and histograms.

The registry metrics in ``repro_torch.obs.metrics`` are cumulative — perfect for
end-of-run export, useless for "what is the fleet doing *right now*".
This module adds the live view: a :class:`WindowedRate` answers "packets
per second over the last N seconds" and a :class:`WindowedHistogram`
answers "p99 queue delay over the last N seconds", both of which the SLO
layer (``repro_torch.obs.slo``) and ``FleetEngine.health()`` build on.

Design — absolute bucket indexing:

Time is cut into fixed-width buckets of ``horizon / buckets`` seconds,
keyed by the *absolute* index ``floor(t / width)`` (not by slots relative
to "now").  An observation at time ``t`` lands in exactly one bucket
regardless of when it is delivered or what else has been observed, which
buys three properties at once:

* **Exact rotation** — a query at time ``now`` includes precisely the
  buckets whose start lies inside ``(now - horizon, now]``; there is no
  drift, no partial-bucket approximation at boundaries, and two queries at
  the same ``now`` always agree.
* **Associative merge** — merging is bucket-wise addition keyed by the
  same absolute indices, so ``merge`` is associative and commutative and
  equals having observed both streams into one window (the same contract
  ``metrics.Histogram.merge`` gives the cumulative histograms).
* **Determinism** — every method takes an **explicit timestamp**; the
  module never reads a clock.  Callers that want wall-clock behaviour pass
  ``time.perf_counter()``; callers that want reproducible behaviour (the
  SLO determinism tests, ``FleetEngine``'s injectable clock) pass their
  own time axis and get bit-identical windows back.

State is pruned to the most recent ``buckets`` indices ever observed —
pruning only drops buckets that can never enter a window anchored at or
after the newest observation, so it is invisible to queries (which are
anchored at ``now >= last observation`` in every sane use) and preserves
merge associativity (a bucket pruned early would be pruned by the final
merge's newer anchor anyway).  Memory is O(buckets), independent of
observation count.
"""
from __future__ import annotations

import math

from repro_torch.obs.metrics import Histogram

__all__ = [
    "WindowedHistogram",
    "WindowedRate",
]

DEFAULT_HORIZON = 10.0
DEFAULT_BUCKETS = 10


def _check_window(horizon: float, buckets: int) -> float:
    if not (horizon > 0 and math.isfinite(horizon)):
        raise ValueError(f"horizon must be finite > 0, got {horizon}")
    if buckets < 1:
        raise ValueError(f"buckets must be >= 1, got {buckets}")
    return horizon / buckets


class WindowedRate:
    """Count of events in the trailing ``horizon`` seconds, as of a caller-
    supplied ``now`` — the live pps / arrivals-per-window primitive."""

    __slots__ = ("horizon", "buckets", "width", "_counts", "_max_idx")

    def __init__(
        self,
        horizon: float = DEFAULT_HORIZON,
        *,
        buckets: int = DEFAULT_BUCKETS,
    ) -> None:
        self.width = _check_window(horizon, buckets)
        self.horizon = float(horizon)
        self.buckets = int(buckets)
        self._counts: dict[int, float] = {}
        self._max_idx: int | None = None

    def _prune(self) -> None:
        if self._max_idx is None:
            return
        floor = self._max_idx - self.buckets
        if any(i <= floor for i in self._counts):
            self._counts = {
                i: c for i, c in self._counts.items() if i > floor
            }

    def add(self, t: float, count: float = 1.0) -> None:
        """Record ``count`` events at time ``t`` (explicit timestamp)."""
        if count <= 0:
            return
        idx = math.floor(t / self.width)
        self._counts[idx] = self._counts.get(idx, 0.0) + float(count)
        if self._max_idx is None or idx > self._max_idx:
            self._max_idx = idx
            self._prune()

    def count(self, now: float) -> float:
        """Events whose bucket starts inside ``(now - horizon, now]``."""
        lo = math.floor((now - self.horizon) / self.width)
        hi = math.floor(now / self.width)
        return sum(
            c for i, c in self._counts.items() if lo < i <= hi
        )

    def rate(self, now: float) -> float:
        """Events per second over the trailing window as of ``now``."""
        return self.count(now) / self.horizon

    def merge(self, other: "WindowedRate") -> None:
        """Fold ``other`` in (in place); windows must be congruent."""
        if (other.horizon, other.buckets) != (self.horizon, self.buckets):
            raise ValueError(
                f"cannot merge a {other.horizon}s/{other.buckets}-bucket "
                f"window into a {self.horizon}s/{self.buckets}-bucket one"
            )
        for idx, c in other._counts.items():
            self._counts[idx] = self._counts.get(idx, 0.0) + c
        if other._max_idx is not None and (
            self._max_idx is None or other._max_idx > self._max_idx
        ):
            self._max_idx = other._max_idx
        self._prune()


class WindowedHistogram:
    """A :class:`~repro_torch.obs.metrics.Histogram` per time bucket, queried over
    the trailing window — live p50/p99 without keeping samples."""

    __slots__ = ("horizon", "buckets", "width", "_hists", "_max_idx")

    def __init__(
        self,
        horizon: float = DEFAULT_HORIZON,
        *,
        buckets: int = DEFAULT_BUCKETS,
    ) -> None:
        self.width = _check_window(horizon, buckets)
        self.horizon = float(horizon)
        self.buckets = int(buckets)
        self._hists: dict[int, Histogram] = {}
        self._max_idx: int | None = None

    def _prune(self) -> None:
        if self._max_idx is None:
            return
        floor = self._max_idx - self.buckets
        if any(i <= floor for i in self._hists):
            self._hists = {
                i: h for i, h in self._hists.items() if i > floor
            }

    def observe(self, t: float, value: float, count: int = 1) -> None:
        """Record ``count`` observations of ``value`` at time ``t``."""
        if count <= 0:
            return
        idx = math.floor(t / self.width)
        hist = self._hists.get(idx)
        if hist is None:
            hist = self._hists[idx] = Histogram()
        hist.observe(value, count)
        if self._max_idx is None or idx > self._max_idx:
            self._max_idx = idx
            self._prune()

    def window(self, now: float) -> Histogram:
        """The trailing window as one merged cumulative histogram."""
        lo = math.floor((now - self.horizon) / self.width)
        hi = math.floor(now / self.width)
        out = Histogram()
        for idx in sorted(self._hists):
            if lo < idx <= hi:
                out.merge(self._hists[idx])
        return out

    def count(self, now: float) -> int:
        return self.window(now).count

    def quantile(self, now: float, q: float) -> float | None:
        """Windowed ``q``-quantile as of ``now`` (``None`` if empty)."""
        return self.window(now).quantile(q)

    def p99(self, now: float) -> float | None:
        return self.quantile(now, 0.99)

    def merge(self, other: "WindowedHistogram") -> None:
        """Fold ``other`` in (in place); windows must be congruent."""
        if (other.horizon, other.buckets) != (self.horizon, self.buckets):
            raise ValueError(
                f"cannot merge a {other.horizon}s/{other.buckets}-bucket "
                f"window into a {self.horizon}s/{self.buckets}-bucket one"
            )
        for idx, h in other._hists.items():
            mine = self._hists.get(idx)
            if mine is None:
                mine = self._hists[idx] = Histogram()
            mine.merge(h)
        if other._max_idx is not None and (
            self._max_idx is None or other._max_idx > self._max_idx
        ):
            self._max_idx = other._max_idx
        self._prune()
