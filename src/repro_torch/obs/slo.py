"""Per-tenant SLO specs, burn rates, and deterministic breach events.

The control-plane half of the performance observatory: a tenant (or a
whole fleet) declares targets — "p99 queue delay under 2ms", "at least
50k pps" — and a :class:`SloTracker` turns the live windowed metrics
(``repro_torch.obs.windows``) into **burn rates** and **breach events** the
scheduler / serving layer can expose (``MultiTenantTelemetry``,
``FleetEngine.health()``) and eventually act on.

Burn rate follows the SRE convention: how fast the error budget is being
consumed, normalised so ``1.0`` means "spending budget exactly as fast as
the SLO allows" and anything above is a breach-in-progress.

* **queue delay** — the target is a p99, so the allowed bad fraction is
  ``budget_fraction`` (default 1%).  The tracker keeps an *exact* count of
  windowed observations over the target (a paired :class:`WindowedRate`,
  not a bucket estimate), and
  ``burn = (bad / total) / budget_fraction`` — e.g. 5% of packets over
  target burns at 5.0x.
* **throughput** — the target is a floor, so the bad fraction is the
  windowed shortfall ``max(0, 1 - pps / min_pps)`` and
  ``burn = shortfall / budget_fraction`` — e.g. running at half the floor
  burns at 50x.

Determinism: every observation and every :meth:`SloTracker.update` takes
an **explicit timestamp** (the ``windows`` contract), so given the same
observations and the same update times, the status and the full breach
event sequence are bit-identical — regardless of how the observations
were chunked between updates, and across process restarts that replay the
same time axis.  Breach events fire exactly on ok -> breaching
transitions per objective (and recovery re-arms them), so an event list
is a deterministic function of (observations, update times).

Burn rates are ``None`` until the first relevant observation arrives —
an idle tracker is "no data", not "breaching".
"""
from __future__ import annotations

import dataclasses

from repro_torch.obs.windows import (
    DEFAULT_BUCKETS,
    WindowedHistogram,
    WindowedRate,
)

__all__ = [
    "BreachEvent",
    "SloSpec",
    "SloStatus",
    "SloTracker",
]

QUEUE_DELAY = "queue_delay"
THROUGHPUT = "throughput"


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """A tenant's service-level objectives over a trailing window."""

    tenant: str
    p99_queue_delay_s: float | None = None  # delay target (p99, seconds)
    min_pps: float | None = None            # throughput floor (packets/s)
    window_s: float = 10.0                  # trailing window the SLO is judged over
    budget_fraction: float = 0.01           # allowed bad fraction (1% for a p99)

    def __post_init__(self) -> None:
        if self.p99_queue_delay_s is None and self.min_pps is None:
            raise ValueError(
                f"SLO for {self.tenant!r} needs at least one target "
                "(p99_queue_delay_s and/or min_pps)"
            )
        if self.p99_queue_delay_s is not None and self.p99_queue_delay_s <= 0:
            raise ValueError("p99_queue_delay_s must be > 0")
        if self.min_pps is not None and self.min_pps <= 0:
            raise ValueError("min_pps must be > 0")
        if self.window_s <= 0:
            raise ValueError("window_s must be > 0")
        if not 0.0 < self.budget_fraction <= 1.0:
            raise ValueError("budget_fraction must be in (0, 1]")


@dataclasses.dataclass(frozen=True)
class BreachEvent:
    """One ok -> breaching transition for one objective."""

    tenant: str
    objective: str           # QUEUE_DELAY | THROUGHPUT
    t: float                 # update timestamp the breach was detected at
    burn_rate: float         # budget burn at detection (> 1.0 by definition)
    value: float             # measured windowed value (p99 delay / pps)
    target: float            # the spec's target it crossed


@dataclasses.dataclass(frozen=True)
class SloStatus:
    """One tenant's SLO posture as of an explicit ``now``."""

    tenant: str
    now: float
    window_s: float
    p99_queue_delay_s: float | None      # measured, windowed
    delay_target_s: float | None
    delay_burn_rate: float | None        # None until first delay observation
    pps: float | None                    # measured, windowed
    min_pps: float | None
    pps_burn_rate: float | None          # None until first packet observation

    @property
    def breached(self) -> bool:
        return any(
            b is not None and b > 1.0
            for b in (self.delay_burn_rate, self.pps_burn_rate)
        )


class SloTracker:
    """Feed windowed observations, read burn rates, collect breach events.

    All methods take explicit timestamps; the tracker never reads a clock
    (see module docstring for the determinism contract this buys).
    """

    def __init__(self, spec: SloSpec, *, buckets: int = DEFAULT_BUCKETS):
        self.spec = spec
        self._delay = WindowedHistogram(spec.window_s, buckets=buckets)
        self._delay_total = WindowedRate(spec.window_s, buckets=buckets)
        self._delay_bad = WindowedRate(spec.window_s, buckets=buckets)
        self._packets = WindowedRate(spec.window_s, buckets=buckets)
        self._saw_delay = False
        self._saw_packets = False
        self._breaching: dict[str, bool] = {QUEUE_DELAY: False, THROUGHPUT: False}
        self.events: list[BreachEvent] = []

    # -- observations --------------------------------------------------------

    def observe_queue_delay(self, t: float, delay_s: float, count: int = 1) -> None:
        """``count`` packets experienced ``delay_s`` of queueing at time ``t``."""
        if count <= 0:
            return
        self._saw_delay = True
        self._delay.observe(t, delay_s, count)
        self._delay_total.add(t, count)
        if (
            self.spec.p99_queue_delay_s is not None
            and delay_s > self.spec.p99_queue_delay_s
        ):
            self._delay_bad.add(t, count)

    def observe_packets(self, t: float, count: float) -> None:
        """``count`` packets served at time ``t`` (feeds the windowed pps)."""
        if count <= 0:
            return
        self._saw_packets = True
        self._packets.add(t, count)

    # -- status / events -----------------------------------------------------

    def status(self, now: float) -> SloStatus:
        """The SLO posture over the trailing window ending at ``now``."""
        spec = self.spec
        delay_burn = None
        p99 = None
        if self._saw_delay:
            p99 = self._delay.p99(now)
            if spec.p99_queue_delay_s is not None:
                total = self._delay_total.count(now)
                bad = self._delay_bad.count(now)
                frac = (bad / total) if total > 0 else 0.0
                delay_burn = frac / spec.budget_fraction
        pps = self._packets.rate(now) if self._saw_packets else None
        pps_burn = None
        if self._saw_packets and spec.min_pps is not None:
            shortfall = max(0.0, 1.0 - pps / spec.min_pps)
            pps_burn = shortfall / spec.budget_fraction
        return SloStatus(
            tenant=spec.tenant,
            now=now,
            window_s=spec.window_s,
            p99_queue_delay_s=p99,
            delay_target_s=spec.p99_queue_delay_s,
            delay_burn_rate=delay_burn,
            pps=pps,
            min_pps=spec.min_pps,
            pps_burn_rate=pps_burn,
        )

    def update(self, now: float) -> list[BreachEvent]:
        """Evaluate both objectives at ``now``; emit (and return) an event
        per objective that just transitioned ok -> breaching."""
        st = self.status(now)
        fresh: list[BreachEvent] = []
        checks = (
            (QUEUE_DELAY, st.delay_burn_rate, st.p99_queue_delay_s,
             self.spec.p99_queue_delay_s),
            (THROUGHPUT, st.pps_burn_rate, st.pps, self.spec.min_pps),
        )
        for objective, burn, value, target in checks:
            breaching = burn is not None and burn > 1.0
            if breaching and not self._breaching[objective]:
                fresh.append(
                    BreachEvent(
                        tenant=self.spec.tenant,
                        objective=objective,
                        t=now,
                        burn_rate=burn,
                        value=value if value is not None else 0.0,
                        target=target if target is not None else 0.0,
                    )
                )
            self._breaching[objective] = breaching
        self.events.extend(fresh)
        return fresh
