"""Probe-drift alarms: the applicability boundary as a live monitor.

``build(nav="auto")`` decides the nav ladder once, from a probe of the
corpus *at build time* (DESIGN.md §10).  Under streaming churn that
verdict rots: a tenant that starts green (contrastive embeddings) and
gradually ingests sign-collapsed rows (SIFT-like CV features) slides
across the paper's boundary while the index keeps navigating in bq2 —
exactly the silent-recall-collapse failure mode the paper's Table 7
warns about.  The :class:`ProbeAccumulator` already maintains the
exact live-set bit-plane entropies under insert/delete, so re-scoring
them against the calibrated :class:`~repro_torch.probe.report.Thresholds`
is free — a :class:`DriftMonitor` does that after every mutation batch and
raises a :class:`DriftAlarm` through the metrics layer whenever the
live corpus crosses a band.

Bands from signature statistics alone (the cheap, every-mutation path):

* ``red``   — ``sign_entropy < thresholds.sign_entropy_red`` (0.2):
  the sign plane is collapsing; BQ navigation is unsafe *now*;
* ``amber`` — entropy under ``amber_scale`` x the red line: drifting
  toward the boundary, re-probe with samples before it is too late;
* ``green`` — the bit planes carry full entropy.

The full sampled verdict (cosine spread, BQ-vs-float32 agreement) is
still authoritative; :meth:`DriftMonitor.check_report` re-scores one
(e.g. from ``MutableQuIVerIndex.probe_report()``) through the same
alarm path at phase boundaries, where the sampled probes are worth
their cost.

The port's own copy of ``repro/obs/drift.py`` (host-only: numpy and the
stdlib), over the port's metrics registry and probe thresholds.
"""

from __future__ import annotations

import collections
import dataclasses
import time

from repro_torch.obs.metrics import MetricsRegistry, get_default_registry
from repro_torch.probe.report import DEFAULT_THRESHOLDS, Thresholds

BANDS = ("green", "amber", "red")
_BAND_CODE = {b: i for i, b in enumerate(BANDS)}


@dataclasses.dataclass(frozen=True)
class DriftAlarm:
    """One band-crossing event (worsening only; recoveries are recorded
    as events but never alarm)."""

    tenant: str
    prev_band: str
    band: str
    stat: str                 # which statistic tripped the band
    value: float
    threshold: float
    n_live: int
    unix_ts: float

    def message(self) -> str:
        return (
            f"[drift] tenant={self.tenant} {self.prev_band}->{self.band} "
            f"{self.stat}={self.value:.3f} (threshold {self.threshold:g},"
            f" n_live={self.n_live})"
        )


class DriftMonitor:
    """Re-score incremental probe stats against the calibrated bands.

    ``acc`` is anything with ``sign_entropy`` / ``strong_entropy`` / ``n``
    (a :class:`~repro_torch.probe.incremental.ProbeAccumulator`; a mutable
    index passes its own).  ``min_n`` suppresses banding noise on tiny
    live sets — a two-row corpus has degenerate entropy and no verdict.

    Attach to a mutable index (``index.attach_drift_monitor(...)``) and
    the index calls :meth:`check` after every insert/delete/consolidate
    batch; or drive it manually from any churn loop.
    """

    def __init__(
        self,
        acc,
        *,
        tenant: str = "default",
        thresholds: Thresholds = DEFAULT_THRESHOLDS,
        amber_scale: float = 2.0,
        min_n: int = 64,
        registry: MetricsRegistry | None = None,
        max_events: int = 256,
        clock=time.time,
    ):
        self.acc = acc
        self.tenant = tenant
        self.thresholds = thresholds
        self.amber_scale = float(amber_scale)
        self.min_n = int(min_n)
        self.clock = clock
        self.band = None                  # unknown until first check()
        self.alarms: list[DriftAlarm] = []
        self.events = collections.deque(maxlen=max_events)
        self._subs: list = []
        reg = registry if registry is not None else get_default_registry()
        self._c_alarms = reg.counter(
            "quiver_drift_alarms_total",
            "probe-drift band-crossing alarms",
            labels=("tenant", "band"),
        )
        self._g_entropy = reg.gauge(
            "quiver_drift_sign_entropy",
            "live-set sign-plane entropy (bits)", labels=("tenant",),
        )
        self._g_band = reg.gauge(
            "quiver_drift_band",
            "live-set drift band (0=green 1=amber 2=red)",
            labels=("tenant",),
        )

    def subscribe(self, fn) -> None:
        """Register ``fn(alarm)`` to fire on every raised
        :class:`DriftAlarm` (band worsenings only, same events that land
        in ``self.alarms``): the hook a closed-loop remediation policy
        attaches to."""
        self._subs.append(fn)

    def _raise(self, event: DriftAlarm) -> DriftAlarm:
        self.alarms.append(event)
        self._c_alarms.inc(tenant=self.tenant, band=event.band)
        for fn in list(self._subs):
            fn(event)
        return event

    # -- banding -----------------------------------------------------------

    def score(self) -> tuple[str, str, float, float]:
        """(band, tripping stat, value, threshold) from the accumulator's
        exact entropies (signature-only: green here means "bit planes
        healthy", not the full sampled-agreement green)."""
        e = float(self.acc.sign_entropy)
        red = self.thresholds.sign_entropy_red
        if e < red:
            return "red", "sign_entropy", e, red
        if e < self.amber_scale * red:
            return "amber", "sign_entropy", e, self.amber_scale * red
        return "green", "sign_entropy", e, self.amber_scale * red

    def check(self) -> DriftAlarm | None:
        """Re-score; on a band *worsening* raise (return + record) an
        alarm.  Improvements update state silently (logged as events)."""
        if getattr(self.acc, "n", 0) < self.min_n:
            return None
        band, stat, value, threshold = self.score()
        self._g_entropy.set(value, tenant=self.tenant)
        self._g_band.set(_BAND_CODE[band], tenant=self.tenant)
        prev, self.band = self.band, band
        if prev is None:
            # arming the monitor asserts a healthy baseline (the index
            # was built/adopted under an acceptable verdict), so a first
            # scoring that is already amber/red must alarm
            prev = "green"
        if band == prev:
            return None
        event = DriftAlarm(
            tenant=self.tenant, prev_band=prev, band=band, stat=stat,
            value=value, threshold=threshold,
            n_live=int(getattr(self.acc, "n", 0)),
            unix_ts=self.clock(),
        )
        self.events.append(event)
        if _BAND_CODE[band] > _BAND_CODE[prev]:
            return self._raise(event)
        return None

    def check_report(self, report) -> DriftAlarm | None:
        """Score a full sampled :class:`CompatibilityReport` verdict
        through the same alarm path (phase-boundary re-probe: the
        sampled agreement stats catch drift the bit planes cannot)."""
        band = report.verdict
        self._g_band.set(_BAND_CODE[band], tenant=self.tenant)
        prev, self.band = self.band, band
        if prev is None:
            prev = "green"              # same baseline rule as check()
        if band == prev:
            return None
        event = DriftAlarm(
            tenant=self.tenant, prev_band=prev, band=band,
            stat="verdict", value=float(_BAND_CODE[band]),
            threshold=float(_BAND_CODE["amber"]),
            n_live=int(getattr(self.acc, "n", 0)),
            unix_ts=self.clock(),
        )
        self.events.append(event)
        if _BAND_CODE[band] > _BAND_CODE[prev]:
            return self._raise(event)
        return None

    def report(self) -> dict:
        return {
            "tenant": self.tenant,
            "band": self.band,
            "n_live": int(getattr(self.acc, "n", 0)),
            "sign_entropy": float(self.acc.sign_entropy),
            "strong_entropy": float(self.acc.strong_entropy),
            "alarms": len(self.alarms),
            "events": [dataclasses.asdict(e) for e in self.events],
        }
