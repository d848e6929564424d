"""Per-tenant SLO accounting and token-bucket admission quotas.

Multi-tenant serving needs two things the engine could not answer
before: *enforcement* (a tenant may not buy more than its share of the
fleet) and *attribution* (whose requests degraded, whose dropped, whose
p99 blew the SLO).  A :class:`TenantLedger` owns both:

* **quota** — one :class:`TokenBucket` per tenant (``qps`` refill rate,
  ``burst`` capacity, cost = queries in the request).  Buckets are
  independent, so an over-budget tenant exhausts only its own tokens:
  rejecting it cannot starve anyone else — isolation is structural, not
  scheduled.  Tenants without a quota are never rejected.
* **accounting** — per-tenant counters (submitted/admitted/rejected/
  done/dropped/degraded, queries), a latency :class:`Ring` for window
  p50/p99, and the audit trail the multitenant benchmark checks:
  ``quota_violations`` counts admissions that went through on an empty
  bucket, which the ledger's own ``admit`` makes impossible — a nonzero
  value means some path bypassed admission.

The ledger is clock-injected (same convention as ``QueryEngine``) so
quota refill is testable without sleeping.
"""

from __future__ import annotations

import dataclasses
import time

from repro_torch.obs.metrics import MetricsRegistry, Ring, latency_summary

DEFAULT_TENANT = "default"

# per-stat navigation-trace window (hops/evals/descent/... per tenant);
# smaller than the latency window — nav traces are per *query*, not per
# request, and the report only needs a current-behaviour p50
NAV_WINDOW = 512


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Admission budget: sustained ``qps`` with ``burst`` headroom, plus
    an optional quality floor — the rolling shadow-recall p50 the tenant
    was promised (DESIGN.md §14).  Unlike qps, the recall SLO is not
    enforced at admission (a query can't be rejected for future recall);
    breaches are *events* the remediation policy subscribes to."""

    qps: float
    burst: float | None = None       # default: 2 * qps (min 1)
    recall_slo: float | None = None  # rolling recall@k p50 floor

    def capacity(self) -> float:
        if self.burst is not None:
            return float(self.burst)
        return max(2.0 * self.qps, 1.0)


class TokenBucket:
    """Classic token bucket: refills at ``qps``, caps at ``capacity``."""

    __slots__ = ("rate", "capacity", "tokens", "stamp")

    def __init__(self, quota: TenantQuota, now: float):
        self.rate = float(quota.qps)
        self.capacity = quota.capacity()
        self.tokens = self.capacity      # full burst on arrival
        self.stamp = now

    def refill(self, now: float) -> None:
        dt = max(now - self.stamp, 0.0)
        self.tokens = min(self.capacity, self.tokens + dt * self.rate)
        self.stamp = now

    def take(self, cost: float, now: float) -> bool:
        self.refill(now)
        if self.tokens >= cost:
            self.tokens -= cost
            return True
        return False


@dataclasses.dataclass
class TenantStats:
    submitted: int = 0
    admitted: int = 0
    rejected: int = 0
    done: int = 0
    dropped: int = 0
    degraded: int = 0
    queries: int = 0                 # admitted queries
    rejected_queries: int = 0
    latencies: Ring = None           # set by the ledger (window-sized)
    recalls: Ring = None             # shadow recall@k window (ledger-set)
    nav: dict = None                 # {stat: Ring} beam nav counters
    recall_breaches: int = 0         # breached-state entries (not samples)
    recall_breached: bool = False    # currently below the recall SLO


class TenantLedger:
    """Quota enforcement + per-tenant serving accounts (see module
    docstring).  One per :class:`~repro_torch.serve.engine.QueryEngine`."""

    def __init__(
        self,
        *,
        registry: MetricsRegistry | None = None,
        latency_window: int = 1024,
        recall_window: int = 256,
        recall_min_samples: int = 16,
        clock=time.monotonic,
    ):
        self.clock = clock
        self.latency_window = int(latency_window)
        self.recall_window = int(recall_window)
        # breach evaluation needs a minimally credible window: a single
        # unlucky shadow sample must not page anyone
        self.recall_min_samples = int(recall_min_samples)
        self._quotas: dict[str, TenantQuota] = {}
        self._buckets: dict[str, TokenBucket] = {}
        self._stats: dict[str, TenantStats] = {}
        self._breach_subs: list = []
        self.quota_violations = 0
        self._reg = registry
        if registry is not None:
            self._c_requests = registry.counter(
                "quiver_tenant_requests_total",
                "requests submitted per tenant and admission outcome",
                labels=("tenant", "outcome"),
            )
            self._c_queries = registry.counter(
                "quiver_tenant_queries_total",
                "admitted queries per tenant", labels=("tenant",),
            )
            self._h_latency = registry.histogram(
                "quiver_tenant_latency_seconds",
                "request latency per tenant", labels=("tenant",),
                window=latency_window,
            )
            self._g_tokens = registry.gauge(
                "quiver_tenant_quota_tokens",
                "remaining admission tokens", labels=("tenant",),
            )
            self._h_recall = registry.histogram(
                "quiver_tenant_recall",
                "shadow-sampled recall@k per tenant", labels=("tenant",),
                buckets=(0.1, 0.25, 0.5, 0.7, 0.8, 0.9, 0.95, 0.99, 1.0),
                window=recall_window,
            )
            self._c_breaches = registry.counter(
                "quiver_recall_slo_breaches_total",
                "recall-SLO breached-state entries", labels=("tenant",),
            )

    # -- quota -------------------------------------------------------------

    def set_quota(self, tenant: str, qps: float,
                  burst: float | None = None,
                  recall_slo: float | None = None) -> TenantQuota:
        q = TenantQuota(qps=qps, burst=burst, recall_slo=recall_slo)
        self._quotas[tenant] = q
        self._buckets[tenant] = TokenBucket(q, self.clock())
        return q

    def quota(self, tenant: str) -> TenantQuota | None:
        return self._quotas.get(tenant)

    def stats(self, tenant: str) -> TenantStats:
        s = self._stats.get(tenant)
        if s is None:
            s = self._stats[tenant] = TenantStats(
                latencies=Ring(self.latency_window),
                recalls=Ring(self.recall_window),
                nav={},
            )
        return s

    def admit(self, tenant: str, n_queries: int,
              now: float | None = None) -> bool:
        """Charge ``n_queries`` against the tenant's bucket; False means
        the request must be rejected (quota exhausted).  Tenants with no
        quota are always admitted."""
        now = self.clock() if now is None else now
        s = self.stats(tenant)
        s.submitted += 1
        bucket = self._buckets.get(tenant)
        ok = True if bucket is None else bucket.take(n_queries, now)
        if ok:
            s.admitted += 1
            s.queries += n_queries
            if bucket is not None and bucket.tokens < 0:
                # structurally unreachable through take(); a nonzero
                # count means an admission path bypassed the bucket
                self.quota_violations += 1
        else:
            s.rejected += 1
            s.rejected_queries += n_queries
        if self._reg is not None:
            self._c_requests.inc(
                tenant=tenant, outcome="admitted" if ok else "rejected"
            )
            if ok:
                self._c_queries.inc(n_queries, tenant=tenant)
            if bucket is not None:
                self._g_tokens.set(bucket.tokens, tenant=tenant)
        return ok

    # -- attribution -------------------------------------------------------

    def observe(self, tenant: str, *, status: str,
                latency: float | None = None,
                degraded: bool = False) -> None:
        """Account one finished request (``done`` | ``dropped``)."""
        s = self.stats(tenant)
        if status == "done":
            s.done += 1
        elif status == "dropped":
            s.dropped += 1
        else:
            raise ValueError(f"unknown terminal status {status!r}")
        if degraded:
            s.degraded += 1
        if latency is not None:
            s.latencies.append(latency)
            if self._reg is not None:
                self._h_latency.observe(latency, tenant=tenant)

    def observe_nav(self, tenant: str, traces: dict) -> None:
        """Account one request's navigation counters: ``traces`` maps a
        stat name (``hops``/``evals``/``descent``/...) to that tenant's
        per-query values from the finalized batch.  Each stat rides its
        own bounded Ring so the report shows *current* navigation
        behaviour — a tenant whose hops p50 climbs while recall still
        holds is walking a degrading graph (DESIGN.md §15)."""
        s = self.stats(tenant)
        for stat, vals in traces.items():
            ring = s.nav.get(stat)
            if ring is None:
                ring = s.nav[stat] = Ring(NAV_WINDOW)
            ring.extend(vals)

    # -- recall SLO --------------------------------------------------------

    def subscribe(self, fn) -> None:
        """Register ``fn(event_dict)`` for recall-SLO breach events.
        Fired once per breached-state *entry* (edge-triggered, like the
        drift monitor's band crossings), not once per bad sample."""
        self._breach_subs.append(fn)

    def recall_breached(self, tenant: str) -> bool:
        return self.stats(tenant).recall_breached

    def observe_recall(self, tenant: str, recall: float) -> bool:
        """Account one shadow-sampled recall@k measurement.

        Appends to the tenant's rolling window, re-evaluates the recall
        SLO over it, and returns whether the tenant is currently in
        breach.  State transitions into breach increment the breach
        counter and notify subscribers; recovery (window p50 back above
        the floor) silently clears the flag so the next degradation
        alarms again.
        """
        s = self.stats(tenant)
        s.recalls.append(float(recall))
        if self._reg is not None:
            self._h_recall.observe(float(recall), tenant=tenant)
        q = self._quotas.get(tenant)
        if q is None or q.recall_slo is None:
            return False
        if len(s.recalls) < self.recall_min_samples:
            return s.recall_breached
        p50 = s.recalls.percentile(50)
        if p50 < q.recall_slo:
            if not s.recall_breached:
                s.recall_breached = True
                s.recall_breaches += 1
                if self._reg is not None:
                    self._c_breaches.inc(tenant=tenant)
                event = {
                    "kind": "recall_slo", "tenant": tenant,
                    "recall_p50": float(p50),
                    "recall_slo": float(q.recall_slo),
                    "window": len(s.recalls),
                }
                for fn in list(self._breach_subs):
                    fn(event)
        else:
            s.recall_breached = False
        return s.recall_breached

    # -- reporting ---------------------------------------------------------

    def tenants(self) -> list[str]:
        return sorted(set(self._stats) | set(self._quotas))

    def report(self) -> dict:
        """Per-tenant SLO account: counters, window percentiles, quota
        state, plus the fleet-wide ``quota_violations`` audit."""
        out = {"quota_violations": self.quota_violations, "tenants": {}}
        for t in self.tenants():
            s = self.stats(t)
            q = self._quotas.get(t)
            lat = s.latencies
            out["tenants"][t] = {
                "submitted": s.submitted,
                "admitted": s.admitted,
                "rejected": s.rejected,
                "done": s.done,
                "dropped": s.dropped,
                "degraded": s.degraded,
                "queries": s.queries,
                "rejected_queries": s.rejected_queries,
                **latency_summary(lat),
                "quota_qps": q.qps if q else None,
                "quota_burst": q.capacity() if q else None,
                "recall_p50": (
                    round(s.recalls.percentile(50), 4)
                    if s.recalls is not None and len(s.recalls) else None
                ),
                "recall_n": (
                    len(s.recalls) if s.recalls is not None else 0
                ),
                "recall_slo": (
                    q.recall_slo if q is not None else None
                ),
                "recall_breaches": s.recall_breaches,
                "recall_breached": s.recall_breached,
                "nav": {
                    stat: {"p50": round(r.percentile(50), 3),
                           "n": len(r)}
                    for stat, r in sorted((s.nav or {}).items())
                    if len(r)
                },
            }
        return out
