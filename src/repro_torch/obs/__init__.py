"""Fleet telemetry: metrics, tracing, tenant SLOs, drift alarms
(DESIGN.md §12); the port's counterpart of ``repro.obs``, with the same
exports.

The observability substrate of the serving stack:

* :mod:`repro_torch.obs.metrics` — labelled counters/gauges/fixed-bucket
  histograms in a :class:`MetricsRegistry`; :class:`Ring` bounded
  windows for SLO percentiles;
* :mod:`repro_torch.obs.tracing` — span-based query-lifecycle tracing
  (admission → coalesce → launch → finalize → escalate/degrade);
* :mod:`repro_torch.obs.sinks` — JSONL / stdout push sinks, Prometheus text
  exposition and the ``/metrics`` snapshot endpoint (plus the
  ``/healthz`` verdict route);
* :mod:`repro_torch.obs.graph` — the graph X-ray: structural health probes
  (degrees, reciprocity, medoid reachability, BQ/f32 edge agreement)
  banded into a calibrated verdict, and the edge-triggered
  :class:`GraphHealthMonitor`;
* :mod:`repro_torch.obs.tenant` — token-bucket admission quotas and
  per-tenant SLO accounting (:class:`TenantLedger`);
* :mod:`repro_torch.obs.drift` — probe-drift alarms: the paper's
  green/amber/red boundary re-scored live under streaming churn;
* :mod:`repro_torch.obs.quality` — shadow ground-truth sampling: exact
  recall@k for a deterministic fraction of live traffic (DESIGN.md §14);
* :mod:`repro_torch.obs.remediate` — the closed loop: drift alarms and
  recall-SLO breaches walk an ordered remediation ladder;
* :mod:`repro_torch.obs.hub` — :class:`ObsHub` bundling the above,
  :class:`PeriodicReporter` push loop, env-driven ``autostart``.
"""

from repro_torch.obs.drift import BANDS, DriftAlarm, DriftMonitor
from repro_torch.obs.graph import (
    DEFAULT_GRAPH_THRESHOLDS,
    GraphHealthAlarm,
    GraphHealthMonitor,
    GraphHealthReport,
    GraphThresholds,
    graph_health_report,
)
from repro_torch.obs.hub import ObsHub, PeriodicReporter, autostart
from repro_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Ring,
    get_default_registry,
    latency_summary,
    reset_default_registry,
)
from repro_torch.obs.quality import (
    DEFAULT_RATE,
    ShadowSampler,
    shadow_hash,
    should_sample,
)
from repro_torch.obs.remediate import ACTIONS, RemediationPolicy
from repro_torch.obs.sinks import (
    JsonlSink,
    PrometheusServer,
    Sink,
    StdoutSink,
    health_snapshot,
    render_prometheus,
    sinks_from_env,
)
from repro_torch.obs.tenant import (
    DEFAULT_TENANT,
    TenantLedger,
    TenantQuota,
    TokenBucket,
)
from repro_torch.obs.tracing import Span, Tracer

__all__ = [
    "ACTIONS",
    "BANDS",
    "Counter",
    "DEFAULT_BUCKETS",
    "DEFAULT_GRAPH_THRESHOLDS",
    "DEFAULT_RATE",
    "DEFAULT_TENANT",
    "DriftAlarm",
    "DriftMonitor",
    "Gauge",
    "GraphHealthAlarm",
    "GraphHealthMonitor",
    "GraphHealthReport",
    "GraphThresholds",
    "Histogram",
    "JsonlSink",
    "MetricsRegistry",
    "ObsHub",
    "PeriodicReporter",
    "PrometheusServer",
    "RemediationPolicy",
    "Ring",
    "ShadowSampler",
    "Sink",
    "Span",
    "StdoutSink",
    "TenantLedger",
    "TenantQuota",
    "TokenBucket",
    "Tracer",
    "autostart",
    "get_default_registry",
    "graph_health_report",
    "health_snapshot",
    "latency_summary",
    "render_prometheus",
    "reset_default_registry",
    "shadow_hash",
    "should_sample",
    "sinks_from_env",
]
