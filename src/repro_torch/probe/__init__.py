"""Applicability-boundary probe, in torch (counterpart of ``repro.probe``).

Training-free compatibility diagnostics, auto metric selection, and the
adaptive-rerank schedule — the paper's Table-7 boundary as a runtime
component:

* :func:`probe_corpus` / :func:`probe_signatures` — sampled statistics ->
  :class:`CompatibilityReport` (green/amber/red);
* :func:`select_policy` -> :class:`NavPolicy` — the bq2 → adc → float32
  ladder plus ef/rerank-depth schedule behind ``build(nav="auto")``;
* :class:`ProbeAccumulator` — exact live-set bit statistics maintained
  incrementally;
* :func:`merge_reports` — fleet-wide report from per-shard reports.
"""

from repro_torch.probe.diagnostics import (
    DEFAULT_CLUSTER_M,
    DEFAULT_K,
    DEFAULT_QUERIES,
    DEFAULT_SAMPLE,
    binary_entropy,
    entropy_from_counts,
    probe_corpus,
    probe_signatures,
    report_from_accumulator,
)
from repro_torch.probe.incremental import ProbeAccumulator
from repro_torch.probe.policy import (
    NAV_LADDER,
    NavPolicy,
    resolve_schedule,
    select_policy,
)
from repro_torch.probe.report import (
    DEFAULT_THRESHOLDS,
    VERDICTS,
    CompatibilityReport,
    Thresholds,
    merge_reports,
)

__all__ = [
    "CompatibilityReport",
    "DEFAULT_CLUSTER_M",
    "DEFAULT_K",
    "DEFAULT_QUERIES",
    "DEFAULT_SAMPLE",
    "DEFAULT_THRESHOLDS",
    "NAV_LADDER",
    "NavPolicy",
    "ProbeAccumulator",
    "Thresholds",
    "VERDICTS",
    "binary_entropy",
    "entropy_from_counts",
    "merge_reports",
    "probe_corpus",
    "probe_signatures",
    "report_from_accumulator",
    "resolve_schedule",
    "select_policy",
]
