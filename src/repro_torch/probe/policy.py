"""NavPolicy — the auto-selection ladder and ef/rerank schedule.

Counterpart of ``repro/probe/policy.py`` (numpy only; the port keeps its
own copy).

``select_policy`` maps a :class:`~repro_torch.probe.report.CompatibilityReport`
verdict to a navigation policy on the ladder **bq2 → adc → float32**
(decreasing compression, increasing metric fidelity):

* **green** — BQ-native topology is safe: navigate in ``bq2`` at the
  caller's ef.  The paper's headline configuration.
* **amber** — BQ ranks the sample imperfectly: keep the compact ``bq2``
  hot path but double the beam (rerank pool = beam width, so this *is*
  the rerank-depth schedule) and turn on per-query adaptive escalation
  (``repro_torch.core.beam.beam_margin``): queries whose top-k BQ margins are
  tight re-run with an ``escalate_mult``-times wider pool.
* **red** — BQ-native navigation would collapse (<15% recall in the
  paper's Table 7): route off the BQ rung entirely — ``float32``
  navigation when cold vectors exist, else ``adc`` (decoded-levels
  asymmetric distance, the best signature-only rung) with aggressive
  widening.  Red-zone policies trade throughput for a recall floor;
  the point of the probe is that the caller learns this *before*
  serving garbage.

The policy is a frozen dataclass persisted inside every index archive
(``policy_*`` npz fields) so a loaded index keeps serving exactly the
schedule it was built under.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.probe.report import CompatibilityReport

# the auto-selection ladder, most to least compressed.  "ivf" is the
# coarse-list sibling of the bq2 rung (DESIGN.md §13): same signature
# space and fidelity, flat top-p list scan instead of graph traversal —
# eligible only when the index carries a partition (``have_ivf``).
NAV_LADDER = ("bq2", "ivf", "adc", "float32")


@dataclasses.dataclass(frozen=True)
class NavPolicy:
    """Navigation policy: nav kind + ef/rerank schedule.

    ``ef_scale`` multiplies the caller's ``ef`` before the beam runs
    (the rerank pool is the beam, so this is also the rerank depth).
    ``adaptive`` enables per-query escalation: queries whose top-k
    margin (``beam_margin``) falls below ``escalate_margin`` re-run
    with ``ef * ef_scale * escalate_mult``.
    """

    nav: str                       # rung of NAV_LADDER
    ef_scale: int = 1              # static beam/rerank-depth multiplier
    adaptive: bool = False         # per-query escalation on tight margins
    escalate_margin: float = 0.15  # beam_margin below this escalates
    escalate_mult: int = 4         # escalated-pass ef multiplier
    source: str = "manual"         # "probe" when chosen by auto-selection

    def __post_init__(self):
        if self.nav not in NAV_LADDER:
            raise ValueError(
                f"nav {self.nav!r} not on the ladder {NAV_LADDER}"
            )
        if self.ef_scale < 1 or self.escalate_mult < 1:
            raise ValueError("ef_scale / escalate_mult must be >= 1")

    def describe(self) -> str:
        extra = " +adaptive" if self.adaptive else ""
        return f"{self.nav} x{self.ef_scale}{extra} ({self.source})"

    # -- persistence (merged into index npz archives) ----------------------

    def to_npz_fields(self, prefix: str = "policy_") -> dict:
        return {
            prefix + "nav": np.array(self.nav),
            prefix + "ef_scale": np.int64(self.ef_scale),
            prefix + "adaptive": np.int64(self.adaptive),
            prefix + "escalate_margin": np.float64(self.escalate_margin),
            prefix + "escalate_mult": np.int64(self.escalate_mult),
            prefix + "source": np.array(self.source),
        }

    @classmethod
    def from_npz(cls, z, prefix: str = "policy_"):
        """Rebuild from an index archive; None when it carries none."""
        if prefix + "nav" not in z:
            return None
        return cls(
            nav=str(z[prefix + "nav"]),
            ef_scale=int(z[prefix + "ef_scale"][()]),
            adaptive=bool(z[prefix + "adaptive"][()]),
            escalate_margin=float(z[prefix + "escalate_margin"][()]),
            escalate_mult=int(z[prefix + "escalate_mult"][()]),
            source=str(z[prefix + "source"]),
        )


def resolve_schedule(
    policy: NavPolicy | None,
    nav: str | None,
    ef: int,
    adaptive: bool | None,
) -> tuple[int, bool, NavPolicy]:
    """Resolve a search call's effective (ef, adaptive, schedule).

    The one owner of the policy-application rule every search surface
    shares: an index's auto-selected schedule applies only when the
    caller navigates on the index's own default (``nav is None``) —
    forcing ``nav=`` overrides it; ``adaptive=None`` defers to the
    policy.  The returned schedule always carries usable escalation
    constants (defaults when the index has no policy).
    """
    sched = policy if nav is None else None
    if sched is not None:
        ef = ef * sched.ef_scale
    if adaptive is None:
        adaptive = sched.adaptive if sched is not None else False
    return ef, adaptive, (sched if sched is not None else NavPolicy("bq2"))


def select_policy(
    report: CompatibilityReport, *, have_vectors: bool = True,
    have_ivf: bool = False,
) -> NavPolicy:
    """Map a probe verdict to a rung of the ladder + schedule.

    ``have_vectors=False`` (vector-free index) removes the float32 rung:
    red-zone data then routes to ``adc`` with the widest schedule — the
    honest best-effort, still far better than collapsed ``bq2``.

    ``have_ivf=True`` (the index carries a coarse partition, i.e. it was
    built with ``ivf_candidates``) makes the ``ivf`` family the green
    default *when the probe also measures strong coarse cluster
    structure* (``cluster_concentration >= thresholds.cluster_strong``):
    on clustered green corpora the flat top-p list scan matches graph
    recall at the same signature fidelity with no traversal, and
    escalation widens ``probes`` instead of ef.  A green corpus without
    list-level concentration keeps the graph — its neighborhoods don't
    align with any coarse partition, so list scans would need probes ~L
    to match recall.  Amber/red verdicts never select ivf — a
    quantization-stressed corpus needs the graph's adaptive widening or
    an off-BQ rung, not a coarser candidate stage.
    """
    verdict = report.verdict
    # corpus-calibrated escalation threshold: serve-time queries whose
    # k-th-candidate margin falls below the probe sample's 30th
    # percentile are in their own corpus's low-margin tail
    margin = report.margin_p30
    if not (margin == margin):            # NaN: signature-only probe
        margin = NavPolicy(nav="bq2").escalate_margin
    if verdict == "green":
        # NaN concentration (report predates the statistic, e.g. loaded
        # from an old archive) keeps the pre-gate behavior: a green
        # verdict already implies usable neighborhood structure
        cluster = report.cluster_concentration
        clustered = not (cluster == cluster) \
            or cluster >= report.thresholds.cluster_strong
        if have_ivf and clustered:
            return NavPolicy(nav="ivf", source="probe")
        return NavPolicy(nav="bq2", source="probe")
    if verdict == "amber":
        return NavPolicy(
            nav="bq2", ef_scale=2, adaptive=True,
            escalate_margin=margin, source="probe",
        )
    if have_vectors:
        return NavPolicy(nav="float32", ef_scale=4, source="probe")
    return NavPolicy(
        nav="adc", ef_scale=4, adaptive=True,
        escalate_margin=margin, source="probe",
    )
