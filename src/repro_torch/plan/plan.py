"""QueryPlan — a frozen, hashable spec of one search configuration.

Counterpart of ``repro/plan/plan.py``.  A search call's three decisions
(the nav-ladder rung with its ef/rerank schedule, the filter route, and
adaptive escalation) are frozen into one hashable :class:`QueryPlan`,
resolved once per request shape by
``repro_torch.plan.planner.resolve_plan``, so the set of programs a
process can run is the closed set of distinct plans
(``repro_torch.plan.cache.PlanCache`` builds each once).

Everything in a plan is static: nav kind, beam width, expansion, rerank
depth, route, whether a predicate mask rides the beam, and the escalation
schedule.  The per-request tensors (the entry point, the predicate mask,
the brute route's match set) live in the companion :class:`PlanContext`
and never key a program.

Derived stages are plans too: ``escalated()`` is the tight-margin second
stage (same program shape, ``escalate_mult``-times wider beam) and
``degraded()`` walks the deadline ladder (halve ef, floor at k); both land
back in the same closed plan set.
"""

from __future__ import annotations

import dataclasses

ROUTES = ("graph", "brute", "ivf")


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """One search configuration (see module docstring).

    ``ef`` is the *effective* beam width: the caller's ef after the
    NavPolicy ``ef_scale`` and — on the filtered graph route — the
    quantized selectivity widening, so equal plans really do share a
    program.  ``filtered`` marks whether a predicate mask rides the
    beam (a masked beam is a structurally different program than an
    unmasked one).  ``rerank`` means float32 cosine rerank (requires
    cold vectors; the planner clears it when they are absent).
    """

    nav: str
    k: int
    ef: int
    expand: int = 1
    rerank: bool = True
    route: str = "graph"            # "graph" | "brute" | "ivf"
    filtered: bool = False          # result_valid mask on the beam
    adaptive: bool = False          # tight-margin second stage enabled
    escalate_margin: float = 0.15
    escalate_mult: int = 4
    query_batch: int = 256          # chunk ceiling of the bucket ladder
    probes: int = 0                 # ivf route: top-p lists scanned

    def __post_init__(self):
        if self.route not in ROUTES:
            raise ValueError(f"route {self.route!r} not in {ROUTES}")
        if self.route == "graph":
            if self.ef < self.k:
                raise ValueError(
                    f"graph plan needs ef >= k, got ef={self.ef} k={self.k}"
                )
            if not 1 <= self.expand <= self.ef:
                raise ValueError(
                    f"expand must be in [1, ef], got {self.expand}"
                )
        if self.route == "ivf":
            if self.ef < self.k:
                raise ValueError(
                    f"ivf plan needs ef >= k, got ef={self.ef} k={self.k}"
                )
            if self.probes < 1:
                raise ValueError(
                    f"ivf plan needs probes >= 1, got {self.probes}"
                )
        if self.k < 1 or self.query_batch < 1 or self.escalate_mult < 1:
            raise ValueError("k / query_batch / escalate_mult must be >= 1")

    # -- derived stages ----------------------------------------------------

    def escalated(self) -> "QueryPlan":
        """Stage 2 of an adaptive plan: same program shape, wider pool,
        no further escalation.  The ivf route widens its list fan-in
        (``probes``) along with ef — starved pools escalate by scanning
        more lists, not just keeping more of the same candidates."""
        probes = self.probes
        if self.route == "ivf":
            probes = self.probes * self.escalate_mult
        return dataclasses.replace(
            self, ef=self.ef * self.escalate_mult, probes=probes,
            adaptive=False,
        )

    @property
    def min_ef(self) -> int:
        return max(self.k, self.expand)

    def can_degrade(self) -> bool:
        """Brute plans are already exact (ef plays no role) and plans at
        the ef floor have nothing left to give."""
        if self.route == "ivf":
            return self.ef // 2 >= self.min_ef or self.probes > 1
        return self.route == "graph" and self.ef // 2 >= self.min_ef

    def degraded(self) -> "QueryPlan":
        """One rung down the deadline ladder: halve the beam (floor at
        ``max(k, expand)``) and drop escalation — under deadline
        pressure the adaptive second stage is the first thing to go.
        Halving keeps the degraded plans inside a closed set (no new
        programs under load spikes).  The ivf route halves its
        probed lists in step (floor 1)."""
        if not self.can_degrade():
            return self
        probes = self.probes
        if self.route == "ivf":
            probes = max(1, self.probes // 2)
        return dataclasses.replace(
            self, ef=max(self.min_ef, self.ef // 2), probes=probes,
            adaptive=False,
        )

    def signature(self) -> str:
        """Short stable id for logs and trace-counter names."""
        bits = [self.nav, f"k{self.k}", f"ef{self.ef}", f"L{self.expand}",
                self.route]
        if self.route == "ivf":
            bits.append(f"p{self.probes}")
        if self.filtered:
            bits.append("masked")
        if self.rerank:
            bits.append("rr")
        if self.adaptive:
            bits.append(f"esc{self.escalate_mult}")
        return "-".join(bits)


@dataclasses.dataclass
class PlanContext:
    """The dynamic companions of a plan: per-request arrays that feed a
    program but never key one.

    ``start`` is the traversal entry point (global or per-label medoid);
    ``result_valid`` the predicate mask of a filtered graph or ivf plan,
    an ``(n,)`` bool tensor on the index's device;
    ``match_ids`` the materialized match set of a brute plan, a host int32
    array;
    ``selectivity`` the (exact-verified where brute) match fraction, for
    reporting.
    """

    start: int = 0
    result_valid: object | None = None     # (n,) bool tensor, on device
    match_ids: object | None = None        # (M,) int32 host match set
    selectivity: float | None = None
