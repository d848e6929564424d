"""Query plans.

Counterpart of ``repro/plan``.  The serving stack's three per-request
decision points (nav ladder, filter routing, adaptive escalation) collapse
into one resolved :class:`QueryPlan`:

* :func:`resolve_plan` — (policy, predicate selectivity band, caller
  args) -> frozen, hashable plan + per-request :class:`PlanContext`;
* :class:`PlanCache` — builds each distinct plan's program once
  (escalation is the same plan's second stage) and reuses it;
* ``repro_torch.plan.trace`` — first-run counters behind the
  "steady-state retraces == 0" serving guarantee.
"""

from repro_torch.plan import trace
from repro_torch.plan.plan import PlanContext, QueryPlan
from repro_torch.plan.planner import resolve_plan
from repro_torch.plan.cache import PendingResult, PlanCache

__all__ = [
    "PendingResult",
    "PlanCache",
    "PlanContext",
    "QueryPlan",
    "resolve_plan",
    "trace",
]
