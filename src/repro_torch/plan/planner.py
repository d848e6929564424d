"""resolve_plan — collapse the three serve-time decision points.

Counterpart of ``repro/plan/planner.py``.  One search call makes three
decisions:

1. the **nav ladder** — which metric rung and ef/rerank schedule the
   index's :class:`~repro_torch.probe.NavPolicy` prescribes;
2. the **filter route** — widened-ef graph traversal vs exact brute force
   over the match set, from the predicate's estimated selectivity;
3. the **escalation schedule** — whether tight-margin queries re-run with
   a wider beam.

:func:`resolve_plan` makes them one decision with one output: a frozen
:class:`~repro_torch.plan.plan.QueryPlan` plus a
:class:`~repro_torch.plan.plan.PlanContext` (the per-request tensors:
entry point, predicate mask, brute match set).  The routing policies stay
where they live (``resolve_schedule``, ``route``/``widened_ef``/
``entry_label``); this module owns their composition.

Selectivity enters the plan only through ``widened_ef``'s quantized
widening multiple, so predicate drift moves the plan key in bounded steps
(a "selectivity band"), not per popcount.
"""

from __future__ import annotations

import numpy as np

from repro_torch.filter import (
    DEFAULT_SELECTIVITY_FLOOR,
    entry_label,
    estimate_selectivity,
    route,
    validate,
    widened_ef,
)
from repro_torch.ivf.search import ivf_probes
from repro_torch.obs.metrics import get_default_registry
from repro_torch.plan.plan import PlanContext, QueryPlan
from repro_torch.probe import resolve_schedule


def _note_resolution(plan: QueryPlan, selectivity: float | None) -> None:
    """Route-decision telemetry: every resolution lands in the process
    registry, so the filter-route mix and the selectivity distribution
    driving it are visible beside everything else."""
    reg = get_default_registry()
    reg.counter(
        "quiver_plan_resolutions_total",
        "resolve_plan outcomes by route",
        labels=("route", "filtered", "nav"),
    ).inc(route=plan.route, filtered=str(plan.filtered).lower(),
          nav=plan.nav)
    if selectivity is not None:
        reg.histogram(
            "quiver_filter_selectivity",
            "match fraction of filtered requests",
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0),
            window=0,
        ).observe(selectivity)


def resolve_plan(
    index,
    *,
    k: int = 10,
    ef: int = 64,
    rerank: bool = True,
    nav: str | None = None,
    expand: int = 1,
    query_batch: int = 256,
    filter=None,
    selectivity_floor: float = DEFAULT_SELECTIVITY_FLOOR,
    adaptive: bool | None = None,
    probes: int | None = None,
) -> tuple[QueryPlan, PlanContext]:
    """Resolve one search call to (plan, context) for ``index``.

    ``index`` is any immutable-index-shaped object: ``sigs``, ``medoid``,
    ``vectors``, ``labels``, ``policy``, ``metric_kind``, ``ivf``.  The
    same (policy, filter selectivity band, ef, k, nav, expand, probes) in
    gives an equal (hash-identical) plan out: the PlanCache key.

    ``kind`` defaults through the index's :class:`NavPolicy` before its
    build metric: the policy may prescribe a navigation family the graph
    was not built in (``nav="ivf"`` navigates coarse lists over a
    bq2-built index).  ``probes`` is the ivf route's list fan-in (default:
    the partition's ``default_probes``).
    """
    n = index.sigs.words.shape[0]
    policy = getattr(index, "policy", None)
    ef, adaptive, sched = resolve_schedule(policy, nav, ef, adaptive)
    kind = nav or (policy.nav if policy is not None else index.metric_kind)
    do_rerank = rerank and index.vectors is not None

    part = None
    if kind == "ivf":
        part = getattr(index, "ivf", None)
        if part is None:
            raise ValueError(
                "nav='ivf' needs a coarse partition: build with "
                "BuildParams(ivf_candidates=True) or call build_ivf()"
            )
        # enough lists to fill k even if every probed list is sparse
        probes = ivf_probes(part, k, probes)
        expand = 1                  # no traversal: expansion is meaningless

    ctx = PlanContext(start=int(index.medoid))
    filtered = False
    ef_run = ef
    if filter is not None:
        if index.labels is None:
            raise ValueError(
                "filtered search needs labels: attach_labels() first"
            )
        expr = validate(filter, index.labels.n_labels)
        count_fn = index.labels.count_fn()
        sel = estimate_selectivity(expr, count_fn, n)
        mask = index.labels.mask(expr)
        if route(sel, selectivity_floor) == "brute":
            # the popcount estimate is a bound, not a measurement (Not()
            # of a union bound can underestimate badly): verify with the
            # exact mask popcount before materializing the match set
            match = mask.nonzero().flatten().cpu().numpy()
            sel = len(match) / max(n, 1)
            if route(sel, selectivity_floor) == "brute":
                ctx.match_ids = match.astype(np.int32)
                ctx.selectivity = sel
                plan = QueryPlan(
                    nav=kind, k=k, ef=max(ef, k), expand=expand,
                    rerank=do_rerank, route="brute",
                    query_batch=query_batch,
                )
                _note_resolution(plan, sel)
                return plan, ctx
        filtered = True
        ctx.result_valid = mask
        ctx.selectivity = sel
        ef_run = widened_ef(ef, sel, selectivity_floor, n)
        if part is not None and ef_run > ef:
            # the ivf route widens its list fan-in by the same quantized
            # multiple the graph route widens its beam: the predicate
            # thins every probed list uniformly in expectation
            probes = min(part.n_lists, -(-(probes * ef_run) // ef))
        lbl = entry_label(expr, count_fn)
        if lbl is not None and index.labels.entries[lbl] >= 0:
            ctx.start = int(index.labels.entries[lbl])

    plan = QueryPlan(
        nav=kind, k=k, ef=ef_run, expand=expand, rerank=do_rerank,
        route="ivf" if kind == "ivf" else "graph",
        filtered=filtered, adaptive=adaptive,
        escalate_margin=sched.escalate_margin,
        escalate_mult=sched.escalate_mult, query_batch=query_batch,
        probes=probes if kind == "ivf" else 0,
    )
    _note_resolution(plan, ctx.selectivity)
    return plan, ctx
