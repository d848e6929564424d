"""Serving engines: continuous-batching QuIVer search and LM generation
with retrieval-augmented prompts.

Counterpart of ``repro/serve/engine.py``:

* :class:`QueryEngine` — the retrieval serving path: an admission queue
  coalesces pending requests by query plan (``repro_torch.plan``), maps
  per-request deadlines onto the plan's ef-degradation ladder, enforces
  per-tenant quotas (``repro_torch.obs.tenant``) and samples a shadow
  lane of exact recall (``repro_torch.obs.quality``)::

      engine = QueryEngine(index)
      engine.warmup()
      t = engine.submit(queries, k=10, ef=64, deadline_ms=50)
      engine.pump()                    # one admission window
      ids, scores = engine.result(t)
      ids, scores = engine.search(q)   # submit + pump + wait

* :class:`ServeEngine` — batched generation: one prefill into a KV cache,
  then one decode step a token (greedy, or sampled from an explicit
  ``torch.Generator``).
* :class:`Retriever` — a QuIVer index plus a token store: the prompt's
  embedding queries the index (directly, or through a
  :class:`QueryEngine`'s admission queue) and the top-k neighbours'
  tokens are prepended to the prompt before prefill.
* :func:`mean_pool_embedder` — the LM as its own embedding model (the mean
  of the final hidden state over positions).

Every attention call goes through the hand-written flash kernel on the
card; every search through the index's plan cache, whose kernels follow
the index's device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.obs import DEFAULT_TENANT, ObsHub, Ring, Span, TenantLedger
from repro_torch.obs.metrics import latency_summary
from repro_torch.obs.quality import ShadowSampler
from repro_torch.plan import resolve_plan, trace
from repro_torch.plan.cache import NAV_STATS
from repro_torch.plan.plan import PlanContext, QueryPlan


def _host_float32(queries) -> np.ndarray:
    """Queries as a float32 host array: a tensor (on any device) is
    copied to the host, an array-like converted as the reference's
    ``np.asarray`` does."""
    if isinstance(queries, torch.Tensor):
        queries = queries.detach().cpu().numpy()
    return np.asarray(queries, dtype=np.float32)


@dataclasses.dataclass
class QueryTicket:
    """One admitted search request (a row range of a coalesced batch)."""

    id: int
    queries: np.ndarray                # (q, D) float32
    kwargs: dict                       # resolve_plan arguments
    filter_key: Any                    # hashable grouping key for filter
    submitted: float                   # clock() at submit
    deadline: float | None             # absolute clock() budget, or None
    tenant: str = DEFAULT_TENANT       # SLO accounting bucket
    trace_id: int = 0                  # span context carried end to end
    status: str = "pending"            # pending | done | dropped | rejected
    degraded: int = 0                  # deadline rungs walked down
    plan: QueryPlan | None = None      # the plan that actually served it
    latency: float | None = None       # seconds, admission -> completion


# window for the engine-wide latency ring: long-running engines keep
# the last this-many request latencies (per-tenant windows live in the
# TenantLedger); percentiles are over the window, memory is O(window)
DEFAULT_LATENCY_WINDOW = 4096


@dataclasses.dataclass
class EngineStats:
    requests: int = 0
    queries: int = 0
    windows: int = 0                   # pump() calls that did work
    batches: int = 0                   # coalesced plan-group launches
    done: int = 0
    dropped: int = 0
    degraded: int = 0                  # requests served below asked ef
    rejected: int = 0                  # quota-refused at admission
    latencies: Ring = dataclasses.field(
        default_factory=lambda: Ring(DEFAULT_LATENCY_WINDOW)
    )


class QueryEngine:
    """Continuous-batching search serving over a ``QuIVerIndex``.

    The engine is deliberately synchronous-pumped: callers ``submit``
    requests and ``pump`` admission windows (a thread, an asyncio task
    or a benchmark's load loop can drive it).  Each window:

    1. resolves every pending request to its :class:`QueryPlan` (the
       ahead-of-time decision point — nav ladder, filter route,
       escalation schedule);
    2. walks deadline-pressed requests down the plan's ef-degradation
       ladder (brute-route plans are exact and never degrade; requests
       already past deadline are dropped);
    3. coalesces requests group-by-plan into one batch each, recorded
       under its bucket of the ladder — singletons land in the smallest
       bucket, so repeated 1-query traffic reuses one program;
    4. launches all groups before finalizing any, as the reference
       does (there, JAX's async dispatch overlaps group i+1's transfer
       and compute with group i's sync; the port's beam syncs with the
       host at each hop, so its ``launch`` does the work and its
       ``finalize`` moves results and runs escalation: the groups of a
       window run one after another);
    5. scatters results back to tickets and records latencies.

    The engine's ``clock`` is read at the reference's points and in its
    order (submit, window start, each launch, each finalize, each drop),
    so under a scripted clock every degrade, drop and reject matches
    the reference's ticket for ticket.

    ``latency_slack``: a request is degraded when its remaining budget
    is under ``latency_slack`` × the EWMA batch latency of its plan.

    Telemetry (DESIGN.md §12): ``obs`` is the engine's
    :class:`~repro_torch.obs.ObsHub` — per-tenant counters and latency
    histograms land in ``obs.registry``, lifecycle spans (admission →
    coalesce → launch → finalize) in ``obs.tracer``, and the same hub
    is handed to the index's :class:`~repro_torch.plan.cache.PlanCache` so
    per-plan stage timings and escalations are attributed too.  Pass
    ``obs=False`` to serve bare (the telemetry-overhead baseline).

    Multi-tenancy: ``submit(tenant=...)`` threads a tenant id through
    the ticket; :meth:`set_quota` arms a token-bucket admission cap
    (queries/s) for that tenant — over-budget requests are *rejected*
    at submit (status ``"rejected"``, -1/-inf results, accounted to the
    tenant) and never reach the batch queue, so one tenant's overload
    cannot starve another's window.

    Shadow lane (DESIGN.md §14): ``shadow=True`` (or a config dict /
    prebuilt :class:`~repro_torch.obs.quality.ShadowSampler`) re-answers a
    deterministic ~1/``rate`` of live queries as exact float32 brute
    force.  Sampled rows are *offered* at result-scatter time (a copy,
    nothing more) and *drained* only after every live request of the
    window is delivered and accounted — the shadow lane never passes
    admission, never charges a token bucket, and never delays a live
    result.  Drained recall@k feeds the tenant ledger's recall-SLO
    windows (:meth:`set_quota` ``recall_slo=``).
    """

    def __init__(
        self,
        index,
        *,
        query_batch: int = 256,
        default_k: int = 10,
        default_ef: int = 64,
        latency_slack: float = 1.0,
        ewma_alpha: float = 0.3,
        latency_window: int = DEFAULT_LATENCY_WINDOW,
        obs: ObsHub | bool | None = None,
        shadow: ShadowSampler | dict | bool | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.index = index
        self.query_batch = query_batch
        self.default_k = default_k
        self.default_ef = default_ef
        self.latency_slack = latency_slack
        self.ewma_alpha = ewma_alpha
        self.clock = clock
        self.stats = EngineStats(latencies=Ring(latency_window))
        self._pending: list[QueryTicket] = []
        self._tickets: dict[int, QueryTicket] = {}
        self._results: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._next_id = 0
        self._lat_ewma: dict[QueryPlan, float] = {}
        if obs is False:
            self.obs = None
        elif obs is None or obs is True:
            self.obs = ObsHub()
        else:
            self.obs = obs
        self.tenants = TenantLedger(
            registry=self.obs.registry if self.obs else None,
            latency_window=latency_window,
            clock=clock,
        )
        if not shadow:
            self.shadow = None
        elif isinstance(shadow, ShadowSampler):
            self.shadow = shadow
            self.shadow.ledger = self.tenants
        else:
            kw = dict(shadow) if isinstance(shadow, dict) else {}
            kw.setdefault("k", default_k)
            self.shadow = ShadowSampler(
                index,
                registry=self.obs.registry if self.obs else None,
                ledger=self.tenants, **kw,
            )
        if self.obs is not None:
            reg = self.obs.registry
            self._m_requests = reg.counter(
                "quiver_engine_requests_total",
                "terminal request outcomes",
                labels=("tenant", "status"),
            )
            self._m_degraded = reg.counter(
                "quiver_engine_degraded_total",
                "requests served below the asked ef", labels=("tenant",),
            )
            self._m_windows = reg.counter(
                "quiver_engine_windows_total", "admission windows pumped"
            )
            self._m_batches = reg.counter(
                "quiver_engine_batches_total",
                "coalesced plan-group launches",
            )
            self._m_queue = reg.gauge(
                "quiver_engine_pending_requests",
                "requests awaiting an admission window",
            )
            # plan-stage timings ride the same hub (PlanCache checks
            # its ``obs`` on every launch/finalize)
            if hasattr(index, "plans"):
                index.plans.obs = self.obs

    # -- admission ---------------------------------------------------------

    def set_quota(self, tenant: str, qps: float,
                  burst: float | None = None,
                  recall_slo: float | None = None) -> None:
        """Arm a token-bucket admission quota (queries/second with
        ``burst`` headroom) for ``tenant``.  Requests beyond the budget
        are rejected at submit; other tenants are unaffected (each
        bucket is independent).

        ``recall_slo`` adds the quality dimension: the tenant's rolling
        shadow-recall p50 must stay at or above it.  Breaches are
        edge-triggered events the ledger's subscribers (the remediation
        policy) receive — they never reject traffic.  Needs the shadow
        lane armed (``shadow=`` at construction) to get measurements.
        """
        self.tenants.set_quota(tenant, qps, burst=burst,
                               recall_slo=recall_slo)

    def submit(
        self,
        queries,
        *,
        k: int | None = None,
        ef: int | None = None,
        rerank: bool = True,
        nav: str | None = None,
        expand: int = 1,
        filter=None,
        adaptive: bool | None = None,
        deadline_ms: float | None = None,
        tenant: str = DEFAULT_TENANT,
    ) -> int:
        """Queue a request; returns a ticket id for :meth:`result`.

        ``tenant`` selects the SLO account (and quota bucket, if one is
        armed).  A quota-rejected request completes immediately with
        status ``"rejected"`` and -1/-inf results — the ticket id is
        still valid for :meth:`result`, so callers observe rejection as
        a fast, attributed failure rather than an exception.
        """
        q = np.atleast_2d(_host_float32(queries))
        now = self.clock()
        t = QueryTicket(
            id=self._next_id,
            queries=q,
            kwargs=dict(
                k=k if k is not None else self.default_k,
                ef=ef if ef is not None else self.default_ef,
                rerank=rerank, nav=nav, expand=expand, filter=filter,
                adaptive=adaptive, query_batch=self.query_batch,
            ),
            filter_key=filter,
            submitted=now,
            deadline=(now + deadline_ms / 1e3
                      if deadline_ms is not None else None),
            tenant=tenant,
            trace_id=(self.obs.tracer.new_trace()
                      if self.obs is not None else 0),
        )
        self._next_id += 1
        self._tickets[t.id] = t
        self.stats.requests += 1
        self.stats.queries += len(q)
        if not self.tenants.admit(tenant, len(q), now):
            self._finish_rejected(t)
            return t.id
        self._pending.append(t)
        if self.obs is not None:
            self._m_queue.set(len(self._pending))
        return t.id

    def _finish_rejected(self, t: QueryTicket) -> None:
        k = t.kwargs["k"]
        nq = len(t.queries)
        self._results[t.id] = (
            np.full((nq, k), -1, np.int32),
            np.full((nq, k), -np.inf, np.float32),
        )
        t.status = "rejected"
        t.latency = 0.0
        self.stats.rejected += 1
        if self.obs is not None:
            self._m_requests.inc(tenant=t.tenant, status="rejected")

    # -- one admission window ----------------------------------------------

    def pump(self) -> int:
        """Serve every pending request in one admission window; returns
        how many requests completed (dropped requests count)."""
        if not self._pending:
            return 0
        admitted, self._pending = self._pending, []
        self.stats.windows += 1
        now = self.clock()
        tracer = self.obs.tracer if self.obs is not None else None
        window_t0 = tracer.clock() if tracer is not None else 0.0

        # 1+2: plan resolution + deadline degradation, group by plan
        groups: dict[tuple, list] = {}
        ctxs: dict[tuple, PlanContext] = {}
        completed = 0
        coalesce_t0 = tracer.clock() if tracer is not None else 0.0
        for t in admitted:
            if tracer is not None:
                # admission span: submit -> window start (queue wait,
                # on the engine clock — same clock as ``latency``)
                tracer.record(Span(
                    "admission", t.trace_id, t.submitted, end=now,
                    attrs={"tenant": t.tenant},
                ))
            if t.deadline is not None and now > t.deadline:
                self._finish_dropped(t)
                completed += 1
                continue
            plan, ctx = resolve_plan(self.index, **t.kwargs)
            if t.deadline is not None:
                budget = t.deadline - now
                while (plan.can_degrade()
                       and self._estimate(plan)
                       * self.latency_slack > budget):
                    plan = plan.degraded()
                    t.degraded += 1
                if t.degraded:
                    self.stats.degraded += 1
                    if self.obs is not None:
                        self._m_degraded.inc(tenant=t.tenant)
                        mark = tracer.clock()
                        tracer.record(Span(
                            "degrade", t.trace_id, mark, end=mark,
                            attrs={"rungs": t.degraded,
                                   "ef": plan.ef,
                                   "tenant": t.tenant},
                        ))
            t.plan = plan
            key = (plan, t.filter_key)
            groups.setdefault(key, []).append(t)
            ctxs.setdefault(key, ctx)
        if tracer is not None:
            tracer.record(Span(
                "coalesce", 0, coalesce_t0,
                attrs={"requests": len(admitted), "groups": len(groups)},
            ))

        # 3+4: coalesce each group and launch all before finalizing any
        # (the reference's double-buffering; here launch runs the beam)
        launches = []
        for key, tickets in groups.items():
            plan = key[0]
            qcat = np.concatenate([t.queries for t in tickets])
            t0 = self.clock()
            if tracer is not None:
                with tracer.span("launch", tickets[0].trace_id,
                                 plan=plan.signature(),
                                 queries=len(qcat)):
                    pending = self.index.plans.launch(
                        plan, ctxs[key], qcat
                    )
            else:
                pending = self.index.plans.launch(plan, ctxs[key], qcat)
            launches.append((plan, tickets, pending, t0))
            self.stats.batches += 1
            if self.obs is not None:
                self._m_batches.inc()

        # 5: sync, scatter, account
        for plan, tickets, pending, t0 in launches:
            if tracer is not None:
                with tracer.span("finalize", tickets[0].trace_id,
                                 plan=plan.signature()):
                    ids, scores = self.index.plans.finalize(pending)
            else:
                ids, scores = self.index.plans.finalize(pending)
            t_done = self.clock()
            self._observe(plan, t_done - t0)
            # nav traces (graph plans only; the cache populates them at
            # finalize when obs is armed) scatter to the same per-ticket
            # row ranges as the results
            nav = getattr(pending, "nav", None)
            row = 0
            for t in tickets:
                nq = len(t.queries)
                self._results[t.id] = (ids[row:row + nq],
                                       scores[row:row + nq])
                if nav is not None:
                    self.tenants.observe_nav(t.tenant, {
                        stat: nav[row:row + nq, col]
                        for col, (stat, _) in enumerate(NAV_STATS)
                    })
                row += nq
                if self.shadow is not None:
                    # offer only: a copy of the sampled rows; ground
                    # truth runs after the whole window is accounted
                    stage = ("degraded" if t.degraded
                             else "adaptive" if plan.adaptive
                             else "base")
                    self.shadow.offer(
                        t.queries, self._results[t.id][0],
                        tenant=t.tenant, nav=plan.nav, stage=stage,
                    )
                t.status = "done"
                t.latency = t_done - t.submitted
                self.stats.done += 1
                self.stats.latencies.append(t.latency)
                self.tenants.observe(
                    t.tenant, status="done", latency=t.latency,
                    degraded=bool(t.degraded),
                )
                if self.obs is not None:
                    self._m_requests.inc(tenant=t.tenant, status="done")
                    tracer.record(Span(
                        "request", t.trace_id, t.submitted,
                        end=t.submitted + t.latency,
                        attrs={"tenant": t.tenant,
                               "plan": plan.signature(),
                               "status": "done"},
                    ))
                completed += 1
        if self.obs is not None:
            self._m_windows.inc()
            self._m_queue.set(len(self._pending))
            tracer.record(Span(
                "window", 0, window_t0,
                attrs={"requests": len(admitted),
                       "batches": len(launches)},
            ))
        # shadow drain: every live result above is already delivered and
        # its latency recorded — the exact brute force happens strictly
        # off the serving path and outside tenant accounting
        if self.shadow is not None and self.shadow.pending:
            if tracer is not None:
                with tracer.span("shadow", 0,
                                 pending=len(self.shadow.pending)):
                    self.shadow.drain()
            else:
                self.shadow.drain()
        return completed

    def _finish_dropped(self, t: QueryTicket) -> None:
        k = t.kwargs["k"]
        nq = len(t.queries)
        self._results[t.id] = (
            np.full((nq, k), -1, np.int32),
            np.full((nq, k), -np.inf, np.float32),
        )
        t.status = "dropped"
        t.latency = self.clock() - t.submitted
        self.stats.dropped += 1
        self.tenants.observe(t.tenant, status="dropped",
                             latency=t.latency)
        if self.obs is not None:
            self._m_requests.inc(tenant=t.tenant, status="dropped")

    def _estimate(self, plan: QueryPlan) -> float:
        """EWMA batch latency for ``plan`` (0.0 until first observed —
        no degradation before the engine has evidence)."""
        if plan in self._lat_ewma:
            return self._lat_ewma[plan]
        # unmeasured degraded rungs inherit the parent's estimate scaled
        # by the beam ratio (latency is ~linear in ef)
        for parent, lat in self._lat_ewma.items():
            if (parent.nav == plan.nav and parent.route == plan.route
                    and parent.filtered == plan.filtered
                    and parent.k == plan.k):
                return lat * plan.ef / max(parent.ef, 1)
        return 0.0

    def _observe(self, plan: QueryPlan, seconds: float) -> None:
        prev = self._lat_ewma.get(plan)
        a = self.ewma_alpha
        self._lat_ewma[plan] = (
            seconds if prev is None else a * seconds + (1 - a) * prev
        )

    # -- results -----------------------------------------------------------

    def poll(self, ticket: int):
        """(ids, scores) if the ticket completed, else None."""
        return self._results.get(ticket)

    def result(self, ticket: int):
        """Block (pumping the queue) until ``ticket`` completes."""
        while ticket not in self._results:
            if not self.pump():
                raise KeyError(f"unknown or lost ticket {ticket}")
        return self._results.pop(ticket)

    def ticket(self, ticket: int) -> QueryTicket:
        return self._tickets[ticket]

    def search(self, queries, **kwargs):
        """Per-call convenience: submit + pump + wait.  Single queries
        still ride the admission path, so they share the smallest
        ladder bucket with every other singleton."""
        return self.result(self.submit(queries, **kwargs))

    # -- index lifecycle ---------------------------------------------------

    def swap_index(self, index, *, warmup: bool = False) -> None:
        """Re-point the engine at a new index snapshot.

        Streaming serves swap in ``freeze()`` snapshots at consolidation
        or phase boundaries; the engine re-wires plan-cache telemetry
        and the shadow sampler's ground-truth tier to the new index.
        Plan latency EWMAs carry over (plan keys are index-independent
        and the new snapshot serves comparable shapes).
        """
        self.index = index
        if self.obs is not None and hasattr(index, "plans"):
            index.plans.obs = self.obs
        if self.shadow is not None:
            self.shadow.index = index
            index.shadow = self.shadow
        if warmup:
            self.warmup()

    # -- warmup & reporting ------------------------------------------------

    def warmup(
        self,
        *,
        buckets: tuple[int, ...] = (8,),
        configs: tuple[dict, ...] = ({},),
    ) -> int:
        """Precompile the plans the engine expects to serve (default:
        its default k/ef on the smallest bucket, escalation stage
        included).  ``configs`` are extra submit-kwarg dicts to warm
        (e.g. ``{"filter": 3}`` or ``{"ef": 32}``)."""
        warmed = 0
        for cfg in configs:
            kw = dict(
                k=self.default_k, ef=self.default_ef, rerank=True,
                nav=None, expand=1, filter=None, adaptive=None,
                query_batch=self.query_batch,
            )
            kw.update(cfg)
            plan, ctx = resolve_plan(self.index, **kw)
            warmed += self.index.plans.warmup(
                plan, ctx if plan.filtered or plan.route == "brute"
                else None, buckets=buckets,
            )
        return warmed

    def stats_report(self) -> dict:
        """``memory_breakdown``-style serving report: request counters,
        window latency percentiles, per-tenant SLO accounts, lifecycle
        span aggregates, plan-cache behaviour, retraces.

        Percentiles are over the bounded latency ring (the last
        ``latency_window`` requests), so a long-running engine reports
        its *current* tail, not its lifetime-averaged one.
        """
        lat = self.stats.latencies
        out = {
            "requests": self.stats.requests,
            "queries": self.stats.queries,
            "windows": self.stats.windows,
            "batches": self.stats.batches,
            "done": self.stats.done,
            "dropped": self.stats.dropped,
            "degraded": self.stats.degraded,
            "rejected": self.stats.rejected,
            "latency_window": lat.maxlen,
            **latency_summary(lat),
        }
        out["tenant_report"] = self.tenants.report()
        if self.shadow is not None:
            out["shadow_report"] = self.shadow.report()
        if self.obs is not None:
            out["span_report"] = self.obs.tracer.report()
        out.update(
            {f"plan_{k}": v for k, v in self.index.plans.report().items()}
        )
        out["trace_report"] = trace.trace_report(
            self.index.plans.trace_prefix()
        )
        return out

    def health_verdicts(self) -> dict:
        """Per-component liveness bands for ``GET /healthz``: the
        graph's last structural X-ray, the probe-drift monitor's band,
        and the recall SLO (red while any tenant is breaching).  A
        component with no monitor attached is simply absent — absence
        reads green, so a bare engine stays servable."""
        out = {}
        gh = getattr(self.index, "graph_health", None)
        if gh is not None:
            out["graph"] = gh.verdict
        gm = getattr(self.index, "graph_monitor", None)
        if gm is not None and gm.band is not None:
            out["graph"] = gm.band
        dm = getattr(self.index, "drift_monitor", None)
        if dm is not None and dm.band is not None:
            out["drift"] = dm.band
        breached = [
            t for t in self.tenants.tenants()
            if self.tenants.recall_breached(t)
        ]
        out["recall_slo"] = "red" if breached else "green"
        return out

    def emit_report(self) -> dict:
        """Push one ``stats_report`` snapshot through the hub's sinks
        (the :class:`~repro_torch.obs.PeriodicReporter` calls this)."""
        report = self.stats_report()
        if self.obs is not None:
            return self.obs.emit({"stats_report": report})
        return report

    def shutdown(self) -> dict:
        """Flush the final telemetry window and close the hub.

        Emits one last ``stats_report`` through the sinks, then stops
        the hub's reporters and closes its sinks (idempotent — the
        hub's own ``atexit`` hook makes a second call a no-op).  Call
        this at the end of short-lived benchmark/CLI processes so the
        final window is never dropped.
        """
        report = self.emit_report()
        if self.obs is not None:
            self.obs.close()
        return report




@dataclasses.dataclass
class Retriever:
    """QuIVer index + token store for RAG.

    ``index`` may be an immutable :class:`QuIVerIndex` or a streaming
    :class:`repro_torch.stream.MutableQuIVerIndex`; with the latter the
    corpus can grow *while serving* through :meth:`add_documents`.

    ``embed_fn`` maps (B, S) tokens (a numpy array) to (B, D) embeddings
    (a tensor or array); ``nav=None`` navigates in the metric the index was
    built in; ``expand`` is the beam expansion width; ``pad_token`` fills
    the context slots of missing hits (search returns -1 ids when the beam
    finds fewer than k live documents, and ids past a lagging token store
    are blanked the same way); ``adaptive=None`` follows the index's own
    nav policy.

    ``filter`` (optional) is a label predicate (``repro_torch.filter``):
    retrieval only surfaces documents matching it (metadata-filtered RAG:
    language, tenant, source tags).  The index needs labels attached
    (``attach_labels``); ``augment(filter=...)`` overrides it per call.

    ``engine`` (optional) is a :class:`QueryEngine` over the same index:
    retrievals then go through its admission queue, coalescing with
    concurrent requests, so a stream of single-prompt lookups reuses one
    plan's program.
    """
    index: Any                      # QuIVerIndex | MutableQuIVerIndex
    doc_tokens: np.ndarray          # (n_docs, doc_len) int32
    embed_fn: Callable              # (B, S) tokens -> (B, D) embeddings
    k: int = 2
    ef: int = 64
    nav: str | None = None
    expand: int = 1
    pad_token: int = 0
    filter: Any = None              # label predicate (repro_torch.filter)
    adaptive: bool | None = None    # None: the index policy decides
    engine: Any = None              # QueryEngine routing (optional)

    def augment(self, tokens: np.ndarray, *, filter=None) -> np.ndarray:
        """(B, S) prompts -> (B, k * doc_len + S): the retrieved documents'
        tokens, then the prompt; ``filter`` (default: the retriever's own)
        restricts the documents retrieved."""
        tokens = np.asarray(tokens)
        emb = self.embed_fn(tokens)
        search = self.engine.search if self.engine is not None \
            else self.index.search
        ids, _ = search(
            emb, k=self.k, ef=self.ef, nav=self.nav, expand=self.expand,
            adaptive=self.adaptive,
            filter=filter if filter is not None else self.filter,
        )
        ids = np.asarray(ids).reshape(len(tokens), -1)
        # ids outside the token store (-1 padding, or slots beyond a lagging
        # doc_tokens) must not gather a real document: clamp for the gather,
        # then blank out
        in_store = (ids >= 0) & (ids < len(self.doc_tokens))
        safe = np.clip(ids, 0, len(self.doc_tokens) - 1)
        ctx = np.asarray(self.doc_tokens)[safe]
        ctx = np.where(in_store[..., None], ctx, self.pad_token)
        ctx = ctx.reshape(len(tokens), -1)
        return np.concatenate([ctx, tokens], axis=1)

    def add_documents(self, doc_tokens, embeddings=None, *,
                      labels=None) -> np.ndarray:
        """Insert documents into a *mutable* index while serving.

        Returns the slot ids the index assigned.  The token store is
        slot-addressed: it is grown to the index capacity on first use, so
        reclaimed slots (delete + consolidate) are overwritten in place.
        ``labels`` tags the new documents for filtered retrieval (one int
        or iterable of ints per document).  ``embeddings`` default to
        ``embed_fn`` of the tokens.
        """
        if not hasattr(self.index, "insert"):
            raise TypeError(
                "add_documents needs a mutable index (repro_torch.stream); "
                f"got {type(self.index).__name__}"
            )
        doc_tokens = np.atleast_2d(np.asarray(doc_tokens, dtype=np.int32))
        if embeddings is None:
            embeddings = self.embed_fn(doc_tokens)
        ids = np.asarray(self.index.insert(embeddings, labels=labels))
        cap = self.index.capacity
        if len(self.doc_tokens) < cap:
            pad = np.full(
                (cap - len(self.doc_tokens), self.doc_tokens.shape[1]),
                self.pad_token, dtype=self.doc_tokens.dtype,
            )
            self.doc_tokens = np.concatenate([self.doc_tokens, pad])
        self.doc_tokens[ids] = doc_tokens
        return ids


class ServeEngine:
    """Batched generation over ``model`` (a :class:`DecoderLM` from
    ``bundle.init``), which must live on ``device`` (default: the card)."""

    def __init__(self, bundle, model, *, max_seq: int = 512, device=None):
        device = resolve_device(device)
        if model.device.type != device.type:
            raise ValueError(f"the model is on {model.device}, the engine "
                             f"on {device}")
        self.device = model.device
        self.bundle = bundle
        self.model = model
        self.max_seq = max_seq

    def generate(
        self,
        tokens: np.ndarray,              # (B, S) int32 prompts
        *,
        max_new: int = 32,
        retriever: Retriever | None = None,
        temperature: float = 0.0,
        seed: int = 0,
        extra_batch: dict | None = None,
    ) -> np.ndarray:
        """(B, max_new) int32 new tokens.  Greedy (``argmax``, ties to the
        lower index, as ``jnp.argmax``) at ``temperature == 0``; otherwise
        sampled from a ``torch.Generator`` seeded with ``seed`` (not the
        reference's ``jax.random`` draws).  ``extra_batch`` joins the
        prefill's batch: a vlm's ``patches`` (B, P, d), which the prefill
        puts before the tokens, so decode starts at position ``P + S`` (the
        reference's ``prompt_len``) and the cache must hold ``P + S +
        max_new`` rows.  Tokens stay on the device until the end."""
        if retriever is not None:
            tokens = retriever.augment(tokens)
        tokens = np.asarray(tokens, dtype=np.int32)
        b, s = tokens.shape
        batch = {"tokens": torch.from_numpy(tokens)}
        if extra_batch:
            batch.update(extra_batch)
        prompt_len = s
        if self.bundle.cfg.frontend == "patch_stub" and extra_batch:
            prompt_len += extra_batch["patches"].shape[1]
        assert prompt_len + max_new <= self.max_seq, \
            (prompt_len, max_new, self.max_seq)

        caches = self.bundle.init_caches(b, self.max_seq, device=self.device)
        logits, caches = self.bundle.prefill(self.model, batch, caches)
        gen = None
        if temperature > 0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        out = torch.empty((b, max_new), dtype=torch.int64, device=self.device)
        pos = prompt_len
        for i in range(max_new):
            if temperature > 0:
                probs = torch.softmax(logits / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                tok = torch.argmax(logits, dim=-1)
            out[:, i] = tok
            logits, caches = self.bundle.decode(self.model, tok[:, None],
                                                caches, pos)
            pos += 1
        return out.cpu().numpy().astype(np.int32)


def mean_pool_embedder(bundle, model) -> Callable:
    """(B, S) tokens -> (B, d_model) float32 embeddings on the model's
    device: the mean over positions of the final hidden state.  As the
    reference's ``jnp.mean`` of a bf16 state, the mean is summed in float32
    and rounded to the state's dtype before the cast to float32."""
    del bundle

    @torch.no_grad()
    def embed(tokens) -> torch.Tensor:
        x = tf.embed_tokens(
            model, torch.as_tensor(tokens, device=model.device).long())
        h, _ = tf.forward_hidden(model, x)
        return h.float().mean(dim=1).to(h.dtype).float()

    return embed
