"""PlanCache — build each distinct QueryPlan's program once, then feed it.

Counterpart of ``repro/plan/cache.py``.  One cache per index.  For every
:class:`~repro_torch.plan.plan.QueryPlan` the cache builds one program
(beam search or the IVF list scan, then rerank and the top-k margin) and
every later request with the same plan reuses it.  Adaptive escalation is
the second stage of the same plan: ``plan.escalated()`` is another plan
in the cache, warmed by :meth:`warmup`.

The reference jit-compiles each program and pads every query chunk to its
bucket of the ladder 8, 32, 128, ... (``batch_bucket``) so that the
compiled shapes form a closed set.  The port compiles nothing, and its
batched beam search is row-independent, so padding would only add device
work: a chunk runs on its real rows, and its bucket is recorded for the
accounting alone.  Trace accounting rides ``repro_torch.plan.trace``:
each program is a ``counting_program`` under this cache's prefix keyed by
the bucket, so ``report()["retraces"]`` is "first runs beyond one per
(plan, bucket)", which steady-state serving keeps at zero.  A chunk costs
its beam's hops, not its rows, so :meth:`PlanCache.warmup` runs a stage's
buckets stacked in one batch.

``launch`` and ``finalize`` stay separate, as in the reference, for a
serving queue that interleaves batches.  The port's beam search syncs
with the host once a hop, so ``launch`` does the work and ``finalize``
only moves results to the host and runs the escalation stage.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch.core.beam import batch_bucket, beam_margin, beam_search
from repro_torch.core.metric import normalize
from repro_torch.ivf.search import ivf_probes, scan_search
from repro_torch.kernels import dispatch
from repro_torch.plan import trace
from repro_torch.plan.plan import PlanContext, QueryPlan

_CACHE_IDS = itertools.count()

# navigation-path trace statistics: column order of the (Q, 5) nav array
# the graph programs return, with the fixed histogram buckets each lands
# in (windowless: observes stay vectorized)
NAV_STATS = (
    ("hops", (1, 2, 4, 8, 16, 32, 64, 128, 256)),
    ("evals", (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)),
    ("descent", (0.0, 1.0, 4.0, 16.0, 64.0, 256.0, 1024.0, 4096.0,
                 16384.0)),
    ("stalls", (0, 1, 2, 4, 8, 16, 32, 64)),
    ("entry_rank", (0, 1, 2, 4, 8, 16, 32, 64, 128)),
)


def _nav_trace(res) -> torch.Tensor:
    """Stack a BeamResult's per-query counters into the (Q, 5) float32
    nav-trace array (one dtype, one transfer)."""
    return torch.stack([res.hops.float(), res.evals.float(),
                        res.descent.float(), res.stalls.float(),
                        res.entry_rank.float()], dim=-1)


class PendingResult:
    """Device results of one launched plan: per-chunk tensors plus splice
    metadata.  ``PlanCache.finalize`` moves them to the host and runs the
    escalation stage if the plan asks for one."""

    __slots__ = ("plan", "ctx", "queries", "reprs", "chunks", "nav")

    def __init__(self, plan, ctx, queries, reprs, chunks):
        self.plan = plan
        self.ctx = ctx
        self.queries = queries       # (Q, D) normalized, device
        self.reprs = reprs           # encoded queries, device
        self.chunks = chunks         # [(ids, scores, margins, nav, real)]
        # (Q, 5) host float32 nav-trace rows [hops, evals, descent,
        # stalls, entry_rank]: filled by finalize() when the cache has an
        # obs hub and the plan traverses the graph; None otherwise
        self.nav = None


class PlanCache:
    """Program cache keyed by :class:`QueryPlan`."""

    def __init__(self, index):
        self._index = index
        self._programs: dict[QueryPlan, trace.CountingProgram] = {}
        # (plan, bucket) pairs that have executed at least once: the
        # closed set of shapes; misses == first-time pairs
        self._seen: set[tuple[QueryPlan, int]] = set()
        self._tag = f"plan[{next(_CACHE_IDS)}]:"
        self.hits = 0
        self.misses = 0
        self.executions = 0
        self.invalidated_plans = 0
        # (plan, bucket) shapes evicted by invalidate(): their trace
        # events stay in the counters, so the retrace audit subtracts them
        self.invalidated_shapes = 0
        # telemetry hub (``registry`` and ``tracer``, with ``clock()`` and
        # ``span(name, **attrs)``): when set, per-plan stage timings land
        # in ``quiver_plan_seconds{stage,plan}``, nav traces in
        # ``quiver_nav_*`` and escalations in
        # ``quiver_escalated_queries_total{plan}``.  None: no overhead.
        self.obs = None

    # -- program construction ---------------------------------------------

    def program(self, plan: QueryPlan) -> trace.CountingProgram:
        """The program for ``plan`` (built exactly once)."""
        if plan not in self._programs:
            self._programs[plan] = self._build(plan)
        return self._programs[plan]

    def _nav_backend(self, nav: str):
        """The metric backend a plan's nav family scores with: the ivf
        family navigates coarse lists but scores candidates in bq2 space
        (the partition lives there)."""
        return self._index.backend("bq2" if nav == "ivf" else nav)

    def _build(self, plan: QueryPlan) -> trace.CountingProgram:
        if plan.route == "brute":
            raise ValueError("brute plans run through "
                             "filter.brute_force_topk, not a program")
        if plan.route == "ivf":
            return self._build_ivf(plan)
        index = self._index
        backend = self._nav_backend(plan.nav)
        neutral = backend.neutral_dist
        n = index.sigs.words.shape[0]
        # lazy: core.index imports this module at its own top level
        from repro_torch.core.index import rerank

        def program(reprs, queries, adjacency, vectors, start,
                    result_valid=None):
            res = beam_search(
                reprs, adjacency, start, dist_fn=backend.dist_many,
                ef=plan.ef, n=n, expand=plan.expand,
                result_valid=result_valid,
            )
            ids, scores = rerank(res.ids, res.dists, queries, vectors,
                                 plan.k)
            margins = beam_margin(res.dists, plan.k, neutral)
            return ids, scores, margins, _nav_trace(res)

        return trace.counting_program(program,
                                      self._tag + plan.signature())

    def _build_ivf(self, plan: QueryPlan) -> trace.CountingProgram:
        """One ivf program: list scan -> top-p gather -> metric top-ef ->
        rerank -> margin."""
        index = self._index
        part = index.ivf
        if part is None:
            raise ValueError("ivf plan on an index without a partition")
        backend = self._nav_backend(plan.nav)
        neutral = backend.neutral_dist
        from repro_torch.core.index import rerank

        scan = dispatch.list_scan_ops(index.sigs.dim, index.device).scan
        p_eff = ivf_probes(part, plan.k, plan.probes)

        def program(reprs, queries, cent_words, list_ids, vectors,
                    result_valid=None):
            ids, dists = scan_search(
                backend, scan, reprs, cent_words, list_ids,
                probes=p_eff, ef=plan.ef, result_valid=result_valid,
            )
            out_ids, scores = rerank(ids, dists, queries, vectors, plan.k)
            margins = beam_margin(dists, plan.k, neutral)
            return out_ids, scores, margins

        return trace.counting_program(program,
                                      self._tag + plan.signature())

    # -- query encoding ----------------------------------------------------

    def encode(self, plan: QueryPlan, queries: torch.Tensor) -> torch.Tensor:
        """Normalized float32 queries -> the plan's beam representation
        (rotation applied for signature-space navigation)."""
        index = self._index
        backend = self._nav_backend(plan.nav)
        enc_in = queries
        if index.rotation is not None and backend.kind != "float32":
            enc_in = queries @ index.rotation
        return backend.encode_queries(enc_in)

    # -- execution ---------------------------------------------------------

    def launch(
        self,
        plan: QueryPlan,
        ctx: PlanContext,
        queries,
        *,
        record: bool = True,
    ) -> PendingResult:
        """Run ``queries`` through ``plan``; results stay on the device.

        Queries are normalized and encoded here; chunks of
        ``plan.query_batch`` rows run on their real rows, each recorded
        under its bucket of the ladder (``batch_bucket``).
        """
        t0 = self.obs.tracer.clock() if self.obs is not None else 0.0
        from repro_torch.core.index import as_float32

        queries = normalize(as_float32(queries, self._index.device))
        if queries.ndim == 1:
            queries = queries[None]
        if plan.route == "brute":
            return PendingResult(plan, ctx, queries, None, None)
        return self._launch(plan, ctx, queries, self.encode(plan, queries),
                            record, t0)

    def _launch(self, plan, ctx, queries, reprs, record,
                t0=0.0) -> PendingResult:
        """``launch`` on queries already normalized and encoded; ``t0`` is
        the hub's clock when the launch began."""
        prog = self.program(plan)
        chunks = []
        for s in range(0, queries.shape[0], plan.query_batch):
            rep = reprs[s:s + plan.query_batch]
            q = queries[s:s + plan.query_batch]
            real = rep.shape[0]
            bucket = batch_bucket(real, plan.query_batch)
            if record:
                self.executions += 1
                if (plan, bucket) in self._seen:
                    self.hits += 1
                else:
                    self.misses += 1
            self._seen.add((plan, bucket))
            out = prog(*self._args(plan, ctx, rep, q), bucket=bucket)
            # graph programs return a 4th (nav-trace) tensor; the ivf
            # route has no traversal to trace
            nav = out[3] if len(out) > 3 else None
            chunks.append((out[0], out[1], out[2], nav, real))
        if self.obs is not None:
            self._stage_hist(self.obs).observe(
                self.obs.tracer.clock() - t0,
                stage="launch", plan=plan.signature(),
            )
        return PendingResult(plan, ctx, queries, reprs, chunks)

    def _args(self, plan, ctx, reprs, queries) -> tuple:
        """A chunk's program arguments."""
        index = self._index
        vectors = index.vectors if plan.rerank else None
        if plan.route == "ivf":
            args = (reprs, queries, index.ivf.cent_words,
                    index.ivf.list_ids, vectors)
        else:
            args = (reprs, queries, index.adjacency, vectors, ctx.start)
        if plan.filtered:
            args += (ctx.result_valid,)
        return args

    def _stage_hist(self, obs):
        return obs.registry.histogram(
            "quiver_plan_seconds",
            "per-plan stage wall time (launch dispatch / finalize sync)",
            labels=("stage", "plan"),
        )

    def finalize(
        self, pending: PendingResult
    ) -> tuple[np.ndarray, np.ndarray]:
        """Move a launched plan's results to the host and run its second
        (escalation) stage where margins demand one."""
        plan, ctx = pending.plan, pending.ctx
        obs = self.obs
        t0 = obs.tracer.clock() if obs is not None else 0.0
        if plan.route == "brute":
            return self._run_brute(plan, ctx, pending.queries)
        out_ids, out_scores, out_margin, out_nav = [], [], [], []
        for ids, scores, margins, nav, real in pending.chunks:
            out_ids.append(ids[:real].cpu().numpy())
            out_scores.append(scores[:real].cpu().numpy())
            out_margin.append(margins[:real].cpu().numpy())
            if obs is not None and nav is not None:
                out_nav.append(nav[:real].cpu().numpy())
        all_ids = np.concatenate(out_ids)
        all_scores = np.concatenate(out_scores)
        if out_nav:
            # nav-path tracing: the counters ride the program either way;
            # the host transfer and the observes happen with a hub only
            pending.nav = np.concatenate(out_nav)
            for col, (stat, buckets) in enumerate(NAV_STATS):
                obs.registry.histogram(
                    f"quiver_nav_{stat}",
                    f"per-query beam {stat} by nav family and plan",
                    labels=("nav", "plan"), buckets=buckets, window=0,
                ).observe_many(
                    pending.nav[:, col],
                    nav=plan.nav, plan=plan.signature(),
                )
        if obs is not None:
            self._stage_hist(obs).observe(
                obs.tracer.clock() - t0,
                stage="finalize", plan=plan.signature(),
            )
        if plan.adaptive:
            margins = np.concatenate(out_margin)
            esc = np.nonzero(margins < plan.escalate_margin)[0]
            if esc.size:
                # the escalated stage reuses the queries' encoding (the
                # reference normalizes and encodes them again, which
                # gives the same words up to a strong bit at a tie)
                take = torch.from_numpy(esc).to(pending.queries.device)

                def stage2():
                    t0 = obs.tracer.clock() if obs is not None else 0.0
                    return self.finalize(self._launch(
                        plan.escalated(), ctx, pending.queries[take],
                        pending.reprs[take], True, t0))

                if obs is not None:
                    obs.registry.counter(
                        "quiver_escalated_queries_total",
                        "tight-margin queries re-run at the escalated "
                        "stage", labels=("plan",),
                    ).inc(int(esc.size), plan=plan.signature())
                    with obs.tracer.span("escalate",
                                         plan=plan.signature(),
                                         queries=int(esc.size)):
                        esc_ids, esc_scores = stage2()
                else:
                    esc_ids, esc_scores = stage2()
                all_ids[esc] = esc_ids
                all_scores[esc] = esc_scores
        return all_ids, all_scores

    def run(
        self, plan: QueryPlan, ctx: PlanContext, queries
    ) -> tuple[np.ndarray, np.ndarray]:
        """launch + finalize: the synchronous per-call entry
        (``QuIVerIndex.search`` lowers to exactly this)."""
        return self.finalize(self.launch(plan, ctx, queries))

    def _run_brute(self, plan, ctx, queries):
        # exact top-k over the materialized match set
        from repro_torch.filter.search import brute_force_topk

        index = self._index
        if plan.rerank:
            return brute_force_topk(
                queries, ctx.match_ids, plan.k, vectors=index.vectors
            )
        backend = self._nav_backend(plan.nav)
        return brute_force_topk(
            queries, ctx.match_ids, plan.k, vectors=None,
            backend=backend, reprs=self.encode(plan, queries),
        )

    # -- invalidation ------------------------------------------------------

    def invalidate(self, *, nav: str) -> int:
        """Evict every program and shape record whose plan navigates in
        ``nav``; returns the number of plans evicted.

        The targeted half of :meth:`QuIVerIndex.replan`: only the plans of
        the abandoned family are dropped, so every other plan keeps its
        program and sees zero retraces.  Evicted plans are rebuilt on next
        use (counted as misses, compensated out of the retrace audit).
        """
        victims = {p for p in self._programs if p.nav == nav}
        victims |= {p for p, _ in self._seen if p.nav == nav}
        for p in victims:
            self._programs.pop(p, None)
        evicted = {pb for pb in self._seen if pb[0].nav == nav}
        self._seen -= evicted
        self.invalidated_shapes += len(evicted)
        self.invalidated_plans += len(victims)
        return len(victims)

    # -- warmup & accounting ----------------------------------------------

    def warmup(
        self,
        plan: QueryPlan,
        ctx: PlanContext | None = None,
        *,
        buckets: tuple[int, ...] = (8,),
        with_escalation: bool = True,
    ) -> int:
        """Run ``plan`` (and its escalation stage) at each of the given
        query buckets; returns how many (stage, bucket) programs ran.
        Warmup traffic is excluded from hit/miss stats.

        The port compiles nothing, so warming a bucket is running the
        program there once.  The beam is row-independent and its cost is
        its hops, not its rows, so one stage's buckets run stacked in one
        batch, each bucket's rows as they would run alone: a warmup costs
        one beam a stage, not one a bucket.  Its results are dropped
        unread (no escalation runs from them)."""
        if plan.route == "brute":
            return 0
        index = self._index
        if ctx is None:
            ctx = PlanContext(start=int(index.medoid))
            if plan.filtered:
                n = index.sigs.words.shape[0]
                ctx.result_valid = torch.ones((n,), dtype=torch.bool,
                                              device=index.device)
        dim = index.sigs.dim
        ran = 0
        stages = [plan]
        if with_escalation and plan.adaptive:
            stages.append(plan.escalated())
        for stage in stages:
            rows = [min(b, stage.query_batch) for b in buckets]
            q = torch.zeros((sum(rows), dim), dtype=torch.float32,
                            device=index.device)
            args = self._args(stage, ctx, self.encode(stage, q), q)
            prog = self.program(stage)
            for size in rows:
                bucket = batch_bucket(size, stage.query_batch)
                self._seen.add((stage, bucket))
                prog.note(*args, bucket=bucket)
            prog.fun(*args)
            ran += len(rows)
        return ran

    def report(self) -> dict:
        """``memory_breakdown``-style serving report."""
        tr = trace.trace_report(self._tag)
        lookups = self.hits + self.misses
        return {
            "plans_compiled": len(self._programs),
            "plan_shapes": len(self._seen),
            "executions": self.executions,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / lookups if lookups else 1.0,
            "invalidated_plans": self.invalidated_plans,
            "trace_events": tr["total_traces"],
            "retraces": (tr["total_traces"] - len(self._seen)
                         - self.invalidated_shapes),
        }

    def trace_prefix(self) -> str:
        """This cache's trace-counter namespace (for snapshots)."""
        return self._tag
