"""The port's query plans (``repro_torch.plan``) against ``repro.plan``, on
the CPU.

One JAX index is built per module (minilm-surrogate, N = 800, the build of
``tests/test_plan.py``), given a coarse partition and labels (~0.5, ~0.1
and ~0.01 drawn as ``tests/test_filtered.py`` draws them, and two labels
that coincide on half the corpus, whose ``Not(Any(3, 4))`` estimates below
the selectivity floor but matches half the rows), and carried to the port
with ``convert.index_from_numpy``.  Held:

* ``QueryPlan`` semantics (equality, hashing, validation, derived stages,
  signatures) equal to the reference's;
* ``resolve_plan``: an equal plan (every field) and an equal context (the
  start, match set, mask and selectivity) for every route;
* ``search`` lowering to ``resolve_plan`` + ``plans.run``, with the
  reference's ids on the unfiltered, adaptive and ivf plans;
* the cache's hit/miss/retrace accounting equal to the reference's over one
  call sequence, program identity, zero retraces in steady state after
  ``warmup`` (the escalated stage too), one trace for a new bucket, and
  targeted invalidation after ``replan``;
* that padding a chunk to its bucket, as the reference does, would change
  no real row;
* the telemetry branch (stage, nav-trace and escalation metrics) equal to
  the reference's under a stub hub;
* archives with labels that cross-load both ways and resolve to the same
  plan and start.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import filter as jfilter
from repro import plan as jplan
from repro.core.index import QuIVerIndex as JaxIndex
from repro.core.vamana import BuildParams as JaxParams
from repro.obs.metrics import MetricsRegistry as JaxRegistry
from repro_torch import convert
from repro_torch import filter as pfilter
from repro_torch import plan
from repro_torch.core.beam import pad_rows
from repro_torch.core.index import QuIVerIndex
from repro_torch.data.datasets import make_dataset
from repro_torch.obs.metrics import MetricsRegistry, get_default_registry
from repro_torch.plan import trace

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

N = 800
PARAMS = dict(m=6, ef_construction=32, prune_pool=32, chunk=128)


def _labels(n):
    rng = np.random.default_rng(0)
    member = np.stack([rng.random(n) < p for p in (0.5, 0.1, 0.01)], axis=1)
    both = np.random.default_rng(8).random(n) < 0.5
    return [np.nonzero(m)[0].tolist() + ([3, 4] if b else [])
            for m, b in zip(member, both)]


def _fields(jindex, path):
    jindex.save(str(path))
    with np.load(path) as z:
        return dict(z)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    base, queries = make_dataset("minilm-surrogate", N, queries=12)
    index = JaxIndex.build(jnp.asarray(base), JaxParams(**PARAMS))
    index.build_ivf()
    index.attach_labels(_labels(N), n_labels=5)
    index.build_label_entries(min_count=32)
    fields = _fields(index, tmp_path_factory.mktemp("ref") / "planned.npz")
    return {"base": base, "queries": queries, "index": index,
            "fields": fields}


def _port(ref):
    """A fresh port index (its own plan cache) over the reference's."""
    return convert.index_from_numpy(ref["fields"], "cpu")


def _jax(ref):
    """The reference index with a fresh plan cache."""
    return dataclasses.replace(ref["index"], _backends={},
                               _plan_cache=None)


def _port_expr(expr):
    if expr is None or isinstance(expr, int):
        return expr
    if isinstance(expr, jfilter.Label):
        return pfilter.Label(expr.label)
    if isinstance(expr, jfilter.Not):
        return pfilter.Not(_port_expr(expr.expr))
    cls = pfilter.Any if isinstance(expr, jfilter.Any) else pfilter.All
    return cls(*map(_port_expr, expr.items))


# -- plan key semantics ------------------------------------------------------

PLANS = [
    dict(nav="bq2", k=10, ef=64),
    dict(nav="bq2", k=10, ef=64, adaptive=True, escalate_mult=4),
    dict(nav="bq1", k=5, ef=40, expand=4, rerank=False, filtered=True),
    dict(nav="ivf", k=10, ef=128, route="ivf", probes=9, adaptive=True),
    dict(nav="ivf", k=10, ef=12, route="ivf", probes=1),
    dict(nav="bq2", k=10, ef=4, route="brute"),
]


@pytest.mark.parametrize("kw", PLANS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_plan_stages_match_reference(kw):
    got, want = plan.QueryPlan(**kw), jplan.QueryPlan(**kw)
    assert got == plan.QueryPlan(**kw) and hash(got) == hash(
        plan.QueryPlan(**kw))
    assert got.signature() == want.signature()
    assert got.min_ef == want.min_ef
    assert dataclasses.asdict(got.escalated()) == dataclasses.asdict(
        want.escalated())
    ladder, jladder = [got], [want]
    while ladder[-1].can_degrade():
        assert jladder[-1].can_degrade()
        ladder.append(ladder[-1].degraded())
        jladder.append(jladder[-1].degraded())
    assert not jladder[-1].can_degrade()
    assert [dataclasses.asdict(p) for p in ladder] == [
        dataclasses.asdict(p) for p in jladder]
    assert ladder[-1].degraded() == ladder[-1]


@pytest.mark.parametrize("kw", [
    dict(nav="bq2", k=10, ef=64, route="teleport"),
    dict(nav="bq2", k=10, ef=4),
    dict(nav="bq2", k=10, ef=64, expand=65),
    dict(nav="ivf", k=10, ef=64, route="ivf"),
    dict(nav="bq2", k=0, ef=64),
])
def test_plan_validation_matches_reference(kw):
    with pytest.raises(ValueError) as want:
        jplan.QueryPlan(**kw)
    with pytest.raises(ValueError) as got:
        plan.QueryPlan(**kw)
    assert str(got.value) == str(want.value)


def test_plan_context_defaults():
    ctx = plan.PlanContext()
    assert ctx.start == 0
    assert ctx.result_valid is None and ctx.match_ids is None
    assert ctx.selectivity is None


# -- resolve_plan ------------------------------------------------------------

RESOLVE = {
    "unfiltered": {},
    "graph_0.5": {"filter": 0},
    "graph_0.1": {"filter": 1},
    "brute_0.01": {"filter": 2},
    "brute_rerank_off": {"filter": 2, "rerank": False},
    "not_of_union": {"filter": jfilter.Not(jfilter.Any(3, 4))},
    "all": {"filter": jfilter.All(0, 1), "expand": 2},
    "ivf": {"nav": "ivf"},
    "ivf_filtered": {"nav": "ivf", "filter": 1},
    "ivf_probes": {"nav": "ivf", "filter": 0, "probes": 3},
    "adaptive": {"adaptive": True},
    "adaptive_filtered": {"adaptive": True, "filter": 0, "nav": "bq1"},
    "floor": {"filter": 1, "selectivity_floor": 0.2},
}


@pytest.mark.parametrize("case", list(RESOLVE))
def test_resolve_plan_matches_reference(ref, case):
    kw = {"k": 10, "ef": 48, **RESOLVE[case]}
    want, jctx = jplan.resolve_plan(_jax(ref), **kw)
    got, ctx = plan.resolve_plan(
        _port(ref), **{**kw, "filter": _port_expr(kw.get("filter"))})
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert ctx.start == jctx.start
    assert ctx.selectivity == jctx.selectivity
    for name in ("match_ids", "result_valid"):
        a, b = getattr(ctx, name), getattr(jctx, name)
        assert (a is None) == (b is None), name
        if a is not None:
            a = a.numpy() if isinstance(a, torch.Tensor) else a
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    if case == "not_of_union":
        # the estimate falls below the floor; the exact count reroutes
        store = _port(ref).labels
        est = pfilter.estimate_selectivity(_port_expr(kw["filter"]),
                                           store.count_fn(), N)
        assert est < pfilter.DEFAULT_SELECTIVITY_FLOOR
        assert got.route == "graph" and ctx.selectivity > 0.3


def test_resolution_telemetry_lands_in_the_registry(ref):
    reg = get_default_registry()
    counter = reg.counter("quiver_plan_resolutions_total",
                          labels=("route", "filtered", "nav"))
    before = counter.value(route="brute", filtered="false", nav="bq2")
    plan.resolve_plan(_port(ref), k=10, ef=48, filter=2)
    assert counter.value(route="brute", filtered="false",
                         nav="bq2") == before + 1


# -- search lowers to plans.run ----------------------------------------------


def test_search_lowers_to_plan_run(ref):
    port, q = _port(ref), ref["queries"]
    ids_a, sc_a = port.search(q, k=10, ef=48)
    p, ctx = plan.resolve_plan(port, k=10, ef=48)
    ids_b, sc_b = port.plans.run(p, ctx, q)
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_array_equal(sc_a, sc_b)


@pytest.mark.parametrize("kw", [
    {}, {"rerank": False}, {"adaptive": True, "ef": 16},
    {"nav": "ivf", "rerank": False}, {"nav": "bq1", "expand": 2},
], ids=lambda kw: "-".join(f"{k}{v}" for k, v in kw.items()) or "plain")
def test_plans_run_matches_reference(ref, kw):
    kw = {"k": 10, "ef": 48, **kw}
    jindex, port, q = _jax(ref), _port(ref), ref["queries"]
    jids, jscores = jindex.search(jnp.asarray(q), **kw)
    ids, scores = port.search(q, **kw)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_allclose(scores, np.asarray(jscores), rtol=0,
                               atol=1e-6)


# -- cache accounting --------------------------------------------------------


def test_same_config_same_program(ref):
    port = _port(ref)
    p1, _ = plan.resolve_plan(port, k=10, ef=64)
    p2, _ = plan.resolve_plan(port, k=10, ef=64)
    assert p1 == p2
    assert port.plans.program(p1) is port.plans.program(p2)
    p3, _ = plan.resolve_plan(port, k=10, ef=48)
    assert port.plans.program(p3) is not port.plans.program(p1)
    # one selectivity band, one plan and program
    pa, ca = plan.resolve_plan(port, k=10, ef=64, filter=0)
    pb, cb = plan.resolve_plan(port, k=10, ef=64, filter=0)
    assert pa.route == "graph" and pa.filtered and pa == pb
    assert port.plans.program(pa) is port.plans.program(pb)
    assert ca.start == cb.start
    with pytest.raises(ValueError, match="brute"):
        port.plans.program(plan.resolve_plan(port, k=10, ef=64,
                                             filter=2)[0])


def _sequence(index, queries, resolve, to_array):
    """One call sequence over a fresh cache: warmup, steady traffic, a new
    bucket, a filtered plan, a brute plan and an adaptive plan."""
    p, ctx = resolve(index, k=10, ef=48)
    index.plans.warmup(p, buckets=(8, 32))
    for nq in (1, 3, 8, 12, 5, 1, 12):
        index.plans.run(p, ctx, to_array(queries[:nq]))
    index.plans.run(p, ctx, to_array(np.tile(queries, (4, 1))))  # 48: 128
    for kw in ({"filter": 0}, {"filter": 2}, {"adaptive": True, "ef": 16}):
        pk, ck = resolve(index, k=10, ef=kw.pop("ef", 48), **kw)
        index.plans.run(pk, ck, to_array(queries))
        index.plans.run(pk, ck, to_array(queries[:3]))
    return index.plans.report()


def test_hit_miss_and_retrace_counts_match_reference(ref):
    want = _sequence(_jax(ref), ref["queries"], jplan.resolve_plan,
                     jnp.asarray)
    got = _sequence(_port(ref), ref["queries"],
                    lambda idx, **kw: plan.resolve_plan(
                        idx, **{**kw, "filter": _port_expr(
                            kw.get("filter"))}),
                    lambda a: a)
    assert got == want
    assert got["retraces"] == 0 and got["misses"] > 0


def test_steady_state_zero_retraces(ref):
    port, q = _port(ref), ref["queries"]
    p, ctx = plan.resolve_plan(port, k=10, ef=64)
    port.plans.warmup(p, buckets=(8, 32))
    misses_before = port.plans.misses
    with trace.assert_no_retrace(port.plans.trace_prefix(),
                                 "steady-state search"):
        for nq in (1, 3, 8, 12, 5, 1, 12):
            port.plans.run(p, ctx, q[:nq])
    assert port.plans.report()["retraces"] == 0
    assert port.plans.misses == misses_before
    # a new bucket is one first run (one trace), then steady again
    snap = trace.snapshot(port.plans.trace_prefix())
    port.plans.run(p, ctx, np.tile(q, (4, 1)))           # 48 rows: 128
    port.plans.run(p, ctx, np.tile(q, (3, 1)))           # 36 rows: 128
    assert snap.delta() == 1
    assert port.plans.report()["retraces"] == 0
    with pytest.raises(AssertionError, match="expected 0 retraces, got 1"):
        with trace.assert_no_retrace(port.plans.trace_prefix()):
            port.plans.run(p, ctx, np.tile(q, (11, 1)))  # 132 rows: 256


def test_warmup_runs_the_escalation_stage(ref):
    port, q = _port(ref), ref["queries"]
    p, ctx = plan.resolve_plan(port, k=10, ef=16, adaptive=True)
    assert p.adaptive
    assert port.plans.warmup(p, buckets=(8, 32)) == 4
    assert p.escalated() in port.plans._programs
    with trace.assert_no_retrace(port.plans.trace_prefix(),
                                 "adaptive two-stage search"):
        port.plans.run(p, ctx, q)


def test_invalidate_after_replan_matches_reference(ref):
    reports = []
    for index, resolve in ((_jax(ref), jplan.resolve_plan),
                           (_port(ref), plan.resolve_plan)):
        q = ref["queries"]
        q = jnp.asarray(q) if isinstance(index, JaxIndex) else q
        for nav in (None, "adc"):
            p, ctx = resolve(index, k=10, ef=32, nav=nav)
            index.plans.run(p, ctx, q)
        kept = index.plans.program(resolve(index, k=10, ef=32,
                                           nav="adc")[0])
        policy = index.replan(nav="adc")
        assert policy.nav == "adc" and policy.source == "replan"
        # the abandoned family's plans go, the others' programs stay
        p, ctx = resolve(index, k=10, ef=32)
        assert p.nav == "adc" and index.plans.program(p) is kept
        index.plans.run(p, ctx, q)
        p, ctx = resolve(index, k=10, ef=32, nav="bq2")
        index.plans.run(p, ctx, q)
        reports.append(index.plans.report())
    want, got = reports
    assert got == want
    assert got["invalidated_plans"] == 1 and got["retraces"] == 0
    with pytest.raises(ValueError, match="build_ivf"):
        dataclasses.replace(_port(ref), ivf=None).replan(nav="ivf")


# -- no padding --------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"filter": 1}, {"nav": "ivf"}],
                         ids=["graph", "filtered", "ivf"])
def test_padding_would_change_no_real_row(ref, kw):
    """The reference pads a chunk to its bucket by repeating the last row;
    the port runs the real rows only.  Every output of the real rows is
    the same either way, and with other rows stacked under them."""
    port, q = _port(ref), ref["queries"][:5]
    p, ctx = plan.resolve_plan(port, k=10, ef=32, **kw)
    queries = torch.from_numpy(q)
    queries = queries / queries.norm(dim=1, keepdim=True)
    reprs = port.plans.encode(p, queries)
    real = port.plans._launch(p, ctx, queries, reprs, False).chunks[0]
    padded = port.plans._launch(p, ctx, pad_rows(queries, 8),
                                pad_rows(reprs, 8), False).chunks[0]
    assert real[-1] == 5 and padded[-1] == 8
    for a, b in zip(real[:4], padded[:4]):
        if a is not None:
            assert torch.equal(a, b[:5])
    # nor would stacking other rows under them, as warmup stacks buckets
    q2 = torch.from_numpy(ref["queries"][5:])
    q2 = q2 / q2.norm(dim=1, keepdim=True)
    stacked = port.plans._launch(
        p, ctx, torch.cat([queries, q2]),
        torch.cat([reprs, port.plans.encode(p, q2)]), False).chunks[0]
    for a, b in zip(real[:4], stacked[:4]):
        if a is not None:
            assert torch.equal(a, b[:5])


# -- telemetry ---------------------------------------------------------------


class _Tracer:
    """A clock that ticks one second a reading, and recorded spans."""

    def __init__(self):
        self.now = 0.0
        self.spans = []

    def clock(self):
        self.now += 1.0
        return self.now

    @contextlib.contextmanager
    def span(self, name, **attrs):
        self.spans.append((name, attrs))
        yield


class _Hub:
    def __init__(self, registry):
        self.registry = registry
        self.tracer = _Tracer()


def test_obs_branch_matches_reference(ref):
    """Stage timings, per-query nav traces and the escalation counter and
    span, under a stub hub, equal to the reference's."""
    hubs = []
    for index, resolve, registry, to_array in (
            (_jax(ref), jplan.resolve_plan, JaxRegistry(), jnp.asarray),
            (_port(ref), plan.resolve_plan, MetricsRegistry(),
             lambda a: a)):
        hub = _Hub(registry)
        index.plans.obs = hub
        p, ctx = resolve(index, k=10, ef=16, adaptive=True)
        pending = index.plans.launch(p, ctx, to_array(ref["queries"]))
        index.plans.finalize(pending)
        hubs.append((hub, pending.nav))
    (jhub, jnav), (hub, nav) = hubs
    np.testing.assert_array_equal(nav, jnav)
    assert hub.tracer.spans == jhub.tracer.spans
    assert hub.tracer.spans and hub.tracer.spans[0][0] == "escalate"
    assert hub.registry.snapshot() == jhub.registry.snapshot()


# -- the trace module --------------------------------------------------------


def test_counting_program_keys_on_bucket_mask_and_dtypes():
    calls = []
    prog = trace.counting_program(lambda *a: calls.append(a) or len(calls),
                                  "plan[test]:prog")
    rows = [torch.zeros((n, 4), dtype=torch.int32) for n in (3, 5, 8)]
    snap = trace.snapshot("plan[test]:")
    for r in rows:                           # three row counts, one bucket
        prog(r, None, bucket=8)
    assert snap.delta() == 1
    prog(rows[0], torch.ones(7, dtype=torch.bool), bucket=8)   # a mask
    prog(rows[0].float(), None, bucket=8)                      # a dtype
    prog(rows[0], None, bucket=32)                             # a bucket
    assert snap.delta() == 4 and len(calls) == 6
    assert trace.trace_report("plan[test]:")["programs"] == {
        "plan[test]:prog": 4}
    assert get_default_registry().counter(
        "quiver_jit_traces_total", labels=("program",)).value(
            program="plan[test]:prog") == 4
    trace.reset("plan[test]:")
    assert trace.total_traces("plan[test]:") == 0


# -- archives ----------------------------------------------------------------


def test_archives_with_labels_cross_load(ref, tmp_path):
    jindex, fields = _jax(ref), ref["fields"]
    want, jctx = jplan.resolve_plan(jindex, k=10, ef=64, filter=0)
    # the reference's archive, loaded by the port
    path = tmp_path / "jax.npz"
    np.savez_compressed(path, **fields)
    port = QuIVerIndex.load(str(path), device="cpu")
    got, ctx = plan.resolve_plan(port, k=10, ef=64, filter=0)
    assert got == plan.QueryPlan(**dataclasses.asdict(want))
    assert ctx.start == jctx.start != port.medoid
    assert port.memory_breakdown() == jindex.memory_breakdown()
    back = convert.index_to_numpy(port)
    assert set(back) == set(fields)
    for key in (k for k in fields if k.startswith("label_")):
        np.testing.assert_array_equal(back[key], fields[key], err_msg=key)
        assert back[key].dtype == fields[key].dtype, key
    # the port's archive, loaded by the reference
    path = tmp_path / "port.npz"
    port.save(str(path))
    loaded = JaxIndex.load(str(path))
    lplan, lctx = jplan.resolve_plan(loaded, k=10, ef=64, filter=0)
    assert lplan == want and lctx.start == jctx.start
    np.testing.assert_array_equal(loaded.labels.entries,
                                  jindex.labels.entries)
    ids_a, _ = port.search(ref["queries"], k=10, ef=64, filter=0)
    ids_b, _ = loaded.search(jnp.asarray(ref["queries"]), k=10, ef=64,
                             filter=0)
    np.testing.assert_array_equal(ids_a, np.asarray(ids_b))
    assert port.plans is not QuIVerIndex.load(str(path), "cpu").plans
