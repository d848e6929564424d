"""The port's serving engine (``repro_torch.serve.engine.QueryEngine``)
against ``repro.serve.engine.QueryEngine``, on the CPU.

One JAX index is built per module (minilm-surrogate, N = 800, the build
and labels of ``tests/test_serve.py``: label 0 on ~half the rows, label 1
on ~1%, per-label entries) and carried to the port with
``convert.index_from_numpy``.  Each test drives both engines with the
same request script under the same scripted clock and holds them ticket
for ticket: status, degrade rungs, plan signature, latency and ids equal,
scores within 1e-6.  Covered: ``tests/test_serve.py``'s seven behaviours,
the per-tenant quota, a traffic script whose deadlines degrade and drop
requests from measured (scripted) latencies, ``stats_report`` without its
wall-clock keys, ``health_verdicts``, ``swap_index`` onto a frozen
``MutableQuIVerIndex`` and ``Retriever(engine=...)``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.index import QuIVerIndex as JaxIndex
from repro.core.vamana import BuildParams as JaxParams
from repro.obs import ObsHub as JaxHub
from repro.obs.metrics import MetricsRegistry as JaxRegistry
from repro.plan import resolve_plan as jresolve_plan
from repro.serve import engine as jengine
from repro.stream.mutable import MutableQuIVerIndex as JaxMutable
from repro_torch import convert
from repro_torch.data.datasets import make_dataset
from repro_torch.obs import MetricsRegistry, ObsHub
from repro_torch.plan import resolve_plan, trace
from repro_torch.serve import engine
from repro_torch.stream import MutableQuIVerIndex

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

N = 800
PARAMS = dict(m=6, ef_construction=32, prune_pool=32, chunk=128)


class StepClock:
    """A scripted clock: each read returns the current time, then moves
    it on by ``step`` seconds; ``t`` may also be set by hand."""

    def __init__(self, step: float = 0.0):
        self.t = 0.0
        self.step = step
        self.reads = 0

    def __call__(self):
        self.reads += 1
        now = self.t
        self.t += self.step
        return now


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    base, queries = make_dataset("minilm-surrogate", N, queries=24)
    index = JaxIndex.build(jnp.asarray(base), JaxParams(**PARAMS))
    rng = np.random.default_rng(0)
    member = np.stack([rng.random(N) < p for p in (0.5, 0.01)], axis=1)
    index.attach_labels([np.nonzero(m)[0].tolist() for m in member],
                        n_labels=2)
    index.build_label_entries(min_count=32)
    path = tmp_path_factory.mktemp("ref") / "served.npz"
    index.save(str(path))
    with np.load(path) as z:
        fields = dict(z)
    return {"index": index, "fields": fields,
            "queries": np.asarray(queries, np.float32)}


def _pair(ref, step=0.0, **kw):
    """(reference engine, port engine, their clocks) over fresh copies of
    the index (fresh plan caches), each with a registry of its own."""
    jclock, pclock = StepClock(step), StepClock(step)
    jindex = dataclasses.replace(ref["index"], _backends={},
                                 _plan_cache=None)
    pindex = convert.index_from_numpy(ref["fields"], "cpu")
    jeng = jengine.QueryEngine(jindex, clock=jclock,
                               obs=JaxHub(JaxRegistry()), **kw)
    peng = engine.QueryEngine(pindex, clock=pclock,
                              obs=ObsHub(MetricsRegistry()), **kw)
    return jeng, peng, jclock, pclock


def assert_same_tickets(jeng, peng, tickets, results=True):
    """Held ticket for ticket: the same fields and (unless collected
    already) the same results."""
    for t in tickets:
        jt, pt = jeng.ticket(t), peng.ticket(t)
        assert pt.status == jt.status, t
        assert pt.degraded == jt.degraded, t
        assert pt.tenant == jt.tenant, t
        assert pt.latency == jt.latency, t
        assert (pt.plan is None) == (jt.plan is None), t
        if jt.plan is not None:
            assert pt.plan.signature() == jt.plan.signature(), t
            assert dataclasses.asdict(pt.plan) == dataclasses.asdict(
                jt.plan), t
        if not results:
            continue
        jids, jscores = jeng.poll(t)
        ids, scores = peng.poll(t)
        np.testing.assert_array_equal(ids, np.asarray(jids), err_msg=t)
        np.testing.assert_allclose(scores, np.asarray(jscores), rtol=0,
                                   atol=1e-6, err_msg=str(t))


def _submit_both(jeng, peng, queries, **kw):
    t = jeng.submit(queries, **kw)
    assert peng.submit(queries, **kw) == t
    return t


def _pump_both(jeng, peng):
    n = jeng.pump()
    assert peng.pump() == n
    return n


# -- tests/test_serve.py's behaviours, held to the reference ----------------


def test_engine_matches_per_call_search(ref):
    jeng, peng, _, _ = _pair(ref, default_k=5, default_ef=32)
    q = ref["queries"][:6]
    jids, jscores = jeng.search(q)
    ids, scores = peng.search(q)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_allclose(scores, np.asarray(jscores), rtol=0,
                               atol=1e-6)
    ids_d, sc_d = peng.index.search(q, k=5, ef=32)
    np.testing.assert_array_equal(ids, ids_d)
    np.testing.assert_allclose(scores, sc_d, rtol=1e-6)
    assert_same_tickets(jeng, peng, [0], results=False)


def test_window_coalesces_same_plan_requests(ref):
    jeng, peng, _, _ = _pair(ref, default_k=5, default_ef=32)
    q = ref["queries"]
    ts = [_submit_both(jeng, peng, q[0]),
          _submit_both(jeng, peng, q[1:4]),
          _submit_both(jeng, peng, q[4:6])]
    assert _pump_both(jeng, peng) == 3
    assert peng.stats.windows == jeng.stats.windows == 1
    assert peng.stats.batches == jeng.stats.batches == 1
    assert_same_tickets(jeng, peng, ts)
    ids_d, _ = peng.index.search(q[:6], k=5, ef=32)
    np.testing.assert_array_equal(peng.poll(ts[1])[0], ids_d[1:4])


def test_singleton_stream_reuses_smallest_bucket(ref):
    jeng, peng, _, _ = _pair(ref, default_k=5, default_ef=32)
    assert peng.warmup(buckets=(8,)) == jeng.warmup(buckets=(8,))
    ts = []
    with trace.assert_no_retrace(peng.index.plans.trace_prefix(),
                                 "singleton request stream"):
        for q in ref["queries"][:6]:
            ts.append(_submit_both(jeng, peng, q))
            _pump_both(jeng, peng)
    assert_same_tickets(jeng, peng, ts)
    rep, jrep = peng.stats_report(), jeng.stats_report()
    assert rep["plan_retraces"] == jrep["plan_retraces"] == 0
    assert rep["requests"] == 6 and rep["done"] == 6


def test_deadline_degrades_ef_before_dropping(ref):
    jeng, peng, _, _ = _pair(ref, default_k=10, default_ef=64)
    for eng, resolve in ((jeng, jresolve_plan), (peng, resolve_plan)):
        plan, _ = resolve(eng.index, k=10, ef=64)
        eng._observe(plan, 10.0)           # plan "measured" at 10 s
    t = _submit_both(jeng, peng, ref["queries"][:2], deadline_ms=1000)
    _pump_both(jeng, peng)
    assert_same_tickets(jeng, peng, [t])
    tk = peng.ticket(t)
    assert tk.status == "done" and tk.degraded == 2
    assert tk.plan.ef == 16 and not tk.plan.adaptive
    assert peng.stats.degraded == 1 and peng.stats.dropped == 0
    ids_d, _ = peng.index.search(ref["queries"][:2], k=10, ef=16,
                                 adaptive=False)
    np.testing.assert_array_equal(peng.poll(t)[0], ids_d)


def test_brute_route_bypasses_degradation(ref):
    jeng, peng, _, _ = _pair(ref, default_k=5, default_ef=64)
    for eng, resolve in ((jeng, jresolve_plan), (peng, resolve_plan)):
        plan, _ = resolve(eng.index, k=5, ef=64, filter=1)
        assert plan.route == "brute"
        eng._observe(plan, 10.0)
    t = _submit_both(jeng, peng, ref["queries"][:2], filter=1,
                     deadline_ms=50)
    _pump_both(jeng, peng)
    assert_same_tickets(jeng, peng, [t])
    tk = peng.ticket(t)
    assert tk.status == "done" and tk.degraded == 0
    assert tk.plan.route == "brute"


def test_expired_request_is_dropped(ref):
    jeng, peng, jclock, pclock = _pair(ref, default_k=5, default_ef=32)
    t = _submit_both(jeng, peng, ref["queries"][:2], deadline_ms=5)
    jclock.t = pclock.t = 1.0              # budget long gone
    _pump_both(jeng, peng)
    assert_same_tickets(jeng, peng, [t])
    assert peng.ticket(t).status == "dropped"
    assert peng.stats.dropped == 1
    ids, scores = peng.result(t)
    assert (ids == -1).all() and np.isneginf(scores).all()


def test_mixed_filtered_unfiltered_window(ref):
    jeng, peng, _, _ = _pair(ref, default_k=5, default_ef=32)
    q = ref["queries"]

    def window():
        ts = [_submit_both(jeng, peng, q[:3]),
              _submit_both(jeng, peng, q[3:6], filter=0),
              _submit_both(jeng, peng, q[6:9], filter=1),
              _submit_both(jeng, peng, q[9:10], deadline_ms=60_000)]
        assert _pump_both(jeng, peng) == 4
        return ts

    ts = window()
    assert peng.stats.batches == jeng.stats.batches == 3
    assert peng.ticket(ts[1]).plan.filtered
    assert peng.ticket(ts[2]).plan.route == "brute"
    assert_same_tickets(jeng, peng, ts)
    with trace.assert_no_retrace(peng.index.plans.trace_prefix(),
                                 "second mixed window"):
        ts = window()
    assert_same_tickets(jeng, peng, ts)
    assert peng.stats_report()["plan_retraces"] == 0


# -- scripted traffic: quotas, measured degradation, drops ---------------------

def _untimed(report):
    """A stats report without what the wall clock decides: the lifecycle
    spans (the tracer's clock) and the plan cache's internals, whose
    program accounting is the port's own (it compiles nothing)."""
    out = {k: v for k, v in report.items()
           if k != "span_report" and not k.startswith(("plan_", "trace_"))}
    return out


def _traffic(jeng, peng, jclock, pclock, q):
    """Three tenants' requests in windows of six; every clock read moves
    both clocks on by 2 ms, so the latencies the engines measure (and the
    EWMA that degrades deadline requests) come from the script."""
    for eng in (jeng, peng):
        eng.set_quota("capped", qps=20.0, burst=3)
    ts = []
    for w in range(4):
        for i in range(6):
            row = (6 * w + i) % (len(q) - 2)
            kind = i % 3
            if kind == 0:
                ts.append(_submit_both(jeng, peng, q[row], tenant="rag"))
            elif kind == 1:
                ts.append(_submit_both(jeng, peng, q[row:row + 3],
                                       tenant="batch",
                                       deadline_ms=(11 if w % 2 else None)))
            else:
                ts.append(_submit_both(jeng, peng, q[row],
                                       tenant="capped"))
        if w == 3:
            jclock.t += 0.5                 # a late window: drops
            pclock.t += 0.5
        _pump_both(jeng, peng)
    return ts


def test_scripted_traffic_matches_reference(ref):
    jeng, peng, jclock, pclock = _pair(ref, step=0.002, default_k=5,
                                       default_ef=32)
    ts = _traffic(jeng, peng, jclock, pclock, ref["queries"])
    assert pclock.reads == jclock.reads
    assert_same_tickets(jeng, peng, ts)
    status = [peng.ticket(t).status for t in ts]
    assert set(status) == {"done", "rejected", "dropped"}
    assert all(peng.ticket(t).tenant == "capped"
               for t in ts if peng.ticket(t).status == "rejected")
    assert any(peng.ticket(t).degraded for t in ts)
    rep, jrep = peng.stats_report(), jeng.stats_report()
    assert _untimed(rep) == _untimed(jrep)
    assert rep["requests"] == rep["done"] + rep["dropped"] + rep["rejected"]
    for t in ts:
        if peng.ticket(t).status in ("rejected", "dropped"):
            ids, scores = peng.poll(t)
            assert (ids == -1).all() and np.isneginf(scores).all()


def test_quota_rejects_over_budget_without_starving_others(ref):
    jeng, peng, _, _ = _pair(ref, default_k=5, default_ef=32)
    for eng in (jeng, peng):
        eng.set_quota("greedy", qps=1.0, burst=2)
    ts = []
    for i in range(6):
        ts.append(_submit_both(jeng, peng, ref["queries"][i % 4],
                               tenant="greedy"))
        ts.append(_submit_both(jeng, peng, ref["queries"][i % 4],
                               tenant="modest"))
    _pump_both(jeng, peng)
    assert_same_tickets(jeng, peng, ts)
    rep = peng.tenants.report()
    assert rep == jeng.tenants.report()
    assert rep["tenants"]["greedy"]["rejected"] == 4
    assert rep["tenants"]["modest"]["rejected"] == 0


def test_health_verdicts_match_reference(ref):
    jeng, peng, _, _ = _pair(ref, default_k=5, default_ef=32)
    assert peng.health_verdicts() == jeng.health_verdicts() == {
        "recall_slo": "green"}
    jeng.index.graph_report(sample=64)
    peng.index.graph_report(sample=64)
    assert peng.health_verdicts() == jeng.health_verdicts()
    assert "graph" in peng.health_verdicts()
    for eng in (jeng, peng):
        eng.set_quota("t", qps=1e6, recall_slo=0.9)
        for _ in range(eng.tenants.recall_min_samples):
            eng.tenants.observe_recall("t", 0.5)
    assert peng.health_verdicts() == jeng.health_verdicts()
    assert peng.health_verdicts()["recall_slo"] == "red"


def test_swap_index_onto_a_frozen_mutable_index(ref):
    jeng, peng, _, _ = _pair(ref, default_k=5, default_ef=32)
    q = ref["queries"]
    dead = np.random.default_rng(3).choice(N, 60, replace=False)
    jmut = JaxMutable.from_index(jeng.index)
    pmut = MutableQuIVerIndex.from_index(peng.index)
    for mut in (jmut, pmut):
        mut.delete(dead)
        mut.consolidate()
    jfrozen, pfrozen = jmut.freeze(), pmut.freeze()
    jeng.swap_index(jfrozen, warmup=True)
    peng.swap_index(pfrozen, warmup=True)
    assert peng.index is pfrozen and pfrozen.plans.obs is peng.obs
    ts = [_submit_both(jeng, peng, q[i:i + 2]) for i in range(0, 8, 2)]
    _pump_both(jeng, peng)
    assert_same_tickets(jeng, peng, ts)
    ids_d, _ = pfrozen.search(q[:8], k=5, ef=32)
    np.testing.assert_array_equal(
        np.concatenate([peng.poll(t)[0] for t in ts]), ids_d)


def test_retriever_through_the_engine_matches_reference(ref):
    jeng, peng, _, _ = _pair(ref, default_k=5, default_ef=32)
    q = ref["queries"]
    docs = np.arange(N * 4, dtype=np.int32).reshape(N, 4)
    tokens = np.arange(6, dtype=np.int32)[:, None] * np.ones((1, 3),
                                                              np.int32)

    def embed(t):
        return q[np.asarray(t)[:, 0]]

    kw = dict(doc_tokens=docs, embed_fn=embed, k=3, ef=32)
    jret = jengine.Retriever(index=jeng.index, engine=jeng, **kw)
    pret = engine.Retriever(index=peng.index, engine=peng, **kw)
    direct = engine.Retriever(index=peng.index, **kw)
    got = pret.augment(tokens)
    np.testing.assert_array_equal(got, jret.augment(tokens))
    np.testing.assert_array_equal(got, direct.augment(tokens))
    np.testing.assert_array_equal(pret.augment(tokens, filter=0),
                                  jret.augment(tokens, filter=0))
    assert peng.stats.requests == jeng.stats.requests == 2
