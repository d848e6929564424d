"""The port's telemetry (``repro_torch.obs``: tracing, tenants, sinks, hub,
shadow recall, remediation) against ``repro.obs``, on the CPU.

Each test runs the same operations through both packages and holds the
results equal: spans and their report under one scripted clock, token
buckets and the tenant ledger (quota, attribution, navigation traces,
recall-SLO breach events), the Prometheus text of the same registry
operations, ``JsonlSink`` files with rotation, ``health_snapshot``,
``sinks_from_env``/``autostart`` under the same environments (the port's
endpoint bound to 127.0.0.1, port 0, and read back), ``shadow_hash``,
the shadow sampler's sampled rows and drained recalls, and the
remediation ladder's events for drift, recall-SLO and graph triggers.
The shadow and remediation tests serve one JAX index (minilm-surrogate,
N = 800) carried to the port with ``convert.index_from_numpy``.
"""

import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.core.index import QuIVerIndex as JaxIndex
from repro.core.vamana import BuildParams as JaxParams
from repro.obs import graph as jgraph
from repro.obs import hub as jhub
from repro.obs import quality as jquality
from repro.obs import sinks as jsinks
from repro.obs import tenant as jtenant
from repro.obs import tracing as jtracing
from repro.serve import engine as jengine
import repro_torch.obs as pobs
from repro_torch import convert
from repro_torch.data.datasets import make_dataset
from repro_torch.obs import graph as pgraph
from repro_torch.obs import hub as phub
from repro_torch.obs import quality as pquality
from repro_torch.obs import sinks as psinks
from repro_torch.obs import tenant as ptenant
from repro_torch.obs import tracing as ptracing
from repro_torch.serve import engine as pengine

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

N = 800
PARAMS = dict(m=6, ef_construction=32, prune_pool=32, chunk=128)


class StepClock:
    """A scripted clock: each read returns the current time, then moves
    it on by ``step`` seconds."""

    def __init__(self, step: float = 0.0):
        self.t = 0.0
        self.step = step

    def __call__(self):
        now = self.t
        self.t += self.step
        return now


def test_port_exports_what_the_reference_exports():
    assert sorted(pobs.__all__) == sorted(jobs.__all__)
    for name in pobs.__all__:
        obj = getattr(pobs, name)
        if callable(obj):
            assert obj.__module__.startswith("repro_torch"), name
    assert pobs.ACTIONS == jobs.ACTIONS
    assert pobs.DEFAULT_RATE == jobs.DEFAULT_RATE
    assert pobs.DEFAULT_TENANT == jobs.DEFAULT_TENANT


# -- tracing -----------------------------------------------------------------


def _trace_script(mod, registry_cls):
    reg = registry_cls()
    tracer = mod.Tracer(reg, max_spans=4, clock=StepClock(0.25))
    ids = [tracer.new_trace() for _ in range(3)]
    with tracer.span("launch", ids[0], plan="bq2|k10", queries=8):
        pass
    tracer.record(mod.Span("admission", ids[1], 0.5, end=1.0,
                           attrs={"tenant": "rag"}))
    tracer.record(mod.Span("request", ids[2], 0.0))
    with pytest.raises(RuntimeError):
        with tracer.span("finalize", ids[2]):
            raise RuntimeError("a failing stage is still recorded")
    for _ in range(2):
        with tracer.span("window"):
            pass
    return tracer, reg, ids


def test_tracer_spans_and_report_match_reference():
    from repro.obs.metrics import MetricsRegistry as JaxRegistry
    from repro_torch.obs.metrics import MetricsRegistry

    jt, jreg, jids = _trace_script(jtracing, JaxRegistry)
    pt, preg, pids = _trace_script(ptracing, MetricsRegistry)
    assert pids == jids
    assert [s.to_dict() for s in pt.spans()] == [
        s.to_dict() for s in jt.spans()]
    assert len(pt.spans()) == 4                       # the bounded ring
    assert [s.to_dict() for s in pt.spans(name="window")] == [
        s.to_dict() for s in jt.spans(name="window")]
    assert pt.report() == jt.report()
    assert psinks.render_prometheus(preg) == jsinks.render_prometheus(jreg)


# -- tenants -------------------------------------------------------------------


def test_token_bucket_matches_reference():
    takes = []
    for mod in (jtenant, ptenant):
        b = mod.TokenBucket(mod.TenantQuota(qps=2.0, burst=4), 0.0)
        got = [b.take(1, 0.0) for _ in range(5)]
        got += [b.take(2, 1.0), b.take(1, 1.0), b.take(0.5, 1.3)]
        takes.append((got, b.tokens, b.stamp))
    assert takes[0] == takes[1]
    assert takes[1][0] == [True] * 4 + [False, True, False, True]


def _ledger_script(mod, registry):
    clock = StepClock(0.05)
    led = mod.TenantLedger(registry=registry, clock=clock,
                           recall_min_samples=4)
    events = []
    led.subscribe(events.append)
    led.set_quota("paid", qps=4.0, burst=2)
    led.set_quota("slo", qps=1e6, recall_slo=0.8)
    admitted = [led.admit("paid", 1) for _ in range(5)]
    admitted += [led.admit("free", 3) for _ in range(3)]
    admitted.append(led.admit("paid", 2, now=10.0))
    led.observe("paid", status="done", latency=0.01)
    led.observe("free", status="dropped", latency=0.5, degraded=True)
    led.observe("slo", status="done", latency=0.02, degraded=True)
    led.observe_nav("paid", {"hops": np.array([3.0, 5.0, 4.0]),
                             "evals": np.array([40.0, 52.0, 47.0])})
    breached = [led.observe_recall("slo", r)
                for r in (0.9, 0.5, 0.6, 0.7, 0.4, 0.95, 0.99, 0.97, 0.98,
                          0.3, 0.2, 0.1, 0.2, 0.2)]
    breached.append(led.observe_recall("free", 0.1))
    with pytest.raises(ValueError):
        led.observe("paid", status="lost")
    return led.report(), admitted, breached, events


def test_ledger_matches_reference_under_one_clock():
    from repro.obs.metrics import MetricsRegistry as JaxRegistry
    from repro_torch.obs.metrics import MetricsRegistry

    jreg, preg = JaxRegistry(), MetricsRegistry()
    want = _ledger_script(jtenant, jreg)
    got = _ledger_script(ptenant, preg)
    assert got == want
    report, admitted, breached, events = got
    assert report["tenants"]["paid"]["rejected"] >= 1
    assert report["quota_violations"] == 0
    assert [e["kind"] for e in events] == ["recall_slo", "recall_slo"]
    assert psinks.render_prometheus(preg) == jsinks.render_prometheus(jreg)


# -- sinks and the hub -----------------------------------------------------------


def _registry_ops(registry):
    c = registry.counter("quiver_a_total", "a counter", labels=("tenant",))
    c.inc(tenant="x")
    c.inc(3, tenant='we"ird\\')
    g = registry.gauge("quiver_b", "a gauge")
    g.set(2.5)
    h = registry.histogram("quiver_c_seconds", "a histogram",
                           labels=("stage",), buckets=(0.001, 0.01, 0.1),
                           window=8)
    for v in (0.0005, 0.02, 0.5, 0.05):
        h.observe(v, stage="launch")
    h.observe_many(np.array([0.002, 0.003]), stage="finalize")
    registry.counter("quiver_d_total")
    return registry


def test_render_prometheus_matches_reference():
    from repro.obs.metrics import MetricsRegistry as JaxRegistry
    from repro_torch.obs.metrics import MetricsRegistry

    want = jsinks.render_prometheus(_registry_ops(JaxRegistry()))
    got = psinks.render_prometheus(_registry_ops(MetricsRegistry()))
    assert got == want
    assert 'quiver_c_seconds_bucket{stage="launch",le="+Inf"} 4' in got


def _jsonl_files(mod, root):
    sink = mod.JsonlSink(root / "obs.jsonl", max_bytes=120, keep=2)
    for i in range(7):
        sink.emit({"i": i, "x": np.float32(0.5), "tag": "a" * (5 * i),
                   "obj": object.__name__})
    sink.close()
    sink.close()
    sink.emit({"late": True})            # after close: dropped
    return {p.name: p.read_text() for p in sorted(root.iterdir())}


def test_jsonl_sink_lines_match_reference(tmp_path):
    want = _jsonl_files(jsinks, tmp_path / "ref")
    got = _jsonl_files(psinks, tmp_path / "port")
    assert got == want
    assert set(got) == {"obs.jsonl", "obs.jsonl.1", "obs.jsonl.2"}
    with pytest.raises(ValueError) as jerr:
        jsinks.JsonlSink(tmp_path / "x.jsonl", keep=0)
    with pytest.raises(ValueError) as perr:
        psinks.JsonlSink(tmp_path / "y.jsonl", keep=0)
    assert str(perr.value) == str(jerr.value)


def _boom():
    raise RuntimeError("probe crashed")


@pytest.mark.parametrize("health_fn", [
    None, lambda: {}, lambda: {"graph": "green", "drift": "amber"},
    lambda: {"graph": "red", "recall_slo": "green"}, _boom,
], ids=["none", "empty", "amber", "red", "crash"])
def test_health_snapshot_matches_reference(health_fn):
    got = psinks.health_snapshot(health_fn)
    assert got == jsinks.health_snapshot(health_fn)
    record, status = got
    assert status == (503 if record["verdict"] == "red" else 200)


def _describe(sinks):
    return [(type(s).__name__, getattr(s, "max_bytes", None),
             getattr(s, "keep", None)) for s in sinks]


@pytest.mark.parametrize("env", [
    {},
    {"REPRO_OBS_STDOUT": "1"},
    {"REPRO_OBS_JSONL": "{dir}/a.jsonl", "REPRO_OBS_JSONL_MAX_BYTES": "4096",
     "REPRO_OBS_JSONL_KEEP": "5", "REPRO_OBS_STDOUT": "0"},
    {"REPRO_OBS_JSONL": "{dir}/b.jsonl", "REPRO_OBS_STDOUT": "1",
     "REPRO_OBS_INTERVAL_S": "30"},
], ids=["bare", "stdout", "jsonl", "both"])
def test_sinks_from_env_and_autostart_match_reference(env, tmp_path):
    made = {}
    for name, mod, hmod in (("ref", jsinks, jhub), ("port", psinks, phub)):
        e = {k: v.format(dir=tmp_path / name) for k, v in env.items()}
        sinks = mod.sinks_from_env(e)
        hub = hmod.ObsHub(sinks=sinks)
        reporter, server = hmod.autostart(hub, env=e)
        try:
            made[name] = (_describe(sinks), reporter is not None,
                          server is not None,
                          reporter.interval if reporter else None)
        finally:
            if reporter is not None:
                reporter.stop()
                reporter.stop()             # idempotent
            hub.close()
            hub.close()                     # idempotent (atexit again)
    assert made["port"] == made["ref"]


def test_autostart_serves_metrics_and_healthz_on_localhost():
    from repro_torch.obs.metrics import MetricsRegistry

    reg = _registry_ops(MetricsRegistry())
    hub = phub.ObsHub(registry=reg)
    reporter, server = phub.autostart(
        hub, env={"REPRO_METRICS_PORT": "0"},
        health_fn=lambda: {"graph": "amber"})
    try:
        assert reporter is None and server is not None
        base = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            assert r.read().decode() == psinks.render_prometheus(reg)
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert json.loads(r.read()) == {
                "verdict": "amber", "components": {"graph": "amber"}}
    finally:
        server.close()
        hub.close()
    record = hub.emit({"extra": 1})
    assert set(record) == {"unix_ts", "metrics", "spans", "extra"}


# -- shadow recall -----------------------------------------------------------


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    base, queries = make_dataset("minilm-surrogate", N, queries=64)
    index = JaxIndex.build(jnp.asarray(base), JaxParams(**PARAMS))
    path = tmp_path_factory.mktemp("ref") / "served.npz"
    index.save(str(path))
    with np.load(path) as z:
        fields = dict(z)
    return {"index": index, "fields": fields,
            "queries": np.asarray(queries, np.float32)}


def _indexes(ref):
    return (dataclasses.replace(ref["index"], _backends={},
                                _plan_cache=None),
            convert.index_from_numpy(ref["fields"], "cpu"))


def test_shadow_hash_matches_reference(ref):
    rows = [ref["queries"][i] for i in range(16)]
    rows += [np.float64(ref["queries"][0]), ref["queries"][0].tolist(),
             np.zeros(7, np.float32)]
    for q in rows:
        assert pquality.shadow_hash(q) == jquality.shadow_hash(q)
        for rate in (1, 2, 8, 256):
            assert pquality.should_sample(q, rate) == \
                jquality.should_sample(q, rate)


def _shadow_run(mod, index, queries, registry):
    from repro.obs.tenant import TenantLedger as JaxLedger
    from repro_torch.obs.tenant import TenantLedger

    ledger = (JaxLedger if mod is jquality else TenantLedger)(
        registry=registry)
    sampler = mod.ShadowSampler(index, rate=4, k=5, registry=registry,
                                ledger=ledger, max_pending=12)
    served = np.argsort(-queries @ np.asarray(index.vectors).T, axis=1)
    served[::3, 2] = served[::3, 40]     # some served lists miss a hit
    taken = []
    for s in range(0, len(queries), 8):
        taken.append(sampler.offer(queries[s:s + 8], served[s:s + 8, :5],
                                   tenant=f"t{s % 3}", nav="bq2",
                                   stage="base"))
        if s == 24:
            drained = sampler.drain(max_rows=3)
    pending = [(q.tolist(), ids.tolist(), *rest)
               for q, ids, *rest in sampler.pending]
    drained += sampler.drain()
    rep = sampler.report()
    del rep["memory_bytes"]
    return taken, pending, drained, rep, sampler.memory_bytes() > 0, \
        ledger.report()


def test_shadow_sampler_matches_reference(ref):
    from repro.obs.metrics import MetricsRegistry as JaxRegistry
    from repro_torch.obs.metrics import MetricsRegistry

    jindex, pindex = _indexes(ref)
    q = ref["queries"]
    want = _shadow_run(jquality, jindex, q, JaxRegistry())
    got = _shadow_run(pquality, pindex, q, MetricsRegistry())
    assert got == want
    taken, _, drained, rep, _, _ = got
    assert rep["backlog_dropped"] > 0 and rep["drained"] == len(drained)
    assert {d["recall"] for d in drained} > {1.0}
    assert pindex.shadow is not None
    assert pindex.memory_breakdown()["host_shadow_bytes"] == \
        jindex.memory_breakdown()["host_shadow_bytes"]


def test_engine_shadow_lane_matches_reference(ref):
    jindex, pindex = _indexes(ref)
    from repro.obs import ObsHub as JaxHub
    from repro.obs.metrics import MetricsRegistry as JaxRegistry
    from repro_torch.obs import ObsHub
    from repro_torch.obs.metrics import MetricsRegistry

    engines = [
        jengine.QueryEngine(jindex, default_k=5, default_ef=32,
                            obs=JaxHub(JaxRegistry()),
                            shadow={"rate": 4}),
        pengine.QueryEngine(pindex, default_k=5, default_ef=32,
                            obs=ObsHub(MetricsRegistry()),
                            shadow={"rate": 4}),
    ]
    out = []
    for eng in engines:
        eng.set_quota("rag", qps=1e6, recall_slo=0.75)
        for s in range(0, 48, 6):
            eng.submit(ref["queries"][s:s + 6], tenant="rag")
            eng.submit(ref["queries"][s + 1], tenant="other")
            eng.pump()
        rep = eng.shadow.report()
        del rep["memory_bytes"]
        out.append((rep, list(eng.shadow.recalls.array()),
                    eng.tenants.report()["tenants"]["rag"]["recall_p50"],
                    eng.health_verdicts()))
    assert out[1] == out[0]
    assert out[1][0]["drained"] > 0 and out[1][0]["pending"] == 0


# -- remediation -------------------------------------------------------------


@dataclasses.dataclass
class Alarm:
    tenant: str = "default"
    band: str = "amber"
    stat: str = "sign_entropy"
    value: float = 0.3


class Monitor:
    """Anything with ``subscribe``: the policy attaches to it."""

    def __init__(self):
        self.subs = []

    def subscribe(self, fn):
        self.subs.append(fn)

    def fire(self, alarm):
        for fn in self.subs:
            fn(alarm)


def _events(policy):
    return [{k: v for k, v in e.items() if k != "unix_ts"}
            for e in policy.events]


def _remediate(ref, script):
    """The same trigger script through a policy over each package's
    engine; returns (reference events, port events, the engines)."""
    from repro.obs import ObsHub as JaxHub
    from repro.obs import RemediationPolicy as JaxPolicy
    from repro.obs.metrics import MetricsRegistry as JaxRegistry
    from repro_torch.obs import ObsHub, RemediationPolicy
    from repro_torch.obs.metrics import MetricsRegistry

    jindex, pindex = _indexes(ref)
    runs = []
    for eng_cls, hub, pol_cls, graph_mod, index in (
            (jengine.QueryEngine, JaxHub(JaxRegistry()), JaxPolicy, jgraph,
             jindex),
            (pengine.QueryEngine, ObsHub(MetricsRegistry()),
             RemediationPolicy, pgraph, pindex)):
        eng = eng_cls(index, default_k=5, default_ef=64, obs=hub)
        policy = pol_cls(eng, auto=True, clock=lambda: 0.0)
        drift = Monitor()
        policy.attach(drift)
        gmon = graph_mod.GraphHealthMonitor(registry=hub.registry,
                                            clock=lambda: 0.0)
        policy.attach_graph(gmon)
        script(eng, policy, drift, gmon, graph_mod)
        runs.append((_events(policy), policy.report(), eng))
    (jev, jrep, jeng), (pev, prep, peng) = runs
    for rep in (jrep, prep):
        rep.pop("events")
    assert pev == jev
    assert prep == jrep
    return pev, peng, jeng


def _breach(eng, tenant="batch"):
    """Arm ``tenant``'s recall SLO and feed it a window that breaches."""
    eng.set_quota(tenant, qps=1e6, recall_slo=0.999)
    for _ in range(eng.tenants.recall_min_samples):
        eng.tenants.observe_recall(tenant, 0.5)


def test_recall_slo_breach_on_a_green_corpus_escalates_ef(ref):
    """The action ``chip_smoke.py``'s engine phase gates on the card: a
    forced recall-SLO breach on a green corpus re-probes (green, the rung
    is already bq2) and escalates ef 64 -> 128."""
    def script(eng, policy, drift, gmon, graph_mod):
        _breach(eng)

    events, peng, _ = _remediate(ref, script)
    assert [e["action"] for e in events] == ["reprobe", "escalate_ef"]
    assert events[0]["verdict"] == "green"
    assert events[1]["ef"] == "64->128" and peng.default_ef == 128


def test_recall_slo_ladder_walks_to_red_and_resolves(ref):
    def script(eng, policy, drift, gmon, graph_mod):
        for i in range(5):
            _breach(eng, tenant=f"batch{i}")
        policy.resolve()
        _breach(eng, tenant="after")

    events, peng, jeng = _remediate(ref, script)
    assert [(e["action"], e.get("ef") or e.get("nav") or e.get("note"))
            for e in events if e["action"] != "reprobe"] == [
        ("escalate_ef", "64->128"), ("escalate_ef", "128->256"),
        ("escalate_ef", "256->512"),              # the cap: 8 x 64
        ("flag_red", "float32"), ("flag_red", "already red-flagged"),
        ("resolve", "operator resolve"),
        ("replan", "float32->bq2")]               # green again: back
    assert peng.index.policy.nav == jeng.index.policy.nav == "bq2"
    assert peng.default_ef == jeng.default_ef == 64


def test_drift_and_graph_triggers_match_reference(ref):
    def script(eng, policy, drift, gmon, graph_mod):
        drift.fire(Alarm())                        # green re-probe: false
        base = dict(n_live=100, n_allocated=100, degree_bound=8,
                    out_degree_mean=6.0, in_degree_mean=6.0,
                    saturation=0.1, reciprocity=0.3, n_unreachable=0,
                    unreachable_frac=0.0, hop_p50=2.0, hop_p99=4.0,
                    hop_max=5.0, tombstone_density=0.0,
                    edge_agreement=0.8, n_sampled=64, agreement_k=8,
                    seed=0)
        report = graph_mod.GraphHealthReport
        for tomb in (0.0, 0.3, 0.35, 0.7, 0.0, 0.3):
            gmon.check(report(**{**base, "tombstone_density": tomb}))

    events, _, _ = _remediate(ref, script)
    assert [(e["action"], e["trigger"]) for e in events] == [
        ("reprobe", "drift"), ("consolidate", "graph_health"),
        ("flag_red", "graph_health"), ("flag_red", "graph_health")]
    assert events[0]["note"] == "false alarm"
