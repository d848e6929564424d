"""The port's graph X-ray (``repro_torch.obs.graph``) against
``repro.obs.graph``, on the CPU.

One JAX index is built per module (minilm-surrogate, N = 800, the build of
``tests/test_graphhealth.py``: m = 8, so R = 16 and full rows carry the
2k edges the agreement probe samples) and carried to the port with
``convert.index_from_numpy``.  Held: the report from the same arrays
(immutable, tombstoned and consolidated) equal to the reference's, its
integer and host-side fields and verdict exactly and ``edge_agreement``
within 2 / (S k), where the float32 cosine sums in torch's order; the
port's ``_edge_agreement`` equal to the reference's on rows whose bq2
scores tie heavily (the tie rule: ``lax.top_k`` takes the lower position,
the port a stable descending sort); determinism under a seed; archives
with ``graph_*`` fields loading in both packages, immutable and
streaming; the medoid BFS flagging a cut component red; the monitor
alarming on worsenings only; and the remediation ladder walked once per
crossing, consolidation's re-X-ray included.
"""

import dataclasses
import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.index import QuIVerIndex as JaxIndex
from repro.core.vamana import BuildParams as JaxParams
from repro.obs import MetricsRegistry as JaxRegistry
from repro.obs import RemediationPolicy as JaxPolicy
from repro.obs import graph as jgraph
from repro.serve.engine import QueryEngine as JaxEngine
from repro.stream.mutable import MutableQuIVerIndex as JaxMutable
from repro_torch import convert
from repro_torch.core.index import QuIVerIndex
from repro_torch.data.datasets import contrastive_surrogate, make_dataset
from repro_torch.obs import MetricsRegistry, RemediationPolicy
from repro_torch.obs import graph as pgraph
from repro_torch.serve.engine import QueryEngine
from repro_torch.stream import MutableQuIVerIndex

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

N = 800
PARAMS = dict(m=8, ef_construction=48, prune_pool=48, chunk=256)
EXACT = ("n_live", "n_allocated", "degree_bound", "out_degree_mean",
         "in_degree_mean", "saturation", "reciprocity", "n_unreachable",
         "unreachable_frac", "hop_p50", "hop_p99", "hop_max",
         "tombstone_density", "n_sampled", "agreement_k", "seed",
         "out_degree_hist", "in_degree_hist")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    base, _ = make_dataset("minilm-surrogate", N, queries=4)
    index = JaxIndex.build(jnp.asarray(base), JaxParams(**PARAMS))
    path = tmp_path_factory.mktemp("ref") / "graph.npz"
    index.save(str(path))
    with np.load(path) as z:
        fields = dict(z)
    return {"index": index, "fields": fields}


def _indexes(ref):
    return (dataclasses.replace(ref["index"], _backends={},
                                _plan_cache=None, graph_health=None),
            convert.index_from_numpy(ref["fields"], "cpu"))


def assert_same_report(got, want):
    """Integer and host-side fields exact, the verdict exact, the edge
    agreement within 2 / (S k)."""
    for name in EXACT:
        assert getattr(got, name) == getattr(want, name), name
    assert dataclasses.asdict(got.thresholds) == dataclasses.asdict(
        want.thresholds)
    if math.isnan(want.edge_agreement):
        assert math.isnan(got.edge_agreement)
    else:
        tol = 2 / (want.n_sampled * want.agreement_k)
        assert abs(got.edge_agreement - want.edge_agreement) <= tol
    assert got.verdict == want.verdict
    assert got.worst_stat()[0] == want.worst_stat()[0]


def test_report_matches_reference(ref):
    jindex, pindex = _indexes(ref)
    want = jindex.graph_report(sample=64, seed=3,
                               registry=JaxRegistry())
    got = pindex.graph_report(sample=64, seed=3,
                              registry=MetricsRegistry())
    assert_same_report(got, want)
    assert pindex.graph_health is got
    assert not math.isnan(got.edge_agreement)
    assert got.n_sampled == 64 and got.n_unreachable == 0
    mem = pindex.memory_breakdown()
    assert mem["graph_verdict"] == jindex.memory_breakdown()["graph_verdict"]
    assert mem["graph_health_score"] == pytest.approx(
        got.health_score)


def test_report_without_vectors_is_structural(ref):
    jindex, pindex = _indexes(ref)
    kw = dict(medoid=pindex.medoid, sample=64)
    want = jgraph.graph_health_report(jindex.adjacency,
                                      registry=JaxRegistry(), **kw)
    got = pgraph.graph_health_report(pindex.adjacency,
                                     registry=MetricsRegistry(), **kw)
    assert_same_report(got, want)
    assert math.isnan(got.edge_agreement) and got.n_sampled == 0


def test_report_is_deterministic_under_a_seed(ref):
    _, pindex = _indexes(ref)
    kw = dict(medoid=pindex.medoid, words=pindex.sigs.words,
              dim=pindex.sigs.dim, vectors=pindex.vectors, sample=64,
              registry=MetricsRegistry())
    r1 = pgraph.graph_health_report(pindex.adjacency, seed=5, **kw)
    r2 = pgraph.graph_health_report(pindex.adjacency, seed=5, **kw)
    assert r1 == r2
    buf = io.BytesIO()
    np.savez(buf, **r1.to_npz_fields())
    buf.seek(0)
    assert pgraph.GraphHealthReport.from_npz(np.load(buf)) == r1


def _mutated(ref, consolidate):
    """The same deletes on a mutable copy in each package."""
    jindex, pindex = _indexes(ref)
    dead = np.random.default_rng(1).choice(N, 200, replace=False)
    muts = (JaxMutable.from_index(jindex),
            MutableQuIVerIndex.from_index(pindex))
    for mut in muts:
        mut.delete(dead)
        if consolidate:
            mut.consolidate()
    return muts


@pytest.mark.parametrize("consolidate", [False, True],
                         ids=["tombstoned", "consolidated"])
def test_report_matches_reference_on_a_mutated_graph(ref, consolidate):
    jmut, pmut = _mutated(ref, consolidate)
    want = jmut.graph_report(sample=64, registry=JaxRegistry())
    got = pmut.graph_report(sample=64, registry=MetricsRegistry())
    assert_same_report(got, want)
    assert got.n_live == N - 200
    assert got.tombstone_density == pytest.approx(
        0.0 if consolidate else 0.25)
    assert pmut.memory_breakdown()["graph_verdict"] == got.verdict


def test_edge_agreement_ties_go_to_the_lower_position():
    """Words drawn from a pool of four signatures: a row's bq2 scores tie
    at almost every position, so the top-k set is the tie rule's; the
    vectors are distinct, so the float32 ordering is not."""
    rng = np.random.default_rng(0)
    n, dim, r, k = 300, 64, 24, 8
    vectors = rng.standard_normal((n, dim)).astype(np.float32)
    pool = rng.integers(0, 2 ** 32, (4, 4), dtype=np.uint64).astype(
        np.uint32)
    words = pool[rng.integers(0, 4, n)]
    adjacency = np.stack([rng.choice(np.delete(np.arange(n), i), r,
                                     replace=False)
                          for i in range(n)]).astype(np.int32)
    adjacency[::5, -3:] = -1
    sample = np.sort(rng.choice(n, 64, replace=False))
    want = float(jgraph._edge_agreement(
        jnp.asarray(words), jnp.asarray(vectors), jnp.asarray(adjacency),
        jnp.asarray(sample, jnp.int32), dim=dim, k=k))
    got = float(pgraph._edge_agreement(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(vectors),
        torch.from_numpy(adjacency), torch.from_numpy(sample), dim=dim,
        k=k))
    assert got == want
    # an unstable order would not hold it: the first k of a descending
    # sort that puts later tied positions first differ
    assert 0.0 < got < 1.0


def test_bfs_flags_a_cut_component_red():
    adj = np.array([[1, 2], [2, 0], [0, 1], [4, -1], [3, -1]], np.int32)
    want = jgraph.graph_health_report(jnp.asarray(adj), medoid=0,
                                      registry=JaxRegistry())
    got = pgraph.graph_health_report(torch.from_numpy(adj), medoid=0,
                                     registry=MetricsRegistry())
    assert_same_report(got, want)
    assert got.n_unreachable == 2 and got.verdict == "red"
    assert got.worst_stat()[0] == "unreachable_frac"
    # a chain: hop radius grows one a row, cut off at max_hops
    chain = np.stack([np.arange(1, 11) % 10, -np.ones(10, int)],
                     axis=1).astype(np.int32)
    for hops in (3, 64):
        want = jgraph.graph_health_report(jnp.asarray(chain), medoid=0,
                                          max_hops=hops,
                                          registry=JaxRegistry())
        got = pgraph.graph_health_report(torch.from_numpy(chain),
                                         medoid=0, max_hops=hops,
                                         registry=MetricsRegistry())
        assert_same_report(got, want)
    assert got.hop_max == 9.0


def test_archives_cross_load_both_ways(ref, tmp_path):
    jindex, pindex = _indexes(ref)
    want = jindex.graph_report(sample=64, registry=JaxRegistry())
    jindex.save(str(tmp_path / "ref.npz"))
    port = QuIVerIndex.load(str(tmp_path / "ref.npz"), "cpu")
    assert port.graph_health.to_dict() == want.to_dict()
    port.save(str(tmp_path / "port.npz"))
    back = JaxIndex.load(str(tmp_path / "port.npz"))
    assert back.graph_health.to_dict() == want.to_dict()
    assert back.memory_breakdown()["graph_verdict"] == \
        port.memory_breakdown()["graph_verdict"]

    jmut, pmut = _mutated(ref, consolidate=False)
    want = jmut.graph_report(sample=64, registry=JaxRegistry())
    pmut.graph_report(sample=64, registry=MetricsRegistry())
    jmut.save(str(tmp_path / "ref_stream.npz"))
    port = MutableQuIVerIndex.load(str(tmp_path / "ref_stream.npz"), "cpu")
    assert port.graph_health.to_dict() == want.to_dict()
    pmut.save(str(tmp_path / "port_stream.npz"))
    back = JaxMutable.load(str(tmp_path / "port_stream.npz"))
    assert_same_report(back.graph_health, want)
    # carried through freeze and adoption, as in the reference
    assert pmut.freeze().graph_health is pmut.graph_health
    assert MutableQuIVerIndex.from_index(port.freeze()).graph_health \
        is port.graph_health


def _mk(mod, **over):
    base = dict(
        n_live=100, n_allocated=100, degree_bound=16,
        out_degree_mean=8.0, in_degree_mean=8.0, saturation=0.1,
        reciprocity=0.2, n_unreachable=0, unreachable_frac=0.0,
        hop_p50=3.0, hop_p99=5.0, hop_max=6.0, tombstone_density=0.0,
        edge_agreement=0.8, n_sampled=64, agreement_k=8, seed=0,
    )
    base.update(over)
    return mod.GraphHealthReport(**base)


def test_monitor_alarms_on_worsening_only():
    tombs = (0.0, 0.3, 0.35, 0.7, 0.0, 0.3, 0.3, 0.9)
    runs = []
    for mod, reg in ((jgraph, JaxRegistry()), (pgraph, MetricsRegistry())):
        mon = mod.GraphHealthMonitor(registry=reg, clock=lambda: 0.0)
        got = [mon.check(_mk(mod, tombstone_density=t)) for t in tombs]
        runs.append(([None if a is None else dataclasses.asdict(a)
                      for a in got], mon.report()))
    assert runs[1] == runs[0]
    alarms = [a for a in runs[1][0] if a is not None]
    assert [a["band"] for a in alarms] == ["amber", "red", "amber", "red"]


def test_remediation_walks_the_graph_ladder_once_per_crossing():
    base = contrastive_surrogate(200, 64, seed=5)
    runs = []
    for mut_cls, eng_cls, pol_cls, mod, reg, kw in (
            (JaxMutable, JaxEngine, JaxPolicy, jgraph, JaxRegistry(), {}),
            (MutableQuIVerIndex, QueryEngine, RemediationPolicy, pgraph,
             MetricsRegistry(), {"device": "cpu"})):
        idx = mut_cls.empty(64, 512, keep_vectors=True, **kw)
        idx.insert(base)
        eng = eng_cls(idx, default_k=4, default_ef=16)
        pol = pol_cls(eng, auto=False, registry=reg, clock=lambda: 0.0)
        mon = mod.GraphHealthMonitor(registry=reg, clock=lambda: 0.0)
        pol.attach_graph(mon)
        events = []
        for tomb in (0.0, 0.3, 0.35):
            mon.check(_mk(mod, tombstone_density=tomb))
        events.append((len(pol.triggers), pol.check(), pol.check()))
        mon.check(_mk(mod, tombstone_density=0.7))
        events.append((len(pol.triggers), pol.check()))
        mon.check(_mk(mod))
        mon.check(_mk(mod, tombstone_density=0.3))
        events.append((pol.check(), pol.flagged_red))
        runs.append(events)
    assert runs[1] == runs[0]
    (n1, first, none), (n2, red), (parked, flagged) = runs[1]
    assert n1 == 1 and first["action"] == "consolidate" and none is None
    assert n2 == 1 and red["note"] == "rebuild-through-probe"
    assert parked["note"] == "already red-flagged" and flagged


def test_consolidate_re_x_rays_an_armed_graph(ref):
    jmut, pmut = _mutated(ref, consolidate=False)
    cycles = []
    for mut, reg in ((jmut, JaxRegistry()), (pmut, MetricsRegistry())):
        mon = mut.attach_graph_monitor(tenant="smoke", registry=reg,
                                       clock=lambda: 0.0)
        first = mon.band
        rep = mut.consolidate()
        mut.delete(np.nonzero(mut.live)[0][:150])
        rep2 = mut.consolidate()
        cycles.append((first, rep, rep2, mon.band, len(mon.alarms),
                       mut.graph_health.n_live))
    (jfirst, jrep, jrep2, jband, jalarms, jlive), \
        (first, rep, rep2, band, alarms, live) = cycles
    assert (first, band, alarms, live) == (jfirst, jband, jalarms, jlive)
    assert live == pmut.n_live
    for got, want in ((rep, jrep), (rep2, jrep2)):
        assert set(got) == set(want)
        assert got["health_band"] == want["health_band"]
        for key in ("dead", "repaired_rows", "reclaimed"):
            assert got[key] == want[key]
        assert got["health_score"] == pytest.approx(want["health_score"],
                                                    abs=1e-6)
    assert "health_delta" in rep2
