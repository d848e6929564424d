"""The port's streaming index (``repro_torch.stream``, ``obs.drift``,
``data.dedup``, ``Retriever.add_documents``) against ``repro.stream`` and
its callers, on the CPU.

The corpus is the reference streaming tests' (minilm-surrogate, N = 2000,
25 queries) and so are the build parameters (``PARAMS``).  Held:

* bit-exact, for bq2 and bq1: the graph surgery (``link_chunk``,
  ``overflow_rows``, ``repair_rows``, ``_dedup_rows``) on identical tensors
  with ties and -1 padding; a chunk run on its real rows against the
  reference's chunk padded to its bucket; a mutation script from
  ``from_index`` of a JAX-built, labelled graph (insert in several adaptive
  chunks, delete with the medoid among the dead, filtered searches on the
  graph and brute routes, consolidate, insert into the reclaimed slots,
  freeze) and ``empty()`` with a bootstrap insert of 600: after every step
  the words, adjacency, degrees, masks, free list, medoid, generation,
  ``StreamStats``, label words, accumulator and hot-path search ids, then
  the frozen index;
* under ``allclose`` (ids equal up to 1e-6 score ties): reranked scores and
  the adc and float32 rungs on a mutated graph;
* the reference's own streaming cases (``tests/test_streaming.py``,
  ``test_filtered.py``, ``test_probe.py``, ``test_ivf.py``,
  ``test_plan.py``, ``test_quality.py`` and ``test_obs.py``), run on both
  packages where they return data;
* streaming archives that cross-load both ways, and immutable ones that
  are adopted.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bq as jbq
from repro.core import metric as jmetric
from repro.core.index import QuIVerIndex as JaxIndex
from repro.core.vamana import BuildParams as JaxParams
from repro.probe import ProbeAccumulator as JaxAccumulator
from repro.stream import MutableQuIVerIndex as JaxMutable
from repro.stream import consolidate as jcons
from repro_torch import convert
from repro_torch.core import bq
from repro_torch.core.baselines import flat_search, recall_at_k
from repro_torch.core.beam import beam_search
from repro_torch.core.index import QuIVerIndex
from repro_torch.core.metric import MetricArrays, make_backend
from repro_torch.core.vamana import BuildParams
from repro_torch.data.datasets import make_dataset
from repro_torch.filter import Any, Label, Not, estimate_selectivity
from repro_torch.obs.metrics import MetricsRegistry, get_default_registry
from repro_torch.probe import CompatibilityReport, ProbeAccumulator
from repro_torch.serve.engine import Retriever
from repro_torch.stream import MutableQuIVerIndex, StreamStats
from repro_torch.stream import consolidate as cons

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

PARAMS = dict(m=6, ef_construction=32, prune_pool=32, chunk=128)
# one capacity for every mutable index that both packages run: the
# reference's device operations then trace once for the whole file
CAPACITY = 1800
LABEL_RATES = (0.5, 0.1, 0.01)


def _t(a):
    """A numpy or JAX array as a torch tensor (uint32 as int32 views)."""
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _np(x):
    """A JAX array or a tensor as numpy (signature words as int32 views)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def assert_ids_match(a, b, scores_a, scores_b, tol=1e-6):
    """Ids may differ at a rank only where the two scores there tie."""
    np.testing.assert_allclose(scores_a, scores_b, rtol=1e-5, atol=1e-6)
    diff = a != b
    assert (np.abs(scores_a - scores_b)[diff] <= tol).all(), (
        np.nonzero(diff.any(axis=1))[0][:5])


@functools.lru_cache(maxsize=1)
def _data():
    return make_dataset("minilm-surrogate", 2000, queries=25)


def _member(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.random(n) < p for p in LABEL_RATES], axis=1)


def _rows(member):
    return [np.nonzero(m)[0].tolist() for m in member]


def _fields(saveable, path):
    saveable.save(str(path))
    with np.load(path) as z:
        return dict(z)


@functools.lru_cache(maxsize=None)
def _graph(metric: str, n: int = 1200):
    """A labelled JAX index over the first ``n`` rows, built in ``metric``
    (bq1 without cold vectors, so the medoid re-election decodes levels;
    ``"auto"`` carries a policy and a report), and its archive's fields;
    the port's copy is ``convert.index_from_numpy`` of them."""
    import tempfile
    base, _ = _data()
    index = JaxIndex.build(jnp.asarray(base[:n]), JaxParams(**PARAMS),
                           metric=metric, keep_vectors=metric != "bq1")
    index.attach_labels(_rows(_member(n)), n_labels=len(LABEL_RATES))
    with tempfile.TemporaryDirectory() as d:
        fields = _fields(index, f"{d}/graph.npz")
    return index, fields


def _pair(metric, capacity=None):
    """(reference mutable, port mutable) adopted from the same graph."""
    index, fields = _graph(metric)
    capacity = capacity or CAPACITY
    return (JaxMutable.from_index(index, capacity=capacity),
            MutableQuIVerIndex.from_index(
                convert.index_from_numpy(fields, "cpu"), capacity=capacity))


def assert_same_state(jm, pm):
    """Every piece of a mutable index's state, bit for bit."""
    for name in ("words", "adjacency", "deg"):
        np.testing.assert_array_equal(_np(getattr(pm, name)),
                                      _np(getattr(jm, name)), err_msg=name)
    if jm.vectors is not None:
        # the cold tier: the norm is summed in torch's order, not XLA's
        # (ROADMAP queue 3), so a component may differ in its last ulps
        np.testing.assert_array_max_ulp(_np(pm.vectors), _np(jm.vectors),
                                        maxulp=2)
    else:
        assert pm.vectors is None
    np.testing.assert_array_equal(pm.live, jm.live)
    np.testing.assert_array_equal(pm.allocated, jm.allocated)
    assert pm._free == jm._free
    assert (pm.size, pm.medoid, pm.generation) == (jm.size, jm.medoid,
                                                   jm.generation)
    assert dataclasses.asdict(pm.stats) == dataclasses.asdict(jm.stats)
    assert pm.probe_acc.n == jm.probe_acc.n
    np.testing.assert_array_equal(pm.probe_acc.pos_counts,
                                  jm.probe_acc.pos_counts)
    np.testing.assert_array_equal(pm.probe_acc.strong_counts,
                                  jm.probe_acc.strong_counts)
    if jm.labels is not None:
        np.testing.assert_array_equal(_np(pm.labels.words),
                                      _np(jm.labels.words))
        np.testing.assert_array_equal(pm.labels.entries, jm.labels.entries)
        np.testing.assert_array_equal(pm.labels.counts, jm.labels.counts)


def _jexpr(expr):
    """The same predicate built from the reference's classes."""
    from repro import filter as jfilter
    if expr is None or isinstance(expr, int):
        return expr
    if isinstance(expr, Label):
        return jfilter.Label(expr.label)
    if isinstance(expr, Not):
        return jfilter.Not(_jexpr(expr.expr))
    cls = jfilter.Any if isinstance(expr, Any) else jfilter.All
    return cls(*map(_jexpr, expr.items))


def assert_same_search(jm, pm, queries, filter=None, reranked=False, **kw):
    """Hot-path ids and scores identical; with ``reranked``, also the
    reranked ids up to score ties and their scores under ``allclose``."""
    jkw = dict(kw, filter=_jexpr(filter))
    kw = dict(kw, filter=filter)
    a, sa = jm.search(jnp.asarray(queries), k=10, ef=48, rerank=False,
                      **jkw)
    b, sb = pm.search(queries, k=10, ef=48, rerank=False, **kw)
    np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(sb, sa)
    if not reranked:
        return b
    a, sa = jm.search(jnp.asarray(queries), k=10, ef=48, **jkw)
    b, sb = pm.search(queries, k=10, ef=48, **kw)
    assert_ids_match(b, np.asarray(a), sb, np.asarray(sa))
    return b


def assert_same_frozen(jf, pf, queries):
    np.testing.assert_array_equal(_np(pf.sigs.words), _np(jf.sigs.words))
    np.testing.assert_array_equal(_np(pf.adjacency), _np(jf.adjacency))
    assert pf.medoid == jf.medoid
    if jf.labels is not None:
        np.testing.assert_array_equal(_np(pf.labels.words),
                                      _np(jf.labels.words))
        np.testing.assert_array_equal(pf.labels.entries, jf.labels.entries)
    a, sa = jf.search(jnp.asarray(queries), k=10, ef=48, rerank=False)
    b, sb = pf.search(queries, k=10, ef=48, rerank=False)
    np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(sb, sa)


# -- graph surgery -------------------------------------------------------------


def _backends(metric, words, vectors, dim):
    """The reference's and the port's backend over the same tensors."""
    jb = jmetric.make_backend(metric, jmetric.MetricArrays(
        sigs=jbq.Signature(words=jnp.asarray(np.asarray(words).view(
            np.uint32)), dim=dim),
        vectors=None if vectors is None else jnp.asarray(vectors)))
    pb = make_backend(metric, MetricArrays(
        sigs=bq.Signature(words=torch.from_numpy(np.asarray(words)),
                          dim=dim),
        vectors=None if vectors is None else torch.from_numpy(vectors)))
    return jb, pb


def _surgery_inputs(metric, seed):
    """A mutated graph's tensors: the adopted graph plus 60 fresh rows
    written into free slots, with ~15% of the live nodes dead."""
    jm, _ = _pair(metric)
    base, _ = _data()
    rng = np.random.default_rng(seed)
    words = _np(jm.words).copy()
    fresh = np.arange(1200, 1260, dtype=np.int32)
    words[fresh] = _np(jbq.encode(jnp.asarray(base[fresh])).words)
    live = jm.live.copy()
    live[fresh] = True
    live[rng.choice(1200, 180, replace=False)] = False
    return (words, _np(jm.adjacency), _np(jm.deg), live, fresh, jm)


def _pad(ids, size):
    out = np.full((size,), -1, np.int32)
    out[:len(ids)] = ids
    return out


@pytest.mark.parametrize("metric", ["bq2", "bq1"])
def test_link_chunk_real_rows_match_reference_padded_chunk(metric):
    """The port links a chunk's real rows only; the reference pads the
    chunk to its bucket.  The padded rows' proposals are invalid in
    ``reverse_append``, so the graphs are identical, and the port's own
    padded chunk gives the same graph again."""
    words, adj, deg, live, fresh, jm = _surgery_inputs(metric, 0)
    jb, pb = _backends(metric, words, None, jm.dim)
    kw = dict(ef=32, pool=32, r=12, alpha=1.2, n=jm.capacity, expand=1,
              r_total=20)
    want = jcons.link_chunk(
        jb, jnp.asarray(adj), jnp.asarray(deg), jnp.asarray(live),
        jnp.asarray(_pad(fresh[:40], 64)), jnp.int32(jm.medoid), **kw)
    for ids in (fresh[:40], _pad(fresh[:40], 64)):
        got = cons.link_chunk(pb, _t(adj), _t(deg), _t(live), _t(ids),
                              jm.medoid, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("metric", ["bq2", "bq1"])
def test_overflow_and_repair_rows_match_reference(metric):
    words, adj, deg, live, _, jm = _surgery_inputs(metric, 1)
    jb, pb = _backends(metric, words, None, jm.dim)
    rows = _pad(np.random.default_rng(2).choice(1200, 100, replace=False),
                128)
    kw = dict(r=12, alpha=1.2, r_total=20)
    for jfn, pfn, extra in ((jcons.overflow_rows, cons.overflow_rows, {}),
                            (jcons.repair_rows, cons.repair_rows,
                             {"pool": 32})):
        # under jit, as the reference's mutable index runs them
        want = jax.jit(functools.partial(jfn, jb, **kw, **extra))(
            jnp.asarray(adj), jnp.asarray(deg), jnp.asarray(live),
            jnp.asarray(rows))
        got = pfn(pb, _t(adj), _t(deg), _t(live), _t(rows), **kw, **extra)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), _np(w))


def test_dedup_rows_matches_reference():
    rng = np.random.default_rng(3)
    cands = rng.integers(-1, 12, (16, 90)).astype(np.int32)
    cands[:, 40:] = -1                      # a padded tail
    got = cons._dedup_rows(_t(cands))
    want = jcons._dedup_rows(jnp.asarray(cands))
    np.testing.assert_array_equal(_np(got), _np(want))
    # each id survives once, at its first slot
    for row, c in zip(_np(got), cands):
        kept = row[row >= 0]
        assert len(kept) == len(set(kept.tolist()))
        assert set(kept.tolist()) == set(c[c >= 0].tolist())


def test_consolidate_rows_without_mask_is_unchanged():
    """``node_valid=None`` (the batch build) keeps the pool as it was."""
    words, adj, deg, live, _, jm = _surgery_inputs("bq2", 4)
    _, pb = _backends("bq2", words, None, jm.dim)
    rows = _t(np.arange(0, 1200, 7, dtype=np.int32))
    from repro_torch.core import linking
    plain = linking.consolidate_rows(pb, _t(adj), _t(deg), rows, r=12,
                                     alpha=1.2, r_total=20)
    all_live = linking.consolidate_rows(
        pb, _t(adj), _t(deg), rows, r=12, alpha=1.2, r_total=20,
        node_valid=torch.ones(jm.capacity, dtype=torch.bool))
    for g, w in zip(plain, all_live):
        assert torch.equal(g, w)


# -- the mutation script ---------------------------------------------------------


@pytest.mark.parametrize("metric", ["bq2", "bq1"])
def test_mutation_script_matches_reference(metric):
    base, queries = _data()
    jm, pm = _pair(metric)
    assert_same_state(jm, pm)
    assert_same_search(jm, pm, queries)

    # insert in three adaptive chunks (128, 128, 44), labels included
    labels = _rows(_member(300, seed=1))
    a = jm.insert(jnp.asarray(base[1200:1500]), labels=labels)
    b = pm.insert(base[1200:1500], labels=labels)
    np.testing.assert_array_equal(b, a)
    assert_same_state(jm, pm)
    assert_same_search(jm, pm, queries)

    # delete the medoid among 300 others, with a repeated and a dead id
    dead = np.r_[jm.medoid, np.arange(100, 400), 150, 150]
    assert pm.delete(dead) == jm.delete(dead)
    assert pm.delete([150]) == jm.delete([150]) == 0
    assert_same_state(jm, pm)
    ids = assert_same_search(jm, pm, queries)
    assert not np.isin(ids, dead).any()
    for expr, route in ((0, "graph"), (2, "brute")):
        ids = assert_same_search(jm, pm, queries, filter=expr, reranked=True)
        ok = ids[ids >= 0]
        assert ok.size and (_np(pm.labels.mask(expr))[ok] & pm.live[ok]).all()

    assert pm.consolidate() == jm.consolidate()
    assert pm.live[pm.medoid]                 # re-elected among the live
    assert_same_state(jm, pm)
    assert_same_search(jm, pm, queries)
    assert_same_search(jm, pm, queries, filter=Any(0, 1))

    # the next insert reuses the reclaimed slots first
    a = jm.insert(jnp.asarray(base[1500:1700]))
    b = pm.insert(base[1500:1700])
    np.testing.assert_array_equal(b, a)
    assert np.isin(b, dead).all()
    assert_same_state(jm, pm)
    assert_same_search(jm, pm, queries, reranked=True)
    assert pm.probe_acc == ProbeAccumulator.from_words(
        pm.words[torch.from_numpy(pm.live)], pm.dim)

    assert_same_frozen(jm.freeze(), pm.freeze(), queries)


@pytest.mark.parametrize("metric", ["bq2", "bq1"])
def test_bootstrap_from_empty_matches_reference(metric):
    """``empty()`` then one insert of 600: adaptive chunks of 16, 16, 32,
    64, 128, 128, 128 and 88 rows, each linked against the graph before
    it."""
    base, queries = _data()
    keep = metric == "bq2"
    jm = JaxMutable.empty(base.shape[1], CAPACITY, JaxParams(**PARAMS),
                          metric=metric, keep_vectors=keep)
    pm = MutableQuIVerIndex.empty(base.shape[1], CAPACITY,
                                  BuildParams(**PARAMS), metric=metric,
                                  keep_vectors=keep, device="cpu")
    a = jm.insert(jnp.asarray(base[:600]))
    b = pm.insert(base[:600])
    np.testing.assert_array_equal(b, a)
    assert_same_state(jm, pm)
    assert_same_search(jm, pm, queries)
    assert_same_frozen(jm.freeze(), pm.freeze(), queries)


def test_float_rungs_match_reference_on_a_mutated_graph():
    """adc and float32 navigation of a consolidated graph (no tombstones
    left), against the reference's frozen snapshot of it, ids mapped
    through the live slots: the reference's mutable ``search(nav="adc")``
    fails to trace (ROADMAP queue 3)."""
    _, queries = _data()
    jm, pm = _pair("bq2")
    for m in (jm, pm):
        m.delete(np.arange(0, 200))
        m.consolidate()
    frozen = jm.freeze()
    live_idx = np.nonzero(jm.live)[0]
    for nav in ("adc", "float32"):
        for rerank in (False, True):
            a, sa = frozen.search(jnp.asarray(queries), k=10, ef=48,
                                  nav=nav, rerank=rerank)
            a = np.where(np.asarray(a) >= 0, live_idx[np.asarray(a)], -1)
            b, sb = pm.search(queries, k=10, ef=48, nav=nav, rerank=rerank)
            assert_ids_match(b, a, sb, np.asarray(sa))


# -- persistence -----------------------------------------------------------------


def test_archives_cross_load_both_ways(tmp_path):
    base, queries = _data()
    jm, pm = _pair("bq2")
    for m in (jm, pm):
        m.delete(np.arange(0, 80))
        m.insert(base[1200:1300] if m is pm else jnp.asarray(base[1200:1300]),
                 labels=[1] * 100)
        m.consolidate()
        m.build_label_entries(min_count=16)
    jfields = _fields(jm, tmp_path / "ref.npz")
    pfields = _fields(pm, tmp_path / "port.npz")
    assert set(pfields) == set(jfields)
    for key, value in jfields.items():
        assert pfields[key].dtype == value.dtype, key
        if key == "vectors":        # see assert_same_state
            np.testing.assert_array_max_ulp(pfields[key], value, maxulp=2)
        else:
            np.testing.assert_array_equal(pfields[key], value, err_msg=key)

    # the reference's archive in the port, the port's in the reference
    from_ref = MutableQuIVerIndex.load(str(tmp_path / "ref.npz"), "cpu")
    from_port = JaxMutable.load(str(tmp_path / "port.npz"))
    assert_same_state(from_port, from_ref)
    assert from_ref.probe_acc == pm.probe_acc
    assert_same_search(from_port, from_ref, queries, reranked=True)
    assert_same_search(from_port, from_ref, queries, filter=1)

    # a streaming archive is not an immutable index, in either package
    with pytest.raises(ValueError, match="streaming archive"):
        QuIVerIndex.load(str(tmp_path / "ref.npz"), "cpu")
    with pytest.raises(ValueError, match="streaming archive"):
        JaxIndex.load(str(tmp_path / "port.npz"))

    # an immutable archive is adopted
    frozen = pm.freeze()
    frozen.save(str(tmp_path / "frozen.npz"))
    adopted = MutableQuIVerIndex.load(str(tmp_path / "frozen.npz"), "cpu")
    assert adopted.n_live == pm.n_live and adopted.capacity == 2 * pm.n_live
    ref_adopted = JaxMutable.load(str(tmp_path / "frozen.npz"))
    assert_same_state(ref_adopted, adopted)


def test_graph_health_state_is_refused(tmp_path):
    """Graph-health state, once refused, is ported: the live graph's
    X-ray equals the reference's (edge agreement within 2 / (S k)), the
    monitor armed by ``attach_graph_monitor`` takes the same band, and
    the ``graph_*`` fields of a streaming archive load in both
    packages."""
    jm, pm = _pair("bq2")
    dead = np.random.default_rng(2).choice(1200, 150, replace=False)
    for m in (jm, pm):
        m.delete(dead)
    # the build's rows carry ~12 edges: k = 4 arms the agreement probe
    want = jm.graph_report(sample=64, agreement_k=4)
    got = pm.graph_report(sample=64, agreement_k=4,
                          registry=MetricsRegistry())
    for name in ("n_live", "n_allocated", "n_unreachable", "hop_max",
                 "out_degree_hist", "in_degree_hist", "reciprocity",
                 "tombstone_density", "n_sampled"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.n_sampled == 64
    assert abs(got.edge_agreement - want.edge_agreement) <= 2 / (64 * 4)
    assert got.verdict == want.verdict
    assert pm.attach_graph_monitor(registry=MetricsRegistry()).band == \
        jm.attach_graph_monitor().band
    fields = convert.mutable_to_numpy(pm)
    assert "graph_out_degree_mean" in fields
    back = convert.mutable_from_numpy(fields, "cpu")
    # (assert_equal: the monitor's k = 8 report has a NaN agreement)
    np.testing.assert_equal(back.graph_health.to_dict(),
                            pm.graph_health.to_dict())
    pm.save(str(tmp_path / "port.npz"))
    np.testing.assert_equal(
        JaxMutable.load(str(tmp_path / "port.npz")).graph_health.to_dict(),
        pm.graph_health.to_dict())


# -- the reference's streaming cases ---------------------------------------------


def _port_graph(metric="bq2"):
    return convert.index_from_numpy(_graph(metric)[1], "cpu")


def _grid():
    n_side = 12
    coords = np.stack(np.meshgrid(np.arange(n_side), np.arange(n_side),
                                  indexing="ij"), -1).reshape(-1, 2)
    adj = np.full((n_side * n_side, 4), -1, dtype=np.int32)
    for i, (x, y) in enumerate(coords):
        k = 0
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            nx, ny = int(x) + dx, int(y) + dy
            if 0 <= nx < n_side and 0 <= ny < n_side:
                adj[i, k] = nx * n_side + ny
                k += 1
    pts = torch.from_numpy(coords.astype(np.float32))

    def dist_fn(queries, ids):
        return torch.linalg.vector_norm(pts[ids.long()] - queries[:, None],
                                        dim=-1)

    return n_side, torch.from_numpy(adj), dist_fn


def test_masked_beam_navigates_through_dead_wall():
    """A dead grid column between start and target is still crossed
    (dead nodes route) and never returned; an all-live mask is the
    unmasked beam."""
    n_side, adj, dist_fn = _grid()
    n = n_side * n_side
    q = torch.tensor([[9.1, 2.1], [8.7, 2.2]])
    plain = beam_search(q, adj, 0, dist_fn=dist_fn, ef=8, n=n)
    masked = beam_search(q, adj, 0, dist_fn=dist_fn, ef=8, n=n,
                         node_valid=torch.ones(n, dtype=torch.bool))
    assert torch.equal(plain.ids, masked.ids)
    assert torch.equal(plain.dists, masked.dists)
    wall = [5 * n_side + y for y in range(n_side)]
    live = torch.ones(n, dtype=torch.bool)
    live[wall] = False
    res = beam_search(q, adj, 0, dist_fn=dist_fn, ef=8, n=n,
                      node_valid=live)
    ids = res.ids.numpy()
    assert ids[0, 0] == 9 * n_side + 2
    assert not np.isin(ids[ids >= 0], wall).any()


def test_freeze_static_corpus_bit_identical():
    _, queries = _data()
    idx = _port_graph()
    mut = MutableQuIVerIndex.from_index(idx)
    frozen = mut.freeze()
    i1, s1 = idx.search(queries, k=10, ef=48)
    i2, s2 = frozen.search(queries, k=10, ef=48)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(s1, s2)
    i3, s3 = mut.search(queries, k=10, ef=48)
    np.testing.assert_array_equal(i1, i3)
    np.testing.assert_array_equal(s1, s3)


def test_inserted_vectors_immediately_findable_and_deletes_recover():
    base, queries = _data()
    mut = MutableQuIVerIndex.from_index(_port_graph(), capacity=2600)
    mut.insert(base[1200:2000])
    assert mut.n_live == 2000
    gt, _ = flat_search(base[:2000], queries, 10, device="cpu")
    pred, _ = mut.search(queries, k=10, ef=48)
    assert recall_at_k(pred, gt) > 0.75
    pred1, _ = mut.search(base[1500:1550], k=1, ef=48)
    assert (pred1.ravel() == np.arange(1500, 1550)).mean() > 0.9

    dead = np.arange(100, 700)                       # 30% of the corpus
    assert mut.delete(dead) == len(dead)
    pred, _ = mut.search(queries, k=10, ef=48)
    assert not np.isin(pred, dead).any()
    keep = np.ones(2000, bool)
    keep[dead] = False
    orig = np.nonzero(keep)[0]
    gt_pos, _ = flat_search(base[:2000][keep], queries, 10, device="cpu")
    gt = orig[gt_pos]
    recall_before = recall_at_k(pred, gt)
    report = mut.consolidate()
    assert report["reclaimed"] == len(dead)
    assert mut.free_slots >= len(dead)
    pred2, _ = mut.search(queries, k=10, ef=48)
    assert not np.isin(pred2, dead).any()
    recall_after = recall_at_k(pred2, gt)
    assert recall_after > 0.75, (recall_before, recall_after)
    assert recall_after >= recall_before - 0.02
    new_ids = mut.insert(base[:100])
    assert np.isin(new_ids, dead).all()


def test_freeze_roundtrips_through_save_load(tmp_path):
    base, queries = _data()
    mut = MutableQuIVerIndex.from_index(_port_graph(), capacity=1500)
    mut.delete(np.arange(0, 80))
    mut.insert(base[1200:1300])
    mut.consolidate()
    mut.save(str(tmp_path / "stream.npz"))
    mut2 = MutableQuIVerIndex.load(str(tmp_path / "stream.npz"), "cpu")
    a, _ = mut.search(queries, k=5, ef=32)
    b, _ = mut2.search(queries, k=5, ef=32)
    np.testing.assert_array_equal(a, b)
    assert mut2.generation == mut.generation
    assert dataclasses.asdict(mut2.stats) == dataclasses.asdict(StreamStats())
    frozen = mut.freeze()
    frozen.save(str(tmp_path / "frozen.npz"))
    frozen2 = QuIVerIndex.load(str(tmp_path / "frozen.npz"), "cpu")
    fa, _ = frozen.search(queries, k=5, ef=32)
    fb, _ = frozen2.search(queries, k=5, ef=32)
    np.testing.assert_array_equal(fa, fb)
    assert fa.max() < mut.n_live


def test_empty_and_capacity_edges():
    mut = MutableQuIVerIndex.empty(32, 64, BuildParams(**PARAMS),
                                   device="cpu")
    ids, scores = mut.search(np.ones((3, 32), np.float32), k=5)
    assert (ids == -1).all() and np.isneginf(scores).all()
    with pytest.raises(ValueError, match="capacity"):
        mut.insert(np.ones((65, 32), np.float32))
    with pytest.raises(ValueError, match="cannot freeze"):
        mut.freeze()
    with pytest.raises(ValueError, match="auto"):
        MutableQuIVerIndex.empty(32, 100, BuildParams(**PARAMS),
                                 metric="auto", device="cpu")
    rng = np.random.default_rng(0)
    mut.insert(rng.standard_normal((40, 32)).astype(np.float32))
    assert mut.n_live == 40 and len(mut) == 40
    ids, _ = mut.search(np.ones((1, 32), np.float32), k=5)
    assert (ids >= 0).all()
    mem = mut.memory_breakdown()
    assert mem["hot_mask_bytes"] == 128
    assert mem["total_bytes"] == mem["hot_total_bytes"] + 64 * 32 * 4


def test_entry_points_run_on_the_card_unless_asked():
    """``device=None`` means the card; without one it raises, never
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MutableQuIVerIndex.empty(32, 64)


def test_filtered_search_small_live_set_and_label_counts():
    rng = np.random.default_rng(11)
    docs = rng.standard_normal((8, 24)).astype(np.float32)
    small = BuildParams(m=2, ef_construction=8, prune_pool=8, chunk=128)
    mut = MutableQuIVerIndex.empty(24, 64, small, n_labels=2, device="cpu")
    mut.insert(docs, labels=[0] * 8)
    ids, scores = mut.search(docs[:2], k=10, ef=64, filter=0)
    assert ids.shape == (2, 10)
    valid = ids >= 0
    assert valid[:, 0].all() and valid.sum(axis=1).max() <= 8
    assert np.isneginf(scores[~valid]).all()

    base, _ = _data()
    mut = MutableQuIVerIndex.empty(base.shape[-1], 800,
                                   BuildParams(**PARAMS), n_labels=2,
                                   device="cpu")
    ids = mut.insert(base[:500], labels=[1] * 100 + [0] * 400)
    assert mut.labels.count(1) == 100
    mut.delete(ids[:95])
    assert mut.labels.count(1) == 5
    assert estimate_selectivity(1, mut.labels.count_fn(), mut.n_live) < 0.05


def test_insert_labels_without_store_raises():
    mut = MutableQuIVerIndex.empty(32, 64, BuildParams(**PARAMS),
                                   device="cpu")
    with pytest.raises(ValueError, match="enable_labels"):
        mut.insert(np.ones((2, 32), np.float32), labels=[0, 1])
    mut.insert(np.ones((2, 32), np.float32))
    with pytest.raises(ValueError, match="filtered search"):
        mut.search(np.ones((1, 32), np.float32), k=2, filter=0)
    mut.enable_labels(3)
    with pytest.raises(ValueError, match="n_labels=3"):
        mut.enable_labels(4)


def test_streaming_labels_compose_with_tombstones_and_reuse(tmp_path):
    base, queries = _data()
    labels = np.random.default_rng(1).integers(0, 4, 1200)
    mut = MutableQuIVerIndex.empty(base.shape[-1], 2000,
                                   BuildParams(**PARAMS), n_labels=4,
                                   device="cpu")
    mut.insert(base[:1200], labels=list(labels))
    kill = np.nonzero(_np(mut.labels.mask(0)) & mut.live)[0][:120]
    mut.delete(kill)
    mut.build_label_entries(min_count=16)
    pred, _ = mut.search(queries, k=10, ef=48, filter=0)
    ok = pred[pred >= 0]
    assert ok.size and not np.isin(ok, kill).any()
    live_match = _np(mut.labels.mask(0)) & mut.live
    assert live_match[ok].all()
    match = np.nonzero(live_match)[0]
    gt_pos, _ = flat_search(base[match], queries, 10, device="cpu")
    assert recall_at_k(pred, match[gt_pos]) >= 0.75

    # reclaimed slots lose their labels; a label-less reinsert stays clean
    mut.consolidate()
    assert all(mut.labels.labels_of(int(i)) == [] for i in kill[:10])
    new_ids = mut.insert(base[1200:1320])
    assert np.isin(new_ids, kill).all()
    assert all(mut.labels.labels_of(int(i)) == [] for i in new_ids[:10])
    for i in np.setdiff1d(np.nonzero(mut.live[:1200])[0], new_ids)[:10]:
        assert mut.labels.labels_of(int(i)) == [int(labels[i])]

    # archives keep the labels; freeze compacts the store
    mut.save(str(tmp_path / "labelled.npz"))
    back = MutableQuIVerIndex.load(str(tmp_path / "labelled.npz"), "cpu")
    a, _ = mut.search(queries, k=5, ef=32, filter=1)
    b, _ = back.search(queries, k=5, ef=32, filter=1)
    np.testing.assert_array_equal(a, b)
    frozen = mut.freeze()
    assert frozen.labels.words.shape[0] == mut.n_live
    fi, _ = frozen.search(queries, k=5, ef=32, filter=1)
    fmask = _np(frozen.labels.mask(1))
    assert fi[fi >= 0].size and fmask[fi[fi >= 0]].all()
    again = MutableQuIVerIndex.from_index(frozen)
    assert again.labels is not None and again.labels.n_labels == 4
    c, _ = again.search(queries, k=5, ef=32, filter=1)
    assert c[c >= 0].size and fmask[c[c >= 0]].all()


def test_accumulator_matches_recompute_after_churn(tmp_path):
    """Churn on an index adopted from an auto build (its policy and
    report travel)."""
    base, _ = _data()
    jm, pm = _pair("auto")
    assert pm.policy is not None
    assert dataclasses.asdict(pm.policy) == dataclasses.asdict(jm.policy)
    for m, x in ((jm, jnp.asarray), (pm, np.asarray)):
        ids = m.insert(x(base[1200:1400]))
        m.delete(ids[:50])
        m.delete(ids[:10])                  # must not double-count
        m.consolidate()
        m.insert(x(base[1400:1500]))
        m.delete(np.arange(25))
    assert_same_state(jm, pm)
    assert pm.probe_acc == ProbeAccumulator.from_words(
        _np(pm.words)[pm.live], pm.dim)
    assert pm.probe_acc.n == pm.n_live
    ref = JaxAccumulator.from_words(np.asarray(jm.words)[jm.live], jm.dim)
    assert pm.probe_acc.sign_entropy == ref.sign_entropy

    r = pm.probe_report(sample=256)
    assert isinstance(r, CompatibilityReport)
    assert r.sign_entropy == pm.probe_acc.sign_entropy
    assert r.verdict == jm.probe_report(sample=256).verdict
    pm.save(str(tmp_path / "stream.npz"))
    back = MutableQuIVerIndex.load(str(tmp_path / "stream.npz"), "cpu")
    assert back.policy == pm.policy and back.report == pm.report
    assert back.probe_acc == pm.probe_acc
    assert back.freeze().policy == pm.policy


def test_freeze_rebuilds_partition_and_mutable_rejects_ivf():
    from repro_torch.ivf import build_partition
    _, queries = _data()
    idx = _port_graph()
    idx.params = dataclasses.replace(idx.params, ivf_candidates=True)
    mut = MutableQuIVerIndex.from_index(idx)
    with pytest.raises(ValueError, match="freeze"):
        mut.search(queries[:2], 5, nav="ivf")
    with pytest.raises(ValueError, match="stale"):
        mut.replan(nav="ivf")
    mut.delete(np.arange(10))
    frozen = mut.freeze()
    assert frozen.ivf is not None and frozen.ivf.assign.shape[0] == 1190
    # the partition of the compacted signatures, with the build seed
    want = build_partition(frozen.sigs, seed=idx.params.seed)
    np.testing.assert_array_equal(frozen.ivf.member_ids, want.member_ids)
    ids, _ = frozen.search(queries[:4], k=5, ef=32, nav="ivf")
    assert (ids >= 0).any()


def test_plan_stable_across_freeze():
    from repro_torch.plan import resolve_plan
    idx = _port_graph()
    idx.build_label_entries(min_count=32)
    plan, ctx = resolve_plan(idx, k=10, ef=64, filter=0)
    frozen = MutableQuIVerIndex.from_index(idx).freeze()
    plan_f, ctx_f = resolve_plan(frozen, k=10, ef=64, filter=0)
    assert plan_f == plan and ctx_f.start == ctx.start
    assert frozen.plans is not idx.plans
    a, _ = idx.plans.run(plan, ctx, torch.zeros((2, idx.sigs.dim)))
    b, _ = frozen.plans.run(plan_f, ctx_f, torch.zeros((2, idx.sigs.dim)))
    np.testing.assert_array_equal(a, b)


def test_mutable_replan_flips_serving_metric():
    rng = np.random.default_rng(0)
    idx = MutableQuIVerIndex.empty(32, 256, BuildParams(**PARAMS),
                                   device="cpu")
    idx.insert(rng.normal(size=(128, 32)).astype(np.float32))
    with pytest.raises(ValueError, match="stale"):
        idx.replan(nav="ivf")
    policy = idx.replan(nav="float32", source="remediation")
    assert policy.nav == "float32" and idx.metric_kind == "float32"
    ids, _ = idx.search(rng.normal(size=(4, 32)).astype(np.float32), k=5)
    assert ids.shape == (4, 5) and (ids >= 0).all()
    policy = idx.replan(nav="bq2", ef_scale=2, adaptive=True)
    assert (policy.nav, policy.ef_scale, policy.adaptive) == ("bq2", 2, True)
    bare = MutableQuIVerIndex.empty(32, 64, BuildParams(**PARAMS),
                                    keep_vectors=False, device="cpu")
    with pytest.raises(ValueError, match="vector"):
        bare.replan(nav="float32")


def _collapsed(rng, n, dim):
    """Sign-collapsed vectors: every coordinate positive."""
    return np.abs(rng.normal(size=(n, dim))).astype(np.float32) + 3.0


def test_drift_monitor_bands_and_alarms():
    rng = np.random.default_rng(0)
    idx = MutableQuIVerIndex.empty(32, 512, BuildParams(**PARAMS),
                                   device="cpu")
    mon = idx.attach_drift_monitor(tenant="t", min_n=32)
    for _ in range(4):
        idx.insert(rng.normal(size=(64, 32)).astype(np.float32))
    assert mon.band == "green" and len(mon.events) == 0

    rng = np.random.default_rng(0)
    reg = MetricsRegistry()
    idx = MutableQuIVerIndex.empty(32, 1024, BuildParams(**PARAMS),
                                   device="cpu")
    mon = idx.attach_drift_monitor(tenant="drifty", min_n=32, registry=reg)
    good = idx.insert(rng.normal(size=(128, 32)).astype(np.float32))
    assert mon.band == "green" and not mon.events
    idx.insert(_collapsed(rng, 512, 32))
    idx.delete(good)                      # the live set is all collapsed
    assert mon.band == "red" and len(mon.events) >= 1
    ev = mon.events[-1]
    assert ev.tenant == "drifty" and ev.band == "red"
    assert "drifty" in ev.message()
    assert reg.counter("quiver_drift_alarms_total", labels=(
        "tenant", "band")).value(tenant="drifty", band="red") >= 1
    report = mon.report()
    assert report["band"] == "red" and report["alarms"] == len(mon.alarms)

    # one alarm a crossing; a full sampled report through the same path
    rng = np.random.default_rng(1)
    idx = MutableQuIVerIndex.empty(32, 1024, BuildParams(**PARAMS),
                                   device="cpu")
    mon = idx.attach_drift_monitor(tenant="t", min_n=32)
    fired = []
    mon.subscribe(fired.append)
    idx.insert(_collapsed(rng, 256, 32))
    n_after = len(mon.events)
    assert n_after >= 1 and len(fired) == len(mon.alarms)
    idx.insert(_collapsed(rng, 64, 32))   # still red: no re-alarm
    assert len(mon.events) == n_after
    assert mon.check_report(idx.probe_report(sample=256)) is None


def test_drift_monitor_matches_reference_on_the_same_counts():
    """The port's monitor over a reference accumulator scores, bands and
    alarms as the reference's does (the same thresholds, the same
    events)."""
    from repro.obs.drift import DriftMonitor as JaxMonitor
    from repro.obs.metrics import MetricsRegistry as JaxRegistry
    from repro_torch.obs.drift import DriftMonitor

    rng = np.random.default_rng(0)
    acc = JaxAccumulator(32)
    clock = iter(range(100)).__next__
    mons = (DriftMonitor(acc, tenant="t", min_n=32,
                         registry=MetricsRegistry(), clock=clock),
            JaxMonitor(acc, tenant="t", min_n=32, registry=JaxRegistry(),
                       clock=clock))
    words = np.asarray(jbq.encode(jnp.asarray(
        rng.normal(size=(128, 32)).astype(np.float32))).words)
    bad = np.asarray(jbq.encode(jnp.asarray(
        _collapsed(rng, 512, 32))).words)
    steps = [(acc.add, words), (acc.add, bad), (acc.remove, words),
             (acc.remove, bad[:400]), (acc.add, words)]
    for op, w in steps:
        op(w)
        got, want = (m.check() for m in mons)
        assert (got is None) == (want is None)
        assert mons[0].score() == mons[1].score()
        assert mons[0].band == mons[1].band
    assert [dataclasses.astuple(e)[:-1] for e in mons[0].events] == [
        dataclasses.astuple(e)[:-1] for e in mons[1].events]


def test_mutation_metrics_recorded():
    rng = np.random.default_rng(2)
    idx = MutableQuIVerIndex.empty(32, 256, BuildParams(**PARAMS),
                                   device="cpu")
    counter = get_default_registry().counter(
        "quiver_stream_mutations_total", "streaming mutations by kind",
        labels=("kind",))
    before = {k: counter.value(kind=k)
              for k in ("insert", "delete", "consolidate")}
    idx.insert(rng.normal(size=(32, 32)).astype(np.float32))
    idx.delete([0, 1, 1])
    idx.consolidate()
    assert counter.value(kind="insert") - before["insert"] == 32
    assert counter.value(kind="delete") - before["delete"] == 3
    assert counter.value(kind="consolidate") - before["consolidate"] == 1
    assert get_default_registry().gauge(
        "quiver_stream_live_rows").value() == 30


# -- callers: retriever and dedup -------------------------------------------------


def test_retriever_over_a_mutable_index():
    """-1 padding ids from a sparse index inject pad tokens, never the
    last document in the store."""
    rng = np.random.default_rng(0)
    docs = rng.standard_normal((5, 16)).astype(np.float32)
    small = dict(m=2, ef_construction=8, prune_pool=8, chunk=128)
    idx = MutableQuIVerIndex.empty(16, 32, BuildParams(**small),
                                   device="cpu")
    idx.insert(docs)
    doc_tokens = np.arange(5 * 3, dtype=np.int32).reshape(5, 3) + 100
    r = Retriever(index=idx, doc_tokens=doc_tokens,
                  embed_fn=lambda t: docs[:len(t)], k=8, ef=8)
    out = r.augment(np.zeros((2, 4), np.int32))
    assert out.shape == (2, 8 * 3 + 4)
    ctx = out[:, :8 * 3].reshape(2, 8, 3)
    assert (ctx == 0).all(-1).any(axis=1).all()
    assert ((ctx == doc_tokens[-1]).all(-1).sum(axis=1) <= 1).all()


def test_retriever_add_documents_grows_the_corpus():
    rng = np.random.default_rng(1)
    docs = rng.standard_normal((20, 24)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=-1, keepdims=True)
    idx = MutableQuIVerIndex.empty(
        24, 64, BuildParams(m=2, ef_construction=8, prune_pool=8,
                            chunk=128), device="cpu")
    idx.insert(docs[:10])
    store = {}

    def embed(tokens):
        return np.stack([store[tuple(t)] for t in np.asarray(tokens)])

    r = Retriever(index=idx,
                  doc_tokens=np.arange(30, dtype=np.int32).reshape(10, 3),
                  embed_fn=embed, k=1, ef=16)
    new_tokens = np.arange(30, 60, dtype=np.int32).reshape(10, 3)
    ids = r.add_documents(new_tokens, embeddings=docs[10:])
    assert len(ids) == 10 and idx.n_live == 20
    assert len(r.doc_tokens) == idx.capacity
    store[tuple(np.zeros(3, np.int32))] = docs[15]
    out = r.augment(np.zeros((1, 3), np.int32))
    np.testing.assert_array_equal(out[0, :3], r.doc_tokens[ids[5]])
    # without embeddings the retriever embeds the tokens itself
    store[tuple(new_tokens[0] + 100)] = docs[0]
    more = r.add_documents(new_tokens[:1] + 100)
    np.testing.assert_array_equal(r.doc_tokens[more[0]], new_tokens[0] + 100)


def test_retriever_filtered_rag_on_streaming_labels():
    rng = np.random.default_rng(6)
    docs = rng.standard_normal((40, 24)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=-1, keepdims=True)
    lang = rng.integers(0, 2, 40)
    idx = MutableQuIVerIndex.empty(
        24, 64, BuildParams(m=2, ef_construction=8, prune_pool=8,
                            chunk=128), n_labels=2, device="cpu")
    r = Retriever(index=idx, doc_tokens=np.zeros((0, 3), np.int32),
                  embed_fn=lambda t: docs[:len(t)], k=3, ef=32, filter=1)
    # document i's tokens are 100 + 3i .. 102 + 3i
    r.add_documents(np.arange(40 * 3, dtype=np.int32).reshape(40, 3) + 100,
                    embeddings=docs, labels=list(lang))
    probe = int(np.nonzero(lang == 0)[0][0])
    r.embed_fn = lambda t: docs[probe:probe + 1]
    ctx = r.augment(np.zeros((1, 3), np.int32))[0, :9].reshape(3, 3)
    got = [(row[0] - 100) // 3 for row in ctx if row[0] >= 100]
    assert got and (lang[got] == 1).all()


def test_streaming_and_batch_dedup():
    from repro_torch.data import dedup

    rng = np.random.default_rng(0)
    base = rng.standard_normal((260, 48)).astype(np.float32)
    base /= np.linalg.norm(base, axis=-1, keepdims=True)
    dup = base[:15] + 0.001 * rng.standard_normal((15, 48)).astype(
        np.float32)
    corpus = np.concatenate([base[:130], dup, base[130:]], axis=0)
    planted = set(range(130, 145))
    for keep in (dedup.streaming_dedup(corpus, threshold=0.98, ef=48,
                                       scan_batch=64, device="cpu"),
                 dedup.semantic_dedup(corpus, threshold=0.98, ef=48,
                                      device="cpu")):
        dropped = set(range(len(corpus))) - set(keep.tolist())
        assert len(dropped & planted) >= 13 and len(dropped - planted) <= 4
        # first occurrence wins: the originals are all kept
        assert set(range(15)) <= set(keep.tolist())
    bare = MutableQuIVerIndex.empty(48, 300, keep_vectors=False,
                                    device="cpu")
    with pytest.raises(ValueError, match="cold vectors"):
        dedup.streaming_dedup(corpus, index=bare)


def test_add_documents_needs_a_mutable_index():
    idx = _port_graph()
    r = Retriever(index=idx, doc_tokens=np.zeros((1200, 2), np.int32),
                  embed_fn=lambda t: t)
    with pytest.raises(TypeError, match="mutable"):
        r.add_documents(np.zeros((2, 2), np.int32))
