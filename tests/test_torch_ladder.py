"""The port's metric ladder (bq1, adc, float32) against the reference.

On the same numpy-made inputs the port must give:

* bit-exact 1-bit Hamming distances: the ``hamming`` plain versions
  against ``repro.kernels.ref.hamming_distance_ref`` and the Pallas kernel
  in interpret mode, ``bq1_ops`` against the reference's ``ref`` route, and
  the bq1 backend's ``dist_many``/``pairwise``;
* float32 backend distances (in [0, 2]) within ``rtol=1e-6, atol=1e-5``
  and adc distances (up to ``4*sqrt(D)``, 78 at D = 384, each a sum of D
  products of up to 2) within ``rtol=1e-6, atol=2.5e-4``: ``torch.bmm``
  and XLA's dot sum in other orders;
* an identical bq1 adjacency and medoid from the JAX initial graph;
* adc and float32 builds (float distances: the graphs may part at a
  near-tie) within 0.5 pt of the reference's recall@10, with most edges
  shared (the overlap is asserted and stated in the test);
* on one JAX-built graph, for every nav kind, with and without a rotation,
  reranked ids that may differ only where two cosine scores lie within
  1e-6 (the rule of ``chip_smoke.py``'s ``ids_match``), and on the
  signature kinds identical hot-path ids and scores;
* under adaptive escalation, on the graph route and on the ivf route, the
  same escalated query set and ids matched by that rule;
* archives of every metric kind that cross-load both ways.

All on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bq as jbq
from repro.core import vamana as jvamana
from repro.core.beam import beam_margin as jax_beam_margin
from repro.core.index import QuIVerIndex as JaxIndex
from repro.core.index import random_rotation
from repro.core.metric import MetricArrays as JaxArrays
from repro.core.metric import make_backend as jax_backend
from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.plan import resolve_plan
from repro.probe import NavPolicy as JaxPolicy
from repro_torch import convert
from repro_torch.core import beam as pbeam
from repro_torch.core import bq, metric, vamana
from repro_torch.core.baselines import flat_search, recall_at_k
from repro_torch.core.index import QuIVerIndex
from repro_torch.data.datasets import make_dataset
from repro_torch.kernels import build, dispatch, hamming
from repro_torch.plan import PlanCache

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

N = 1200
PARAMS = dict(m=6, ef_construction=32, prune_pool=32, chunk=128)
JAX_PARAMS = jvamana.BuildParams(**PARAMS)
# float distances in another summation order (see the module docstring)
FLOAT_TOL = {"float32": dict(rtol=1e-6, atol=1e-5),
             "adc": dict(rtol=1e-6, atol=2.5e-4)}


def _t(a):
    """A numpy or JAX array as a torch tensor (uint32 as int32 views)."""
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def assert_ids_match(a, b, scores_a, scores_b, tol=1e-6):
    """Ids may differ at a rank only where the two scores there tie."""
    np.testing.assert_allclose(scores_a, scores_b, rtol=1e-5, atol=1e-6)
    diff = a != b
    assert (np.abs(scores_a - scores_b)[diff] <= tol).all(), (
        np.nonzero(diff.any(axis=1))[0][:5])


def _words(rng, n, dim):
    x = rng.standard_normal((n, dim)).astype(np.float32)
    return np.asarray(jbq.encode(jnp.asarray(x)).words)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    base, queries = make_dataset("minilm-surrogate", N, queries=60)
    index = JaxIndex.build(jnp.asarray(base), JAX_PARAMS)
    path = tmp_path_factory.mktemp("ladder") / "jax.npz"
    index.save(str(path))
    with np.load(path) as z:
        fields = dict(z)
    truth, _ = flat_search(base, queries, 10, device="cpu")
    sigs = bq.Signature(_t(index.sigs.words), index.sigs.dim)
    return {"base": base, "queries": queries, "index": index,
            "fields": fields, "truth": truth, "sigs": sigs}


# -- the hamming kernel's plain versions -------------------------------------


@pytest.mark.parametrize("dim", [64, 100, 384, 768, 1536])
@pytest.mark.parametrize("q,n", [(1, 64), (8, 512), (13, 777)])
def test_hamming_plain_matches_reference(dim, q, n):
    rng = np.random.default_rng(dim + q + n)
    qw, bw = _words(rng, q, dim), _words(rng, n, dim)
    w = bq.n_words(dim)
    want = np.asarray(jref.hamming_distance_ref(
        jnp.asarray(qw[:, :w]), jnp.asarray(bw[:, :w]), dim))
    if (q, n) == (13, 777):
        # the Pallas kernel in interpret mode, at the ragged shape
        pallas = jops.hamming_distance(jnp.asarray(qw[:, :w]),
                                       jnp.asarray(bw[:, :w]), interpret=True)
        np.testing.assert_array_equal(np.asarray(pallas), want)
    ids = torch.arange(n, dtype=torch.int32).expand(q, n).contiguous()
    build.reset_launches()
    got = hamming.dist_rows(_t(qw[:, :w]).contiguous(), ids, _t(bw))
    np.testing.assert_array_equal(got.numpy(), want)
    # pairwise: pools of the base rows against themselves
    c = min(n, 40)
    pool = torch.from_numpy(rng.integers(0, n, (3, c), dtype=np.int32))
    pw = hamming.pairwise(pool, _t(bw), bq.valid_mask(dim))
    rows = bw[pool.numpy(), :w]
    want_pw = np.stack([np.asarray(jref.hamming_distance_ref(
        jnp.asarray(r), jnp.asarray(r), dim)) for r in rows])
    np.testing.assert_array_equal(pw.numpy(), want_pw)
    assert sum(build.LAUNCHES.values()) == 0     # CPU tensors: plain route


def test_hamming_checks_inputs():
    table = torch.zeros((10, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="q must be"):
        hamming.dist_rows(torch.zeros((2, 8), dtype=torch.int32),
                          torch.zeros((2, 3), dtype=torch.int32), table)
    with pytest.raises(ValueError, match="int32"):
        hamming.pairwise(torch.zeros((2, 3), dtype=torch.int64), table,
                         bq.valid_mask(100))
    with pytest.raises(ValueError, match="table must be"):
        hamming.pairwise(torch.zeros((2, 3), dtype=torch.int32),
                         torch.zeros((10, 7), dtype=torch.int32),
                         bq.valid_mask(100))


@pytest.mark.parametrize("dim", [64, 100, 384])
def test_bq1_ops_matches_reference(dim):
    rng = np.random.default_rng(dim)
    table = _words(rng, 300, dim)
    w = bq.n_words(dim)
    ids = rng.integers(0, 300, (7, 37), dtype=np.int32)
    q = table[rng.integers(0, 300, 7), :w]
    jops_ = jdispatch.bq1_ops(dim, route="ref")
    want = np.asarray(jops_.dist_rows(jnp.asarray(q),
                                      jnp.asarray(table[ids, :w])))
    want_pw = np.asarray(jops_.pairwise(jnp.asarray(table[ids, :w])))
    ops = dispatch.bq1_ops(dim, "cpu")
    got = ops.dist_rows(_t(q), _t(ids), _t(table))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ops.pairwise(_t(ids), _t(table)).numpy(),
                                  want_pw)


@pytest.mark.parametrize("dim", [100, 384])
def test_bq_helpers_match_reference(dim):
    rng = np.random.default_rng(dim + 1)
    x = rng.standard_normal((40, dim)).astype(np.float32)
    a, b = jbq.encode(jnp.asarray(x[:20])), jbq.encode(jnp.asarray(x[20:]))
    pa = bq.Signature(_t(a.words), dim)
    pb = bq.Signature(_t(b.words), dim)
    np.testing.assert_array_equal(
        bq.hamming_distance_1bit(pa, pb).numpy(),
        np.asarray(jbq.hamming_distance_1bit(a, b)))
    np.testing.assert_array_equal(
        bq.pairwise_hamming_1bit(pa, pb).numpy(),
        np.asarray(jbq.pairwise_hamming_1bit(a, b)))
    qf = x[:5] / np.linalg.norm(x[:5], axis=1, keepdims=True)
    np.testing.assert_allclose(
        bq.adc_distance(torch.from_numpy(qf), pb).numpy(),
        np.asarray(jbq.adc_distance(jnp.asarray(qf), b)), **FLOAT_TOL["adc"])
    assert bq.distance_upper_bound(dim) == jbq.distance_upper_bound(dim)


# -- the backends ------------------------------------------------------------


@pytest.mark.parametrize("kind", ["bq1", "adc", "float32"])
def test_backend_matches_reference(ref, kind):
    index = ref["index"]
    jb = jax_backend(kind, JaxArrays(sigs=index.sigs, vectors=index.vectors),
                     route="ref")
    pb = metric.make_backend(kind, metric.MetricArrays(
        sigs=ref["sigs"], vectors=_t(index.vectors)))
    assert pb.kind == kind and pb.n == N
    assert pb.neutral_dist == jb.neutral_dist
    rng = np.random.default_rng(3)
    ids = rng.integers(0, N, (9, 40), dtype=np.int32)
    nodes = rng.integers(0, N, 9, dtype=np.int32)
    q = np.asarray(ref["queries"][:9], dtype=np.float32)
    jq = np.asarray(jb.encode_queries(jnp.asarray(q)))
    pq = pb.encode_queries(torch.from_numpy(q))
    jr = np.asarray(jb.query_repr(jnp.asarray(nodes)))
    pr = pb.query_repr(torch.from_numpy(nodes))
    want = np.asarray(jb.dist_many(jnp.asarray(jq), jnp.asarray(ids), None))
    want_pw = np.asarray(jb.pairwise(jnp.asarray(ids)))
    want_r = np.asarray(jb.dist_many(jnp.asarray(jr), jnp.asarray(ids), None))
    if kind == "bq1":
        # integer distances: exact
        np.testing.assert_array_equal(pq.numpy().view(np.uint32), jq)
        np.testing.assert_array_equal(pr.numpy().view(np.uint32), jr)
        np.testing.assert_array_equal(
            pb.dist_many(pq, torch.from_numpy(ids)).numpy(), want)
        np.testing.assert_array_equal(
            pb.pairwise(torch.from_numpy(ids)).numpy(), want_pw)
        np.testing.assert_array_equal(
            pb.dist_many(pr, torch.from_numpy(ids)).numpy(), want_r)
    else:
        tol = FLOAT_TOL[kind]
        np.testing.assert_allclose(pq.numpy(), jq, **tol)
        np.testing.assert_allclose(pr.numpy(), jr, **tol)
        np.testing.assert_allclose(
            pb.dist_many(pq, torch.from_numpy(ids)).numpy(), want, **tol)
        np.testing.assert_allclose(
            pb.pairwise(torch.from_numpy(ids)).numpy(), want_pw, **tol)
        np.testing.assert_allclose(
            pb.dist_many(pr, torch.from_numpy(ids)).numpy(), want_r, **tol)


def test_backends_refuse_missing_arrays(ref):
    for kind in ("bq1", "adc"):
        with pytest.raises(ValueError, match="signatures"):
            metric.make_backend(kind, metric.MetricArrays())
    with pytest.raises(ValueError, match="cold vectors"):
        metric.make_backend("float32", metric.MetricArrays(sigs=ref["sigs"]))
    assert metric.registered_kinds() == ["adc", "bq1", "bq2", "float32"]
    x = torch.from_numpy(ref["queries"][:3])
    assert torch.equal(metric.encode_queries_for("bq2", x),
                       bq.encode(x).words)


# -- builds in every space ---------------------------------------------------


@pytest.fixture(scope="module")
def builds(ref):
    """Per metric kind: the reference's build, and the port's build over the
    same signatures and vectors from the JAX initial graph (its own
    medoid)."""
    init_adj, _ = jvamana._init_graph(N, JAX_PARAMS, JAX_PARAMS.seed)
    out = {}
    for kind in ("bq1", "adc", "float32"):
        index = JaxIndex.build(jnp.asarray(ref["base"]), JAX_PARAMS,
                               metric=kind)
        pb = metric.make_backend(kind, metric.MetricArrays(
            sigs=bq.Signature(_t(index.sigs.words), index.sigs.dim),
            vectors=_t(index.vectors)))
        adj, medoid, stats = vamana.build_graph(
            pb, vamana.BuildParams(**PARAMS), init_adjacency=_t(init_adj))
        port = QuIVerIndex(
            sigs=bq.Signature(_t(index.sigs.words), index.sigs.dim),
            adjacency=adj, medoid=medoid,
            params=vamana.BuildParams(**PARAMS), vectors=_t(index.vectors),
            build_stats=stats, metric_kind=kind)
        out[kind] = (index, port)
    return out


def test_bq1_build_matches_reference(builds):
    index, port = builds["bq1"]
    # the port's own medoid (decoded levels' mean, re-encoded sign plane)
    assert port.medoid == index.medoid
    np.testing.assert_array_equal(port.adjacency.numpy(),
                                  np.asarray(index.adjacency))
    for field in ("chunks", "consolidations", "reverse_edges_added",
                  "occluded_total"):
        assert getattr(port.build_stats, field) \
            == getattr(index.build_stats, field)


# measured on this corpus (CPU): adc shares 0.9797 of the reference graph's
# edges (recall@10 0.9500 against 0.9533), float32 all of them (0.9483 both)
@pytest.mark.parametrize("kind,min_overlap", [("adc", 0.97),
                                              ("float32", 0.99)])
def test_float_build_matches_reference_recall(ref, builds, kind,
                                              min_overlap):
    index, port = builds[kind]
    assert port.medoid == index.medoid
    jadj = np.asarray(index.adjacency)
    shared = [len(np.intersect1d(a[a >= 0], b[b >= 0]))
              for a, b in zip(port.adjacency.numpy(), jadj)]
    overlap = sum(shared) / int((jadj >= 0).sum())
    assert overlap >= min_overlap, overlap
    jids, _ = index.search(jnp.asarray(ref["queries"]), k=10, ef=64)
    ids, _ = port.search(ref["queries"], k=10, ef=64)
    want = recall_at_k(np.asarray(jids), ref["truth"])
    got = recall_at_k(ids, ref["truth"])
    assert abs(got - want) <= 0.005 + 1e-12, (got, want)   # 0.5 pt


def test_ivf_seeded_float32_build_is_refused(ref):
    params = vamana.BuildParams(**PARAMS, ivf_candidates=True)
    with pytest.raises(ValueError, match="signature-bearing"):
        QuIVerIndex.build(ref["base"][:300], params, metric="float32",
                          device="cpu")


# -- search: every nav kind on one graph -------------------------------------


@pytest.mark.parametrize("rotated", [False, True], ids=["plain", "rotated"])
@pytest.mark.parametrize("nav", ["bq2", "bq1", "adc", "float32"])
def test_nav_kinds_on_one_graph_match_reference(ref, nav, rotated):
    jindex, fields = ref["index"], ref["fields"]
    if rotated:
        rot = np.asarray(random_rotation(ref["base"].shape[1], 11))
        jindex = dataclasses.replace(jindex, rotation=jnp.asarray(rot),
                                     _backends={}, _plan_cache=None)
        fields = {**fields, "rotation": rot}
    port = convert.index_from_numpy(fields, "cpu")
    q = ref["queries"]
    jids, jscores = jindex.search(jnp.asarray(q), k=10, ef=48, nav=nav)
    ids, scores = port.search(q, k=10, ef=48, nav=nav)
    assert_ids_match(ids, np.asarray(jids), scores, np.asarray(jscores))
    if nav in ("bq2", "bq1"):
        # integer navigation distances: the hot path is exact
        jids, jscores = jindex.search(jnp.asarray(q), k=10, ef=48, nav=nav,
                                      rerank=False)
        ids, scores = port.search(q, k=10, ef=48, nav=nav, rerank=False)
        np.testing.assert_array_equal(ids, np.asarray(jids))
        np.testing.assert_array_equal(scores, np.asarray(jscores))


# -- adaptive escalation -----------------------------------------------------


def _spy_margins(monkeypatch):
    """Record the margins the port's search escalates on: the first
    stage's margins and the threshold its plan cache compares them with."""
    seen = {}
    real = PlanCache.finalize

    def spy(self, pending):
        if pending.plan.adaptive:
            seen["margins"] = np.concatenate(
                [m[:real_rows].numpy()
                 for _, _, m, _, real_rows in pending.chunks])
            seen["thr"] = pending.plan.escalate_margin
        return real(self, pending)

    monkeypatch.setattr(PlanCache, "finalize", spy)
    return seen


def _jax_margins(index, queries, **kw):
    """The reference plan's first-stage margins and its threshold."""
    plan, ctx = resolve_plan(index, **kw)
    pending = index.plans.launch(plan, ctx, jnp.asarray(queries))
    margins = np.concatenate([np.asarray(m[:real])
                              for _, _, m, _, real in pending.chunks])
    return margins, plan.escalate_margin


@pytest.mark.parametrize("route", ["graph", "ivf"])
def test_adaptive_matches_reference(ref, route, monkeypatch):
    jindex, q = ref["index"], ref["queries"]
    nav = "bq2"
    if route == "ivf":
        # a partition attached to the graph: the ivf route's plans
        jindex = dataclasses.replace(jindex, _backends={}, _plan_cache=None)
        jindex.build_ivf()
        nav = "ivf"
    # a threshold at the median first-stage margin: half the queries
    # escalate
    plain = JaxPolicy(nav=nav)
    margins, _ = _jax_margins(dataclasses.replace(
        jindex, policy=plain, _plan_cache=None), q, k=10, ef=32)
    thr = float(np.median(margins))
    policy = JaxPolicy(nav=nav, ef_scale=2, adaptive=True,
                       escalate_margin=thr, source="probe")
    jindex = dataclasses.replace(jindex, policy=policy, _backends={},
                                 _plan_cache=None)
    port = convert.index_from_numpy(_fields_of(jindex), "cpu")
    assert dataclasses.asdict(port.policy) == dataclasses.asdict(policy)
    jm, jthr = _jax_margins(jindex, q, k=10, ef=16)
    seen = _spy_margins(monkeypatch)
    ids, scores = port.search(q, k=10, ef=16)
    jids, jscores = jindex.search(jnp.asarray(q), k=10, ef=16)
    assert seen["thr"] == jthr
    esc, jesc = np.nonzero(seen["margins"] < thr)[0], np.nonzero(jm < jthr)[0]
    assert 0 < len(esc) < len(q)
    np.testing.assert_array_equal(esc, jesc)
    np.testing.assert_array_equal(seen["margins"], jm)
    assert_ids_match(ids, np.asarray(jids), scores, np.asarray(jscores))
    # forcing adaptive with an explicit nav uses the default schedule
    ids, scores = port.search(q, k=10, ef=16, nav=nav, adaptive=True)
    jids, jscores = jindex.search(jnp.asarray(q), k=10, ef=16, nav=nav,
                                  adaptive=True)
    assert_ids_match(ids, np.asarray(jids), scores, np.asarray(jscores))


def _fields_of(jindex):
    """A JAX index's archive fields, written and read back."""
    import io
    buf = io.BytesIO()
    jindex.save(buf)
    buf.seek(0)
    with np.load(buf) as z:
        return dict(z)


def test_beam_margin_scales_per_nav_kind(ref):
    dists = torch.tensor([[1.0, 2.0, 3.0], [5.0, 9.0, 3.0e38]])
    for kind in ("bq1", "adc", "float32"):
        pb = convert.index_from_numpy(ref["fields"], "cpu").backend(kind)
        got = pbeam.beam_margin(dists, 2, pb.neutral_dist).numpy()
        want = np.asarray(jax_beam_margin(jnp.asarray(dists.numpy()), 2,
                                          pb.neutral_dist))
        np.testing.assert_array_equal(got, want)


# -- archives of every metric kind -------------------------------------------


@pytest.mark.parametrize("kind", ["bq1", "adc", "float32"])
def test_archives_cross_load_every_kind(ref, builds, kind, tmp_path):
    jindex, port = builds[kind]
    loaded = convert.index_from_numpy(_fields_of(jindex), "cpu")
    assert loaded.metric_kind == kind
    q = ref["queries"]
    jids, jscores = jindex.search(jnp.asarray(q), k=5, ef=24)
    ids, scores = loaded.search(q, k=5, ef=24)
    assert_ids_match(ids, np.asarray(jids), scores, np.asarray(jscores))
    # and the port's archive in the reference
    path = tmp_path / "port.npz"
    port.save(str(path))
    back = JaxIndex.load(str(path))
    assert back.metric_kind == kind
    np.testing.assert_array_equal(np.asarray(back.adjacency),
                                  port.adjacency.numpy())
    jids, jscores = back.search(jnp.asarray(q), k=5, ef=24)
    ids, scores = port.search(q, k=5, ef=24)
    assert_ids_match(ids, np.asarray(jids), scores, np.asarray(jscores))


def test_build_nav_ivf_matches_reference(ref, monkeypatch):
    """``build(nav="ivf")``: a bq2 graph, a partition and a manual ivf
    policy, so that searches default to the list scan."""
    small = ref["base"][:600]
    params = dict(PARAMS, m=4, ef_construction=24, prune_pool=24)
    jindex = JaxIndex.build(jnp.asarray(small), jvamana.BuildParams(**params),
                            nav="ivf")
    init_adj, _ = jvamana._init_graph(600, jvamana.BuildParams(**params), 0)
    init = _t(init_adj)
    monkeypatch.setattr(vamana, "_init_graph",
                        lambda n, p, seed, device: init.to(device))
    port = QuIVerIndex.build(small, vamana.BuildParams(**params), nav="ivf",
                             device="cpu")
    assert port.metric_kind == jindex.metric_kind == "bq2"
    assert dataclasses.asdict(port.policy) \
        == dataclasses.asdict(jindex.policy)
    np.testing.assert_array_equal(port.ivf.member_ids, jindex.ivf.member_ids)
    np.testing.assert_array_equal(port.adjacency.numpy(),
                                  np.asarray(jindex.adjacency))
    q = ref["queries"]
    jids, jscores = jindex.search(jnp.asarray(q), k=10, ef=32)
    ids, scores = port.search(q, k=10, ef=32)
    assert_ids_match(ids, np.asarray(jids), scores, np.asarray(jscores))
    # the ivf default reads probes; a forced graph search ignores them
    jids, jscores = jindex.search(jnp.asarray(q), k=10, ef=32, probes=2)
    ids, scores = port.search(q, k=10, ef=32, probes=2)
    assert_ids_match(ids, np.asarray(jids), scores, np.asarray(jscores))
    jids, jscores = jindex.search(jnp.asarray(q), k=10, ef=32, nav="bq2",
                                  probes=2)
    ids, scores = port.search(q, k=10, ef=32, nav="bq2", probes=2)
    assert_ids_match(ids, np.asarray(jids), scores, np.asarray(jscores))
