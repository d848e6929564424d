"""The port's IVF layer against ``repro.ivf`` and the reference's IVF paths.

The corpus is the reference's own (``tests/test_ivf.py``): cohere-surrogate,
N = 1500, ``BuildParams(m=6, ef_construction=32, prune_pool=32, chunk=128,
ivf_candidates=True)``.  One JAX index is built and saved per module.  On
the same numpy-made inputs the port must give bit-identical list scans,
partitions, list candidates, IVF-seeded adjacency (from the JAX initial
graph) and ``nav="ivf"`` candidate ids; reranked ids may differ only where
two cosine scores lie within 1e-6, as in ``tests/test_torch_index.py``.
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
from repro.core.index import QuIVerIndex as JaxIndex
from repro.core.metric import MetricArrays as JaxArrays
from repro.core.metric import make_backend as jax_backend
from repro.ivf import build_partition as jax_build_partition
from repro.ivf import search as jsearch
from repro.kernels import dispatch as jdispatch
from repro.kernels.list_scan import list_scan_pallas
from repro.obs.metrics import MetricsRegistry as JaxRegistry
from repro.plan import resolve_plan
from repro_torch import convert
from repro_torch.core import bq, linking, metric, vamana
from repro_torch.core.baselines import flat_search, recall_at_k
from repro_torch.core.index import QuIVerIndex
from repro_torch.ivf.search import ivf_probes
from repro_torch.data.datasets import make_dataset
from repro_torch.ivf import IVFPartition, build_partition
from repro_torch.ivf.partition import majority_words
from repro_torch.ivf import search as psearch
from repro_torch.kernels import build, dispatch, list_scan
from repro_torch.obs.metrics import MetricsRegistry

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

N = 1500
PARAMS = dict(m=6, ef_construction=32, prune_pool=32, chunk=128,
              ivf_candidates=True)
JAX_PARAMS = jvamana.BuildParams(**PARAMS)


def _t(a):
    """A numpy or JAX array as a torch tensor (uint32 as int32 views)."""
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _port_partition(part) -> IVFPartition:
    """The reference's partition as the port's (CPU tensors)."""
    return IVFPartition.from_npz(part.to_npz_fields(), "cpu")


def assert_ids_match(a, b, scores_a, scores_b, tol=1e-6):
    """Ids may differ at a rank only where the two scores there tie."""
    np.testing.assert_allclose(scores_a, scores_b, rtol=1e-5, atol=1e-6)
    diff = a != b
    assert (np.abs(scores_a - scores_b)[diff] <= tol).all(), (
        np.nonzero(diff.any(axis=1))[0][:5])


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    base, queries = make_dataset("cohere-surrogate", N, queries=200)
    index = JaxIndex.build(jnp.asarray(base), JAX_PARAMS)
    path = tmp_path_factory.mktemp("ivf") / "jax.npz"
    index.save(str(path))
    with np.load(path) as z:
        fields = dict(z)
    sigs = bq.Signature(_t(index.sigs.words), index.sigs.dim)
    truth, _ = flat_search(base, queries, 10, device="cpu")
    return {"base": base, "queries": queries, "index": index, "path": path,
            "fields": fields, "sigs": sigs, "truth": truth,
            "jb": jax_backend("bq2", JaxArrays(sigs=index.sigs), route="ref"),
            "pb": metric.make_backend("bq2", metric.MetricArrays(sigs=sigs))}


@pytest.fixture(scope="module")
def port_index(ref):
    return QuIVerIndex.build(ref["base"], vamana.BuildParams(**PARAMS),
                             device="cpu")


# -- the list-scan kernel ----------------------------------------------------


@pytest.mark.parametrize("dim", [64, 100, 384, 768, 1536])
@pytest.mark.parametrize("q,el", [(16, 128), (33, 300)])
def test_scan_plain_matches_reference(dim, q, el):
    rng = np.random.default_rng(dim + el)
    x = rng.standard_normal((q + el, dim)).astype(np.float32)
    words = np.asarray(jbq.encode(jnp.asarray(x)).words)
    qw, cw = words[:q], words[q:]
    got = list_scan.scan_plain(_t(qw), _t(cw), bq.valid_mask(dim))
    want = jdispatch.list_scan_ops(dim, route="ref").scan(
        jnp.asarray(qw), jnp.asarray(cw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the Pallas kernel takes Q % 8 == 0 and L % 128 == 0: zero-pad
    qp = np.pad(qw, ((0, -q % 8), (0, 0)))
    cp = np.pad(cw, ((0, -el % 128), (0, 0)))
    pallas = list_scan_pallas(jnp.asarray(qp), jnp.asarray(cp),
                              jbq.valid_mask(dim), dim=dim, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas)[:q, :el])
    # the dispatch binding on a CPU tensor takes the plain version
    build.reset_launches()
    bound = dispatch.list_scan_ops(dim, "cpu").scan(_t(qw), _t(cw))
    assert torch.equal(bound, got) and sum(build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("dim", [64, 100, 384, 768, 3072])
@pytest.mark.parametrize("q,el", [(7, 45), (19, 130)])
def test_int8_levels_give_the_reference_similarities(dim, q, el):
    """The int8 levels the tensor-core kernel stages, multiplied as
    integers, give exactly the Pallas kernel's (interpret mode) and
    ``repro.core.bq``'s similarities."""
    rng = np.random.default_rng(dim + q)
    x = rng.standard_normal((q + el, dim)).astype(np.float32)
    sig = jbq.encode(jnp.asarray(x))
    words = np.asarray(sig.words)
    qw, cw = words[:q], words[q:]
    mask = bq.valid_mask(dim)
    lq = list_scan.int8_levels(_t(qw), mask)
    lc = list_scan.int8_levels(_t(cw), mask)
    assert lq.dtype == torch.int8 and lq.shape == (q, 32 * mask.shape[0])
    assert set(lq.unique().tolist()) <= {-2, -1, 0, 1, 2}
    assert not lq[:, dim:].any()
    got = (lq.long() @ lc.long().T).numpy()
    want = -np.asarray(jbq.pairwise_distance(
        jbq.Signature(jnp.asarray(qw), dim), jbq.Signature(jnp.asarray(cw),
                                                           dim)))
    np.testing.assert_array_equal(got, want)
    qp = np.pad(qw, ((0, -q % 8), (0, 0)))
    cp = np.pad(cw, ((0, -el % 128), (0, 0)))
    pallas = list_scan_pallas(jnp.asarray(qp), jnp.asarray(cp),
                              jbq.valid_mask(dim), dim=dim, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas)[:q, :el])


def test_scan_checks_inputs():
    mask = bq.valid_mask(100)
    cent = torch.zeros((5, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="q_words must be"):
        list_scan.scan(torch.zeros((3, 6), dtype=torch.int32), cent, mask)
    with pytest.raises(ValueError, match="int32"):
        list_scan.scan(torch.zeros((3, 8), dtype=torch.int64), cent, mask)
    with pytest.raises(ValueError, match="table must be"):
        list_scan.scan(torch.zeros((3, 8), dtype=torch.int32), cent[:, :4],
                       mask)


# -- partition ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("balance", [1.5, None])
def test_partition_matches_reference(ref, seed, balance):
    want = jax_build_partition(ref["index"].sigs, seed=seed, balance=balance,
                               route="ref")
    got = build_partition(ref["sigs"], seed=seed, balance=balance)
    np.testing.assert_array_equal(got.cent_words.numpy(),
                                  np.asarray(want.cent_words).view(np.int32))
    np.testing.assert_array_equal(got.list_ids.numpy(),
                                  np.asarray(want.list_ids))
    for field in ("cent_ids", "assign", "offsets", "member_ids"):
        g, w = getattr(got, field), getattr(want, field)
        np.testing.assert_array_equal(g, w, err_msg=field)
        assert g.dtype == w.dtype, field
    assert (got.cap, got.n_lists, got.dim, got.seed) \
        == (want.cap, want.n_lists, want.dim, want.seed)
    assert (got.default_probes, got.build_probes) \
        == (want.default_probes, want.build_probes)


# glove-like cases where the port's encode of the majority centroids (the
# binarize kernel's order) set other strong bits than the reference
@pytest.mark.parametrize("n,seed", [(1500, 0), (3000, 1)])
def test_partition_matches_reference_at_threshold_ties(n, seed):
    """A majority centroid's mean |x| can equal one of its entries exactly
    (a mean of levels is made of multiples of 1/count): its strong bits
    then follow the reference's summation order of tau."""
    base, _ = make_dataset("glove-like", n)
    base = base / np.linalg.norm(base, axis=1, keepdims=True)
    words = jbq.encode(jnp.asarray(base)).words
    want = jax_build_partition(jbq.Signature(words, base.shape[1]),
                               seed=seed, route="ref")
    got = build_partition(bq.Signature(_t(words), base.shape[1]), seed=seed)
    np.testing.assert_array_equal(got.cent_words.numpy(),
                                  np.asarray(want.cent_words).view(np.int32))
    for field in ("cent_ids", "assign", "offsets", "member_ids"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)


@pytest.mark.parametrize("dim", [17, 33, 100, 384, 768, 1536, 2304, 3072])
def test_majority_words_match_reference_encode(dim):
    """The majority centroids' encode sums tau as XLA does on the CPU: equal
    words, ties at |x| = tau included (levels averaged over 31 rows)."""
    rng = np.random.default_rng(dim)
    levels = rng.choice(np.float32([-2, -1, 1, 2]), size=(2000, 31, dim))
    mean = levels.sum(axis=1) / np.float32(31)
    want = np.asarray(jbq.encode(jnp.asarray(mean)).words)
    got = majority_words(torch.from_numpy(mean))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_build_partition_matches_the_index_partition(ref, port_index):
    want = ref["index"].ivf
    got = port_index.ivf
    np.testing.assert_array_equal(got.cent_words.numpy(),
                                  np.asarray(want.cent_words).view(np.int32))
    np.testing.assert_array_equal(got.member_ids, want.member_ids)
    np.testing.assert_array_equal(got.cent_ids, want.cent_ids)


def test_shard_medoids_matches_reference(ref):
    from repro.core import linking as jlinking

    rng = np.random.default_rng(5)
    shards = rng.integers(0, N, size=(9, 40)).astype(np.int32)
    shards[rng.random(shards.shape) < 0.2] = -1
    shards[3] = shards[3, 0]          # every slot ties: the first wins
    shards[4] = -1                    # an empty shard
    reprs = np.asarray(ref["index"].sigs.words)[rng.integers(0, N, 9)]
    want = jlinking.shard_medoids(ref["jb"], jnp.asarray(reprs),
                                  jnp.asarray(shards))
    got = linking.shard_medoids(ref["pb"], _t(reprs), _t(shards))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_layout_survives_npz(ref):
    part = ref["index"].ivf
    got = _port_partition(part)
    np.testing.assert_array_equal(got.list_ids.numpy(),
                                  np.asarray(part.list_ids))
    assert got.memory_bytes() == part.memory_bytes()
    fields = got.to_npz_fields()
    for key, value in part.to_npz_fields().items():
        np.testing.assert_array_equal(fields[key], value, err_msg=key)
        assert np.asarray(fields[key]).dtype == np.asarray(value).dtype, key


# -- search primitives -------------------------------------------------------


def _probes(part, which):
    return {"one": 1, "default": part.default_probes,
            "all": part.n_lists}[which]


@pytest.mark.parametrize("which", ["one", "default", "all"])
def test_search_primitives_match_reference(ref, which):
    part = ref["index"].ivf
    pp = _port_partition(part)
    p = _probes(part, which)
    jw = np.asarray(jbq.encode(jnp.asarray(ref["queries"][:40])).words)
    jscan = jdispatch.list_scan_ops(part.dim, route="ref").scan
    pscan = dispatch.list_scan_ops(part.dim, "cpu").scan
    want_top = jsearch.top_lists(jscan, jnp.asarray(jw), part.cent_words, p)
    got_top = psearch.top_lists(pscan, _t(jw), pp.cent_words, p)
    np.testing.assert_array_equal(got_top.numpy(), np.asarray(want_top))
    want = jsearch.list_candidates(ref["jb"], jnp.asarray(jw),
                                   part.list_ids, want_top)
    got = psearch.list_candidates(ref["pb"], _t(jw), pp.list_ids, got_top)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # ef within the pool, and ef beyond probes * cap (a short pool)
    for ef in (64, p * part.cap + 24):
        want = jsearch.scan_search(ref["jb"], jscan, jnp.asarray(jw),
                                   part.cent_words, part.list_ids,
                                   probes=p, ef=ef)
        got = psearch.scan_search(ref["pb"], pscan, _t(jw), pp.cent_words,
                                  pp.list_ids, probes=p, ef=ef)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # lists hold fewer members than cap: the short pool's tail is padding
    assert (got[0][:, -1] == -1).all()
    assert (got[1][:, -1] == psearch.INF).all()


def test_record_routes_matches_reference():
    top = np.random.default_rng(2).integers(0, 12, size=(30, 4))
    shards = np.random.default_rng(3).integers(1, 9, size=30)
    jreg, preg = JaxRegistry(), MetricsRegistry()
    jsearch.record_routes(jnp.asarray(top), shards, registry=jreg)
    psearch.record_routes(torch.from_numpy(top), torch.from_numpy(shards),
                          registry=preg)
    assert preg.snapshot() == jreg.snapshot()


@pytest.mark.parametrize("k", [1, 10, 100, 500])
@pytest.mark.parametrize("probes", [None, 0, 1, 5, 200])
def test_probe_resolution_matches_planner(ref, k, probes):
    index = ref["index"]
    plan, _ = resolve_plan(index, k=k, ef=max(k, 64), nav="ivf",
                           probes=probes)
    assert ivf_probes(_port_partition(index.ivf), k, probes) == plan.probes


# -- IVF-seeded build --------------------------------------------------------


def test_ivf_seeded_build_matches_reference(ref):
    index = ref["index"]
    init_adj, _ = jvamana._init_graph(N, JAX_PARAMS, JAX_PARAMS.seed)
    adj, medoid, stats = vamana.build_graph(
        ref["pb"], vamana.BuildParams(**PARAMS), ivf=_port_partition(index.ivf),
        init_adjacency=_t(init_adj), medoid=index.medoid)
    assert medoid == index.medoid
    np.testing.assert_array_equal(adj.numpy(), np.asarray(index.adjacency))
    want = index.build_stats
    for field in ("chunks", "consolidations", "reverse_edges_added",
                  "occluded_total"):
        assert getattr(stats, field) == getattr(want, field), field
    assert stats.mean_hops == want.mean_hops == 0.0
    for field in ("pool_occupancy", "survivor_ratio"):
        assert getattr(stats, field) == pytest.approx(
            getattr(want, field), rel=1e-6), field


def test_ivf_build_makes_its_own_partition(ref):
    # without ``ivf=`` the build partitions the signatures itself
    init_adj, _ = jvamana._init_graph(N, JAX_PARAMS, JAX_PARAMS.seed)
    adj, _, _ = vamana.build_graph(
        ref["pb"], vamana.BuildParams(**PARAMS),
        init_adjacency=_t(init_adj), medoid=ref["index"].medoid)
    np.testing.assert_array_equal(adj.numpy(),
                                  np.asarray(ref["index"].adjacency))


# -- the index: nav="ivf", archives, accounting --------------------------------


def test_jax_ivf_archive_searches_identically(ref):
    index = QuIVerIndex.load(str(ref["path"]), device="cpu")
    part = ref["index"].ivf
    wide = -(-3 * part.n_lists // 4)
    q = ref["queries"]
    for kw in ({"nav": "ivf", "ef": 128}, {"nav": "ivf", "ef": 128,
                                           "probes": wide},
               {"nav": "bq2", "ef": 64}):
        jids, jscores = ref["index"].search(jnp.asarray(q), k=10, **kw)
        ids, scores = index.search(q, k=10, **kw)
        assert_ids_match(ids, np.asarray(jids), scores, np.asarray(jscores))
        # the candidate stage alone is integer-exact
        jids, jscores = ref["index"].search(jnp.asarray(q), k=10,
                                            rerank=False, **kw)
        ids, scores = index.search(q, k=10, rerank=False, **kw)
        np.testing.assert_array_equal(ids, np.asarray(jids))
        np.testing.assert_array_equal(scores, np.asarray(jscores))


def test_port_ivf_archive_loads_in_reference(ref, port_index, tmp_path):
    path = tmp_path / "port.npz"
    port_index.save(str(path))
    loaded = JaxIndex.load(str(path))
    part, want = loaded.ivf, port_index.ivf
    np.testing.assert_array_equal(np.asarray(part.cent_words),
                                  want.cent_words.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(part.list_ids),
                                  want.list_ids.numpy())
    for field in ("cent_ids", "assign", "offsets", "member_ids"):
        np.testing.assert_array_equal(getattr(part, field),
                                      getattr(want, field), err_msg=field)
    assert (part.dim, part.seed, part.cap) == (want.dim, want.seed, want.cap)
    jids, jscores = loaded.search(jnp.asarray(ref["queries"]), k=10, ef=128,
                                  nav="ivf")
    ids, scores = port_index.search(ref["queries"], k=10, ef=128, nav="ivf")
    assert_ids_match(ids, np.asarray(jids), scores, np.asarray(jscores))


def test_ivf_memory_breakdown_matches_reference(ref, port_index):
    index = convert.index_from_numpy(ref["fields"], "cpu")
    assert index.memory_breakdown() == ref["index"].memory_breakdown()
    assert index.memory_breakdown()["hot_ivf_bytes"] > 0
    assert port_index.memory_breakdown() == ref["index"].memory_breakdown()


def test_convert_round_trips_the_ivf_archive(ref):
    fields = convert.index_to_numpy(
        convert.index_from_numpy(ref["fields"], "cpu"))
    assert any(key.startswith("ivf_") for key in fields)
    assert set(fields) == set(ref["fields"])
    for key, value in ref["fields"].items():
        np.testing.assert_array_equal(fields[key], value, err_msg=key)
        assert fields[key].dtype == value.dtype, key


def test_port_ivf_recall_matches_reference(ref, port_index):
    q, truth = ref["queries"], ref["truth"]
    part = ref["index"].ivf
    for kw in ({"nav": "bq2", "ef": 64}, {"nav": "ivf", "ef": 128},
               {"nav": "ivf", "ef": 128,
                "probes": -(-3 * part.n_lists // 4)}):
        jids, _ = ref["index"].search(jnp.asarray(q), k=10, **kw)
        ids, scores = port_index.search(q, k=10, **kw)
        assert ids.shape == (len(q), 10) and np.isfinite(scores).all()
        want = recall_at_k(np.asarray(jids), truth)
        got = recall_at_k(ids, truth)
        assert want > 0.8, kw
        assert abs(got - want) <= 0.005 + 1e-12, (kw, got, want)  # 0.5 pt


def test_build_ivf_attaches_the_reference_partition(ref):
    index = convert.index_from_numpy(
        {k: v for k, v in ref["fields"].items() if not k.startswith("ivf_")},
        "cpu")
    assert index.ivf is None
    with pytest.raises(ValueError, match="coarse partition"):
        index.search(ref["queries"][:2], nav="ivf")
    jindex = dataclasses.replace(ref["index"], ivf=None, _backends={},
                                 _plan_cache=None)
    with pytest.raises(ValueError, match="coarse partition"):
        jindex.search(jnp.asarray(ref["queries"][:2]), nav="ivf")
    want = jindex.build_ivf(n_lists=20, seed=3)
    got = index.build_ivf(n_lists=20, seed=3)
    np.testing.assert_array_equal(got.cent_words.numpy(),
                                  np.asarray(want.cent_words).view(np.int32))
    np.testing.assert_array_equal(got.member_ids, want.member_ids)
    jids, jscores = jindex.search(jnp.asarray(ref["queries"]), k=10,
                                  nav="ivf", ef=96, rerank=False)
    ids, scores = index.search(ref["queries"], k=10, nav="ivf", ef=96,
                               rerank=False)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_array_equal(scores, np.asarray(jscores))
