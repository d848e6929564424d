"""The port's filter layer (``repro_torch.filter``, the two-mask beam, the
filtered routes of ``plans.run`` and ``Retriever(filter=...)``) against
``repro.filter`` and the reference index, on the CPU.

One JAX index is built per module (minilm-surrogate, N = 2000, the build of
``tests/test_filtered.py``'s labelled index), given a coarse partition and
labels at selectivities ~0.5, ~0.1 and ~0.01 drawn as that test draws them,
and carried to the port with ``convert.index_from_numpy``.  Held:

* bit-exact: packed label words, ``eval_mask`` of every predicate shape
  (labels 31 and 32 on both sides of a word boundary), counts, estimated
  selectivities and entry labels, and a store's words through every
  mutation mode;
* per-label entry points equal to the reference's, with and without cold
  vectors;
* the masked beam on one graph: every ``BeamResult`` field identical to
  ``batched_beam_search`` under ``result_valid``, ``node_valid`` and both,
  at expand 1 and 4, and an all-true mask bit-identical to none;
* ``search`` per route: identical ids on the filtered graph and ivf routes
  and the brute route without rerank (scores within 1e-6 where reranked,
  identical where not); on the brute route with cold vectors, ids that may
  differ only where two cosine scores lie within 1e-6; -1/-inf tails for k
  above the match count; every returned id matching its predicate;
* ``Retriever(filter=...)`` giving the reference retriever's prompts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import filter as jfilter
from repro.core import beam as jbeam
from repro.core import linking as jlinking
from repro.core.index import QuIVerIndex as JaxIndex
from repro.core.vamana import BuildParams as JaxParams
from repro.ivf import search as jivf_search
from repro.kernels import dispatch as jdispatch
from repro.serve import engine as jengine
from repro_torch import convert
from repro_torch import filter as pfilter
from repro_torch.core import beam, linking
from repro_torch.data.datasets import make_dataset
from repro_torch.filter import labels as plabels
from repro_torch.ivf import search as pivf_search
from repro_torch.kernels import dispatch
from repro_torch.serve import engine

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

N = 2000
SELECTIVITIES = (0.5, 0.1, 0.01)


def _t(a):
    """A numpy or JAX array as a torch tensor (uint32 as int32 views)."""
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def assert_ids_match(a, b, scores_a, scores_b, tol=1e-6):
    """Ids may differ at a rank only where the two scores there tie."""
    np.testing.assert_allclose(scores_a, scores_b, rtol=1e-5, atol=1e-6)
    diff = a != b
    assert (np.abs(scores_a[diff] - scores_b[diff]) <= tol).all(), (
        np.nonzero(diff.any(axis=1))[0][:5])


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    base, queries = make_dataset("minilm-surrogate", N, queries=25)
    rng = np.random.default_rng(0)
    member = np.stack([rng.random(N) < p for p in SELECTIVITIES], axis=1)
    index = JaxIndex.build(jnp.asarray(base), JaxParams(
        m=8, ef_construction=64, prune_pool=64, chunk=128))
    index.build_ivf()
    index.attach_labels([np.nonzero(m)[0].tolist() for m in member],
                        n_labels=3)
    index.build_label_entries(min_count=32)
    path = tmp_path_factory.mktemp("ref") / "labelled.npz"
    index.save(str(path))
    with np.load(path) as z:
        fields = dict(z)
    return {"base": base, "queries": queries, "member": member,
            "index": index, "fields": fields,
            "port": convert.index_from_numpy(fields, "cpu")}


# -- predicates and labels ---------------------------------------------------

ROWS = [[0], [1, 33], [], [0, 1, 33], [31], [32], [31, 32, 63], [63, 2]]
PREDICATES = [
    jfilter.Label(0), jfilter.Label(31), jfilter.Label(32), jfilter.Label(63),
    jfilter.Any(33), jfilter.All(1, 33), jfilter.Not(0), jfilter.Any(31, 32),
    jfilter.All(jfilter.Any(0, 1), jfilter.Not(33)),
    jfilter.Not(jfilter.Any(31, jfilter.All(32, 63))),
    jfilter.Any(jfilter.All(31, 63), jfilter.Not(jfilter.Label(2))),
]


def _port_expr(expr):
    """The same expression tree built from the port's classes."""
    if isinstance(expr, jfilter.Label):
        return pfilter.Label(expr.label)
    if isinstance(expr, jfilter.Not):
        return pfilter.Not(_port_expr(expr.expr))
    cls = pfilter.Any if isinstance(expr, jfilter.Any) else pfilter.All
    return cls(*map(_port_expr, expr.items))


def test_pack_label_rows_match_reference():
    want = jfilter.pack_label_rows(ROWS, n_labels=64)
    got = pfilter.pack_label_rows(ROWS, n_labels=64)
    assert got.dtype == np.uint32 and got.shape == (len(ROWS), 2)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        plabels.popcount_rows(got, 64), jfilter.labels.popcount_rows(want, 64))


@pytest.mark.parametrize("expr", PREDICATES, ids=repr)
def test_eval_mask_matches_reference(expr):
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2**32, (500, 2), dtype=np.uint64).astype(
        np.uint32)
    words[:8] = jfilter.pack_label_rows(ROWS, n_labels=64)
    words[8, :] = 0x80000000                # bit 31 of each word alone
    want = np.asarray(jfilter.eval_mask(jnp.asarray(words), expr))
    got = pfilter.eval_mask(_t(words), _port_expr(expr))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_counts_selectivity_and_entry_labels_match_reference(ref):
    jstore, store = ref["index"].labels, ref["port"].labels
    np.testing.assert_array_equal(store.counts, jstore.counts)
    np.testing.assert_array_equal(store.words.numpy().view(np.uint32),
                                  np.asarray(jstore.words))
    exprs = [jfilter.Label(0), jfilter.Any(1, 2), jfilter.All(0, 1),
             jfilter.Not(0), jfilter.All(jfilter.Any(0, 2), jfilter.Not(1)),
             jfilter.Not(jfilter.Any(0, 1))]
    for expr in exprs:
        pexpr = _port_expr(expr)
        assert pfilter.estimate_selectivity(pexpr, store.count_fn(), N) \
            == jfilter.estimate_selectivity(expr, jstore.count_fn(), N)
        assert pfilter.entry_label(pexpr, store.count_fn()) \
            == jfilter.entry_label(expr, jstore.count_fn())
        np.testing.assert_array_equal(store.mask(pexpr).numpy(),
                                      np.asarray(jstore.mask(expr)))
    for bad in (3, pfilter.Any(0, 7)):
        with pytest.raises(ValueError, match="outside"):
            store.mask(bad)
    with pytest.raises(TypeError):
        pfilter.as_predicate("tenant-a")


def test_label_store_mutations_match_reference():
    stores = [jfilter.LabelStore(16, 40), pfilter.LabelStore(16, 40, "cpu")]
    for s in stores:
        s.set(np.arange(8), 2)                   # categorical broadcast
        s.add([0, 1], [[3], [3, 33]])            # multi-tag OR
        s.set([0], [1])                          # overwrite
        s.entries[2] = 5
        s.entries[3] = 1
        s.clear([1])
        s.add([5, 5], [[3], [39]])               # duplicate ids OR
    jstore, store = stores
    np.testing.assert_array_equal(store.words.numpy().view(np.uint32),
                                  np.asarray(jstore.words))
    np.testing.assert_array_equal(store.counts, jstore.counts)
    np.testing.assert_array_equal(store.entries, jstore.entries)
    for node in (0, 1, 5):
        assert store.labels_of(node) == jstore.labels_of(node)
    assert store.memory_bytes() == jstore.memory_bytes()
    grown = store.padded_to(20)
    assert grown.capacity == 20 and grown.count(3) == store.count(3)
    live = np.array([0, 2, 5, 7])
    small, jsmall = store.compact(live), jstore.compact(live)
    np.testing.assert_array_equal(small.words.numpy().view(np.uint32),
                                  np.asarray(jsmall.words))
    np.testing.assert_array_equal(small.entries, jsmall.entries)


@pytest.mark.parametrize("vectors", [True, False],
                         ids=["vectors", "vector_free"])
def test_label_entries_match_reference(ref, vectors):
    jindex, port = ref["index"], ref["port"]
    jstore = jfilter.LabelStore.from_npz(ref["fields"])
    store = pfilter.LabelStore.from_npz(ref["fields"], "cpu")
    jstore.entries[:] = -1
    store.entries[:] = -1
    jbuilt = jfilter.build_label_entries(
        jstore, jindex.backend(),
        vectors=jindex.vectors if vectors else None, min_count=32)
    built = pfilter.build_label_entries(
        store, port.backend(), vectors=port.vectors if vectors else None,
        min_count=32)
    assert built == jbuilt == 2                 # label 2 has < 32 members
    np.testing.assert_array_equal(store.entries, jstore.entries)
    if vectors:
        np.testing.assert_array_equal(store.entries,
                                      ref["index"].labels.entries)


def test_masked_medoid_scan_matches_reference(ref):
    jindex, port = ref["index"], ref["port"]
    q = ref["queries"][:1]
    jb, pb = jindex.backend(), port.backend()
    for label in range(2):
        valid = ref["member"][:, label]
        want = jlinking.medoid_scan(jb, jb.encode_queries(jnp.asarray(q))[0],
                                    chunk=512, node_valid=jnp.asarray(valid))
        got = linking.medoid_scan(pb, pb.encode_queries(torch.from_numpy(q))[0],
                                  chunk=512,
                                  node_valid=torch.from_numpy(valid))
        assert int(got) == int(want)
        assert valid[int(got)]
    none = linking.medoid_scan(pb, pb.encode_queries(torch.from_numpy(q))[0],
                               chunk=512,
                               node_valid=torch.zeros(N, dtype=torch.bool))
    assert int(none) == 0


# -- the two-mask beam -------------------------------------------------------


def _masks(ref, which):
    node = np.random.default_rng(3).random(N) > 0.3
    result = ref["member"][:, 0]
    return {"result": {"result_valid": result},
            "node": {"node_valid": node},
            "both": {"node_valid": node, "result_valid": result}}[which]


@pytest.mark.parametrize("which", ["result", "node", "both"])
@pytest.mark.parametrize("expand", [1, 4])
def test_masked_beam_matches_reference(ref, which, expand):
    jindex, port = ref["index"], ref["port"]
    jb = jindex.backend()
    words = np.asarray(jb.encode_queries(jnp.asarray(ref["queries"])))
    masks = _masks(ref, which)
    want = jbeam.batched_beam_search(
        jnp.asarray(words), jindex.adjacency, jnp.int32(jindex.medoid),
        dist_fn=jb.dist_fn, ef=32, n=N, expand=expand,
        **{k: jnp.asarray(v) for k, v in masks.items()})
    got = beam.beam_search(
        _t(words), port.adjacency, port.medoid,
        dist_fn=port.backend().dist_many, ef=32, n=N, expand=expand,
        **{k: torch.from_numpy(v) for k, v in masks.items()})
    for field in beam.BeamResult._fields:
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            err_msg=field)
    ok = np.logical_and.reduce(list(masks.values()))
    ids = got.ids.numpy()
    assert (ids >= 0).any() and ok[ids[ids >= 0]].all()


@pytest.mark.parametrize("expand", [1, 4])
def test_all_true_mask_is_bit_identical(ref, expand):
    port = ref["port"]
    words = port.backend().encode_queries(torch.from_numpy(ref["queries"]))
    kw = dict(dist_fn=port.backend().dist_many, ef=24, n=N, expand=expand)
    plain = beam.beam_search(words, port.adjacency, port.medoid, **kw)
    masked = beam.beam_search(words, port.adjacency, port.medoid, **kw,
                              result_valid=torch.ones(N, dtype=torch.bool))
    for field in beam.BeamResult._fields:
        assert torch.equal(getattr(plain, field), getattr(masked, field))


def test_filtered_scan_search_matches_reference(ref):
    jindex, port = ref["index"], ref["port"]
    jb, pb = jindex.backend("bq2"), port.backend("bq2")
    words = np.asarray(jb.encode_queries(jnp.asarray(ref["queries"])))
    valid = ref["member"][:, 1]
    jscan = jdispatch.list_scan_ops(jindex.sigs.dim, route="ref").scan
    want = jivf_search.scan_search(
        jb, jscan, jnp.asarray(words), jindex.ivf.cent_words,
        jindex.ivf.list_ids, probes=12, ef=48,
        result_valid=jnp.asarray(valid))
    got = pivf_search.scan_search(
        pb, dispatch.list_scan_ops(port.sigs.dim, "cpu").scan, _t(words),
        port.ivf.cent_words, port.ivf.list_ids, probes=12, ef=48,
        result_valid=torch.from_numpy(valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ids = got[0].numpy()
    assert valid[ids[ids >= 0]].all()


# -- search, route by route --------------------------------------------------

# (label predicate as the reference's, search kwargs, expected route)
ROUTES = {
    "graph_0.5": (0, {}, "graph"),
    # ef 16 widens to 160 at ~0.1
    "graph_0.1": (1, {"ef": 16}, "graph"),
    "graph_not": (jfilter.Not(1), {"expand": 4}, "graph"),
    "graph_rerank_off": (1, {"ef": 16, "rerank": False}, "graph"),
    "brute": (2, {}, "brute"),
    "brute_rerank_off": (2, {"rerank": False}, "brute"),
    "brute_k_above_matches": (2, {"k": 100}, "brute"),
    "ivf": (1, {"nav": "ivf"}, "ivf"),
    "ivf_rerank_off": (0, {"nav": "ivf", "rerank": False}, "ivf"),
}


def _matches(ref, expr):
    store = ref["port"].labels
    return store.mask(_port_expr(jfilter.as_predicate(expr))).numpy()


@pytest.mark.parametrize("case", list(ROUTES))
def test_search_route_matches_reference(ref, case):
    from repro.plan import resolve_plan as jresolve
    from repro_torch.plan import resolve_plan

    expr, kw, want_route = ROUTES[case]
    kw = {"k": 10, "ef": 32, **kw}
    jindex, port, q = ref["index"], ref["port"], ref["queries"]
    pexpr = _port_expr(jfilter.as_predicate(expr))
    plan, _ = resolve_plan(port, filter=pexpr, **kw)
    jplan, _ = jresolve(jindex, filter=expr, **kw)
    assert plan.route == want_route
    assert dataclasses.asdict(plan) == dataclasses.asdict(jplan)
    jids, jscores = jindex.search(jnp.asarray(q), filter=expr, **kw)
    ids, scores = port.search(q, filter=pexpr, **kw)
    jids, jscores = np.asarray(jids), np.asarray(jscores)
    assert ids.shape == jids.shape == (len(q), kw["k"])
    if plan.route == "brute" and plan.rerank:
        # exact cosine over the match set: a matmul in torch's order
        assert_ids_match(ids, jids, scores, jscores)
    else:
        np.testing.assert_array_equal(ids, jids)
        if plan.rerank:
            np.testing.assert_allclose(scores, jscores, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(scores, jscores)
    match = _matches(ref, expr)
    assert match[ids[ids >= 0]].all()
    if case == "brute_k_above_matches":
        valid = ids >= 0
        assert valid.sum(axis=1).max() == match.sum() < kw["k"]
        assert (ids[~valid] == -1).all() and np.isneginf(scores[~valid]).all()


def test_filter_needs_labels(ref):
    bare = dataclasses.replace(ref["port"], labels=None, _backends={},
                               _plan_cache=None)
    with pytest.raises(ValueError, match="attach_labels"):
        bare.search(ref["queries"][:2], filter=0)


def test_brute_queries_are_counted(ref):
    from repro_torch.obs.metrics import get_default_registry

    counter = get_default_registry().counter("quiver_brute_queries_total")
    before = counter.value()
    ref["port"].search(ref["queries"][:5], filter=2)
    assert counter.value() == before + 5


# -- Retriever(filter=...) ---------------------------------------------------


@pytest.mark.parametrize("where", ["retriever", "call"])
def test_retriever_filter_matches_reference(ref, where):
    """One embedding function (a token's row of the corpus) and one
    labelled index: identical augmented prompts, every retrieved
    document carrying the label."""
    base = ref["base"]
    docs = np.random.default_rng(4).integers(0, 1000, (N, 6)).astype(
        np.int32)
    prompts = np.random.default_rng(5).integers(0, N, (12, 5)).astype(
        np.int32)

    def embed_fn(tokens):
        return base[np.asarray(tokens)[:, 0]]

    kw = dict(doc_tokens=docs, embed_fn=embed_fn, k=3, ef=32)
    pexpr = pfilter.Any(1, 2)
    jexpr = jfilter.Any(1, 2)
    if where == "retriever":
        want = jengine.Retriever(index=ref["index"], filter=jexpr,
                                 **kw).augment(prompts)
        got = engine.Retriever(index=ref["port"], filter=pexpr,
                               **kw).augment(prompts)
    else:
        want = jengine.Retriever(index=ref["index"], filter=jfilter.Label(0),
                                 **kw).augment(prompts, filter=jexpr)
        got = engine.Retriever(index=ref["port"], filter=pfilter.Label(0),
                               **kw).augment(prompts, filter=pexpr)
    np.testing.assert_array_equal(got, np.asarray(want))
    ids, _ = ref["port"].search(embed_fn(prompts), k=3, ef=32, filter=pexpr)
    assert (ids >= 0).all() and _matches(ref, jexpr)[ids].all()
    np.testing.assert_array_equal(got[:, :18].reshape(12, 3, 6), docs[ids])
