"""The port's ``QuIVerIndex`` against ``repro.core.index`` end to end.

One JAX index is built and saved per module.  The port builds its own
index from the same vectors (its own random starting graph, so the graphs
differ) and must reach the reference's recall@10 within 0.5 pt; the JAX
archive must search identically in the port, and the port's archive in
the reference.  Reranked ids may differ only where two candidates' cosine
scores lie within 1e-6 (float sums in another order), and scores agree to
``allclose(rtol=1e-5, atol=1e-6)``.  All on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bq as jbq
from repro.core.baselines import flat_search as jax_flat_search
from repro.core.index import QuIVerIndex as JaxIndex
from repro.core.index import _normalize as jax_normalize
from repro.core.index import random_rotation
from repro.core.vamana import BuildParams as JaxParams
from repro.data import datasets as jdatasets
from repro_torch import convert
from repro_torch.core.baselines import flat_search, recall_at_k
from repro_torch.core.index import QuIVerIndex
from repro_torch.core.vamana import BuildParams
from repro_torch.data import datasets
from repro_torch.kernels.binarize import strong_bit_flips

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

N = 1500
PARAMS = dict(m=8, ef_construction=48, prune_pool=48, chunk=128)


def assert_ids_match(a, b, scores_a, scores_b, tol=1e-6):
    """Ids may differ at a rank only where the two scores there tie."""
    np.testing.assert_allclose(scores_a, scores_b, rtol=1e-5, atol=1e-6)
    diff = a != b
    assert (np.abs(scores_a - scores_b)[diff] <= tol).all(), (
        np.nonzero(diff.any(axis=1))[0][:5])


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    base, queries = datasets.make_dataset("minilm-surrogate", N,
                                          queries=100)
    index = JaxIndex.build(jnp.asarray(base), JaxParams(**PARAMS))
    path = tmp_path_factory.mktemp("ref") / "jax.npz"
    index.save(str(path))
    ids, scores = index.search(jnp.asarray(queries), k=10, ef=64)
    truth, _ = flat_search(base, queries, 10, device="cpu")
    with np.load(path) as z:
        fields = dict(z)
    return {"base": base, "queries": queries, "index": index,
            "path": path, "fields": fields, "truth": truth,
            "ids": np.asarray(ids), "scores": np.asarray(scores)}


@pytest.fixture(scope="module")
def port_index(ref):
    return QuIVerIndex.build(ref["base"], BuildParams(**PARAMS),
                             device="cpu")


def test_recall_matches_reference(ref, port_index):
    ids, scores = port_index.search(ref["queries"], k=10, ef=64)
    assert ids.shape == (100, 10) and np.isfinite(scores).all()
    want = recall_at_k(ref["ids"], ref["truth"])
    got = recall_at_k(ids, ref["truth"])
    assert want > 0.9
    assert abs(got - want) <= 0.005 + 1e-12, (got, want)   # 0.5 pt


def test_jax_archive_searches_identically(ref):
    index = QuIVerIndex.load(str(ref["path"]), device="cpu")
    ids, scores = index.search(ref["queries"], k=10, ef=64)
    assert_ids_match(ids, ref["ids"], scores, ref["scores"])
    # the hot path alone is integer-exact
    jids, jscores = ref["index"].search(jnp.asarray(ref["queries"]), k=10,
                                        ef=64, rerank=False, expand=2)
    ids, scores = index.search(ref["queries"], k=10, ef=64, rerank=False,
                               expand=2)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_array_equal(scores, np.asarray(jscores))


def test_port_archive_loads_in_reference(ref, port_index, tmp_path):
    path = tmp_path / "port.npz"
    port_index.save(str(path))
    loaded = JaxIndex.load(str(path))
    np.testing.assert_array_equal(
        np.asarray(loaded.sigs.words),
        port_index.sigs.words.numpy().view(np.uint32))
    np.testing.assert_array_equal(np.asarray(loaded.adjacency),
                                  port_index.adjacency.numpy())
    assert loaded.medoid == port_index.medoid
    assert dataclasses.asdict(loaded.params) \
        == dataclasses.asdict(port_index.params)
    jids, jscores = loaded.search(jnp.asarray(ref["queries"]), k=10, ef=64)
    ids, scores = port_index.search(ref["queries"], k=10, ef=64)
    assert_ids_match(ids, np.asarray(jids), scores, np.asarray(jscores))


def test_memory_breakdown_matches_reference(ref):
    index = convert.index_from_numpy(ref["fields"], "cpu")
    assert index.memory_breakdown() == ref["index"].memory_breakdown()


def test_convert_round_trips_the_archive(ref):
    fields = convert.index_to_numpy(
        convert.index_from_numpy(ref["fields"], "cpu"))
    assert set(fields) == set(ref["fields"])
    for key, value in ref["fields"].items():
        np.testing.assert_array_equal(fields[key], value, err_msg=key)
        assert fields[key].dtype == value.dtype, key


@pytest.mark.parametrize("extra", [
    {"graph_out_degree_mean": np.float64(4.0)},
    {"stream_format": np.int64(1)},
], ids=lambda e: next(iter(e)))
def test_unported_archive_state_is_refused(ref, extra, tmp_path):
    # graph-health state, once refused, now cross-loads both ways (the
    # reference's own X-ray of its index); a streaming archive is refused
    # with the reference's ValueError, as its QuIVerIndex.load refuses it
    if "stream_format" not in extra:
        jindex = dataclasses.replace(ref["index"], _backends={},
                                     _plan_cache=None)
        report = jindex.graph_report(sample=64)
        fields = {**ref["fields"], **report.to_npz_fields()}
        assert "graph_out_degree_mean" in fields
        port = convert.index_from_numpy(fields, "cpu")
        assert port.graph_health.to_dict() == report.to_dict()
        assert convert.index_to_numpy(port).keys() == fields.keys()
        port.save(str(tmp_path / "port.npz"))
        back = JaxIndex.load(str(tmp_path / "port.npz"))
        assert back.graph_health.to_dict() == report.to_dict()
        assert port.memory_breakdown()["graph_verdict"] == report.verdict
        return
    fields = {**ref["fields"], **extra}
    path = str(tmp_path / "stream.npz")
    np.savez(path, **fields)
    for load in (lambda: convert.index_from_numpy(fields, "cpu"),
                 lambda: QuIVerIndex.load(path, "cpu"),
                 lambda: JaxIndex.load(path)):
        with pytest.raises(ValueError, match="streaming archive"):
            load()


def _policy_fields():
    from repro.probe import NavPolicy as JaxPolicy
    return JaxPolicy(nav="bq2", ef_scale=2, adaptive=True,
                     escalate_margin=0.2, source="probe").to_npz_fields()


def _report_fields(base):
    from repro.probe import probe_corpus as jax_probe_corpus
    return jax_probe_corpus(base, sample=256).to_npz_fields()


# archive state the ladder slice ported: each loads, round-trips and
# searches as the reference's load of the same fields does
@pytest.mark.parametrize("extra", [
    "policy_nav", "probe_cos_mean", "metric_kind",
])
def test_ladder_archive_state_loads_as_in_reference(ref, extra, tmp_path):
    extra = {"policy_nav": _policy_fields,
             "probe_cos_mean": lambda: _report_fields(ref["base"]),
             "metric_kind": lambda: {"metric_kind": np.array("float32")},
             }[extra]()
    fields = {**ref["fields"], **extra}
    index = convert.index_from_numpy(fields, "cpu")
    back = convert.index_to_numpy(index)
    assert set(back) == set(fields)
    for key, value in fields.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    path = tmp_path / "jax.npz"
    np.savez_compressed(path, **fields)
    jindex = JaxIndex.load(str(path))
    jids, jscores = jindex.search(jnp.asarray(ref["queries"]), k=10, ef=32)
    ids, scores = index.search(ref["queries"], k=10, ef=32)
    assert_ids_match(ids, np.asarray(jids), scores, np.asarray(jscores))


def test_entry_points_need_a_card_unless_told_cpu(ref, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QuIVerIndex.build(ref["base"][:300], BuildParams(**PARAMS))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QuIVerIndex.load(str(ref["path"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flat_search(ref["base"], ref["queries"], 10)


# search options the ladder slice ported (they raised before): the same
# kwargs on the same JAX-built index in both packages
@pytest.mark.parametrize("kw", [
    {"nav": "bq1"}, {"adaptive": True}, {"probes": 4},
], ids=lambda kw: next(iter(kw)))
def test_ladder_search_options_match_reference(ref, kw):
    index = convert.index_from_numpy(ref["fields"], "cpu")
    jids, jscores = ref["index"].search(jnp.asarray(ref["queries"]), k=10,
                                        ef=64, **kw)
    ids, scores = index.search(ref["queries"], k=10, ef=64, **kw)
    assert_ids_match(ids, np.asarray(jids), scores, np.asarray(jscores))


def test_k_above_ef_raises(ref):
    index = convert.index_from_numpy(ref["fields"], "cpu")
    # the graph plan's own check, with the reference's message
    with pytest.raises(ValueError, match="graph plan needs ef >= k"):
        index.search(ref["queries"][:2], k=20, ef=16)


def test_rotation_matches_reference(ref):
    rot = np.asarray(random_rotation(ref["base"].shape[1], 7))
    # build side: the port encodes the rotated vectors as the reference does
    small = ref["base"][:300]
    index = QuIVerIndex.build(small, BuildParams(m=4, ef_construction=16,
                                                 prune_pool=16, chunk=128),
                              rotation=rot, device="cpu")
    x = np.asarray(jax_normalize(jnp.asarray(small)) @ jnp.asarray(rot))
    strong_bit_flips(index.sigs.words.numpy(),
                     np.asarray(jbq.encode(jnp.asarray(x)).words), x)
    # search side: queries are rotated before encoding
    jindex = dataclasses.replace(ref["index"], rotation=jnp.asarray(rot),
                                 _backends={}, _plan_cache=None)
    jids, jscores = jindex.search(jnp.asarray(ref["queries"]), k=10, ef=64)
    pindex = convert.index_from_numpy({**ref["fields"], "rotation": rot},
                                      "cpu")
    ids, scores = pindex.search(ref["queries"], k=10, ef=64)
    assert_ids_match(ids, np.asarray(jids), scores, np.asarray(jscores))


def test_flat_search_matches_reference(ref):
    jids, jscores = jax_flat_search(jnp.asarray(ref["base"]),
                                    jnp.asarray(ref["queries"]), 10)
    ids, scores = flat_search(ref["base"], ref["queries"], 10, device="cpu")
    assert_ids_match(ids, np.asarray(jids), scores, np.asarray(jscores))
    assert recall_at_k(ids, np.asarray(jids)) == 1.0


@pytest.mark.parametrize("name", ["cohere-surrogate", "glove-like",
                                  "redcaps-surrogate"])
def test_datasets_match_reference(name):
    got = datasets.make_dataset(name, 300, queries=20)
    want = jdatasets.make_dataset(name, 300, queries=20)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
