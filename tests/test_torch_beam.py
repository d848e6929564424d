"""The port's batched beam search against ``repro.core.beam`` on one graph.

One JAX index is built per module; both packages then search its graph
from its medoid with the same query words, on the CPU.  Every
``BeamResult`` field must be identical: ids, distances, and the per-query
hops, evals, descent, stalls and entry rank that the reference's ``vmap``
of ``while_loop`` keeps frozen once a query is done.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import beam as jbeam
from repro.core import bq as jbq
from repro.core.index import QuIVerIndex as JaxIndex
from repro.core.metric import MetricArrays as JaxArrays
from repro.core.metric import make_backend as jax_backend
from repro.core.vamana import BuildParams as JaxParams
from repro_torch.core import beam, bq, metric
from repro_torch.data.datasets import make_dataset

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

N = 1000


@pytest.fixture(scope="module")
def graph():
    base, queries = make_dataset("minilm-surrogate", N, queries=40)
    index = JaxIndex.build(
        jnp.asarray(base),
        JaxParams(m=6, ef_construction=32, prune_pool=32, chunk=128),
    )
    q_words = np.asarray(jbq.encode(jnp.asarray(queries)).words)
    words = np.asarray(index.sigs.words)
    port_backend = metric.make_backend("bq2", metric.MetricArrays(
        sigs=bq.Signature(torch.from_numpy(words.view(np.int32).copy()),
                          index.sigs.dim)))
    return {
        "index": index,
        "jax_backend": jax_backend("bq2", JaxArrays(sigs=index.sigs),
                                   route="ref"),
        "port_backend": port_backend,
        "q_words": q_words,
        "adj": np.asarray(index.adjacency),
    }


def _both(graph, **kw):
    g = graph
    want = jbeam.batched_beam_search(
        jnp.asarray(g["q_words"]), jnp.asarray(g["adj"]),
        jnp.int32(g["index"].medoid), dist_fn=g["jax_backend"].dist_fn,
        n=N, **kw,
    )
    got = beam.beam_search(
        torch.from_numpy(g["q_words"].view(np.int32).copy()),
        torch.from_numpy(g["adj"].copy()), g["index"].medoid,
        dist_fn=g["port_backend"].dist_many, n=N, **kw,
    )
    return want, got


def _assert_same(want, got):
    for field in beam.BeamResult._fields:
        np.testing.assert_array_equal(
            getattr(got, field).numpy(), np.asarray(getattr(want, field)),
            err_msg=field,
        )


@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("ef", [16, 48])
def test_beam_matches_reference(graph, expand, ef):
    want, got = _both(graph, ef=ef, expand=expand)
    _assert_same(want, got)
    # per-query termination: the queries really stopped at different hops
    assert len(set(got.hops.tolist())) > 1


@pytest.mark.parametrize("kw", [{"max_evals": 150}, {"max_hops": 5}],
                         ids=["max_evals", "max_hops"])
def test_beam_budgets_match_reference(graph, kw):
    want, got = _both(graph, ef=32, expand=2, **kw)
    _assert_same(want, got)


def test_beam_margin_matches_reference(graph):
    want, got = _both(graph, ef=16, expand=1)
    neutral = graph["port_backend"].neutral_dist
    for k in (1, 10, 16):
        np.testing.assert_array_equal(
            beam.beam_margin(got.dists, k, neutral).numpy(),
            np.asarray(jbeam.beam_margin(want.dists, k, neutral)),
        )
    starved = torch.full((2, 4), beam.INF)
    np.testing.assert_array_equal(
        beam.beam_margin(starved, 2, neutral).numpy(), [-1.0, -1.0])


def test_expand_outside_range_raises(graph):
    with pytest.raises(ValueError, match="expand"):
        beam.beam_search(
            torch.zeros((1, 24), dtype=torch.int32),
            torch.from_numpy(graph["adj"].copy()), 0,
            dist_fn=graph["port_backend"].dist_many, n=N, ef=4, expand=5,
        )


@pytest.mark.parametrize("n,qb", [(1, 256), (9, 256), (40, 256),
                                  (300, 256), (5, 4)])
def test_batch_bucket_and_pad_rows_match_reference(n, qb):
    assert beam.batch_bucket(n, qb) == jbeam.batch_bucket(n, qb)
    size = beam.batch_bucket(n, qb)
    arr = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
    np.testing.assert_array_equal(
        beam.pad_rows(torch.from_numpy(arr), size).numpy(),
        np.asarray(jbeam.pad_rows(jnp.asarray(arr), size)),
    )


@pytest.mark.parametrize("adaptive", [True, False])
def test_escalated_search_matches_reference(adaptive):
    """The escalation wrapper (the streaming index's search delegates to
    it) with one base search: the same rows re-run at ef * mult and
    spliced back in place."""
    margins = np.random.default_rng(2).random(24).astype(np.float32) * 0.3
    queries = np.arange(24 * 4, dtype=np.float32).reshape(24, 4)

    def run(reprs, queries, ef, want_margin):
        rows = np.asarray(queries)[:, 0].astype(np.int64) // 4
        ids = (rows[:, None] * 100 + ef + np.arange(3)).astype(np.int32)
        scores = (rows[:, None] + ef / 1000.0).astype(np.float32)
        return ids, scores, margins[rows] if want_margin else None

    kw = dict(adaptive=adaptive, margin_thr=0.1, mult=4)
    want = jbeam.escalated_search(run, jnp.asarray(queries),
                                  jnp.asarray(queries), 16, **kw)
    got = beam.escalated_search(run, torch.from_numpy(queries),
                                torch.from_numpy(queries), 16, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    escalated = (got[0][:, 0] % 100) == 64
    assert escalated.any() == adaptive
    np.testing.assert_array_equal(escalated, adaptive & (margins < 0.1))
