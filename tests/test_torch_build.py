"""The port's Vamana build against ``repro.core.vamana`` and its parts.

One JAX index is built per module.  The port then builds from the same
signatures, the same initial graph (``repro.core.vamana._init_graph``,
injected, since ``jax.random`` cannot be reproduced in torch) and the
same medoid, and must give an identical adjacency and identical build
counts.  The parts — alpha-prune, chunk linking, forward/reverse edge
installation, consolidation and the medoid scan — are held against the
reference's jitted wrappers on the same inputs.  All on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import prune as jprune
from repro.core import vamana as jvamana
from repro.core.index import QuIVerIndex as JaxIndex
from repro.core.metric import MetricArrays as JaxArrays
from repro.core.metric import make_backend as jax_backend
from repro_torch.core import bq, linking, metric, prune, vamana
from repro_torch.data.datasets import make_dataset
from repro_torch.obs.metrics import get_default_registry

jax.config.update("jax_platform_name", "cpu")
# the suite runs in parallel worker processes: one thread each
torch.set_num_threads(1)

N = 1200
JAX_PARAMS = jvamana.BuildParams(m=6, ef_construction=32, prune_pool=32,
                                 chunk=128, consolidate_every=4)
PARAMS = vamana.BuildParams(**dataclasses.asdict(JAX_PARAMS))


def _t(a, dtype=None):
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a if dtype is None else a.astype(dtype))


@pytest.fixture(scope="module")
def built():
    base, _ = make_dataset("minilm-surrogate", N, queries=10)
    index = JaxIndex.build(jnp.asarray(base), JAX_PARAMS)
    jb = jax_backend("bq2", JaxArrays(sigs=index.sigs), route="ref")
    pb = metric.make_backend("bq2", metric.MetricArrays(
        sigs=bq.Signature(_t(index.sigs.words), index.sigs.dim)))
    init_adj, _ = jvamana._init_graph(N, JAX_PARAMS, JAX_PARAMS.seed)
    adj, medoid, stats = vamana.build_graph(
        pb, PARAMS, init_adjacency=_t(init_adj), medoid=index.medoid)
    return {"index": index, "jb": jb, "pb": pb,
            "init_adj": np.asarray(init_adj),
            "port": (adj, medoid, stats)}


def test_full_build_matches_reference(built):
    index = built["index"]
    adj, medoid, stats = built["port"]
    assert medoid == index.medoid
    np.testing.assert_array_equal(adj.numpy(), np.asarray(index.adjacency))
    want = index.build_stats
    for field in ("chunks", "consolidations", "reverse_edges_added",
                  "occluded_total"):
        assert getattr(stats, field) == getattr(want, field), field
    for field in ("mean_hops", "pool_occupancy", "survivor_ratio"):
        assert getattr(stats, field) == pytest.approx(
            getattr(want, field), rel=1e-6), field


def test_build_records_histograms(built):
    names = {m.name for m in get_default_registry().metrics()}
    assert {"quiver_build_pool_occupancy", "quiver_build_survivor_ratio",
            "quiver_build_occluded"} <= names


def test_centroid_medoid_matches_reference(built):
    jc = np.asarray(jvamana._centroid_repr(built["jb"]))
    pc = vamana._centroid_repr(built["pb"])
    np.testing.assert_array_equal(pc.numpy(), jc.view(np.int32))
    assert int(linking.medoid_scan(built["pb"], pc, chunk=4096)) \
        == built["index"].medoid
    small = int(jvamana._medoid(built["jb"], jnp.asarray(jc), chunk=100))
    assert int(linking.medoid_scan(built["pb"], pc, chunk=100)) == small


def _pools(built, b=6, c=24, seed=0):
    """Candidate pools with -1 padding and tied distances."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(N, size=(b, c)).astype(np.int32)
    ids[rng.random((b, c)) < 0.15] = -1
    dists = rng.integers(300, 340, size=(b, c)).astype(np.float32)
    dists[ids < 0] = 3.0e38
    pw = np.asarray(built["jb"].pairwise(jnp.asarray(np.maximum(ids, 0))))
    return ids, dists, pw


@pytest.mark.parametrize("alpha", [1.0, 1.2])
@pytest.mark.parametrize("r", [4, 12])
def test_alpha_prune_matches_reference(built, alpha, r):
    ids, dists, pw = _pools(built, seed=r)
    want = jprune.alpha_prune_stats_batch(
        jnp.asarray(ids), jnp.asarray(dists), jnp.asarray(pw),
        r=r, alpha=alpha)
    got = prune.alpha_prune_stats_batch(_t(ids), _t(dists), _t(pw),
                                        r=r, alpha=alpha)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    plain = prune.alpha_prune_batch(_t(ids), _t(dists), _t(pw),
                                    r=r, alpha=alpha)
    for g, w in zip(plain, want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    one = prune.alpha_prune_stats(_t(ids[0]), _t(dists[0]), _t(pw[0]),
                                  r=r, alpha=alpha)
    want_one = jprune.alpha_prune_stats(
        jnp.asarray(ids[0]), jnp.asarray(dists[0]), jnp.asarray(pw[0]),
        r=r, alpha=alpha)
    for g, w in zip(one, want_one):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ids1, _ = prune.alpha_prune(_t(ids[1]), _t(dists[1]), _t(pw[1]),
                                r=r, alpha=alpha)
    np.testing.assert_array_equal(ids1.numpy(), np.asarray(want[0][1]))


def _chunk(rng, b=64):
    ids = rng.choice(N, size=b, replace=False).astype(np.int32)
    ids[-5:] = -1
    return ids


def _forward(built, adj, chunk_ids):
    kw = dict(ef=JAX_PARAMS.ef_construction, pool=JAX_PARAMS.prune_pool,
              r=JAX_PARAMS.r, alpha=JAX_PARAMS.alpha, n=N, expand=1)
    medoid = built["index"].medoid
    want = jvamana._chunk_forward(jnp.asarray(adj), jnp.asarray(chunk_ids),
                                  jnp.int32(medoid), backend=built["jb"],
                                  **kw)
    got = linking.chunk_forward(built["pb"], _t(adj), _t(chunk_ids),
                                medoid, **kw)
    return want, got


def test_chunk_forward_matches_reference(built):
    chunk_ids = _chunk(np.random.default_rng(1))
    want, got = _forward(built, built["init_adj"], chunk_ids)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_forward_and_reverse_edges_match_reference(built):
    adj = built["init_adj"]
    deg = (adj >= 0).sum(1).astype(np.int32)
    chunk_ids = _chunk(np.random.default_rng(2))
    want_fwd, _ = _forward(built, adj, chunk_ids)
    fwd = np.asarray(want_fwd[0])
    rt = JAX_PARAMS.r_total
    j_adj, j_deg = jvamana._apply_forward(
        jnp.asarray(adj), jnp.asarray(deg), jnp.asarray(chunk_ids),
        jnp.asarray(fwd), r_total=rt)
    p_adj, p_deg = linking.apply_forward(_t(adj), _t(deg), _t(chunk_ids),
                                         _t(fwd), r_total=rt)
    np.testing.assert_array_equal(p_adj.numpy(), np.asarray(j_adj))
    np.testing.assert_array_equal(p_deg.numpy(), np.asarray(j_deg))
    want = jvamana._reverse_append(j_adj, j_deg, jnp.asarray(chunk_ids),
                                   jnp.asarray(fwd), r_total=rt)
    got = linking.reverse_append(p_adj, p_deg, _t(chunk_ids), _t(fwd),
                                 r_total=rt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # a proposal that already exists is skipped; slots past r_total drop
    assert 0 < int(got[2]) < (fwd >= 0).sum()


def test_scatter_rows_matches_reference(built):
    from repro.core import linking as jlinking

    adj = np.asarray(built["index"].adjacency)
    deg = (adj >= 0).sum(1).astype(np.int32)
    rows = np.array([3, -1, 17, 5], dtype=np.int32)
    edges = np.random.default_rng(3).integers(-1, N, size=(4, 7)).astype(
        np.int32)
    want = jlinking.scatter_rows(jnp.asarray(adj), jnp.asarray(deg),
                                 jnp.asarray(rows), jnp.asarray(edges),
                                 r_total=JAX_PARAMS.r_total)
    got = linking.scatter_rows(_t(adj), _t(deg), _t(rows), _t(edges),
                               r_total=JAX_PARAMS.r_total)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_consolidate_rows_matches_reference(built):
    # the initial graph's rows are full and random: re-pruning them to a
    # smaller r exercises the prune; duplicate and padded row ids occur in
    # the reference's wrap-around batches
    adj = built["init_adj"]
    deg = (adj >= 0).sum(1).astype(np.int32)
    rows = np.array([0, 7, 7, -1, 400, 1199, 12, 12], dtype=np.int32)
    kw = dict(r=4, alpha=JAX_PARAMS.alpha, r_total=JAX_PARAMS.r_total)
    want = jvamana._consolidate_rows(jnp.asarray(adj), jnp.asarray(deg),
                                     jnp.asarray(rows), backend=built["jb"],
                                     **kw)
    got = linking.consolidate_rows(built["pb"], _t(adj), _t(deg), _t(rows),
                                   **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_port_init_graph_is_seeded_and_loop_free():
    a = vamana._init_graph(500, PARAMS, 3, "cpu")
    b = vamana._init_graph(500, PARAMS, 3, "cpu")
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert a.shape == (500, PARAMS.r_total)
    assert (a[:, PARAMS.r:] == -1).all()
    rand = a[:, :PARAMS.r]
    assert ((rand >= 0) & (rand < 500)).all()
    assert not (rand == torch.arange(500)[:, None]).any()


def test_ivf_seeded_build_matches_reference(built):
    from repro.ivf import build_partition as jax_build_partition
    from repro_torch.ivf import IVFPartition

    jparams = dataclasses.replace(JAX_PARAMS, ivf_candidates=True)
    part = jax_build_partition(built["index"].sigs, seed=jparams.seed,
                               route="ref")
    want_adj, medoid, want = jvamana.build_graph(built["jb"], jparams,
                                                 ivf=part)
    adj, got_medoid, stats = vamana.build_graph(
        built["pb"], dataclasses.replace(PARAMS, ivf_candidates=True),
        ivf=IVFPartition.from_npz(part.to_npz_fields(), "cpu"),
        init_adjacency=_t(built["init_adj"]), medoid=medoid)
    assert got_medoid == medoid
    np.testing.assert_array_equal(adj.numpy(), np.asarray(want_adj))
    for field in ("chunks", "consolidations", "reverse_edges_added",
                  "occluded_total"):
        assert getattr(stats, field) == getattr(want, field), field
    assert stats.mean_hops == want.mean_hops == 0.0


def test_injected_adjacency_shape_is_checked(built):
    with pytest.raises(ValueError, match="init_adjacency"):
        vamana.build_graph(built["pb"], PARAMS,
                           init_adjacency=torch.zeros((N, 3),
                                                      dtype=torch.int32))
