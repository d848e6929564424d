"""BQ-native Vamana graph construction (QuIVer §3.2 / §4.1).

Counterpart of ``repro/core/vamana.py``: bulk encode, then chunked
linking.  Nodes are inserted in chunks of ``BuildParams.chunk``; each
chunk beam-searches the current graph, alpha-prunes its candidate pools
in bq2 space, writes forward edges and scatter-appends reverse edges, and
every ``consolidate_every`` chunks the rows that overflowed R are
re-pruned.  The host drives the loop; the device does the work.  With
``BuildParams(ivf_candidates=True)`` each chunk's candidate pool comes from
the node's nearest coarse lists (``repro_torch.ivf``) instead of a beam
search, as in the reference.

The starting graph differs from the reference's, which draws it with
``jax.random``: :func:`_init_graph` draws it from ``numpy``'s
``default_rng(seed)`` on the host, so it is the same on every device.
``build_graph`` also takes an injected ``init_adjacency`` and ``medoid``,
which is how the tests start both packages from one graph.  The insertion
order uses the same numpy generator calls as the reference.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import bq, linking
from repro_torch.core.metric import MetricSpace
from repro_torch.core.prune import alpha_prune_stats_batch
from repro_torch.ivf import build_partition
from repro_torch.ivf import search as ivf_search
from repro_torch.kernels import dispatch
from repro_torch.obs.metrics import get_default_registry


@dataclasses.dataclass(frozen=True)
class BuildParams:
    m: int = 32                  # paper: max degree 2m
    ef_construction: int = 128
    alpha: float = 1.2
    chunk: int = 256
    prune_pool: int = 128        # candidates entering alpha-prune
    reverse_slack: int = 8       # adjacency headroom for reverse appends
    consolidate_every: int = 8   # chunks between overflow re-prunes
    passes: int = 1              # full insertion passes over the data
    seed: int = 0
    beam_expand: int = 1         # beam expansion width L during build
    # IVF-seeded construction: seed each chunk's prune pool from the
    # node's top-p coarse lists instead of a full-graph beam search;
    # ``ivf_lists=0`` means the partition's own sqrt(N) default
    ivf_candidates: bool = False
    ivf_lists: int = 0

    @property
    def r(self) -> int:          # out-degree bound
        return 2 * self.m

    @property
    def r_total(self) -> int:    # adjacency row width incl. slack
        return self.r + self.reverse_slack


@dataclasses.dataclass
class BuildStats:
    seconds: float = 0.0
    chunks: int = 0
    consolidations: int = 0
    reverse_edges_added: int = 0
    mean_hops: float = 0.0
    # per-chunk means averaged over the build; occluded is the total
    # candidate count the alpha-criterion covered away
    pool_occupancy: float = 0.0    # mean pool fill / prune_pool
    survivor_ratio: float = 0.0    # mean survivors / pool
    occluded_total: int = 0


def _init_graph(n: int, params: BuildParams, seed: int, device):
    """Random R-regular starting graph (no self loops) + slack columns."""
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, n, size=(n, params.r), dtype=np.int64)
    ids = np.arange(n)[:, None]
    rand = np.where(rand == ids, (rand + 1) % n, rand)
    adj = np.concatenate(
        [rand, np.full((n, params.reverse_slack), -1)], axis=1
    ).astype(np.int32)
    return torch.from_numpy(adj).to(device)


def _chunk_forward_ivf(backend, scan, chunk_ids, rand_ids, cent_words,
                       list_ids, *, pool, r, alpha, probes):
    """IVF-seeded chunk linking: top-p lists feed the prune pool.

    Replaces the beam search of ``linking.chunk_forward``: each chunk
    node's candidates are the members of its ``probes`` nearest coarse
    lists, topped up with ``rand_ids``, random far candidates whose long
    edges the alpha-criterion can keep.  A duplicate between the two pools
    dies in the prune (it is at distance 0 from its selected twin).  Hops
    are 0: there is no traversal.
    """
    pad_row = (chunk_ids < 0)[:, None]
    reprs = backend.query_repr(chunk_ids.clamp_min(0))
    top = ivf_search.top_lists(scan, reprs, cent_words, probes)
    mem, d = ivf_search.list_candidates(backend, reprs, list_ids, top)
    drop = (mem == chunk_ids[:, None]) | pad_row
    mem = torch.where(drop, -1, mem)
    d = torch.where(drop, linking.BIG, d)
    n_local = max(pool - rand_ids.shape[1], 1)
    local_dists, pos = torch.sort(d, dim=1, stable=True)
    local_dists = local_dists[:, :n_local]
    local_ids = mem.gather(1, pos[:, :n_local])

    rand_ok = (rand_ids >= 0) & (rand_ids != chunk_ids[:, None]) & ~pad_row
    rd = backend.dist_many(reprs, rand_ids.clamp_min(0))
    cids = torch.cat([local_ids, torch.where(rand_ok, rand_ids, -1)], dim=1)
    cdists = torch.cat([local_dists, torch.where(rand_ok, rd, linking.BIG)],
                       dim=1)
    pw = backend.pairwise(cids.clamp_min(0))
    fwd_ids, fwd_dists, pool_sizes, occluded = alpha_prune_stats_batch(
        cids, cdists, pw, r=r, alpha=alpha
    )
    hops = torch.zeros(chunk_ids.shape, dtype=torch.int32,
                       device=chunk_ids.device)
    return fwd_ids, fwd_dists, hops, pool_sizes, occluded


def build_graph(
    backend: MetricSpace,
    params: BuildParams,
    *,
    medoid: int | None = None,
    ivf=None,
    init_adjacency: torch.Tensor | None = None,
    verbose: bool = False,
) -> tuple[torch.Tensor, int, BuildStats]:
    """Construct a Vamana graph in ``backend``'s metric space.

    With ``params.ivf_candidates`` each chunk's prune pool is seeded from
    the node's top-p coarse lists; ``ivf`` is the
    :class:`~repro_torch.ivf.IVFPartition` to seed from, built here from
    the backend's signatures when None.  ``init_adjacency`` (optional,
    ``(N, r_total)`` int32, -1 padded) replaces the random starting graph;
    ``medoid`` (optional) replaces the centroid-nearest entry point.  Build
    stats accumulate on the device and are read once at the end.

    Returns (adjacency (N, r_total) int32, medoid id, stats).
    """
    t0 = time.perf_counter()
    n = backend.n
    dev = backend.device
    stats = BuildStats()
    if init_adjacency is None:
        adj = _init_graph(n, params, params.seed, dev)
    else:
        adj = torch.as_tensor(init_adjacency, dtype=torch.int32, device=dev)
        if adj.shape != (n, params.r_total):
            raise ValueError(f"init_adjacency must be {(n, params.r_total)}, "
                             f"got {tuple(adj.shape)}")
    deg = (adj >= 0).sum(dim=1, dtype=torch.int32)

    if medoid is None:
        medoid = int(linking.medoid_scan(
            backend, _centroid_repr(backend), chunk=4096))

    if params.ivf_candidates:
        if not hasattr(backend, "sigs"):
            raise ValueError(
                "ivf_candidates needs a signature-bearing build metric "
                "(bq2/bq1/adc); float32 builds must beam-search"
            )
        if ivf is None:
            ivf = build_partition(backend.sigs,
                                  n_lists=params.ivf_lists or None,
                                  seed=params.seed)
        scan = dispatch.list_scan_ops(backend.sigs.dim, dev).scan
        n_rand = max(1, min(params.prune_pool // 4, params.r))

    rng = np.random.default_rng(params.seed)
    chunk = params.chunk
    added_acc = torch.zeros((), dtype=torch.int64, device=dev)
    hops_sum = torch.zeros((), dtype=torch.float32, device=dev)
    n_hop_chunks = 0
    occl_acc = torch.zeros((), dtype=torch.int64, device=dev)
    # per-chunk device scalars, stacked and read once at the end
    pool_occ_chunks: list = []
    surv_chunks: list = []
    occl_chunks: list = []

    for pass_idx in range(params.passes):
        order = rng.permutation(n).astype(np.int32)
        pad = (-len(order)) % chunk
        if pad:
            order = np.concatenate([order, order[:pad]])
        n_chunks = len(order) // chunk
        order_dev = torch.from_numpy(order).to(dev)

        for ci in range(n_chunks):
            chunk_ids = order_dev[ci * chunk:(ci + 1) * chunk]
            if params.ivf_candidates:
                rand_ids = torch.from_numpy(rng.integers(
                    0, n, size=(chunk, n_rand), dtype=np.int32)).to(dev)
                fwd_ids, _, hops, pool_sizes, occluded = _chunk_forward_ivf(
                    backend, scan, chunk_ids, rand_ids, ivf.cent_words,
                    ivf.list_ids,
                    pool=params.prune_pool,
                    r=params.r,
                    alpha=params.alpha,
                    probes=ivf.build_probes,
                )
            else:
                fwd_ids, _, hops, pool_sizes, occluded = \
                    linking.chunk_forward(
                        backend, adj, chunk_ids, medoid,
                        ef=params.ef_construction,
                        pool=params.prune_pool,
                        r=params.r,
                        alpha=params.alpha,
                        n=n,
                        expand=params.beam_expand,
                    )
            adj, deg = linking.apply_forward(
                adj, deg, chunk_ids, fwd_ids, r_total=params.r_total
            )
            adj, deg, added = linking.reverse_append(
                adj, deg, chunk_ids, fwd_ids, r_total=params.r_total
            )
            stats.chunks += 1
            added_acc += added
            hops_sum += hops.to(torch.float32).mean()
            n_hop_chunks += 1
            real = chunk_ids >= 0
            denom = real.sum().clamp_min(1).to(torch.float32)
            pool_real = torch.where(real, pool_sizes, 0).sum()
            pool_occ_chunks.append(pool_real / denom / params.prune_pool)
            surv = torch.where(real, (fwd_ids >= 0).sum(dim=1), 0).sum()
            surv_chunks.append(surv / pool_real.clamp_min(1).to(torch.float32))
            occl = torch.where(real, occluded, 0).sum()
            occl_acc += occl
            occl_chunks.append(occl)

            if (ci + 1) % params.consolidate_every == 0:
                adj, deg, did = _consolidate_overflow(
                    adj, deg, backend, params, chunk
                )
                stats.consolidations += did
            if verbose and ci % 16 == 0:
                print(f"[vamana] pass {pass_idx} chunk {ci}/{n_chunks} "
                      f"hops={float(hops.float().mean()):.1f}")

    adj, deg, did = _consolidate_overflow(adj, deg, backend, params, chunk)
    stats.consolidations += did
    stats.reverse_edges_added = int(added_acc)
    stats.mean_hops = float(hops_sum) / n_hop_chunks if n_hop_chunks else 0.0
    stats.occluded_total = int(occl_acc)
    if pool_occ_chunks:
        pool_occ = torch.stack(pool_occ_chunks).cpu().numpy()
        surv = torch.stack(surv_chunks).cpu().numpy()
        occl = torch.stack(occl_chunks).cpu().numpy()
        stats.pool_occupancy = float(pool_occ.mean())
        stats.survivor_ratio = float(surv.mean())
        reg = get_default_registry()
        reg.histogram(
            "quiver_build_pool_occupancy",
            "per-chunk prune-pool fill ratio at alpha-prune entry",
            buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0), window=0,
        ).observe_many(pool_occ)
        reg.histogram(
            "quiver_build_survivor_ratio",
            "per-chunk alpha-prune survivors / pool",
            buckets=(0.05, 0.1, 0.25, 0.5, 0.75, 1.0), window=0,
        ).observe_many(surv)
        reg.histogram(
            "quiver_build_occluded",
            "per-chunk candidates occluded by the alpha-criterion",
            buckets=(1.0, 1e1, 1e2, 1e3, 1e4, 1e5), window=0,
        ).observe_many(occl)
    stats.seconds = time.perf_counter() - t0
    return adj, int(medoid), stats


def _centroid_repr(backend) -> torch.Tensor:
    """Centroid query representation for medoid selection: the encoded
    mean of the cold vectors for a float32 backend; otherwise decode the
    signatures to +-1/+-2 levels, average, re-encode.  The level sums are
    whole numbers below 2**24, so they are exact in any order; either mean
    multiplies by the float32 reciprocal of N, as ``jnp.mean`` does."""
    rows = backend.vectors if backend.kind == "float32" \
        else bq.decode_levels(backend.sigs)
    inv_n = float(np.float32(1) / np.float32(rows.shape[0]))
    c = rows.sum(dim=0, keepdim=True) * inv_n
    return backend.encode_queries(c)[0]


def _consolidate_overflow(adj, deg, backend, params, batch):
    """Host-side: find rows with deg > R, re-prune them in fixed batches
    (the last batch wraps around to the first rows, as the reference's)."""
    overflow = np.nonzero(deg.cpu().numpy() > params.r)[0].astype(np.int32)
    if overflow.size == 0:
        return adj, deg, 0
    pad = (-overflow.size) % batch
    if pad:
        overflow = np.concatenate([overflow, overflow[:pad]])
    rows_all = torch.from_numpy(overflow).to(adj.device)
    for i in range(0, overflow.size, batch):
        adj, deg = linking.consolidate_rows(
            backend, adj, deg, rows_all[i:i + batch],
            r=params.r, alpha=params.alpha, r_total=params.r_total,
        )
    return adj, deg, 1
