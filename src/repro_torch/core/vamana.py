"""BQ-native Vamana graph construction (QuIVer §3.2 / §4.1).

Counterpart of ``repro/core/vamana.py``: bulk encode, then chunked
linking.  Nodes are inserted in chunks of ``BuildParams.chunk``; each
chunk beam-searches the current graph, alpha-prunes its candidate pools
in bq2 space, writes forward edges and scatter-appends reverse edges, and
every ``consolidate_every`` chunks the rows that overflowed R are
re-pruned.  The host drives the loop; the device does the work.

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
    # IVF-seeded construction waits for the port of repro.ivf
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


def build_graph(
    backend: MetricSpace,
    params: BuildParams,
    *,
    medoid: int | None = None,
    init_adjacency: torch.Tensor | None = None,
    verbose: bool = False,
) -> tuple[torch.Tensor, int, BuildStats]:
    """Construct a Vamana graph in ``backend``'s metric space.

    ``init_adjacency`` (optional, ``(N, r_total)`` int32, -1 padded)
    replaces the random starting graph; ``medoid`` (optional) replaces
    the centroid-nearest entry point.  Build stats accumulate on the
    device and are read once at the end.

    Returns (adjacency (N, r_total) int32, medoid id, stats).
    """
    if params.ivf_candidates:
        raise NotImplementedError(
            "IVF-seeded construction (ivf_candidates=True) is not ported yet"
        )
    t0 = time.perf_counter()
    n = backend.n
    dev = backend.sigs.words.device
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
            fwd_ids, _, hops, pool_sizes, occluded = linking.chunk_forward(
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
    """Centroid query representation for medoid selection: decode the
    signatures to +-1/+-2 levels, average, re-encode.  The level sums are
    whole numbers below 2**24, so they are exact in any order; the mean
    multiplies by the float32 reciprocal of N, as ``jnp.mean`` does."""
    levels = bq.decode_levels(backend.sigs)
    inv_n = float(np.float32(1) / np.float32(levels.shape[0]))
    c = levels.sum(dim=0, keepdim=True) * inv_n
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
