"""IVF list-scan search primitives.

Counterpart of ``repro/ivf/search.py``: scan the centroid signatures with
the list-scan kernel, keep the top-p lists, gather their (disjoint) members
from the padded ``list_ids`` view, score them with the metric backend and
keep the best ef: the flat two-stage alternative to graph traversal behind
``QuIVerIndex.search(nav="ivf")``, whose ``top_lists``/``list_candidates``
the IVF-seeded build (``core.vamana``) reuses.

Every score is an integer, so ties are common; where the reference selects
with ``lax.top_k`` (the lower index wins a tie) these functions sort
stably.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.obs.metrics import get_default_registry

INF = 3.0e38

# shards-contacted histogram boundaries: powers of two
_SCATTER_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def record_routes(top, shards_contacted=None, *, registry=None):
    """Record per-list routing counters.

    ``top`` is the (Q, p) probed-list array of one batch (tensor or
    array); ``shards_contacted`` (optional, (Q,)) is how many shards each
    query's targeted scatter touched.  Its callers are the two scatters,
    ``repro_torch.core.distributed.search_ivf_sharded`` and
    ``repro_torch.stream.StreamingShardedIndex.search(scatter=True)``.
    Feeds
    ``quiver_ivf_list_routes_total{list}`` and the
    ``quiver_ivf_scatter_shards`` histogram on ``registry`` (default: the
    process registry).
    """
    reg = registry if registry is not None else get_default_registry()
    routes = reg.counter(
        "quiver_ivf_list_routes_total",
        "IVF probes routed to this coarse list",
        labels=("list",),
    )
    counts = np.bincount(_host(top).ravel())
    for lst in np.nonzero(counts)[0]:
        routes.inc(int(counts[lst]), list=int(lst))
    if shards_contacted is not None:
        reg.histogram(
            "quiver_ivf_scatter_shards",
            "shards contacted per query by targeted scatter",
            buckets=_SCATTER_BUCKETS,
        ).observe_many(_host(shards_contacted))


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def top_lists(scan, reprs, cent_words, p: int) -> torch.Tensor:
    """(Q, 2W) query signatures -> (Q, p) nearest-list ids (int64).

    ``scan`` is a bound ``ListScanOps.scan``; the similarity is int32
    Table-1, larger = nearer.
    """
    sim = scan(reprs, cent_words)
    return torch.sort(sim, dim=1, descending=True, stable=True).indices[:, :p]


def list_candidates(backend, reprs, list_ids, top):
    """Gather + score the members of each query's top-p lists.

    Returns ((Q, p*cap) member ids with -1 padding, (Q, p*cap) float32
    distances, INF on padding).  Lists partition the corpus, so a query's
    gathered members are disjoint.
    """
    mem = list_ids[top].reshape(top.shape[0], -1)
    d = backend.dist_many(reprs, mem.clamp_min(0))
    return mem, torch.where(mem >= 0, d, INF)


def scan_search(backend, scan, reprs, cent_words, list_ids, *,
                probes: int, ef: int, result_valid=None):
    """Full IVF candidate stage: (Q, 2W) reprs -> ((Q, ef') ids, dists).

    ``ef'`` = min(ef, probes*cap); short pools surface as -1 ids and INF
    distances.  ``result_valid`` (optional (N,) bool) is the filtered
    route's predicate mask: non-matching members score INF before the
    top-ef and never surface, as under the beam's result mask.
    """
    top = top_lists(scan, reprs, cent_words, probes)
    mem, d = list_candidates(backend, reprs, list_ids, top)
    if result_valid is not None:
        d = torch.where(result_valid[mem.clamp_min(0).long()], d, INF)
    dists, pos = torch.sort(d, dim=1, stable=True)
    ef_eff = min(ef, mem.shape[1])
    dists = dists[:, :ef_eff]
    ids = mem.gather(1, pos[:, :ef_eff])
    return torch.where(dists < INF / 2, ids, -1), dists


def ivf_probes(part, k: int, probes: int | None) -> int:
    """Lists a ``nav="ivf"`` search probes: ``probes`` (default: the
    partition's ``default_probes``) clamped to the partition, but never
    below the fan-in that can fill k (degraded plans halve probes with
    floor 1).  The planner resolves a plan's probes with it and the plan
    cache clamps again; the clamp is idempotent."""
    probes = probes or part.default_probes
    return max(min(probes, part.n_lists),
               min(part.n_lists, -(-k // part.cap)))
