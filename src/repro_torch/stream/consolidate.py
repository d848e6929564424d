"""Streaming graph surgery: live-masked linking and FreshDiskANN repair.

Counterpart of ``repro/stream/consolidate.py``.  Every function takes the
mutable index's capacity-sized tensors and a metric backend built from
them (``repro_torch.stream.mutable``), and returns new tensors.  The
repair never leaves the metric space the graph was built in, so no float
topology creeps back after consolidation.

:func:`repair_rows` is the FreshDiskANN delete-consolidation step: for a
row that points at tombstones, the candidate pool becomes

    (live out-neighbours of the row)
  ∪ (live out-neighbours of each dead out-neighbour)

(the dead node's edges are spliced across it), and the pool is
alpha-pruned with the backend's own ``dist_many``/``pairwise``, exactly
the criterion used at build time (Vamana Alg. 1).  Every sort is stable,
as ``jnp.argsort`` is.
"""

from __future__ import annotations

import torch

from repro_torch.core import linking
from repro_torch.core.metric import MetricSpace
from repro_torch.core.prune import alpha_prune_batch

BIG = 3.0e38


def link_chunk(backend: MetricSpace, adj, deg, live, chunk_ids, medoid: int,
               *, ef: int, pool: int, r: int, alpha: float, n: int,
               expand: int, r_total: int):
    """Insert one chunk of freshly encoded nodes (``chunk_ids`` (B,) int32,
    -1 padded) into the live graph: beam-search candidates are restricted
    to ``live`` nodes, so new edges never target tombstones; then forward
    rows are installed and reverse edges scatter-appended.  Returns (adj,
    deg, () reverse edges added)."""
    fwd_ids, _, _, _, _ = linking.chunk_forward(
        backend, adj, chunk_ids, medoid,
        ef=ef, pool=pool, r=r, alpha=alpha, n=n, expand=expand,
        node_valid=live,
    )
    adj, deg = linking.apply_forward(adj, deg, chunk_ids, fwd_ids,
                                     r_total=r_total)
    return linking.reverse_append(adj, deg, chunk_ids, fwd_ids,
                                  r_total=r_total)


def overflow_rows(backend: MetricSpace, adj, deg, live, row_ids, *,
                  r: int, alpha: float, r_total: int):
    """Live-masked re-prune of degree-overflowed rows."""
    return linking.consolidate_rows(
        backend, adj, deg, row_ids,
        r=r, alpha=alpha, r_total=r_total, node_valid=live,
    )


def _dedup_rows(cands: torch.Tensor) -> torch.Tensor:
    """Per-row candidate dedup: every repeat of an id after its first slot
    (in the stable sorted order, so the earliest slot) becomes -1."""
    order = torch.sort(cands, dim=1, stable=True).indices
    s = cands.gather(1, order)
    dup_sorted = torch.zeros_like(s, dtype=torch.bool)
    dup_sorted[:, 1:] = (s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)
    dup = torch.zeros_like(dup_sorted).scatter_(1, order, dup_sorted)
    return torch.where(dup, -1, cands)


def repair_rows(backend: MetricSpace, adj, deg, live, row_ids, *,
                r: int, alpha: float, r_total: int, pool: int):
    """Splice dead out-neighbours' edges into ``row_ids``' pools (B,
    int32, -1 padded) and alpha-prune in the backend's metric space
    (delete consolidation).  The pool is scored at T + T*T candidates a
    row (T = ``r_total``) and its best ``pool`` enter the prune."""
    safe_row = row_ids.clamp_min(0).long()
    rows = adj[safe_row]                                  # (B, T)
    nbr_safe = rows.clamp_min(0).long()
    nbr_ok = rows >= 0
    nbr_live = nbr_ok & live[nbr_safe]
    nbr_dead = nbr_ok & ~live[nbr_safe]

    # one hop through each dead neighbour: its own live out-edges
    second = adj[torch.where(nbr_dead, rows, 0).long()]   # (B, T, T)
    sec_ok = nbr_dead[:, :, None] & (second >= 0)
    sec_ok &= live[second.clamp_min(0).long()]

    b = rows.shape[0]
    cands = torch.cat([torch.where(nbr_live, rows, -1),
                       torch.where(sec_ok, second, -1).reshape(b, -1)],
                      dim=1)                              # (B, T + T*T)
    cands = torch.where(cands == row_ids[:, None], -1, cands)
    cands = _dedup_rows(cands)

    valid = cands >= 0
    d = backend.dist_many(backend.query_repr(safe_row), cands.clamp_min(0))
    d = torch.where(valid, d, BIG)
    order = torch.sort(d, dim=1, stable=True).indices[:, :pool]
    cids = cands.gather(1, order)
    cdists = d.gather(1, order)

    pw = backend.pairwise(cids.clamp_min(0))
    new_ids, _ = alpha_prune_batch(cids, cdists, pw, r=r, alpha=alpha)
    return linking.scatter_rows(adj, deg, row_ids, new_ids, r_total=r_total)
