"""Vamana linking primitives (QuIVer §4.1): the chunk-level graph surgery.

Counterpart of ``repro/core/linking.py``, shared by the batch build and the
streaming index (``repro_torch.stream``): beam-search a chunk of nodes,
alpha-prune their candidate pools, install forward edges, scatter-append
reverse edges, re-prune overflowing rows, scan for the medoid, and pick
each IVF list's medoid.  ``chunk_ids`` / ``row_ids`` may hold ``-1``
padding; padded entries scatter into a trash row and leave the graph
untouched.

``node_valid`` (the live mask of a mutable index) restricts beam-search
candidates and re-prune pools to live nodes; dead nodes are still
traversed.  ``None`` (the batch build) means all nodes.

Every function returns new tensors and leaves its inputs as they were, as
the reference's do.
"""

from __future__ import annotations

import torch

from repro_torch.core.beam import beam_search
from repro_torch.core.metric import MetricSpace
from repro_torch.core.prune import alpha_prune_batch, alpha_prune_stats_batch

BIG = 3.0e38


def chunk_forward(
    backend: MetricSpace,
    adj: torch.Tensor,
    chunk_ids: torch.Tensor,      # (B,) int32, -1 padded
    medoid: int,
    *,
    ef: int,
    pool: int,
    r: int,
    alpha: float,
    n: int,
    expand: int = 1,
    node_valid: torch.Tensor | None = None,
):
    """Beam-search a chunk of nodes and alpha-prune their candidates.

    Returns ((B, r) forward ids, (B, r) dists, (B,) hops, (B,) prune pool
    sizes, (B,) occlusion counts).  Rows whose ``chunk_ids`` entry is -1
    come back all -1 / 0.
    """
    pad_row = (chunk_ids < 0)[:, None]
    queries = backend.query_repr(chunk_ids.clamp_min(0))
    res = beam_search(
        queries, adj, medoid, dist_fn=backend.dist_many, ef=ef, n=n,
        expand=expand, node_valid=node_valid,
    )
    # remove self from each candidate list, keep the best ``pool``
    drop = (res.ids == chunk_ids[:, None]) | pad_row
    cids = torch.where(drop, -1, res.ids)
    cdists = torch.where(drop, BIG, res.dists)
    order = torch.sort(cdists, dim=1, stable=True).indices[:, :pool]
    cids = cids.gather(1, order)
    cdists = cdists.gather(1, order)

    pw = backend.pairwise(cids.clamp_min(0))
    fwd_ids, fwd_dists, pool_sizes, occluded = alpha_prune_stats_batch(
        cids, cdists, pw, r=r, alpha=alpha
    )
    return fwd_ids, fwd_dists, res.hops, pool_sizes, occluded


def scatter_rows(adj, deg, row_ids, edge_ids, *, r_total):
    """Overwrite ``row_ids``' adjacency rows with ``edge_ids`` (B, <= r_total),
    right-padded with -1; degrees become the count of valid edges.  Rows
    of -1 scatter into a trash row."""
    n = adj.shape[0]
    b = edge_ids.shape[0]
    rows = torch.full((b, r_total), -1, dtype=torch.int32, device=adj.device)
    rows[:, : edge_ids.shape[1]] = edge_ids
    tgt = torch.where(row_ids >= 0, row_ids, n).long()
    adj_pad = torch.cat([adj, rows.new_full((1, r_total), -1)])
    adj_pad[tgt] = rows
    deg_pad = torch.cat([deg, deg.new_zeros(1)])
    deg_pad[tgt] = (edge_ids >= 0).sum(dim=1, dtype=torch.int32)
    return adj_pad[:n], deg_pad[:n]


def apply_forward(adj, deg, chunk_ids, fwd_ids, *, r_total):
    """Install forward-edge rows for a chunk (padded ids -> trash row)."""
    return scatter_rows(adj, deg, chunk_ids, fwd_ids, r_total=r_total)


def reverse_append(adj, deg, chunk_ids, fwd_ids, *, r_total):
    """Scatter-append reverse edges src -> tgt with capacity drop.

    Returns (adj, deg, () number of edges added).
    """
    n = adj.shape[0]
    r = fwd_ids.shape[1]
    tgt = fwd_ids.reshape(-1)                              # (B*R,)
    src = chunk_ids.repeat_interleave(r)                   # (B*R,)
    valid = (tgt >= 0) & (src >= 0)
    tgt_safe = torch.where(valid, tgt, 0)

    # skip proposals whose edge already exists
    exists = (adj[tgt_safe.long()] == src[:, None]).any(dim=1)
    valid &= ~exists

    # rank of each proposal within its target group (sorted by target)
    key = torch.where(valid, tgt, n + 1)
    order = torch.sort(key, stable=True).indices
    tgt_s, src_s, valid_s = key[order], src[order], valid[order]
    idx = torch.arange(tgt_s.shape[0], device=adj.device)
    boundary = torch.ones_like(valid_s)
    boundary[1:] = tgt_s[1:] != tgt_s[:-1]
    seg_start = torch.cummax(torch.where(boundary, idx, 0), dim=0).values
    rank = idx - seg_start

    tgt_w = torch.where(valid_s, tgt_s, n).long()          # n: trash row
    slot = deg[tgt_w.clamp_max(n - 1)] + rank
    ok = valid_s & (slot < r_total)
    tgt_w = torch.where(ok, tgt_w, n)
    slot_w = torch.where(ok, slot, r_total)                # r_total: trash col

    adj_pad = torch.full((n + 1, r_total + 1), -1, dtype=torch.int32,
                         device=adj.device)
    adj_pad[:n, :r_total] = adj
    adj_pad[tgt_w, slot_w] = torch.where(ok, src_s, -1)
    deg = deg.scatter_add(0, tgt_w.clamp_max(n - 1),
                          (ok & (tgt_w < n)).to(torch.int32))
    return adj_pad[:n, :r_total], deg, ok.sum()


def consolidate_rows(backend: MetricSpace, adj, deg, row_ids, *,
                     r: int, alpha: float, r_total: int,
                     node_valid: torch.Tensor | None = None):
    """Re-prune rows back down to <= r edges (degree overflow).  With
    ``node_valid``, dead neighbours leave the pool before the prune.
    Padded ``row_ids`` entries leave the graph alone."""
    safe_row_ids = row_ids.clamp_min(0)
    rows = adj[safe_row_ids.long()]                        # (B, r_total)
    ok = rows >= 0
    if node_valid is not None:
        ok &= node_valid[rows.clamp_min(0).long()]
        rows = torch.where(ok, rows, -1)
    safe = rows.clamp_min(0)
    # distance of each neighbour to the row's own node
    dists = backend.dist_many(backend.query_repr(safe_row_ids), safe)
    dists = torch.where(ok, dists, BIG)
    pw = backend.pairwise(safe)
    new_ids, _ = alpha_prune_batch(rows, dists, pw, r=r, alpha=alpha)
    return scatter_rows(adj, deg, row_ids, new_ids, r_total=r_total)


def shard_medoids(backend: MetricSpace, cent_reprs: torch.Tensor,
                  shard_ids: torch.Tensor) -> torch.Tensor:
    """For each of L shards (``shard_ids`` (L, S) int32, -1 padded), the
    member nearest its representation ``cent_reprs[l]``: the first minimum
    in slot order, as ``jnp.argmin`` picks it.  One ``dist_many`` call
    scores all members.  Returns (L,) int32 node ids."""
    d = backend.dist_many(cent_reprs, shard_ids.clamp_min(0))
    d = torch.where(shard_ids >= 0, d, BIG)
    best = d.argmin(dim=1)          # documented: the first minimal value
    return shard_ids.gather(1, best[:, None])[:, 0]


def medoid_scan(backend: MetricSpace, centroid_repr: torch.Tensor, *,
                chunk: int,
                node_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Id of the node nearest ``centroid_repr`` (2W,): the *first* global
    minimum in id order, scanned in blocks of ``chunk`` ids.  Nodes outside
    ``node_valid`` (optional, (n,) bool) score ``BIG``; with none valid the
    result is node 0, as in the reference.  Returns a () int64 tensor on
    the backend's device."""
    n = backend.n
    dev = centroid_repr.device
    q = centroid_repr[None]
    best_d = torch.tensor(BIG, dtype=torch.float32, device=dev)
    best_i = torch.tensor(0, dtype=torch.int64, device=dev)
    for s in range(0, n, chunk):
        block = torch.arange(s, min(s + chunk, n), dtype=torch.int32,
                             device=dev)
        d = backend.dist_many(q, block[None])[0]
        if node_valid is not None:
            d = torch.where(node_valid[s:s + chunk], d, BIG)
        m = d.min()
        i = torch.where(d == m, block.long(), n).min()     # first minimum
        better = m < best_d
        best_d = torch.where(better, m, best_d)
        best_i = torch.where(better, i, best_i)
    return best_i
