"""Symmetric BQ beam search over a fixed-degree graph (QuIVer §3.3, stage 1).

Counterpart of ``repro/core/beam.py``.  The reference is a ``vmap`` of a
``lax.while_loop``; here it is one batched loop over a ``(B, ef)`` beam
with **per-query termination**: a query whose condition is false keeps its
state frozen while the others go on, so ``hops`` and ``evals`` are per
query, exactly as under ``vmap``.  The loop ends when no query can go on,
which costs one host sync (``any``) per hop.

Each hop expands the ``expand`` nearest unexpanded beam entries of every
live query and folds their <= ``expand * R`` neighbours into the beam with
one batched distance call.  Ties are broken as the reference breaks them:
frontier picks and the ``[beam | new]`` merge use stable sorts, and a
neighbour that appears twice in one hop counts only at its first slot.

Two optional ``(n,)`` masks restrict what is *returned*, never what is
traversed: ``node_valid`` (tombstones) and ``result_valid`` (a filter
predicate) conjoin, and under either a parallel valid-only result list is
merged beside the navigation beam, as in the reference.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.obs.metrics import get_default_registry

INF = 3.0e38

# dist_fn(queries (B, ...), ids (B, K) int32) -> (B, K) float32
DistFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def batch_bucket(n: int, query_batch: int) -> int:
    """Padded size for a (possibly partial) query batch: the ladder 8, 32,
    128, ... capped at ``query_batch``."""
    b = 8
    while b < n and b < query_batch:
        b *= 4
    return min(b, query_batch)


def pad_rows(arr: torch.Tensor, size: int) -> torch.Tensor:
    """Pad axis 0 to ``size`` rows by repeating the last row."""
    pad = size - arr.shape[0]
    if pad <= 0:
        return arr
    return torch.cat([arr, arr[-1:].expand(pad, *arr.shape[1:])], dim=0)


def beam_margin(dists: torch.Tensor, k: int, neutral: float) -> torch.Tensor:
    """Per-query top-k score margin ``(neutral - d[k-1]) / neutral`` of a
    ``(Q, ef)`` sorted distance list; -1 where fewer than k were found."""
    dk = dists[..., k - 1]
    # multiply by the float32 reciprocal, as XLA compiles the reference's
    # division by a constant (the two round differently)
    margin = (neutral - dk) * float(np.float32(1) / np.float32(neutral))
    return torch.where(dk < INF / 2, margin, torch.full_like(margin, -1.0))


def escalated_search(run, reprs, queries, ef: int, *,
                     adaptive: bool, margin_thr: float, mult: int):
    """Adaptive escalation around a base search (the reference's
    ``repro.core.beam.escalated_search``; its plan cache applies the same
    rule as the second stage of a plan).

    ``run(reprs, queries, ef, want_margin) -> (ids, scores, margins)`` is
    the caller's batched base search, returning host numpy arrays
    (``margins``: float32 :func:`beam_margin` at the nav backend's own
    ``neutral_dist``, or None when ``want_margin`` is False).  With
    ``adaptive``, queries whose margin falls below ``margin_thr`` re-run
    once at ``ef * mult`` and their rows are spliced back in place.  The
    comparison is numpy's float32 one, as in the reference.
    """
    all_ids, all_scores, margins = run(reprs, queries, ef, adaptive)
    if adaptive and margins is not None:
        reg = get_default_registry()
        reg.histogram(
            "quiver_beam_margin",
            "per-query normalized k-th-neighbor score margin",
            buckets=(-1.0, 0.0, 0.05, 0.1, 0.15, 0.2, 0.3, 0.5, 1.0),
            window=0,
        ).observe_many(np.asarray(margins, dtype=np.float64))
        esc = np.nonzero(margins < margin_thr)[0]
        if esc.size:
            reg.counter(
                "quiver_escalated_queries_total",
                "tight-margin queries re-run at the escalated stage",
                labels=("plan",),
            ).inc(int(esc.size), plan=f"ef{ef}x{mult}")
            take = torch.from_numpy(esc).to(reprs.device)
            esc_ids, esc_scores, _ = run(reprs[take], queries[take],
                                         ef * mult, False)
            all_ids[esc] = esc_ids
            all_scores[esc] = esc_scores
    return all_ids, all_scores


def _conjoin(node_valid, result_valid):
    """Combine the tombstone and predicate result masks (None == all
    valid); the one owner of the two-mask conjunction."""
    if node_valid is not None and result_valid is not None:
        return node_valid & result_valid
    return node_valid if node_valid is not None else result_valid


def _merge(ids, dists, new_ids, new_dists, ef):
    """Merge new candidates into a sorted (B, ef) list and keep the best
    ``ef``; a stable sort keeps earlier entries first among equal
    distances.  Returns (ids, dists, the gather order)."""
    cat_d = torch.cat([dists, new_dists], dim=1)
    order = torch.sort(cat_d, dim=1, stable=True).indices[:, :ef]
    return (torch.cat([ids, new_ids], dim=1).gather(1, order),
            cat_d.gather(1, order), order)


class BeamResult(NamedTuple):
    ids: torch.Tensor         # (B, ef) int32, -1 padded, sorted by distance
    dists: torch.Tensor       # (B, ef) float32, INF padded
    hops: torch.Tensor        # (B,) int32 expansion rounds performed
    evals: torch.Tensor       # (B,) int32 fresh distance evaluations
    descent: torch.Tensor     # (B,) float32 entry dist - best dist
    stalls: torch.Tensor      # (B,) int32 rounds without beam-best gain
    entry_rank: torch.Tensor  # (B,) int32 beam dists beating the entry


def beam_search(
    queries: torch.Tensor,
    adjacency: torch.Tensor,   # (N, R) int32, -1 padded
    start: int,
    *,
    dist_fn: DistFn,
    ef: int,
    n: int,
    max_hops: int = 0,
    expand: int = 1,
    max_evals: int = 0,
    node_valid: torch.Tensor | None = None,     # (n,) bool live mask
    result_valid: torch.Tensor | None = None,   # (n,) bool predicate mask
) -> BeamResult:
    """Batched best-first beam search from ``start`` toward each query.

    ``queries`` is whatever ``dist_fn`` consumes, batched on axis 0.
    ``expand`` (the expansion width L) picks how many unexpanded entries
    each query expands per hop; ``max_evals`` (0 = unlimited) stops a
    query once it has spent that many fresh distance evaluations.

    ``node_valid`` (tombstones of a mutable index) and ``result_valid`` (a
    filter predicate's match mask), shared by the batch, conjoin.  Under
    either, navigation is unchanged: masked-out nodes are still expanded
    and their edges still route.  Only the returned ids and dists come
    from the valid-only result list; ``descent`` and ``entry_rank`` are
    read from the navigation list.
    """
    dev = adjacency.device
    b, r = queries.shape[0], adjacency.shape[1]
    max_hops = max_hops or (4 * ef + 128)
    if not 1 <= expand <= ef:
        raise ValueError(f"expand must lie in [1, ef], got {expand}, {ef}")
    lr = expand * r

    d0 = dist_fn(queries, torch.full((b, 1), start, dtype=torch.int32,
                                     device=dev))[:, 0]
    ids = torch.full((b, ef), -1, dtype=torch.int32, device=dev)
    ids[:, 0] = start
    dists = torch.full((b, ef), INF, dtype=torch.float32, device=dev)
    dists[:, 0] = d0
    # padding entries are marked expanded so they are never picked
    expanded = torch.ones((b, ef), dtype=torch.bool, device=dev)
    expanded[:, 0] = False
    # column n is a trash column for invalid neighbour slots
    visited = torch.zeros((b, n + 1), dtype=torch.bool, device=dev)
    visited[:, start] = True
    hops = torch.zeros(b, dtype=torch.int32, device=dev)
    evals = torch.ones(b, dtype=torch.int32, device=dev)
    stalls = torch.zeros(b, dtype=torch.int32, device=dev)
    # earlier[i, j]: slot j comes before slot i within one hop's batch
    earlier = torch.ones((lr, lr), dtype=torch.bool, device=dev).tril(-1)
    inf = torch.tensor(INF, dtype=torch.float32, device=dev)
    res_valid = _conjoin(node_valid, result_valid)
    if res_valid is not None:
        ok0 = res_valid[start]
        res_ids = torch.full_like(ids, -1)
        res_ids[:, 0] = torch.where(ok0, ids[:, 0], -1)
        res_dists = torch.full_like(dists, INF)
        res_dists[:, 0] = torch.where(ok0, d0, inf)

    while True:
        frontier = ~expanded & (ids >= 0)
        go = frontier.any(dim=1) & (hops < max_hops)
        if max_evals:
            go &= evals < max_evals
        if not bool(go.any()):
            break
        prev_best = dists[:, 0]
        # stable sort => tie-break by beam position, as argmin at L=1
        picks = torch.sort(torch.where(frontier, dists, inf), dim=1,
                           stable=True).indices[:, :expand]
        valid_pick = frontier.gather(1, picks) & go[:, None]
        nodes = torch.where(valid_pick, ids.gather(1, picks), 0)
        expanded.scatter_(1, picks, expanded.gather(1, picks) | valid_pick)

        nbrs = adjacency.index_select(0, nodes.reshape(-1)).reshape(b, lr)
        valid = (nbrs >= 0) & valid_pick.repeat_interleave(r, dim=1)
        nbrs_safe = torch.where(valid, nbrs, 0)
        slots = torch.where(valid, nbrs, n).long()
        fresh = valid & ~visited.gather(1, slots)
        # duplicate neighbours within one batch: keep first occurrence only
        dup = (nbrs_safe[:, :, None] == nbrs_safe[:, None, :]) \
            & earlier & valid[:, None, :]
        fresh &= ~dup.any(dim=2)
        visited.scatter_(1, slots, True)

        nd = torch.where(fresh, dist_fn(queries, nbrs_safe), inf)
        new_ids = torch.where(fresh, nbrs_safe, -1)
        ids, dists, order = _merge(ids, dists, new_ids, nd, ef)
        expanded = torch.cat([expanded, torch.zeros_like(fresh)],
                             dim=1).gather(1, order)
        if res_valid is not None:
            live = fresh & res_valid[nbrs_safe.long()]
            res_ids, res_dists, _ = _merge(
                res_ids, res_dists, torch.where(live, nbrs_safe, -1),
                torch.where(live, nd, inf), ef)
        evals += fresh.sum(dim=1, dtype=torch.int32)
        # a round that fails to improve the beam best is a stall
        stalls += (~(dists[:, 0] < prev_best) & go).to(torch.int32)
        hops += go.to(torch.int32)

    nav = dict(descent=d0 - dists[:, 0], stalls=stalls,
               entry_rank=(dists < d0[:, None]).sum(dim=1,
                                                    dtype=torch.int32))
    if res_valid is not None:
        ids, dists = res_ids, res_dists
    return BeamResult(ids=ids, dists=dists, hops=hops, evals=evals, **nav)
