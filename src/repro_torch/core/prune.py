"""Vamana alpha-diversity pruning on BQ distances (QuIVer Alg. 1).

Counterpart of ``repro/core/prune.py``, written for a batch of targets at
once: ``cand_ids (B, C)``, ``cand_dists (B, C)``, ``pairwise (B, C, C)``.
For each of the R output slots, the nearest candidate not yet selected or
pruned is selected, and every candidate it covers
(``dist(c, target) > alpha * dist(c, pick)``) is pruned.  Distances are the
calibrated non-negative BQ distances ``d = 4D - similarity``, whole numbers
held in float32, so the result is exact; ``alpha`` is rounded to float32 as
in the reference.
"""

from __future__ import annotations

import torch

BIG = 3.0e38


def _greedy_select(cand_ids, cand_dists, pairwise, *, r, alpha):
    """Distance-sort + greedy cover loop; returns (sorted ids, sorted
    dists, selected mask, pruned mask) over the sorted candidate order."""
    b, c = cand_ids.shape
    dev = cand_ids.device
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    order = torch.sort(torch.where(cand_ids >= 0, cand_dists, big), dim=1,
                       stable=True).indices
    ids = cand_ids.gather(1, order)
    dists = cand_dists.gather(1, order)
    pw = pairwise.gather(1, order[:, :, None].expand(b, c, c))
    pw = pw.gather(2, order[:, None, :].expand(b, c, c))
    valid = ids >= 0
    alpha32 = torch.tensor(alpha, dtype=torch.float32, device=dev)
    slot = torch.arange(c, device=dev)

    selected = torch.zeros((b, c), dtype=torch.bool, device=dev)
    pruned = torch.zeros((b, c), dtype=torch.bool, device=dev)
    for _ in range(r):
        avail = valid & ~selected & ~pruned
        # sorted by distance: the first available is the nearest
        first = torch.where(avail, slot, c).amin(dim=1, keepdim=True)
        any_avail = first < c
        pick = torch.where(any_avail, first, 0)
        selected.scatter_(1, pick, selected.gather(1, pick) | any_avail)
        row = pw.gather(1, pick[:, :, None].expand(b, 1, c))[:, 0]
        covered = (dists > alpha32 * row) & ~selected & any_avail
        pruned |= covered
    return ids, dists, selected, pruned


def _compact(ids, dists, selected, r):
    """Compact the <= r selected entries (in distance order) into (B, r)."""
    b = ids.shape[0]
    rank = selected.cumsum(dim=1) - 1
    slot = torch.where(selected, rank, r)        # r: overflow bucket
    out_ids = torch.full((b, r + 1), -1, dtype=ids.dtype, device=ids.device)
    out_ids.scatter_(1, slot, torch.where(selected, ids, -1))
    out_dists = torch.full((b, r + 1), BIG, dtype=torch.float32,
                           device=ids.device)
    out_dists.scatter_(1, slot, torch.where(selected, dists, BIG))
    return out_ids[:, :r], out_dists[:, :r]


def alpha_prune_batch(cand_ids, cand_dists, pairwise, *, r, alpha):
    """(B, C) / (B, C, C) -> ((B, r) ids, (B, r) dists)."""
    ids, dists, selected, _ = _greedy_select(
        cand_ids, cand_dists, pairwise, r=r, alpha=alpha
    )
    return _compact(ids, dists, selected, r)


def alpha_prune_stats_batch(cand_ids, cand_dists, pairwise, *, r, alpha):
    """:func:`alpha_prune_batch` plus the build-telemetry counts: (B,)
    pool sizes (valid candidates entering the prune) and (B,) occluded
    counts (candidates the alpha-criterion covered away)."""
    ids, dists, selected, pruned = _greedy_select(
        cand_ids, cand_dists, pairwise, r=r, alpha=alpha
    )
    out_ids, out_dists = _compact(ids, dists, selected, r)
    pool = (ids >= 0).sum(dim=1, dtype=torch.int32)
    occluded = pruned.sum(dim=1, dtype=torch.int32)
    return out_ids, out_dists, pool, occluded


def alpha_prune(cand_ids, cand_dists, pairwise, *, r, alpha):
    """One target: (C,) / (C, C) -> ((r,) ids, (r,) dists)."""
    ids, dists = alpha_prune_batch(
        cand_ids[None], cand_dists[None], pairwise[None], r=r, alpha=alpha
    )
    return ids[0], dists[0]


def alpha_prune_stats(cand_ids, cand_dists, pairwise, *, r, alpha):
    """One target: :func:`alpha_prune` plus () pool size and () occluded."""
    out = alpha_prune_stats_batch(
        cand_ids[None], cand_dists[None], pairwise[None], r=r, alpha=alpha
    )
    return tuple(t[0] for t in out)
