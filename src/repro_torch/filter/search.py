"""Filtered-search routing: widened graph search vs brute force.

Counterpart of ``repro/filter/search.py``.  Graph traversal with a result
mask degrades as selectivity drops (ever more of the beam is spent on
non-matching nodes), while brute force over the match set gets cheaper:
at selectivity 0.01 a scan over the matches touches 1% of the corpus with
perfect recall.  :func:`route` picks the side of that cliff from the
popcount-estimated selectivity; :func:`widened_ef` scales the beam so the
graph side keeps ~``ef`` matching candidates in flight; and
:func:`brute_force_topk` is the under-the-floor fallback (exact cosine
with cold vectors, backend distances without, on the score conventions of
``repro_torch.core.index.rerank``).

:func:`build_label_entries` computes Filtered-Vamana-style per-label entry
points: the member-set medoid of every frequent label, so a filtered
query starts inside its label region instead of navigating to it from the
global medoid.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bq
from repro_torch.core.linking import medoid_scan
from repro_torch.core.metric import MetricSpace
from repro_torch.filter.labels import LabelStore
from repro_torch.obs.metrics import get_default_registry

# below this estimated selectivity, graph navigation falls off the
# filtered-ANN cliff and brute force over the match set wins
DEFAULT_SELECTIVITY_FLOOR = 0.05


def route(selectivity: float, floor: float) -> str:
    """``"graph"`` above the selectivity floor, ``"brute"`` below."""
    return "graph" if selectivity >= floor else "brute"


def widened_ef(ef: int, selectivity: float, floor: float, n: int) -> int:
    """Scale ``ef`` so ~``ef`` *matching* candidates stay in the beam.

    A result mask at selectivity s thins the live result list by ~s, so
    the beam widens by 1/s, clamped at 1/floor (below the floor the router
    brute-forces instead) and at ``n``.  The widening is quantized to an
    integer multiple of ``ef``, which bounds the distinct plans at
    ceil(1/floor) per base ``ef``.  ``n`` caps only the widening: the
    result never drops below the caller's ``ef``.
    """
    widen = min(1.0 / max(selectivity, 1e-9), 1.0 / floor)
    return max(ef, min(n, ef * int(np.ceil(widen))))


def _pad_pow2(ids: np.ndarray, lo: int = 64) -> np.ndarray:
    """-1-pad a match-id list to a power-of-two length."""
    size = lo
    while size < len(ids):
        size *= 2
    out = np.full((size,), -1, dtype=np.int32)
    out[: len(ids)] = ids
    return out


def _topk_of_scores(scores, padded, k):
    """Top-k of (Q, M) scores over a -1-padded id list: ties to the lower
    position, as ``lax.top_k`` breaks them; non-finite scores give -1."""
    scores, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    scores, pos = scores[:, :k], pos[:, :k]
    ids = padded[pos]
    return torch.where(torch.isfinite(scores), ids, -1), scores


def _brute_cosine(queries, vectors, match_ids, k):
    """Exact cosine top-k over a -1-padded match-id list."""
    cand = vectors[match_ids.clamp_min(0).long()]            # (M, D)
    sims = torch.matmul(queries, cand.T)                     # (Q, M)
    sims = torch.where(match_ids[None, :] >= 0, sims,
                       torch.full_like(sims, -float("inf")))
    return _topk_of_scores(sims, match_ids, k)


def brute_force_topk(
    queries: torch.Tensor,         # (Q, D) float32, L2-normalized
    match_ids: np.ndarray,         # (M,) int32 matching node ids
    k: int,
    *,
    vectors: torch.Tensor | None,
    backend: MetricSpace | None = None,
    reprs: torch.Tensor | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k over the match set (the sub-floor fallback).

    With cold ``vectors`` the scores are cosine similarity (the reranked
    graph path's scale).  Without, ``backend``/``reprs`` compute negated
    backend distances (the ``rerank=False`` scale of
    ``repro_torch.core.index.topk_by_dist``): for bq2 one ``dist_rows``
    call over every query and the padded match list.
    """
    nq = int(queries.shape[0])
    get_default_registry().counter(
        "quiver_brute_queries_total",
        "queries served by the exact brute-force route",
    ).inc(nq)
    if len(match_ids) == 0:
        return (np.full((nq, k), -1, np.int32),
                np.full((nq, k), -np.inf, np.float32))
    # pad to >= k as well, so missing hits come back as -1/-inf
    padded = torch.from_numpy(
        _pad_pow2(np.asarray(match_ids, np.int32), lo=max(64, k))
    ).to(queries.device)
    if vectors is not None:
        ids, scores = _brute_cosine(queries, vectors, padded, k)
        return ids.cpu().numpy(), scores.cpu().numpy()
    if backend is None or reprs is None:
        raise ValueError(
            "brute force without cold vectors needs the metric backend")
    valid = padded >= 0
    cand = padded.clamp_min(0)[None, :].expand(nq, -1).contiguous()
    dists = backend.dist_many(reprs, cand)
    dists = torch.where(valid[None, :], dists,
                        torch.full_like(dists, float("inf")))
    ids, scores = _topk_of_scores(-dists, padded, k)
    return ids.cpu().numpy(), scores.cpu().numpy()


def member_centroid(member: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Mean of ``rows`` (N, D) over the ``member`` (N,) bool mask, as
    float32.  The column sums are taken in float64 and rounded to float32
    once, so the CPU's and the card's means differ only where a float64
    sum lands within a few of its ulps of a float32 rounding boundary; the
    reference sums in float32, in XLA's order (see ROADMAP queue 3)."""
    member_f = member.to(torch.float64)
    denom = member_f.sum().clamp_min(1.0)
    return (torch.matmul(member_f, rows.to(torch.float64))
            / denom).to(torch.float32)


def build_label_entries(
    store: LabelStore,
    backend: MetricSpace,
    *,
    vectors: torch.Tensor | None = None,
    node_valid: torch.Tensor | None = None,
    min_count: int = 32,
    chunk: int = 4096,
) -> int:
    """Fill ``store.entries`` with per-label medoids; returns how many.

    For every label whose member count is >= ``min_count`` (rarer ones
    route to brute force anyway), the member set's centroid is encoded
    into the backend's query representation and a masked medoid scan
    picks the closest member.  ``node_valid`` restricts members to live
    nodes (streaming).
    """
    built = 0
    counts = store.counts
    rows = (vectors if vectors is not None
            else bq.decode_levels(backend.sigs)).to(torch.float64)
    for label in range(store.n_labels):
        if counts[label] < min_count:
            store.entries[label] = -1
            continue
        member = store.member_mask(label)
        if node_valid is not None:
            member = member & node_valid
        c = member_centroid(member, rows)
        centroid = backend.encode_queries(c[None])[0]
        store.entries[label] = int(
            medoid_scan(backend, centroid, chunk=chunk, node_valid=member)
        )
        built += 1
    return built
