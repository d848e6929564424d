"""Ground truth (paper §5.1 "Exact Flat baselines").

Counterpart of ``repro/core/baselines.py``: exact brute-force cosine
top-k and Recall@k.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.index import as_float32, normalize
from repro_torch.device import resolve_device


def flat_search(
    vectors,
    queries,
    k: int = 10,
    *,
    query_batch: int = 128,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact brute-force cosine top-k -> ((Q, k) ids, (Q, k) scores)."""
    device = resolve_device(device)
    base = normalize(as_float32(vectors, device))
    queries = normalize(as_float32(queries, device))
    all_ids, all_scores = [], []
    for s in range(0, queries.shape[0], query_batch):
        scores, ids = torch.topk(queries[s:s + query_batch] @ base.T, k)
        all_ids.append(ids.to(torch.int32).cpu().numpy())
        all_scores.append(scores.cpu().numpy())
    return np.concatenate(all_ids), np.concatenate(all_scores)


def recall_at_k(pred_ids: np.ndarray, true_ids: np.ndarray) -> float:
    """Mean |pred ∩ true| / k over queries (Recall@k, the paper's metric)."""
    k = true_ids.shape[1]
    hits = 0
    for p, t in zip(pred_ids, true_ids):
        hits += len(set(p[:k].tolist()) & set(t.tolist()))
    return hits / (k * len(true_ids))
