"""QuIVer-backed semantic deduplication for the data pipeline.

Counterpart of ``repro/data/dedup.py``.  Before documents enter the token
pipeline, their embeddings are indexed with QuIVer and near-duplicates
(a BQ beam-search hit whose *float32-reranked* cosine reaches
``threshold``) are dropped.  The scan runs in the 2-bit hot path (build
and search touch float32 only at rerank), so the paper's 12:1 hot-memory
compression applies to the dedup working set too.

Two modes:

* :func:`semantic_dedup` — batch: build once over all docs, then scan.
* :func:`streaming_dedup` — insert-as-you-scan over a mutable index: each
  batch is searched against only the docs *kept* so far, and the
  survivors are inserted at once.  Same keep semantics (first occurrence
  wins), in a single pass.

Both run on ``device`` (default: the CUDA card).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.index import QuIVerIndex
from repro_torch.core.vamana import BuildParams
from repro_torch.stream import MutableQuIVerIndex

_DEFAULT_PARAMS = dict(m=8, ef_construction=48, prune_pool=48, chunk=256)


def semantic_dedup(
    embeddings: np.ndarray,
    *,
    threshold: float = 0.97,
    params: BuildParams | None = None,
    ef: int = 32,
    query_batch: int = 256,
    device=None,
) -> np.ndarray:
    """Returns indices of the documents to KEEP (first occurrence wins).

    Greedy order-preserving dedup: build the index once over all docs,
    then query each doc's neighbourhood; doc i is dropped iff some kept
    doc j < i has cosine(q_i, v_j) >= threshold.
    """
    params = params or BuildParams(**_DEFAULT_PARAMS)
    x = np.asarray(embeddings, dtype=np.float32)
    idx = QuIVerIndex.build(x, params, device=device)
    ids, scores = idx.search(x, k=min(16, ef), ef=ef,
                             query_batch=query_batch)

    keep_mask = np.ones(len(x), dtype=bool)
    for i in range(len(x)):
        for j, s in zip(ids[i], scores[i]):
            if j < 0 or j == i:
                continue
            if s >= threshold and j < i and keep_mask[j]:
                keep_mask[i] = False
                break
    return np.nonzero(keep_mask)[0]


def streaming_dedup(
    embeddings: np.ndarray,
    *,
    threshold: float = 0.97,
    params: BuildParams | None = None,
    ef: int = 32,
    scan_batch: int = 256,
    k: int = 16,
    index: MutableQuIVerIndex | None = None,
    device=None,
) -> np.ndarray:
    """Insert-as-you-scan dedup; returns indices of documents to KEEP.

    Each batch is (1) searched against the index of previously kept docs
    (a reranked-cosine hit >= ``threshold`` drops the doc), then (2)
    checked for exact-cosine duplicates *within* the batch (the index
    cannot see docs not inserted yet), and (3) its survivors are inserted
    before the next batch is scanned.

    Pass ``index`` to continue an earlier scan (e.g. deduplicating an
    hourly feed against everything already ingested); by default a fresh
    mutable index sized to ``len(embeddings)`` is made on ``device``.
    """
    params = params or BuildParams(**_DEFAULT_PARAMS)
    x = np.asarray(embeddings, dtype=np.float32)
    x = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
    if index is None:
        index = MutableQuIVerIndex.empty(x.shape[-1], len(x), params,
                                         device=device)
    if index.vectors is None:
        # without the cold tier, search scores are negative BQ distances
        # and the >= threshold test would never fire
        raise ValueError(
            "streaming_dedup needs an index with cold vectors "
            "(keep_vectors=True) — thresholds are reranked cosines"
        )
    keep: list[int] = []
    for s in range(0, len(x), scan_batch):
        batch = x[s:s + scan_batch]
        if index.n_live:
            ids, scores = index.search(batch, k=k, ef=ef)
            dup = ((ids >= 0) & (scores >= threshold)).any(axis=1)
        else:
            dup = np.zeros(len(batch), dtype=bool)
        # within the batch: exact cosine against earlier survivors
        sims = batch @ batch.T
        survivors: list[int] = []
        for i in range(len(batch)):
            if dup[i]:
                continue
            if survivors and (sims[i, survivors] >= threshold).any():
                continue
            survivors.append(i)
        if survivors:
            index.insert(batch[survivors])
            keep.extend(s + i for i in survivors)
    return np.asarray(keep, dtype=np.int64)
