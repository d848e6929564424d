"""Kernel dispatch: one owner for every BQ distance evaluation.

Counterpart of ``repro/kernels/dispatch.py``.  The metric backend in
``repro_torch.core.metric`` binds its primitives here once, at
construction.  There is no route switch and no fallback: each primitive
follows the device of the signature table it is given — CUDA tensors
launch the hand-written kernels of ``repro_torch.kernels.bq_distance``,
CPU tensors take their plain versions.

Both metric primitives are gather-fused (they take row ids into the
``(N, 2W)`` table) and return **int32 similarities** (Table-1 weighted sums
for bq2, negated Hamming for bq1); the backend applies its own
non-negative distance calibration on top:

* ``dist_rows(q (B, 2W), ids (B, K), table)`` -> ``(B, K)``
  (bq1: ``q (B, W)``, the query's sign plane)
* ``pairwise(ids (B, C), table)``            -> ``(B, C, C)``

:func:`bq2_ops` binds ``repro_torch.kernels.bq_distance``, :func:`bq1_ops`
``repro_torch.kernels.hamming``.

The IVF layer's coarse routing has its own primitive, bound by
:func:`list_scan_ops` to ``repro_torch.kernels.list_scan``:

* ``scan(q (Q, 2W), cent_words (L, 2W))``    -> ``(Q, L)``
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import bq
from repro_torch.kernels import bq_distance, hamming, list_scan


class MetricOps(NamedTuple):
    """Distance primitives bound to one signature dimensionality."""

    dist_rows: Callable  # (B, 2W | W) x (B, K) ids -> (B, K) int32 sim
    pairwise: Callable   # (B, C) ids -> (B, C, C) int32 sim


class ListScanOps(NamedTuple):
    """IVF coarse-routing primitive bound to one signature dimensionality."""

    scan: Callable       # (Q, 2W) x (L, 2W) -> (Q, L) int32 sim


def bq2_ops(dim: int, device: torch.device | str) -> MetricOps:
    """Bind the symmetric 2-bit SM similarity primitives for ``dim``."""
    mask = bq.valid_mask(dim, device=device)
    return MetricOps(
        dist_rows=lambda q, ids, table: bq_distance.dist_rows(
            q, ids, table, mask),
        pairwise=lambda ids, table: bq_distance.pairwise(ids, table, mask),
    )


def list_scan_ops(dim: int, device: torch.device | str) -> ListScanOps:
    """Bind the centroid scan for ``dim``: a top-p over its (Q, L) result
    is the IVF layer's list routing decision."""
    mask = bq.valid_mask(dim, device=device)
    return ListScanOps(
        scan=lambda q, cent_words: list_scan.scan(q, cent_words, mask),
    )


def bq1_ops(dim: int, device: torch.device | str) -> MetricOps:
    """Bind the 1-bit Hamming primitives for ``dim``, as negated-distance
    similarities.  The pool decodes the sign plane under the valid-bit
    mask; the gather needs none."""
    mask = bq.valid_mask(dim, device=device)
    return MetricOps(
        dist_rows=lambda q, ids, table: -hamming.dist_rows(q, ids, table),
        pairwise=lambda ids, table: -hamming.pairwise(ids, table, mask),
    )
