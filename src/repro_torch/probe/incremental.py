"""Incremental probe statistics for the streaming lifecycle.

Counterpart of ``repro/probe/incremental.py`` (numpy on the host).  The
port's streaming index is not ported yet, so the accumulator has no
caller inside the package; it is held to the reference on its own.

A :class:`ProbeAccumulator` maintains the *exact* per-dimension bit-plane
counts of the live set under insert/delete — O(B·D) work per mutation
batch, never a full-store rescan — so a mutable index always knows its
sign/magnitude entropy without re-probing.  The counts are computed from
the packed signature words themselves (the planes ARE the statistics),
which means the accumulator works on vector-free indexes too and a
from-scratch recompute over the live rows reproduces it exactly:

    acc == ProbeAccumulator.from_words(words[live], dim)

Consolidation is a no-op for the accumulator: deletes already removed
the dead rows' counts, and reclaiming slots only clears storage the
accumulator never counted.

The expensive sampled statistics (cosine spread, BQ agreement) are NOT
maintained incrementally — they are recomputed on demand from a live
sample (the reference's ``MutableQuIVerIndex.probe_report``), with the
entropy fields taken from this accumulator (exact over the whole live
set, not a sample).
"""

from __future__ import annotations

import numpy as np

import torch

from repro_torch.core import bq
from repro_torch.probe.diagnostics import (
    entropy_from_counts,
    report_from_accumulator,
)


def _host_words(words) -> np.ndarray:
    """Packed words as a host uint32 array: a tensor's int32 bit views or
    the reference's uint32 words alike."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy()
    words = np.ascontiguousarray(words)
    return words.view(np.uint32) if words.dtype == np.int32 \
        else words.astype(np.uint32)


def _plane_bits(words, dim: int) -> tuple[np.ndarray, np.ndarray]:
    """(B, 2W) packed words -> ((B, D) pos bits, (B, D) strong bits)."""
    words = _host_words(words)
    w = words.shape[-1] // 2
    bits = np.unpackbits(
        words.view(np.uint8).reshape(len(words), -1),
        axis=-1, bitorder="little",
    )
    return bits[:, : dim], bits[:, 32 * w: 32 * w + dim]


class ProbeAccumulator:
    """Exact live-set bit-plane counts under insert/delete churn."""

    def __init__(self, dim: int):
        self.dim = int(dim)
        self.n = 0
        self.pos_counts = np.zeros((dim,), dtype=np.int64)
        self.strong_counts = np.zeros((dim,), dtype=np.int64)

    @classmethod
    def from_words(cls, words, dim: int) -> "ProbeAccumulator":
        """From-scratch recompute over a row set (the consistency oracle
        the incremental path is tested against)."""
        out = cls(dim)
        words = _host_words(words)
        if len(words):
            out.add(words)
        return out

    @classmethod
    def from_signature(cls, sig: bq.Signature) -> "ProbeAccumulator":
        return cls.from_words(sig.words, sig.dim)

    # -- mutation ----------------------------------------------------------

    def add(self, words) -> None:
        """Count a batch of inserted rows' packed words."""
        pos, strong = _plane_bits(words, self.dim)
        self.n += len(pos)
        self.pos_counts += pos.sum(axis=0, dtype=np.int64)
        self.strong_counts += strong.sum(axis=0, dtype=np.int64)

    def remove(self, words) -> None:
        """Un-count a batch of deleted rows' packed words."""
        pos, strong = _plane_bits(words, self.dim)
        self.n -= len(pos)
        self.pos_counts -= pos.sum(axis=0, dtype=np.int64)
        self.strong_counts -= strong.sum(axis=0, dtype=np.int64)
        if self.n < 0:
            raise ValueError("removed more rows than were added")

    # -- statistics --------------------------------------------------------

    @property
    def sign_balance(self) -> np.ndarray:
        """(D,) fraction of positive signs per dimension."""
        return self.pos_counts / max(self.n, 1)

    @property
    def sign_entropy(self) -> float:
        return entropy_from_counts(self.pos_counts, self.n)

    @property
    def strong_entropy(self) -> float:
        return entropy_from_counts(self.strong_counts, self.n)

    def report(self, *, k: int = 10, thresholds=None):
        """Signature-statistics :class:`CompatibilityReport` from the
        exact live counts — the remediation ladder's cheapest re-probe
        (see :func:`repro_torch.probe.diagnostics.report_from_accumulator`)."""
        if thresholds is None:
            return report_from_accumulator(self, k=k)
        return report_from_accumulator(self, k=k, thresholds=thresholds)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, ProbeAccumulator)
            and self.dim == other.dim
            and self.n == other.n
            and np.array_equal(self.pos_counts, other.pos_counts)
            and np.array_equal(self.strong_counts, other.strong_counts)
        )

    def __repr__(self) -> str:
        return (
            f"ProbeAccumulator(n={self.n}, dim={self.dim}, "
            f"sign_entropy={self.sign_entropy:.3f}, "
            f"strong_entropy={self.strong_entropy:.3f})"
        )
