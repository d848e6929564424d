"""LabelStore — per-node labels as packed bitsets on the index's device.

Counterpart of ``repro/filter/labels.py``.  One word row per node,
``W = ceil(n_labels / 32)`` words wide: bit ``b`` of word ``w`` in row
``i`` means node ``i`` carries label ``w * 32 + b``.  The words are int32
bit views of the reference's uint32 words (the archive holds uint32) and
live on the device beside the signature words; predicate evaluation is
word operations over them, accounted as hot memory in
``memory_breakdown``.

Attach modes (host-driven, scatter-applied on the device):

* **categorical** — one label id per node (``set``);
* **multi-tag**   — a sequence of label ids per node (``set`` with lists,
  or ``add`` to OR tags into existing rows).

Per-label popcounts (``counts`` / ``count_fn``) feed selectivity
estimation; ``entries`` holds the per-label entry points (the medoid of
each frequent label's member set, built by
:func:`repro_torch.filter.search.build_label_entries`).  ``compact``
remaps both through a freeze, and ``clear`` wipes reclaimed slots.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.filter.predicate import PredicateLike, eval_mask, validate

WORD_BITS = 32


def n_label_words(n_labels: int) -> int:
    return (n_labels + WORD_BITS - 1) // WORD_BITS


def pack_label_rows(labels: Sequence, n_labels: int) -> np.ndarray:
    """Per-node labels -> packed ``(B, W)`` uint32 rows (host side).

    ``labels`` is one entry per node: an int (categorical) or an iterable
    of ints (multi-tag).  Out-of-range ids raise.
    """
    w = n_label_words(n_labels)
    rows = np.zeros((len(labels), w), dtype=np.uint32)
    for i, item in enumerate(labels):
        ids = (item,) if np.isscalar(item) else tuple(item)
        for lb in ids:
            lb = int(lb)
            if not 0 <= lb < n_labels:
                raise ValueError(
                    f"label {lb} outside [0, {n_labels}) at row {i}"
                )
            rows[i, lb // WORD_BITS] |= np.uint32(1 << (lb % WORD_BITS))
    return rows


def popcount_rows(words: np.ndarray, n_labels: int) -> np.ndarray:
    """Packed ``(n, W)`` rows -> ``(n_labels,)`` per-label popcounts."""
    bits = np.unpackbits(
        np.ascontiguousarray(words).view(np.uint8), axis=-1,
        bitorder="little",
    )                                            # (n, W*32)
    return bits[:, :n_labels].sum(axis=0).astype(np.int64)


def _host(words: torch.Tensor) -> np.ndarray:
    """Device int32 words -> host uint32 words (the same bits)."""
    return words.cpu().numpy().view(np.uint32)


def _dev(rows: np.ndarray, device) -> torch.Tensor:
    """Host uint32 words -> int32 words on ``device`` (the same bits)."""
    return torch.from_numpy(
        np.ascontiguousarray(rows, dtype=np.uint32).view(np.int32)
    ).to(device)


class LabelStore:
    """Packed per-node label bitsets + per-label entry points.

    ``device=None`` means the CUDA card, as for every entry point.
    """

    def __init__(self, capacity: int, n_labels: int, device=None):
        if n_labels <= 0:
            raise ValueError(f"n_labels must be positive, got {n_labels}")
        self.capacity = int(capacity)
        self.n_labels = int(n_labels)
        self.n_words = n_label_words(n_labels)
        self.device = resolve_device(device)
        self.words = torch.zeros((self.capacity, self.n_words),
                                 dtype=torch.int32, device=self.device)
        # per-label entry points (Filtered-Vamana medoids); -1 == none
        self.entries = np.full((self.n_labels,), -1, dtype=np.int32)
        self._counts: np.ndarray | None = np.zeros(
            (self.n_labels,), dtype=np.int64
        )

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_rows(
        cls,
        labels: Sequence,
        *,
        n_labels: int | None = None,
        capacity: int | None = None,
        device=None,
    ) -> "LabelStore":
        """Build a store from one label (or label list) per node."""
        if n_labels is None:
            flat: list[int] = []
            for item in labels:
                flat.extend(
                    (int(item),) if np.isscalar(item)
                    else (int(x) for x in item)
                )
            if not flat:
                raise ValueError(
                    "cannot infer n_labels from empty labels; pass "
                    "n_labels explicitly"
                )
            n_labels = max(flat) + 1
        out = cls(capacity or len(labels), n_labels, device)
        out.set(np.arange(len(labels), dtype=np.int32), labels)
        return out

    # -- mutation ----------------------------------------------------------

    def _rows_for(self, ids: np.ndarray, labels) -> np.ndarray:
        if np.isscalar(labels):
            labels = [labels] * len(ids)
        if len(labels) != len(ids):
            raise ValueError(
                f"{len(ids)} ids but {len(labels)} label entries"
            )
        return pack_label_rows(labels, self.n_labels)

    def _count_delta(self, old: np.ndarray, new: np.ndarray) -> None:
        """Incremental popcount update from the mutated rows only."""
        if self._counts is None:
            return
        self._counts = (
            self._counts
            + popcount_rows(new, self.n_labels)
            - popcount_rows(old, self.n_labels)
        )

    @staticmethod
    def _dedup_or(ids: np.ndarray, rows: np.ndarray):
        """Collapse duplicate ids by OR-ing their rows: a scatter with
        duplicate indices keeps an arbitrary one, silently dropping
        tags."""
        uniq, inv = np.unique(ids, return_inverse=True)
        if len(uniq) == len(ids):
            return ids, rows
        combined = np.zeros((len(uniq), rows.shape[1]), dtype=np.uint32)
        np.bitwise_or.at(combined, inv, rows)
        return uniq.astype(np.int32), combined

    def _write(self, ids: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """Overwrite rows ``ids`` with ``rows``; returns the old rows."""
        dev = torch.from_numpy(ids.astype(np.int64)).to(self.device)
        old = _host(self.words[dev])
        self.words[dev] = _dev(rows, self.device)
        return old

    def set(self, ids, labels) -> None:
        """Overwrite the label rows of ``ids`` (categorical attach).

        ``labels``: one int / iterable-of-ints per id, or a single int
        applied to every id.  Duplicate ids within one batch OR their rows
        together (the batch is one logical assignment per node).
        """
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int32))
        if len(ids) == 0:
            return
        ids, rows = self._dedup_or(ids, self._rows_for(ids, labels))
        old = self._write(ids, rows)
        self._count_delta(old, rows)

    def add(self, ids, labels) -> None:
        """OR labels into the existing rows of ``ids`` (multi-tag)."""
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int32))
        if len(ids) == 0:
            return
        ids, rows = self._dedup_or(ids, self._rows_for(ids, labels))
        dev = torch.from_numpy(ids.astype(np.int64)).to(self.device)
        new = _host(self.words[dev]) | rows
        old = self._write(ids, new)
        self._count_delta(old, new)

    def clear(self, ids) -> None:
        """Zero the rows of ``ids`` (reclaimed streaming slots)."""
        ids = np.unique(np.atleast_1d(np.asarray(ids, dtype=np.int32)))
        if len(ids) == 0:
            return
        old = self._write(
            ids, np.zeros((len(ids), self.n_words), dtype=np.uint32))
        self.entries[np.isin(self.entries, ids)] = -1
        self._count_delta(old, np.zeros_like(old))

    # -- queries -----------------------------------------------------------

    @property
    def counts(self) -> np.ndarray:
        """(n_labels,) per-label popcounts (cached between mutations)."""
        if self._counts is None:
            self._counts = popcount_rows(_host(self.words), self.n_labels)
        return self._counts

    def count(self, label: int) -> int:
        return int(self.counts[label])

    def count_fn(self):
        """``label -> popcount`` callable for selectivity estimation."""
        counts = self.counts
        return lambda lb: int(counts[lb])

    def mask(self, expr: PredicateLike) -> torch.Tensor:
        """Predicate mask: ``(capacity,)`` bool on the store's device."""
        return eval_mask(self.words, validate(expr, self.n_labels))

    def member_mask(self, label: int) -> torch.Tensor:
        return self.mask(label)

    def labels_of(self, node: int) -> list[int]:
        """The label ids carried by ``node`` (host-side, for debugging)."""
        row = _host(self.words[node:node + 1])
        bits = np.unpackbits(
            row.view(np.uint8), axis=-1, bitorder="little"
        )[0, : self.n_labels]
        return np.nonzero(bits)[0].tolist()

    def memory_bytes(self) -> int:
        return int(self.words.numel() * 4 + self.entries.size * 4)

    # -- lifecycle ---------------------------------------------------------

    def padded_to(self, capacity: int) -> "LabelStore":
        """A copy grown to ``capacity`` rows (mutable-index adoption)."""
        if capacity < self.capacity:
            raise ValueError(
                f"capacity {capacity} < store size {self.capacity}"
            )
        out = LabelStore(capacity, self.n_labels, self.device)
        out.words[: self.capacity] = self.words
        out.entries = self.entries.copy()
        out._counts = None
        return out

    def compact(self, live_idx: np.ndarray) -> "LabelStore":
        """Select rows ``live_idx`` and remap entries (freeze path)."""
        live_idx = np.asarray(live_idx)
        out = LabelStore(len(live_idx), self.n_labels, self.device)
        out.words = self.words[
            torch.from_numpy(live_idx.astype(np.int64)).to(self.device)]
        remap = np.full((self.capacity,), -1, dtype=np.int32)
        remap[live_idx] = np.arange(len(live_idx), dtype=np.int32)
        ent = self.entries.copy()
        ok = ent >= 0
        ent[ok] = remap[ent[ok]]
        out.entries = ent
        out._counts = None
        return out

    # -- persistence -------------------------------------------------------

    def to_npz_fields(self) -> dict:
        """Named npz fields (merged into the index archive)."""
        return {
            "label_words": _host(self.words),
            "label_n": np.int64(self.n_labels),
            "label_entries": self.entries,
        }

    @classmethod
    def from_npz(cls, z, device=None) -> "LabelStore | None":
        """Rebuild from an index archive; None when it has no labels."""
        if "label_words" not in z:
            return None
        words = np.asarray(z["label_words"])
        out = cls(words.shape[0], int(z["label_n"]), device)
        out.words = _dev(words, out.device)
        out.entries = np.array(z["label_entries"], dtype=np.int32)
        out._counts = None
        return out


def iter_label_lists(labels: Sequence) -> Iterable[tuple[int, ...]]:
    """Normalize a per-node label column to tuples (test/bench helper)."""
    for item in labels:
        yield (int(item),) if np.isscalar(item) else tuple(
            int(x) for x in item
        )
