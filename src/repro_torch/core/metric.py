"""The metric layer: registry-driven metric spaces for the whole index.

Counterpart of ``repro/core/metric.py``.  Backends are registered by name
and built from a shared :class:`MetricArrays` bundle::

    backend = make_backend("bq2", MetricArrays(sigs=sigs))

* ``bq2`` — the paper: symmetric 2-bit Sign-Magnitude distance,
  calibrated non-negative as ``d = 4D - similarity`` (the alpha-criterion
  of Algorithm 1 needs d >= 0; see the reference module).

Every bq2 distance goes through ``repro_torch.kernels.dispatch``, whose
primitives follow the device of the signature table.  The reference's
``dist_fn`` (one query) and ``dist_many`` (a batch) are one batched
method here, :meth:`BQ2Backend.dist_many`, because the port's beam search
is batched; neither takes the reference's unused ``valid`` argument.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol

import torch

from repro_torch.core import bq
from repro_torch.kernels import dispatch


@dataclasses.dataclass(frozen=True)
class MetricArrays:
    """Shared tensor bundle every backend is constructed from."""

    sigs: bq.Signature | None = None
    vectors: torch.Tensor | None = None


class MetricSpace(Protocol):
    """What construction and search require of a metric space."""

    kind: str
    n: int
    neutral_dist: float   # zero-similarity distance (beam_margin scale)

    def query_repr(self, ids: torch.Tensor) -> torch.Tensor:
        """Representation handed to beam search for these node ids."""

    def encode_queries(self, x: torch.Tensor) -> torch.Tensor:
        """External float32 queries (Q, D) -> beam-search representation."""

    def dist_many(self, queries, ids) -> torch.Tensor:
        """(B, K) float32 distances from query b to nodes ids[b]; >= 0."""

    def pairwise(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, C) ids -> (B, C, C) float32 pairwise distances; >= 0."""


_REGISTRY: dict[str, type] = {}


def register(name: str):
    """Class decorator: register a backend under ``name``."""

    def deco(cls):
        cls.kind = name
        _REGISTRY[name] = cls
        return cls

    return deco


def registered_kinds() -> list[str]:
    return sorted(_REGISTRY)


def resolve(kind: str) -> type:
    try:
        return _REGISTRY[kind]
    except KeyError:
        raise ValueError(
            f"unknown metric kind {kind!r}; registered: {registered_kinds()}"
        ) from None


def make_backend(kind: str, arrays: MetricArrays) -> MetricSpace:
    """Construct the registered backend ``kind`` from ``arrays``."""
    return resolve(kind).from_arrays(arrays)


@register("bq2")
class BQ2Backend:
    """Symmetric 2-bit Sign-Magnitude metric space (the paper's hot path)."""

    def __init__(self, sigs: bq.Signature):
        self.sigs = sigs
        self.n = sigs.words.shape[0]
        self.dim = sigs.dim
        self._ops = dispatch.bq2_ops(sigs.dim, sigs.words.device)
        self._offset = float(4 * sigs.dim)
        # an orthogonal pair scores similarity ~0 -> distance ~offset
        self.neutral_dist = float(4 * sigs.dim)

    @classmethod
    def from_arrays(cls, arrays: MetricArrays):
        if arrays.sigs is None:
            raise ValueError("bq2 needs packed signatures")
        return cls(arrays.sigs)

    @classmethod
    def encode(cls, x: torch.Tensor) -> torch.Tensor:
        return bq.encode(x).words

    def query_repr(self, ids):
        return self.sigs.words[ids]

    def encode_queries(self, x):
        return self.encode(x)

    def dist_many(self, queries, ids):
        sim = self._ops.dist_rows(queries, ids, self.sigs.words)
        return self._offset - sim.to(torch.float32)

    def pairwise(self, ids):
        sim = self._ops.pairwise(ids, self.sigs.words)
        return self._offset - sim.to(torch.float32)
