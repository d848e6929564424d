"""The metric layer: registry-driven metric spaces for the whole index.

Counterpart of ``repro/core/metric.py``.  Backends are registered by name
and built from a shared :class:`MetricArrays` bundle::

    backend = make_backend("bq2", MetricArrays(sigs=sigs))

* ``bq2``     — the paper: symmetric 2-bit Sign-Magnitude distance,
  calibrated non-negative as ``d = 4D - similarity`` (the alpha-criterion
  of Algorithm 1 needs d >= 0; see the reference module).
* ``bq1``     — 1-bit SimHash Hamming over the sign plane (the §2.1/§5
  ablation); ``neutral_dist = D/2``.
* ``adc``     — asymmetric navigation: a float32 query against the decoded
  +-1/+-2 levels, offset by ``2*sqrt(D)`` (computed in float32, as the
  reference does); a node's own representation is its unit-normalized
  levels, so ADC-built graphs work too.
* ``float32`` — exact cosine distance ``1 - cos`` over the unit cold
  vectors (the full-precision reference build); ``neutral_dist = 1``.

Every bq2 and bq1 distance goes through ``repro_torch.kernels.dispatch``,
whose primitives follow the device of the signature table.  The adc and
float32 products are plain ``torch.bmm`` calls, as the reference computes
them outside any Pallas kernel.  The reference's ``dist_fn`` (one query)
and ``dist_many`` (a batch) are one batched method here,
:meth:`dist_many`, because the port's beam search is batched; neither takes
the reference's unused ``valid`` argument.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol

import numpy as np
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
    device: torch.device  # where the backend's arrays live
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


def encode_queries_for(kind: str, x: torch.Tensor) -> torch.Tensor:
    """Instance-free query encoding for ``kind``."""
    return resolve(kind).encode(x)


def normalize(x: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit L2 norm (a zero row stays zero)."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / norm.clamp_min(1e-12)


@register("bq2")
class BQ2Backend:
    """Symmetric 2-bit Sign-Magnitude metric space (the paper's hot path)."""

    def __init__(self, sigs: bq.Signature):
        self.sigs = sigs
        self.n = sigs.words.shape[0]
        self.device = sigs.words.device
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


@register("bq1")
class BQ1Backend:
    """1-bit SimHash Hamming metric space (ablation baseline).  The query
    representation is the sign plane, ``(B, W)`` words."""

    def __init__(self, sigs: bq.Signature):
        self.sigs = sigs
        self.n = sigs.words.shape[0]
        self.device = sigs.words.device
        self.dim = sigs.dim
        self._ops = dispatch.bq1_ops(sigs.dim, sigs.words.device)
        # expected Hamming distance of independent sign planes
        self.neutral_dist = float(sigs.dim) / 2.0

    @classmethod
    def from_arrays(cls, arrays: MetricArrays):
        if arrays.sigs is None:
            raise ValueError("bq1 needs packed signatures")
        return cls(arrays.sigs)

    @classmethod
    def encode(cls, x: torch.Tensor) -> torch.Tensor:
        sig = bq.encode(x)
        return sig.pos.contiguous()

    def query_repr(self, ids):
        return self.sigs.pos[ids]

    def encode_queries(self, x):
        return self.encode(x)

    def dist_many(self, queries, ids):
        sim = self._ops.dist_rows(queries, ids, self.sigs.words)
        return -sim.to(torch.float32)          # sim is negated Hamming

    def pairwise(self, ids):
        return -self._ops.pairwise(ids, self.sigs.words).to(torch.float32)


@register("float32")
class Float32Backend:
    """Exact cosine metric space (full-precision reference build)."""

    def __init__(self, vectors: torch.Tensor):
        self.vectors = normalize(vectors)
        self.n = vectors.shape[0]
        self.device = vectors.device
        self.dim = vectors.shape[-1]
        self.neutral_dist = 1.0          # cos 0 -> distance 1

    @classmethod
    def from_arrays(cls, arrays: MetricArrays):
        if arrays.vectors is None:
            raise ValueError("float32 needs cold vectors")
        return cls(arrays.vectors)

    @classmethod
    def encode(cls, x: torch.Tensor) -> torch.Tensor:
        return normalize(x)

    def query_repr(self, ids):
        return self.vectors[ids.long()]

    def encode_queries(self, x):
        return self.encode(x)

    def dist_many(self, queries, ids):
        rows = self.vectors[ids.long()]                      # (B, K, D)
        return 1.0 - torch.bmm(rows, queries[:, :, None])[..., 0]

    def pairwise(self, ids):
        rows = self.vectors[ids.long()]                      # (B, C, D)
        return 1.0 - torch.bmm(rows, rows.transpose(1, 2))


@register("adc")
class ADCBackend:
    """Asymmetric navigation: float32 query vs decoded 2-bit signatures.

    A node's own query representation is its unit-normalized decoded
    levels, and ``pairwise`` is the decoded-levels inner product with the
    same calibration, so ADC-built graphs work, not just ADC traversal of
    a symmetric-built graph.
    """

    def __init__(self, sigs: bq.Signature):
        self.sigs = sigs
        self.n = sigs.words.shape[0]
        self.device = sigs.words.device
        self.dim = sigs.dim
        # |<q, levels>| <= ||levels|| <= 2*sqrt(D) for unit q; float32, as
        # the reference computes 2.0 * jnp.sqrt(jnp.float32(D))
        self._offset = float(np.float32(2) * np.sqrt(np.float32(sigs.dim)))
        self.neutral_dist = self._offset   # zero inner product

    @classmethod
    def from_arrays(cls, arrays: MetricArrays):
        if arrays.sigs is None:
            raise ValueError("adc needs packed signatures")
        return cls(arrays.sigs)

    @classmethod
    def encode(cls, x: torch.Tensor) -> torch.Tensor:
        return normalize(x)

    def _levels(self, ids):
        rows = bq.Signature(words=self.sigs.words[ids.long()], dim=self.dim)
        return bq.decode_levels(rows)                # (..., K, D)

    def query_repr(self, ids):
        return normalize(self._levels(ids))

    def encode_queries(self, x):
        return self.encode(x)

    def dist_many(self, queries, ids):
        levels = self._levels(ids)                   # (B, K, D)
        return self._offset - torch.bmm(levels, queries[:, :, None])[..., 0]

    def pairwise(self, ids):
        levels = self._levels(ids)                   # (B, C, D)
        sims = torch.bmm(normalize(levels), levels.transpose(1, 2))
        return self._offset - sims
