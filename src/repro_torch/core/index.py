"""QuIVerIndex — the paper's pipeline (Fig. 1) as the port's public API.

Counterpart of ``repro/core/index.py``::

    float32 vectors --binarize--> 2-bit SM signatures        (hot)
                                   |
                         bq2 Vamana build                    (hot)
                                   |
    query --encode--> symmetric bq2 beam search              (hot)
                                   | top-ef candidates
                      float32 cosine rerank                  (cold)

The reference lowers ``search`` through compiled query plans
(``repro.plan``); for an index with no probe policy and no filter that
plan is beam search, then :func:`rerank`, and for ``nav="ivf"`` it is the
IVF list scan (``repro_torch.ivf.scan_search``), then :func:`rerank`:
that is what ``search`` runs here.  Other navigation families, filters,
adaptive escalation and the plan cache wait for their parts of the port
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bq
from repro_torch.core.beam import beam_search
from repro_torch.core.metric import MetricArrays, MetricSpace, make_backend
from repro_torch.core.vamana import BuildParams, BuildStats, build_graph
from repro_torch.device import resolve_device
from repro_torch.ivf import IVFPartition, build_partition, scan_search
from repro_torch.kernels import dispatch


def as_float32(x, device) -> torch.Tensor:
    """A tensor or array-like as a float32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x), dtype=torch.float32, device=device)


def normalize(x: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / norm.clamp_min(1e-12)


@dataclasses.dataclass
class QuIVerIndex:
    """A built index. ``vectors`` is the cold path; everything else hot."""

    sigs: bq.Signature               # (N, 2W) int32 words — hot
    adjacency: torch.Tensor          # (N, R+slack) int32 — hot
    medoid: int
    params: BuildParams
    vectors: torch.Tensor | None     # (N, D) float32, L2-normalized — cold
    rotation: torch.Tensor | None = None
    build_stats: BuildStats | None = None
    metric_kind: str = "bq2"
    # the coarse partition, present when built with ``ivf_candidates`` or
    # attached by ``build_ivf``; enables ``nav="ivf"``
    ivf: IVFPartition | None = None
    _backends: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )

    @property
    def device(self) -> torch.device:
        return self.adjacency.device

    def backend(self, kind: str | None = None) -> MetricSpace:
        """The metric backend for ``kind`` (default: the index's own)."""
        kind = kind or self.metric_kind
        if kind not in self._backends:
            self._backends[kind] = make_backend(
                kind, MetricArrays(sigs=self.sigs, vectors=self.vectors)
            )
        return self._backends[kind]

    # -- construction ------------------------------------------------------

    @classmethod
    def build(
        cls,
        vectors,
        params: BuildParams | None = None,
        *,
        metric: str = "bq2",
        rotation=None,
        keep_vectors: bool = True,
        verbose: bool = False,
        device=None,
    ) -> "QuIVerIndex":
        """Build the index from (N, D) float32 ``vectors`` in ``metric``
        space (only ``"bq2"`` so far).  ``rotation`` (optional, (D, D)) is
        applied before encoding, as the reference's ``rotate_seed`` does
        with its own random rotation; pass that matrix for parity.
        ``device=None`` means the CUDA card."""
        if metric != "bq2":
            raise NotImplementedError(
                f"metric={metric!r}: only bq2 is ported so far")
        params = params or BuildParams()
        if params.prune_pool > params.ef_construction:
            raise ValueError("prune_pool must not exceed ef_construction")
        device = resolve_device(device)
        vectors = normalize(as_float32(vectors, device))
        encoded = vectors
        if rotation is not None:
            rotation = as_float32(rotation, device)
            encoded = vectors @ rotation
        sigs = bq.encode(encoded)
        ivf = None
        if params.ivf_candidates:
            ivf = build_partition(sigs, n_lists=params.ivf_lists or None,
                                  seed=params.seed)
        backend = make_backend(metric, MetricArrays(sigs=sigs,
                                                    vectors=vectors))
        adj, medoid, stats = build_graph(backend, params, ivf=ivf,
                                         verbose=verbose)
        index = cls(
            sigs=sigs,
            adjacency=adj,
            medoid=medoid,
            params=params,
            vectors=vectors if keep_vectors else None,
            rotation=rotation,
            build_stats=stats,
            metric_kind=metric,
            ivf=ivf,
        )
        index._backends[metric] = backend
        return index

    def build_ivf(self, *, n_lists: int | None = None,
                  seed: int | None = None) -> IVFPartition:
        """Attach a coarse partition to a built index (enables
        ``nav="ivf"``); deterministic under the build seed unless ``seed``
        overrides it."""
        self.ivf = build_partition(
            self.sigs, n_lists=n_lists,
            seed=self.params.seed if seed is None else seed,
        )
        return self.ivf

    # -- search ------------------------------------------------------------

    def search(
        self,
        queries,
        k: int = 10,
        *,
        ef: int = 64,
        rerank: bool = True,
        nav: str | None = None,
        expand: int = 1,
        query_batch: int = 256,
        filter=None,
        adaptive: bool | None = None,
        probes: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """(Q, D) float32 queries -> ((Q, k) ids, (Q, k) scores).

        With ``rerank=True`` (and cold vectors present) scores are float32
        cosine similarity; otherwise they are negated navigation
        distances (``sim - 4D`` for bq2), as in the reference.

        ``nav="ivf"`` scans the centroid signatures, gathers the members
        of the ``probes`` nearest lists (default: the partition's
        ``default_probes``), keeps the best ``ef`` in bq2 space and
        reranks: no graph traversal.
        """
        ivf = nav == "ivf"
        if ivf and self.ivf is None:
            raise ValueError(
                "nav='ivf' needs a coarse partition: build with "
                "BuildParams(ivf_candidates=True) or call build_ivf()"
            )
        if not ivf and nav not in (None, self.metric_kind):
            raise NotImplementedError(f"nav={nav!r} is not ported yet")
        if filter is not None:
            raise NotImplementedError("filtered search is not ported yet")
        if adaptive:
            raise NotImplementedError("adaptive escalation is not ported yet")
        if probes is not None and not ivf:
            # the reference reads probes without nav="ivf" only from an
            # ivf navigation policy, which is not ported
            raise NotImplementedError("probes without nav='ivf' (a navigation "
                                      "policy) is not ported yet")
        if k > ef:
            raise ValueError(f"k={k} exceeds ef={ef}")
        backend = self.backend()
        queries = normalize(as_float32(queries, self.device))
        if queries.ndim == 1:
            queries = queries[None]
        enc_in = queries if self.rotation is None else queries @ self.rotation
        reprs = backend.encode_queries(enc_in)
        vectors = self.vectors if rerank else None
        n = self.sigs.words.shape[0]
        if ivf:
            p_eff = ivf_probes(self.ivf, k, probes)
            scan = dispatch.list_scan_ops(self.sigs.dim, self.device).scan
        out_ids, out_scores = [], []
        for s in range(0, queries.shape[0], query_batch):
            if ivf:
                cand_ids, cand_dists = scan_search(
                    backend, scan, reprs[s:s + query_batch],
                    self.ivf.cent_words, self.ivf.list_ids,
                    probes=p_eff, ef=ef,
                )
            else:
                res = beam_search(
                    reprs[s:s + query_batch], self.adjacency, self.medoid,
                    dist_fn=backend.dist_many, ef=ef, n=n, expand=expand,
                )
                cand_ids, cand_dists = res.ids, res.dists
            ids, scores = _rerank(cand_ids, cand_dists,
                                  queries[s:s + query_batch], vectors, k)
            out_ids.append(ids.cpu().numpy())
            out_scores.append(scores.cpu().numpy())
        return np.concatenate(out_ids), np.concatenate(out_scores)

    # -- accounting (paper Table 2) -----------------------------------------

    def memory_breakdown(self) -> dict:
        n = self.sigs.words.shape[0]
        sig_bytes = self.sigs.words.numel() * 4
        adj_bytes = self.adjacency.numel() * 4 + n * 4  # + degree counters
        # the IVF tier rides the hot path: every ivf search gathers from it
        ivf_bytes = self.ivf.memory_bytes() if self.ivf is not None else 0
        cold = self.vectors.numel() * 4 if self.vectors is not None else 0
        hot = sig_bytes + adj_bytes + ivf_bytes
        return {
            "hot_signature_bytes": int(sig_bytes),
            "hot_adjacency_bytes": int(adj_bytes),
            "hot_label_bytes": 0,
            "hot_ivf_bytes": int(ivf_bytes),
            "hot_total_bytes": int(hot),
            "cold_vector_bytes": int(cold),
            "host_shadow_bytes": 0,
            "total_bytes": int(hot + cold),
        }

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        """Write the reference's npz archive (words as uint32)."""
        from repro_torch.convert import index_to_numpy
        np.savez_compressed(path, **index_to_numpy(self))

    @classmethod
    def load(cls, path: str, device=None) -> "QuIVerIndex":
        """Read an npz archive written by either package."""
        from repro_torch.convert import index_from_numpy
        with np.load(path) as z:
            return index_from_numpy(dict(z), device)


def ivf_probes(part: IVFPartition, k: int, probes: int | None) -> int:
    """Lists a ``nav="ivf"`` search probes: ``probes`` (default: the
    partition's ``default_probes``) clamped to the partition, but never
    below the fan-in that can fill k.  The reference resolves this in its
    planner and clamps again in its plan cache; the clamp is idempotent."""
    probes = probes or part.default_probes
    return max(min(probes, part.n_lists),
               min(part.n_lists, -(-k // part.cap)))


def rerank_f32(beam_ids, queries, vectors, k):
    """Cold-path rerank: exact cosine over the ef candidates (§3.3).

    Candidates with id < 0 score -inf and surface only as trailing -1
    ids.  Ties go to the earlier beam slot, as ``lax.top_k`` gives them.
    """
    cand = vectors[beam_ids.clamp_min(0).long()]              # (Q, ef, D)
    sims = torch.bmm(cand, queries[:, :, None])[:, :, 0]
    sims = torch.where(beam_ids >= 0, sims,
                       torch.full_like(sims, -float("inf")))
    scores, pos = torch.sort(sims, dim=1, descending=True, stable=True)
    scores, pos = scores[:, :k], pos[:, :k]
    ids = beam_ids.gather(1, pos)
    return torch.where(torch.isfinite(scores), ids, -1), scores


def topk_by_dist(beam_ids, beam_dists, k):
    """Hot-path-only top-k: scores are **negated navigation distances**."""
    scores, pos = torch.sort(-beam_dists, dim=1, descending=True,
                             stable=True)
    return beam_ids.gather(1, pos[:, :k]), scores[:, :k]


def rerank(beam_ids, beam_dists, queries, vectors, k):
    """The score-convention boundary (the reference's ``rerank``): cosine
    scores with cold ``vectors``, negated navigation distances without."""
    if vectors is None:
        return topk_by_dist(beam_ids, beam_dists, k)
    return rerank_f32(beam_ids, queries, vectors, k)


# QuIVerIndex.search takes a ``rerank`` flag, which shadows the function
_rerank = rerank
