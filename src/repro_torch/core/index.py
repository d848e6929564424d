"""QuIVerIndex — the paper's pipeline (Fig. 1) as the port's public API.

Counterpart of ``repro/core/index.py``::

    float32 vectors --binarize--> 2-bit SM signatures        (hot)
                                   |
                         BQ-native Vamana build              (hot)
                                   |
    query --encode--> symmetric bq2 beam search              (hot)
                                   | top-ef candidates
                      float32 cosine rerank                  (cold)

The graph is built in any registered metric space (bq2, bq1, adc,
float32), or in the one the applicability probe picks
(``build(nav="auto")``, ``repro_torch.probe``), and searched in any of them
(``search(nav=...)``), or through the IVF list scan (``nav="ivf"``).

The reference lowers ``search`` through compiled query plans
(``repro.plan``).  For an unfiltered search a plan is: the policy's
schedule (``resolve_schedule``), beam search (or the IVF list scan), then
:func:`rerank`, with :func:`beam_margin` at the nav backend's
``neutral_dist``; an adaptive plan re-runs the tight-margin queries at
``ef * escalate_mult`` (and ``probes * escalate_mult`` on the ivf route).
That is what ``search`` runs here, through
:func:`~repro_torch.core.beam.escalated_search`, without plans.  Filters,
``replan`` and the plan cache wait for their parts of the port; ``filter``
raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bq
from repro_torch.core.beam import beam_margin, beam_search, escalated_search
from repro_torch.core.metric import (
    MetricArrays,
    MetricSpace,
    make_backend,
    normalize,
    registered_kinds,
)
from repro_torch.core.vamana import BuildParams, BuildStats, build_graph
from repro_torch.device import resolve_device
from repro_torch.ivf import IVFPartition, build_partition, scan_search
from repro_torch.kernels import dispatch
from repro_torch.probe import (
    CompatibilityReport,
    NavPolicy,
    probe_corpus,
    resolve_schedule,
    select_policy,
)


def as_float32(x, device) -> torch.Tensor:
    """A tensor or array-like as a float32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x), dtype=torch.float32, device=device)


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
    # the probe report and nav policy chosen by ``build(nav="auto")`` (or
    # the manual ivf policy of ``build(nav="ivf")``); both persist through
    # save/load, and the policy drives ``search`` defaults
    policy: NavPolicy | None = None
    report: CompatibilityReport | None = None
    # the coarse partition, present when built with ``ivf_candidates`` or
    # attached by ``build_ivf``; enables ``nav="ivf"``
    ivf: IVFPartition | None = None
    # one backend per nav kind, built on first use
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
        nav: str | None = None,
        probe_sample: int = 1024,
        probe_seed: int = 0,
        rotation=None,
        keep_vectors: bool = True,
        verbose: bool = False,
        device=None,
    ) -> "QuIVerIndex":
        """Build the index from (N, D) float32 ``vectors``; ``metric``
        (alias ``nav``) picks the space: a registered kind, ``"ivf"`` (a
        bq2 graph plus a partition, served by the list scan) or ``"auto"``.

        ``"auto"`` runs the applicability probe (``repro_torch.probe``) on
        a ``probe_sample``-row slice of the encoded vectors and takes the
        rung the verdict selects: green -> bq2 (ivf with a partition and
        clustered data), amber -> bq2 with a doubled beam and adaptive
        escalation, red -> float32 (adc without cold vectors).  The
        :class:`NavPolicy` and :class:`CompatibilityReport` ride the index
        through save/load and drive ``search`` defaults.

        ``rotation`` (optional, (D, D)) is applied before encoding, as the
        reference's ``rotate_seed`` does with its own random rotation;
        pass that matrix for parity.  ``device=None`` means the CUDA card.
        """
        if nav is not None:
            metric = nav
        if metric not in (*registered_kinds(), "ivf", "auto"):
            raise ValueError(f"unknown metric {metric!r}; expected one of "
                             f"{registered_kinds()}, 'ivf' or 'auto'")
        params = params or BuildParams()
        if params.prune_pool > params.ef_construction:
            raise ValueError("prune_pool must not exceed ef_construction")
        device = resolve_device(device)
        vectors = normalize(as_float32(vectors, device))
        encoded = vectors
        if rotation is not None:
            rotation = as_float32(rotation, device)
            encoded = vectors @ rotation
        policy = report = None
        if metric == "auto":
            # probe the encoding the index will serve: the bit-plane
            # statistics and the BQ agreement belong to the (possibly
            # rotated) signatures
            report = probe_corpus(encoded, sample=probe_sample,
                                  seed=probe_seed, device=device)
            policy = select_policy(report, have_vectors=keep_vectors,
                                   have_ivf=params.ivf_candidates)
            metric = policy.nav
            if verbose:
                print(f"[probe] {report.summary()} -> {policy.describe()}")
        if metric == "ivf":
            # a nav family over a bq2 graph and a partition, not a build
            # metric; the policy carries the default
            if policy is None:
                policy = NavPolicy(nav="ivf", source="manual")
            metric = "bq2"
        sigs = bq.encode(encoded)
        ivf = None
        if params.ivf_candidates or (policy is not None
                                     and policy.nav == "ivf"):
            ivf = build_partition(sigs, n_lists=params.ivf_lists or None,
                                  seed=params.seed)
        backend = make_backend(metric, MetricArrays(sigs=sigs,
                                                    vectors=vectors))
        adj, medoid, stats = build_graph(backend, params, ivf=ivf,
                                         verbose=verbose)
        return cls(
            sigs=sigs,
            adjacency=adj,
            medoid=medoid,
            params=params,
            vectors=vectors if keep_vectors else None,
            rotation=rotation,
            build_stats=stats,
            metric_kind=metric,
            policy=policy,
            report=report,
            ivf=ivf,
        )

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
        distances on the nav backend's own scale (``sim - 4D`` for bq2),
        as in the reference.

        ``nav`` defaults to the index's policy, else its build metric; any
        registered kind navigates the same graph (queries are rotated for
        the signature kinds, never for float32).  ``nav="ivf"`` scans the
        centroid signatures, gathers the members of the ``probes`` nearest
        lists (default: the partition's ``default_probes``), keeps the
        best ``ef`` in bq2 space and reranks: no graph traversal.
        ``probes`` is read only on that route.

        With ``nav`` left at its default, the policy's schedule applies:
        ``ef`` is multiplied by ``policy.ef_scale`` and ``adaptive``
        defaults to the policy's.  ``adaptive=True`` re-runs the queries
        whose top-k margin (:func:`beam_margin`) is below the schedule's
        ``escalate_margin`` at ``ef * escalate_mult`` (and, on the ivf
        route, ``probes * escalate_mult``).
        """
        if filter is not None:
            raise NotImplementedError("filtered search is not ported yet")
        ef, adaptive, sched = resolve_schedule(self.policy, nav, ef,
                                               adaptive)
        kind = nav or (self.policy.nav if self.policy is not None
                       else self.metric_kind)
        ivf = kind == "ivf"
        if ivf and self.ivf is None:
            raise ValueError(
                "nav='ivf' needs a coarse partition: build with "
                "BuildParams(ivf_candidates=True) or call build_ivf()"
            )
        if k > ef:
            raise ValueError(f"k={k} exceeds ef={ef}")
        # the ivf family scores its candidates in bq2 space
        backend = self.backend("bq2" if ivf else kind)
        queries = normalize(as_float32(queries, self.device))
        if queries.ndim == 1:
            queries = queries[None]
        enc_in = queries
        if self.rotation is not None and backend.kind != "float32":
            enc_in = queries @ self.rotation
        reprs = backend.encode_queries(enc_in)
        vectors = self.vectors if rerank else None
        n = self.sigs.words.shape[0]
        if ivf:
            probes = ivf_probes(self.ivf, k, probes)
            scan = dispatch.list_scan_ops(self.sigs.dim, self.device).scan

        def run(reprs, queries, ef_run, want_margin):
            if ivf:
                # the escalated stage widens the list fan-in by the same
                # multiple as the pool
                p_run = ivf_probes(self.ivf, k, probes * (ef_run // ef))
            out_ids, out_scores, out_margins = [], [], []
            for s in range(0, queries.shape[0], query_batch):
                if ivf:
                    cand_ids, cand_dists = scan_search(
                        backend, scan, reprs[s:s + query_batch],
                        self.ivf.cent_words, self.ivf.list_ids,
                        probes=p_run, ef=ef_run,
                    )
                else:
                    res = beam_search(
                        reprs[s:s + query_batch], self.adjacency,
                        self.medoid, dist_fn=backend.dist_many, ef=ef_run,
                        n=n, expand=expand,
                    )
                    cand_ids, cand_dists = res.ids, res.dists
                ids, scores = _rerank(cand_ids, cand_dists,
                                      queries[s:s + query_batch], vectors, k)
                out_ids.append(ids.cpu().numpy())
                out_scores.append(scores.cpu().numpy())
                if want_margin:
                    out_margins.append(beam_margin(
                        cand_dists, k, backend.neutral_dist).cpu().numpy())
            margins = np.concatenate(out_margins) if want_margin else None
            return (np.concatenate(out_ids), np.concatenate(out_scores),
                    margins)

        return escalated_search(
            run, reprs, queries, ef, adaptive=adaptive,
            margin_thr=sched.escalate_margin, mult=sched.escalate_mult,
        )

    # -- accounting (paper Table 2) -----------------------------------------

    def memory_breakdown(self) -> dict:
        n = self.sigs.words.shape[0]
        sig_bytes = self.sigs.words.numel() * 4
        adj_bytes = self.adjacency.numel() * 4 + n * 4  # + degree counters
        # the IVF tier rides the hot path: every ivf search gathers from it
        ivf_bytes = self.ivf.memory_bytes() if self.ivf is not None else 0
        cold = self.vectors.numel() * 4 if self.vectors is not None else 0
        hot = sig_bytes + adj_bytes + ivf_bytes
        out = {
            "hot_signature_bytes": int(sig_bytes),
            "hot_adjacency_bytes": int(adj_bytes),
            "hot_label_bytes": 0,
            "hot_ivf_bytes": int(ivf_bytes),
            "hot_total_bytes": int(hot),
            "cold_vector_bytes": int(cold),
            "host_shadow_bytes": 0,
            "total_bytes": int(hot + cold),
        }
        if self.policy is not None:
            # the serving policy beside the bytes it costs: a red-zone
            # float32 ladder puts the "cold" tier on the hot path
            out["nav_policy"] = self.policy.describe()
            out["probe_verdict"] = (
                self.report.verdict if self.report is not None else "n/a"
            )
        return out

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
