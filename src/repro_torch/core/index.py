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

``search`` lowers, as the reference's does, to a query plan: the nav
ladder, the filter route and the escalation schedule are resolved once
into a frozen :class:`~repro_torch.plan.QueryPlan`
(:func:`~repro_torch.plan.resolve_plan`), and the index's
:class:`~repro_torch.plan.PlanCache` runs it.  Labels
(``attach_labels``, ``repro_torch.filter``) make ``filter=`` predicates
available; ``replan`` switches the default nav policy and evicts the
abandoned family's plans.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bq
from repro_torch.core.metric import (
    MetricArrays,
    MetricSpace,
    make_backend,
    normalize,
    registered_kinds,
)
from repro_torch.core.vamana import BuildParams, BuildStats, build_graph
from repro_torch.device import resolve_device
from repro_torch.filter import (
    DEFAULT_SELECTIVITY_FLOOR,
    LabelStore,
    build_label_entries,
)
from repro_torch.ivf import IVFPartition, build_partition
from repro_torch.plan.cache import PlanCache
from repro_torch.plan.planner import resolve_plan
from repro_torch.probe import (
    CompatibilityReport,
    NavPolicy,
    probe_corpus,
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
    labels: LabelStore | None = None     # packed label bitsets — hot
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
    # query plans: one cache per index, each distinct plan built once
    _plan_cache: PlanCache | None = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def device(self) -> torch.device:
        return self.adjacency.device

    @property
    def plans(self) -> PlanCache:
        """The index's plan cache (created on first use)."""
        if self._plan_cache is None:
            self._plan_cache = PlanCache(self)
        return self._plan_cache

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

    # -- replanning ----------------------------------------------------------

    def replan(
        self,
        *,
        nav: str,
        ef_scale: int | None = None,
        adaptive: bool | None = None,
        source: str = "replan",
    ) -> NavPolicy:
        """Switch the index's default nav policy at serve time.

        The new :class:`NavPolicy` becomes the default of every search
        that leaves ``nav`` unset, and the old default's plans are evicted
        from the :class:`PlanCache` (targeted: every other nav family's
        programs survive, so their traffic sees zero retraces).
        ``ef_scale`` / ``adaptive`` default to the current policy's values
        (or the :class:`NavPolicy` defaults when none is set).
        """
        if nav == "ivf" and self.ivf is None:
            raise ValueError(
                "replan(nav='ivf') needs a coarse partition; call "
                "build_ivf() first"
            )
        if nav == "float32" and self.vectors is None:
            raise ValueError(
                "replan(nav='float32') needs the cold vector tier; "
                "this index is vector-free"
            )
        old_nav = (
            self.policy.nav if self.policy is not None else self.metric_kind
        )
        if self.policy is not None:
            kw = {"nav": nav, "source": source}
            if ef_scale is not None:
                kw["ef_scale"] = int(ef_scale)
            if adaptive is not None:
                kw["adaptive"] = bool(adaptive)
            self.policy = dataclasses.replace(self.policy, **kw)
        else:
            self.policy = NavPolicy(
                nav=nav, source=source,
                **({} if ef_scale is None else {"ef_scale": int(ef_scale)}),
                **({} if adaptive is None else {"adaptive": bool(adaptive)}),
            )
        if nav != old_nav and self._plan_cache is not None:
            self._plan_cache.invalidate(nav=old_nav)
        return self.policy

    # -- labels (filtered search) --------------------------------------------

    def attach_labels(self, labels, *,
                      n_labels: int | None = None) -> LabelStore:
        """Attach per-node labels: one int (categorical) or iterable of
        ints (multi-tag) per node, length N.  Returns the store, whose
        words live on the index's device."""
        n = self.sigs.words.shape[0]
        if len(labels) != n:
            raise ValueError(f"{len(labels)} label rows for {n} nodes")
        self.labels = LabelStore.from_rows(labels, n_labels=n_labels,
                                           device=self.device)
        return self.labels

    def build_label_entries(self, *, min_count: int = 32) -> int:
        """Per-label entry points (member medoids) for frequent labels;
        returns how many were built."""
        if self.labels is None:
            raise ValueError("no labels attached")
        return build_label_entries(
            self.labels, self.backend(), vectors=self.vectors,
            min_count=min_count,
        )

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
        selectivity_floor: float = DEFAULT_SELECTIVITY_FLOOR,
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
        whose top-k margin (``beam_margin``) is below the schedule's
        ``escalate_margin`` at ``ef * escalate_mult`` (and, on the ivf
        route, ``probes * escalate_mult``).

        ``filter`` (optional) is a label predicate (``repro_torch.filter``'s
        ``Any``/``All``/``Not`` or a bare label id) over the attached
        :class:`LabelStore`.  Its estimated selectivity picks the route:
        at or above ``selectivity_floor`` the graph (or the ivf lists) is
        searched with a widened ``ef`` and the predicate as the result
        mask, from the best per-label entry point; below it the match set
        is brute-forced exactly.

        The call lowers to :func:`resolve_plan` and the index's
        :class:`PlanCache`, which runs each distinct plan's program.
        """
        plan, ctx = resolve_plan(
            self, k=k, ef=ef, rerank=rerank, nav=nav, expand=expand,
            query_batch=query_batch, filter=filter,
            selectivity_floor=selectivity_floor, adaptive=adaptive,
            probes=probes,
        )
        return self.plans.run(plan, ctx, queries)

    # -- accounting (paper Table 2) -----------------------------------------

    def memory_breakdown(self) -> dict:
        n = self.sigs.words.shape[0]
        sig_bytes = self.sigs.words.numel() * 4
        adj_bytes = self.adjacency.numel() * 4 + n * 4  # + degree counters
        label_bytes = (
            self.labels.memory_bytes() if self.labels is not None else 0
        )
        # the IVF tier rides the hot path: every ivf search gathers from it
        ivf_bytes = self.ivf.memory_bytes() if self.ivf is not None else 0
        cold = self.vectors.numel() * 4 if self.vectors is not None else 0
        hot = sig_bytes + adj_bytes + label_bytes + ivf_bytes
        out = {
            "hot_signature_bytes": int(sig_bytes),
            "hot_adjacency_bytes": int(adj_bytes),
            "hot_label_bytes": int(label_bytes),
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
