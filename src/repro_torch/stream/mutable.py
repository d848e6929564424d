"""MutableQuIVerIndex — the paper's index with a live mutation lifecycle.

Counterpart of ``repro/stream/mutable.py``.  Every tensor is preallocated
at ``capacity`` and lives on the index's device (the CUDA card unless the
caller asks for the CPU) for its whole life:

    words      (capacity, 2W) int32    packed 2-bit SM signatures (hot)
    adjacency  (capacity, R+slack) int32
    deg        (capacity,) int32       degree counters
    vectors    (capacity, D) float32   cold rerank tier (optional)
    live       (capacity,) bool        tombstone mask (host numpy)

``insert`` encodes the new vectors and chunk-links them against the
*live* graph with the linking primitives the batch build uses
(``repro_torch.core.linking``): the paper's chunked concurrent linking
(§4.1) run against a non-frozen graph.  ``delete`` only flips tombstones:
dead nodes keep routing beam searches (FreshDiskANN semantics) but never
surface in results, through the beam's ``node_valid`` mask.
``consolidate`` repairs the topology (each dead node's out-edges are
spliced into its in-neighbours' candidate pools and alpha-pruned in the
index's own metric space), then reclaims the dead slots for reuse.
``freeze`` compacts the live set into an immutable :class:`QuIVerIndex`.

``live`` and ``allocated`` are host arrays, as in the reference; every
device operation takes a fresh copy of ``live`` (:meth:`_live_dev`), so
the device never sees a stale mask.  The reference pads partial chunks
to a few bucket sizes to bound its jit traces; the port compiles nothing
and every row of a chunk is independent, so a chunk runs on its real
rows only.  ``search`` calls the beam directly, as the reference's does,
and does not go through query plans.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bq
from repro_torch.core.beam import beam_margin, beam_search, escalated_search
from repro_torch.core.index import QuIVerIndex, as_float32
from repro_torch.core.index import rerank as rerank_topk
from repro_torch.core.linking import medoid_scan
from repro_torch.core.metric import (
    MetricArrays,
    encode_queries_for,
    make_backend,
    normalize,
)
from repro_torch.core.vamana import BuildParams
from repro_torch.device import resolve_device
from repro_torch.filter import (
    DEFAULT_SELECTIVITY_FLOOR,
    LabelStore,
    brute_force_topk,
    build_label_entries,
    entry_label,
    estimate_selectivity,
    route,
    validate,
    widened_ef,
)
from repro_torch.filter.search import member_centroid
from repro_torch.obs.metrics import get_default_registry
from repro_torch.probe import (
    CompatibilityReport,
    NavPolicy,
    ProbeAccumulator,
    probe_corpus,
    probe_signatures,
    resolve_schedule,
)
from repro_torch.stream.consolidate import (
    link_chunk,
    overflow_rows,
    repair_rows,
)

_GRAPH_HEALTH = ("the graph X-ray is not ported yet (ROADMAP modules "
                 "item 12)")


@dataclasses.dataclass
class StreamStats:
    """Cumulative mutation accounting (since construction or load)."""

    inserts: int = 0
    deletes: int = 0
    consolidations: int = 0
    slots_reclaimed: int = 0
    rows_repaired: int = 0
    reverse_edges_added: int = 0


class MutableQuIVerIndex:
    """A QuIVer index that supports live insert/delete/consolidate.

    Construct with :meth:`empty` (streaming from scratch), :meth:`build`
    (batch build + headroom) or :meth:`from_index` (adopt an existing
    immutable index).  ``device=None`` means the CUDA card.
    """

    def __init__(
        self,
        *,
        capacity: int,
        dim: int,
        params: BuildParams,
        metric_kind: str = "bq2",
        keep_vectors: bool = True,
        rotation: torch.Tensor | None = None,
        n_labels: int | None = None,
        policy: NavPolicy | None = None,
        report: CompatibilityReport | None = None,
        device=None,
    ):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if metric_kind == "auto":
            raise ValueError(
                "metric='auto' needs a corpus to probe; use build() "
                "(or probe_report() + select_policy after inserting)"
            )
        device = resolve_device(device)
        w2 = 2 * bq.n_words(dim)
        self.device = device
        self.capacity = int(capacity)
        self.dim = int(dim)
        self.params = params
        self.metric_kind = metric_kind
        self.rotation = (as_float32(rotation, device)
                         if rotation is not None else None)
        self.words = torch.zeros((capacity, w2), dtype=torch.int32,
                                 device=device)
        self.adjacency = torch.full((capacity, params.r_total), -1,
                                    dtype=torch.int32, device=device)
        self.deg = torch.zeros((capacity,), dtype=torch.int32, device=device)
        self.vectors = (
            torch.zeros((capacity, dim), dtype=torch.float32, device=device)
            if keep_vectors else None
        )
        self.labels = (LabelStore(capacity, n_labels, device)
                       if n_labels else None)
        self.live = np.zeros((capacity,), dtype=bool)
        self.allocated = np.zeros((capacity,), dtype=bool)
        self.size = 0                    # allocation high-water mark
        self.medoid = -1                 # -1 until the first insert
        self.generation = 0              # bumped on every mutation
        self.stats = StreamStats()
        self._free: list[int] = []       # reclaimed slots, reused first
        # the nav policy / probe report travel with the index; the
        # accumulator keeps the live set's exact bit-plane statistics
        # current under churn
        self.policy = policy
        self.report = report
        self.probe_acc = ProbeAccumulator(dim)
        # optional probe-drift monitor: re-scores the accumulator against
        # the calibrated bands after every mutation
        self.drift_monitor = None

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_index(cls, index: QuIVerIndex, *,
                   capacity: int | None = None) -> "MutableQuIVerIndex":
        """Adopt a built :class:`QuIVerIndex` (default headroom: 2x), on
        the index's device."""
        n = index.sigs.words.shape[0]
        capacity = capacity or 2 * n
        if capacity < n:
            raise ValueError(f"capacity {capacity} < index size {n}")
        out = cls(
            capacity=capacity,
            dim=index.sigs.dim,
            params=index.params,
            metric_kind=index.metric_kind,
            keep_vectors=index.vectors is not None,
            rotation=index.rotation,
            policy=index.policy,
            report=index.report,
            device=index.device,
        )
        out.probe_acc.add(index.sigs.words)
        out.words[:n] = index.sigs.words
        out.adjacency[:n] = index.adjacency
        out.deg[:n] = (index.adjacency >= 0).sum(dim=1, dtype=torch.int32)
        if out.vectors is not None:
            out.vectors[:n] = index.vectors
        out.live[:n] = True
        out.allocated[:n] = True
        out.size = n
        out.medoid = int(index.medoid)
        if index.labels is not None:
            out.labels = index.labels.padded_to(capacity)
        return out

    @classmethod
    def build(
        cls,
        vectors,
        params: BuildParams | None = None,
        *,
        capacity: int | None = None,
        metric: str = "bq2",
        device=None,
        **build_kw,
    ) -> "MutableQuIVerIndex":
        """Batch-build (two-stage Vamana) then adopt with headroom."""
        idx = QuIVerIndex.build(vectors, params, metric=metric,
                                device=device, **build_kw)
        return cls.from_index(idx, capacity=capacity)

    @classmethod
    def empty(
        cls,
        dim: int,
        capacity: int,
        params: BuildParams | None = None,
        *,
        metric: str = "bq2",
        keep_vectors: bool = True,
        rotation=None,
        n_labels: int | None = None,
        device=None,
    ) -> "MutableQuIVerIndex":
        return cls(
            capacity=capacity,
            dim=dim,
            params=params or BuildParams(),
            metric_kind=metric,
            keep_vectors=keep_vectors,
            rotation=rotation,
            n_labels=n_labels,
            device=device,
        )

    def _backend(self, kind: str | None = None):
        """The metric backend ``kind`` (default: the index's own) over the
        current tensors."""
        return make_backend(kind or self.metric_kind, MetricArrays(
            sigs=bq.Signature(words=self.words, dim=self.dim),
            vectors=self.vectors))

    def enable_labels(self, n_labels: int) -> LabelStore:
        """Create (or return) the label store for filtered search."""
        if self.labels is None:
            self.labels = LabelStore(self.capacity, n_labels, self.device)
        elif self.labels.n_labels != n_labels:
            raise ValueError(
                f"labels already enabled with n_labels="
                f"{self.labels.n_labels}"
            )
        return self.labels

    def build_label_entries(self, *, min_count: int = 32) -> int:
        """Per-label entry points over the *live* member sets."""
        if self.labels is None:
            raise ValueError("no labels enabled")
        return build_label_entries(
            self.labels, self._backend(), vectors=self.vectors,
            node_valid=self._live_dev(), min_count=min_count,
        )

    # -- applicability probe -----------------------------------------------

    def probe_report(
        self,
        *,
        sample: int = 1024,
        queries: int = 64,
        k: int = 10,
        seed: int = 0,
    ) -> CompatibilityReport:
        """Probe the *live* set: sampled statistics plus the exact
        incremental bit-plane entropies from :class:`ProbeAccumulator`.

        The sampled stats (cosine spread, BQ agreement, margins) are
        recomputed from a live sample on demand; the entropy fields are
        taken from the accumulator, which covers every live row exactly.
        Vector-free indexes degrade to signature-only probes (agreement
        NaN, verdict capped at amber).
        """
        if self.n_live == 0:
            raise ValueError("cannot probe an empty index")
        live_idx = torch.from_numpy(np.nonzero(self.live)[0]).to(self.device)
        if self.vectors is not None:
            # probe the served encoding: signatures were built from
            # rotated vectors, so the sampled stats must be too
            v = self.vectors[live_idx]
            if self.rotation is not None:
                v = v @ self.rotation
            r = probe_corpus(v, sample=sample, queries=queries, k=k,
                             seed=seed, device=self.device)
        else:
            r = probe_signatures(self.words[live_idx], self.dim,
                                 sample=sample, k=k, seed=seed,
                                 device=self.device)
        return dataclasses.replace(
            r,
            sign_entropy=self.probe_acc.sign_entropy,
            strong_entropy=self.probe_acc.strong_entropy,
        )

    # -- drift alarms --------------------------------------------------------

    def attach_drift_monitor(self, monitor=None, *, tenant="default",
                             registry=None, **monitor_kw):
        """Arm probe-drift alarms: after every insert/delete/consolidate
        batch the accumulator's exact bit-plane stats are re-scored
        against the calibrated green/amber/red thresholds
        (:class:`repro_torch.obs.drift.DriftMonitor`), and band crossings
        raise alarms through the metrics layer.

        Pass a prebuilt monitor, or kwargs to build one over this index's
        accumulator (thresholds default to the build-time probe report's).
        Returns the armed monitor.
        """
        if monitor is None:
            from repro_torch.obs.drift import DriftMonitor
            if "thresholds" not in monitor_kw and self.report is not None:
                monitor_kw["thresholds"] = self.report.thresholds
            monitor = DriftMonitor(self.probe_acc, tenant=tenant,
                                   registry=registry, **monitor_kw)
        self.drift_monitor = monitor
        monitor.check()                     # establish the current band
        return monitor

    def graph_report(self, **kw):
        """The structural X-ray of the live graph: not ported yet."""
        raise NotImplementedError(_GRAPH_HEALTH)

    def attach_graph_monitor(self, monitor=None, **kw):
        """Graph-health banding on every consolidation: not ported yet."""
        raise NotImplementedError(_GRAPH_HEALTH)

    def replan(
        self,
        *,
        nav: str,
        ef_scale: int | None = None,
        adaptive: bool | None = None,
        source: str = "replan",
    ) -> NavPolicy:
        """Switch the live index's default nav at serve time.  Same
        contract as ``QuIVerIndex.replan`` except ``nav="ivf"`` is
        rejected, as ``search(nav="ivf")`` is: coarse partitions go stale
        under churn, so freeze() first.  A mutable index resolves its
        default nav from ``metric_kind`` (the policy carries only the
        ef/escalation schedule), so both are updated together.
        """
        if nav == "ivf":
            raise ValueError(
                "replan(nav='ivf') is not available on a mutable index "
                "(partitions go stale under churn); freeze() first"
            )
        if nav == "float32" and self.vectors is None:
            raise ValueError(
                "replan(nav='float32') needs the cold vector tier; "
                "this index is vector-free"
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
        self.metric_kind = nav
        return self.policy

    def _note_mutation(self, kind: str, count: int):
        """Mutation telemetry + drift re-score (insert, delete and
        consolidate all funnel through here)."""
        reg = get_default_registry()
        reg.counter(
            "quiver_stream_mutations_total",
            "streaming mutations by kind", labels=("kind",),
        ).inc(count, kind=kind)
        reg.gauge(
            "quiver_stream_live_rows", "live rows in mutable indexes",
        ).set(self.n_live)
        if self.drift_monitor is not None:
            return self.drift_monitor.check()
        return None

    # -- introspection -----------------------------------------------------

    @property
    def n_live(self) -> int:
        return int(self.live.sum())

    @property
    def n_dead(self) -> int:
        return int((self.allocated & ~self.live).sum())

    @property
    def free_slots(self) -> int:
        return self.capacity - self.size + len(self._free)

    def __len__(self) -> int:
        return self.n_live

    def memory_breakdown(self) -> dict:
        sig_bytes = self.words.numel() * 4
        adj_bytes = self.adjacency.numel() * 4 + self.deg.numel() * 4
        mask_bytes = 2 * self.capacity  # live + allocated, host-side
        label_bytes = (
            self.labels.memory_bytes() if self.labels is not None else 0
        )
        cold = self.vectors.numel() * 4 if self.vectors is not None else 0
        hot = sig_bytes + adj_bytes + mask_bytes + label_bytes
        out = {
            "hot_signature_bytes": int(sig_bytes),
            "hot_adjacency_bytes": int(adj_bytes),
            "hot_mask_bytes": int(mask_bytes),
            "hot_label_bytes": int(label_bytes),
            "hot_total_bytes": int(hot),
            "cold_vector_bytes": int(cold),
            "host_shadow_bytes": 0,
            "total_bytes": int(hot + cold),
        }
        if self.policy is not None:
            out["nav_policy"] = self.policy.describe()
            out["probe_verdict"] = (
                self.report.verdict if self.report is not None else "n/a"
            )
        return out

    def _live_dev(self) -> torch.Tensor:
        """The live mask as a (capacity,) bool tensor on the device: a copy
        of the host mask as it is now."""
        return torch.tensor(self.live, device=self.device)

    def _dev_ids(self, ids: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(ids, dtype=np.int64)).to(
            self.device)

    # -- mutation ----------------------------------------------------------

    def _allocate(self, count: int) -> np.ndarray:
        take = min(count, len(self._free))
        ids = self._free[:take]
        fresh = count - take
        if self.size + fresh > self.capacity:
            raise ValueError(
                f"insert of {count} exceeds capacity: "
                f"{self.free_slots} slots free of {self.capacity} "
                f"(consolidate() reclaims tombstoned slots)"
            )
        del self._free[:take]
        ids = ids + list(range(self.size, self.size + fresh))
        self.size += fresh
        return np.asarray(ids, dtype=np.int32)

    def insert(self, vectors, labels=None) -> np.ndarray:
        """Insert a batch of float32 vectors; returns their slot ids.

        Vectors are L2-normalized and encoded, then chunk-linked against
        the live graph: beam search from the medoid, alpha-prune in the
        index's metric space, forward + reverse edge install.  A chunk
        links against the graph as it stood before it, so a chunk never
        links more nodes than the live graph already holds
        (``min(chunk, max(16, live_before), left)``).

        ``labels`` (optional) assigns filter labels on the way in: one int
        or iterable of ints per vector (or a single int for the whole
        batch), written before the new nodes become searchable.  Requires
        ``enable_labels``.
        """
        v = normalize(as_float32(vectors, self.device))
        if v.ndim == 1:
            v = v[None]
        if v.shape[-1] != self.dim:
            raise ValueError(f"dim mismatch: {v.shape[-1]} != {self.dim}")
        if labels is not None and self.labels is None:
            raise ValueError(
                "insert(labels=...) needs enable_labels(n_labels) first"
            )
        if v.shape[0] == 0:
            return np.empty((0,), dtype=np.int32)
        ids = self._allocate(v.shape[0])
        pre_live = self.n_live
        if labels is not None:
            self.labels.set(ids, labels)
        elif self.labels is not None:
            self.labels.clear(ids)     # reused slots must start clean

        enc = v @ self.rotation if self.rotation is not None else v
        sig_words = bq.encode(enc).words
        self.probe_acc.add(sig_words)
        ids_dev = torch.from_numpy(ids).to(self.device)   # int32
        self.words[ids_dev.long()] = sig_words
        if self.vectors is not None:
            self.vectors[ids_dev.long()] = v
        self.live[ids] = True
        self.allocated[ids] = True
        if self.medoid < 0 or pre_live == 0:
            # empty (or fully tombstoned) graph: a dead medoid inside an
            # all-dead component could strand the new nodes; re-anchor
            self.medoid = int(ids[0])

        p = self.params
        backend = self._backend()
        pos = 0
        while pos < len(ids):
            live_before = self.n_live - (len(ids) - pos)
            take = min(p.chunk, max(16, live_before), len(ids) - pos)
            block = ids_dev[pos:pos + take]
            pos += take
            self.adjacency, self.deg, added = link_chunk(
                backend, self.adjacency, self.deg, self._live_dev(), block,
                self.medoid, ef=p.ef_construction, pool=p.prune_pool,
                r=p.r, alpha=p.alpha, n=self.capacity,
                expand=p.beam_expand, r_total=p.r_total,
            )
            self.stats.reverse_edges_added += int(added)
        self._consolidate_overflow()
        self.stats.inserts += len(ids)
        self.generation += 1
        self._note_mutation("insert", len(ids))
        return ids

    def delete(self, ids) -> int:
        """Tombstone ``ids``; returns how many were live.

        Dead nodes keep routing beam searches until :meth:`consolidate`
        splices them out and reclaims their slots.  Their label bits are
        cleared *now*: popcounts drive selectivity routing, and
        dead-inflated counts would keep a mostly deleted label on the
        graph route long after brute force became the right answer.
        """
        ids = np.atleast_1d(np.asarray(ids, dtype=np.int64))
        if len(ids) and (ids.min() < 0 or ids.max() >= self.capacity):
            raise ValueError(f"ids out of range [0, {self.capacity})")
        was_live = self.live[ids].sum()
        gone = np.unique(ids[self.live[ids]])
        if gone.size:
            # un-count exactly the rows leaving the live set (duplicate
            # and already-dead ids must not decrement twice)
            self.probe_acc.remove(self.words[self._dev_ids(gone)])
        self.live[ids] = False
        if self.labels is not None:
            self.labels.clear(ids)
        self.stats.deletes += int(was_live)
        self.generation += 1
        self._note_mutation("delete", int(was_live))
        return int(was_live)

    def _batched_rows(self, rows: np.ndarray, op) -> None:
        """Run a row-repair operation over batches of ``chunk`` rows
        ((n,) int32, copied to the device once)."""
        chunk = self.params.chunk
        rows = torch.from_numpy(rows).to(self.device)
        for s in range(0, len(rows), chunk):
            self.adjacency, self.deg = op(rows[s:s + chunk])

    def _consolidate_overflow(self) -> None:
        """Re-prune rows whose degree overflowed r (as the build does)."""
        overflow = np.nonzero(
            self.deg.cpu().numpy() > self.params.r)[0].astype(np.int32)
        if overflow.size == 0:
            return
        p, backend, live = self.params, self._backend(), self._live_dev()
        self._batched_rows(overflow, lambda row_ids: overflow_rows(
            backend, self.adjacency, self.deg, live, row_ids,
            r=p.r, alpha=p.alpha, r_total=p.r_total))

    def consolidate(self) -> dict:
        """FreshDiskANN-style repair + slot reclamation.

        For every live row that points at a tombstone, splice the dead
        neighbours' own live out-edges into the row's candidate pool and
        alpha-prune it in the index's metric space.  Then clear the dead
        rows, reclaim their slots for reuse, and re-elect the medoid if it
        died.
        """
        dead_mask = self.allocated & ~self.live
        dead = np.nonzero(dead_mask)[0]
        report = {"dead": int(dead.size), "repaired_rows": 0,
                  "reclaimed": int(dead.size)}
        if dead.size == 0:
            return report

        # the points-at-dead mask on the device: only a (capacity,) bool
        # comes back, never the adjacency
        adj = self.adjacency
        dead_dev = torch.tensor(dead_mask, device=self.device)
        points_at_dead = ((adj >= 0) & dead_dev[adj.clamp_min(0).long()]
                          ).any(dim=1).cpu().numpy()
        affected = np.nonzero(self.live & points_at_dead)[0].astype(np.int32)
        report["repaired_rows"] = int(affected.size)

        if affected.size:
            p, backend, live = self.params, self._backend(), self._live_dev()
            self._batched_rows(affected, lambda row_ids: repair_rows(
                backend, self.adjacency, self.deg, live, row_ids,
                r=p.r, alpha=p.alpha, r_total=p.r_total, pool=p.prune_pool))

        # clear + reclaim the dead slots (labels too: a reclaimed slot must
        # not inherit its previous occupant's filter labels)
        dead_ids = self._dev_ids(dead)
        self.adjacency[dead_ids] = -1
        self.deg[dead_ids] = 0
        if self.labels is not None:
            self.labels.clear(dead)
        self.allocated[dead] = False
        self._free.extend(int(i) for i in dead)

        # re-elect the medoid if it died (or was never set)
        if self.n_live and (self.medoid < 0 or not self.live[self.medoid]):
            self.medoid = self._live_medoid()
        elif self.n_live == 0:
            self.medoid = -1

        self.stats.consolidations += 1
        self.stats.rows_repaired += report["repaired_rows"]
        self.stats.slots_reclaimed += report["reclaimed"]
        self.generation += 1
        self._note_mutation("consolidate", 1)
        return report

    def _live_medoid(self) -> int:
        """The live node nearest the live centroid, in the index's metric
        space: the centroid of the cold vectors (else of the decoded
        levels), summed in float64 and rounded once
        (``filter.search.member_centroid``), so the CPU and the card
        agree."""
        backend = self._backend()
        rows = self.vectors if self.vectors is not None else \
            bq.decode_levels(bq.Signature(words=self.words, dim=self.dim))
        live = self._live_dev()
        centroid = backend.encode_queries(member_centroid(live, rows)[None])
        return int(medoid_scan(backend, centroid[0], chunk=4096,
                               node_valid=live))

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
    ) -> tuple[np.ndarray, np.ndarray]:
        """Tombstone-aware search: the contract of ``QuIVerIndex.search``
        (the score scale: cosine with ``rerank=True``, negated navigation
        distances with ``rerank=False``; the :class:`NavPolicy` schedule)
        but dead or never-inserted slots cannot appear in the results.

        ``filter`` composes with tombstones through the beam's two masks:
        the predicate mask and the live mask each restrict only what may
        be *returned* while navigation traverses everything, so results
        are exactly live ∧ matching.
        """
        queries = normalize(as_float32(queries, self.device))
        if queries.ndim == 1:
            queries = queries[None]
        nq = queries.shape[0]
        if self.n_live == 0:
            return (np.full((nq, k), -1, np.int32),
                    np.full((nq, k), -np.inf, np.float32))
        if nav == "ivf":
            raise ValueError(
                "nav='ivf' serves from a frozen coarse partition, which "
                "would go stale under churn — freeze() this index first "
                "(with BuildParams(ivf_candidates=True) the frozen "
                "snapshot carries a fresh partition)"
            )
        ef, adaptive, sched = resolve_schedule(self.policy, nav, ef,
                                               adaptive)
        kind = nav or self.metric_kind
        enc_in = queries
        if self.rotation is not None and kind != "float32":
            enc_in = queries @ self.rotation
        reprs = encode_queries_for(kind, enc_in)
        backend = self._backend(kind)
        live = self._live_dev()

        result_valid = live          # live & live == live: no-op AND
        start = max(self.medoid, 0)
        ef_run = ef
        if filter is not None:
            if self.labels is None:
                raise ValueError(
                    "filtered search needs enable_labels() / "
                    "insert(labels=...) first"
                )
            expr = validate(filter, self.labels.n_labels)
            count_fn = self.labels.count_fn()
            sel = estimate_selectivity(expr, count_fn, self.n_live)
            mask = self.labels.mask(expr)
            if route(sel, selectivity_floor) == "brute":
                # the estimate is a bound: check the exact live match
                # count before materializing the match set
                match = np.nonzero(mask.cpu().numpy() & self.live)[0]
                sel = len(match) / max(self.n_live, 1)
                if route(sel, selectivity_floor) == "brute":
                    if rerank and self.vectors is not None:
                        return brute_force_topk(queries, match, k,
                                                vectors=self.vectors)
                    return brute_force_topk(queries, match, k, vectors=None,
                                            backend=backend, reprs=reprs)
            result_valid = mask
            ef_run = widened_ef(ef, sel, selectivity_floor, self.n_live)
            lbl = entry_label(expr, count_fn)
            if lbl is not None:
                ent = int(self.labels.entries[lbl])
                if ent >= 0 and self.live[ent]:
                    start = ent
        vectors = self.vectors if rerank else None

        def run(reprs_r, queries_r, ef_r, want_margin):
            out_ids, out_scores, out_margin = [], [], []
            for s in range(0, reprs_r.shape[0], query_batch):
                res = beam_search(
                    reprs_r[s:s + query_batch], self.adjacency, start,
                    dist_fn=backend.dist_many, ef=ef_r, n=self.capacity,
                    expand=expand, node_valid=live,
                    result_valid=result_valid,
                )
                ids, scores = rerank_topk(
                    res.ids, res.dists, queries_r[s:s + query_batch],
                    vectors, k)
                out_ids.append(ids.cpu().numpy())
                out_scores.append(scores.cpu().numpy())
                if want_margin:
                    out_margin.append(beam_margin(
                        res.dists, k, backend.neutral_dist).cpu().numpy())
            return (np.concatenate(out_ids), np.concatenate(out_scores),
                    np.concatenate(out_margin) if want_margin else None)

        return escalated_search(
            run, reprs, queries, ef_run, adaptive=adaptive,
            margin_thr=sched.escalate_margin, mult=sched.escalate_mult,
        )

    # -- snapshots ---------------------------------------------------------

    def freeze(self) -> QuIVerIndex:
        """Compact the live set into an immutable :class:`QuIVerIndex`.

        Live slots keep their relative order; edges to tombstones are
        dropped (they are already absent after :meth:`consolidate`).
        With zero churn this is exactly the arrays the index was built
        with, so searches are bit-identical to the source index.  With
        ``BuildParams(ivf_candidates=True)`` the snapshot also carries a
        freshly built coarse partition over the compacted live set, so
        ``nav="ivf"`` works on the frozen index.
        """
        if self.n_live == 0:
            raise ValueError("cannot freeze an empty index")
        live_idx = np.nonzero(self.live)[0]
        remap = np.full((self.capacity + 1,), -1, dtype=np.int32)
        remap[live_idx] = np.arange(live_idx.size, dtype=np.int32)

        sel = self._dev_ids(live_idx)
        words = self.words[sel]
        vectors = self.vectors[sel] if self.vectors is not None else None
        adj_host = self.adjacency.cpu().numpy()[live_idx]
        adj_new = remap[np.clip(adj_host, 0, None)]
        adj_new[adj_host < 0] = -1

        medoid = self.medoid
        if medoid < 0 or not self.live[medoid]:
            medoid = self._live_medoid()
        sigs = bq.Signature(words=words, dim=self.dim)
        ivf = None
        if self.params.ivf_candidates:
            from repro_torch.ivf import build_partition
            ivf = build_partition(sigs, seed=self.params.seed)
        return QuIVerIndex(
            sigs=sigs,
            adjacency=torch.from_numpy(adj_new).to(self.device),
            medoid=int(remap[medoid]),
            params=self.params,
            vectors=vectors,
            rotation=self.rotation,
            metric_kind=self.metric_kind,
            labels=(self.labels.compact(live_idx)
                    if self.labels is not None else None),
            policy=self.policy,
            report=self.report,
            ivf=ivf,
        )

    # -- persistence -------------------------------------------------------

    def save(self, path: str) -> None:
        """Write the reference's streaming npz archive (``stream_format``
        1, words as uint32)."""
        from repro_torch.convert import mutable_to_numpy
        np.savez_compressed(path, **mutable_to_numpy(self))

    @classmethod
    def load(cls, path: str, device=None) -> "MutableQuIVerIndex":
        """Read a streaming archive written by either package; an
        immutable archive is adopted (:meth:`from_index`)."""
        from repro_torch.convert import index_from_numpy, mutable_from_numpy
        with np.load(path) as z:
            fields = dict(z)
        if "stream_format" not in fields:
            return cls.from_index(index_from_numpy(fields, device))
        return mutable_from_numpy(fields, device)
