"""Shard-local streaming: mutable QuIVer shards behind one fan-out API.

Counterpart of ``repro/stream/sharded.py``.  Each shard is a
:class:`MutableQuIVerIndex` over its own capacity-preallocated tensors,
on its own device.  Inserts are routed round-robin so shards stay
balanced under churn; deletes route by the shard encoded in the global
id; searches snapshot the shards into a
:class:`~repro_torch.core.distributed.ShardedIndex` whose ``live`` masks
carry every shard's tombstones into the fan-out: dead nodes are filtered
from each local top-k before the merge, so the gather stays one (k ids,
k scores) pair per shard.

Global id scheme: ``gid = shard * capacity_per_shard + slot``.  Slots are
reclaimed by consolidation, so a gid is unique among *live* ids at any
instant but may be reused after its document is deleted and the shard
consolidated: the usual semantics of a slotted streaming store.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bq
from repro_torch.core.distributed import (
    ShardedIndex,
    merge_host,
    search_sharded,
    shard_devices,
)
from repro_torch.core.index import as_float32
from repro_torch.core.metric import encode_queries_for, normalize
from repro_torch.core.vamana import BuildParams
from repro_torch.ivf import build_partition, record_routes, top_lists
from repro_torch.kernels import dispatch
from repro_torch.probe import CompatibilityReport, merge_reports
from repro_torch.stream.mutable import MutableQuIVerIndex


class StreamingShardedIndex:
    """Round-robin streaming over per-shard mutable indexes."""

    def __init__(self, shards: list[MutableQuIVerIndex]):
        if not shards:
            raise ValueError("need at least one shard")
        caps = {s.capacity for s in shards}
        dims = {s.dim for s in shards}
        kinds = {s.metric_kind for s in shards}
        if len(caps) != 1 or len(dims) != 1 or len(kinds) != 1:
            raise ValueError(
                "shards must share capacity/dim/metric "
                f"(got {caps}/{dims}/{kinds})"
            )
        self.shards = shards
        self.capacity_per_shard = caps.pop()
        self.dim = dims.pop()
        self.metric_kind = kinds.pop()
        self._rr = 0                      # round-robin insert cursor
        self._snapshot: ShardedIndex | None = None
        self._snapshot_gens: tuple[int, ...] | None = None
        # IVF routing tier (enable_ivf_routing): (cent_words, owners,
        # default_probes, generations it was built at)
        self._ivf_route = None
        self._ivf_route_seed = 0

    @classmethod
    def empty(
        cls,
        dim: int,
        *,
        n_shards: int,
        capacity_per_shard: int,
        params: BuildParams | None = None,
        metric: str = "bq2",
        keep_vectors: bool = True,
        n_labels: int | None = None,
        device=None,
    ) -> "StreamingShardedIndex":
        """An empty fleet; ``device`` places the shards as
        :func:`~repro_torch.core.distributed.shard_devices` says."""
        return cls([
            MutableQuIVerIndex.empty(
                dim, capacity_per_shard, params, metric=metric,
                keep_vectors=keep_vectors, n_labels=n_labels, device=dev,
            )
            for dev in shard_devices(device, n_shards)
        ])

    def enable_labels(self, n_labels: int) -> None:
        """Enable filtered search on every shard."""
        for s in self.shards:
            s.enable_labels(n_labels)

    def build_label_entries(self, *, min_count: int = 32) -> int:
        """Per-shard per-label entry points; returns total built."""
        return sum(
            s.build_label_entries(min_count=min_count)
            for s in self.shards
        )

    # -- id scheme ---------------------------------------------------------

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def n_live(self) -> int:
        return sum(s.n_live for s in self.shards)

    def _to_global(self, shard: int, slots: np.ndarray) -> np.ndarray:
        return shard * self.capacity_per_shard + np.asarray(slots)

    def _to_local(self, gids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        gids = np.asarray(gids, dtype=np.int64)
        return gids // self.capacity_per_shard, \
            gids % self.capacity_per_shard

    # -- mutation ----------------------------------------------------------

    def insert(self, vectors, labels=None) -> np.ndarray:
        """Round-robin insert; returns global ids in input order.

        All-or-nothing: capacity is checked across every target shard
        *before* any shard mutates, so a full shard can never leave the
        fleet with untracked live vectors.

        ``labels`` (optional): one int / iterable of ints per vector,
        routed to each owning shard's label store alongside the vector
        (see ``MutableQuIVerIndex.insert``)."""
        v = np.asarray(vectors, dtype=np.float32)
        if v.ndim == 1:
            v = v[None]
        if labels is not None:
            labels = list(labels)
            if len(labels) != len(v):
                raise ValueError(
                    f"{len(labels)} label rows for {len(v)} vectors"
                )
        owner = (self._rr + np.arange(len(v))) % self.n_shards
        counts = np.bincount(owner, minlength=self.n_shards)
        for s, need in enumerate(counts):
            if need > self.shards[s].free_slots:
                raise ValueError(
                    f"shard {s} needs {need} slots but has "
                    f"{self.shards[s].free_slots} free of "
                    f"{self.shards[s].capacity} "
                    f"(consolidate() reclaims tombstoned slots)"
                )
        self._rr = int((self._rr + len(v)) % self.n_shards)
        gids = np.empty((len(v),), dtype=np.int64)
        for s in range(self.n_shards):
            take = np.nonzero(owner == s)[0]
            if take.size == 0:
                continue
            slots = self.shards[s].insert(
                v[take],
                labels=(
                    [labels[i] for i in take] if labels is not None
                    else None
                ),
            )
            gids[take] = self._to_global(s, slots)
        return gids

    def delete(self, gids) -> int:
        """Tombstone global ids; returns how many were live."""
        shard, slot = self._to_local(np.atleast_1d(gids))
        if len(shard) and (shard.min() < 0 or shard.max() >= self.n_shards):
            raise ValueError("global id out of range")
        removed = 0
        for s in range(self.n_shards):
            take = shard == s
            if take.any():
                removed += self.shards[s].delete(slot[take])
        return removed

    def consolidate(self) -> list[dict]:
        """Per-shard repair + reclamation (embarrassingly parallel)."""
        return [s.consolidate() for s in self.shards]

    def attach_drift_monitors(self, *, tenant="default", registry=None,
                              **monitor_kw) -> list:
        """Arm per-shard probe-drift alarms (DESIGN.md §12).  Each shard
        gets its own monitor over its own live-set accumulator, labelled
        ``{tenant}/shard{i}`` so a single drifting shard is attributable
        on the fleet scrape.  Returns the monitors in shard order."""
        return [
            s.attach_drift_monitor(
                tenant=f"{tenant}/shard{i}", registry=registry,
                **monitor_kw,
            )
            for i, s in enumerate(self.shards)
        ]

    def replan(self, *, nav: str, **replan_kw) -> list:
        """Fan a nav replan out to every shard (DESIGN.md §14), so the
        fleet serves one consistent policy.  Returns the per-shard
        policies in shard order; same validation as
        ``MutableQuIVerIndex.replan`` (``nav="ivf"`` rejected: the
        routing tier is a scatter overlay, not a per-shard nav family)."""
        return [s.replan(nav=nav, **replan_kw) for s in self.shards]

    # -- applicability probe (DESIGN.md §10) -------------------------------

    def probe_report(self, **probe_kw) -> CompatibilityReport:
        """Fleet-wide compatibility report: per-shard live-set probes
        (``MutableQuIVerIndex.probe_report``) merged sample-weighted, the
        streaming analogue of ``build_sharded(metric="auto")``'s merge.
        Empty shards contribute nothing."""
        reports = [
            s.probe_report(**probe_kw) for s in self.shards if s.n_live
        ]
        if not reports:
            raise ValueError("cannot probe an empty fleet")
        return merge_reports(reports)

    # -- IVF routing tier (DESIGN.md §13) ----------------------------------

    @property
    def _home(self) -> torch.device:
        return self.shards[0].device

    def enable_ivf_routing(self, *, n_lists: int | None = None,
                           seed: int = 0) -> int:
        """Build the coarse routing tier over the fleet's live set.

        Streaming placement is round-robin (lists cannot be the shard
        unit under churn), so the tier is an *ownership overlay*: one
        global partition over the live signatures, on the first shard's
        device, plus an (S, L) matrix of which shards hold members of each
        list.  ``search(..., scatter=True)`` then contacts only the shards
        owning a query's top-p lists.  The tier is rebuilt lazily
        whenever any shard's generation counter moves.  Returns the
        number of lists.
        """
        self._ivf_route_seed = seed
        live_words, shard_of = [], []
        for i, s in enumerate(self.shards):
            rows = np.nonzero(s.live)[0]
            if rows.size:
                live_words.append(s.words[s._dev_ids(rows)].to(self._home))
                shard_of.append(np.full(rows.size, i, np.int32))
        if not live_words:
            raise ValueError("cannot route an empty fleet")
        sigs = bq.Signature(words=torch.cat(live_words), dim=self.dim)
        part = build_partition(sigs, n_lists=n_lists, seed=seed)
        shard_of = np.concatenate(shard_of)
        owners = np.zeros((self.n_shards, part.n_lists), dtype=bool)
        owners[shard_of, part.assign] = True
        self._ivf_route = (
            part.cent_words, owners, part.default_probes,
            tuple(s.generation for s in self.shards),
        )
        return part.n_lists

    def _scatter_search(self, queries, *, ef, k, probes, filter,
                        registry):
        if self._ivf_route is None:
            raise ValueError(
                "scatter search needs enable_ivf_routing() first"
            )
        gens = tuple(s.generation for s in self.shards)
        if gens != self._ivf_route[3]:    # stale under churn: rebuild
            self.enable_ivf_routing(
                n_lists=self._ivf_route[0].shape[0],
                seed=self._ivf_route_seed,
            )
        cent_words, owners, default_probes, _ = self._ivf_route
        q = as_float32(queries, self._home)
        if q.ndim == 1:
            q = q[None]
        nq = q.shape[0]
        p = max(1, min(probes or default_probes, cent_words.shape[0]))
        reprs = encode_queries_for("bq2", normalize(q))
        ops = dispatch.list_scan_ops(self.dim, self._home)
        top = top_lists(ops.scan, reprs, cent_words, p).cpu().numpy()
        contact = owners.T[top].any(axis=1)            # (Q, S)
        record_routes(top, contact.sum(axis=-1), registry=registry)

        all_ids = np.full((nq, self.n_shards, k), -1, dtype=np.int64)
        all_scores = np.full((nq, self.n_shards, k), -np.inf,
                             dtype=np.float32)
        qn = q.cpu().numpy()
        for s in range(self.n_shards):
            rows = np.nonzero(contact[:, s])[0]
            if rows.size == 0:
                continue
            ids, scores = self.shards[s].search(
                qn[rows], k, ef=ef, filter=filter,
            )
            ok = ids >= 0
            all_ids[rows, s] = np.where(
                ok, self._to_global(s, np.maximum(ids, 0)), -1
            )
            all_scores[rows, s] = np.where(ok, scores, -np.inf)
        return merge_host(all_ids, all_scores, k)

    # -- search ------------------------------------------------------------

    def snapshot(self) -> ShardedIndex:
        """The shards' tensors as a :class:`ShardedIndex` whose ``live``
        masks carry tombstones into the fan-out search.

        The tensors are copies, so a snapshot held across a mutation
        stays what it was.  Cached on the shard generation counters: an
        unchanged fleet serves every search from the same snapshot
        instead of copying the fleet per request.
        """
        if any(s.vectors is None for s in self.shards):
            raise ValueError("sharded streaming search needs cold vectors")
        gens = tuple(s.generation for s in self.shards)
        if self._snapshot is not None and gens == self._snapshot_gens:
            return self._snapshot
        labeled = all(s.labels is not None for s in self.shards)
        self._snapshot = ShardedIndex(
            sig_words=tuple(s.words.clone() for s in self.shards),
            adjacency=tuple(s.adjacency.clone() for s in self.shards),
            medoids=np.asarray(
                [max(s.medoid, 0) for s in self.shards], dtype=np.int32
            ),
            vectors=tuple(s.vectors.clone() for s in self.shards),
            dim=self.dim,
            metric=self.metric_kind,
            live=tuple(s._live_dev() for s in self.shards),
            label_words=(
                tuple(s.labels.words.clone() for s in self.shards)
                if labeled else None
            ),
            n_labels=(
                self.shards[0].labels.n_labels if labeled else 0
            ),
            label_entries=(
                np.stack([s.labels.entries for s in self.shards])
                if labeled else None
            ),
            # live-accurate fleet popcounts (delete clears label bits)
            label_counts=(
                np.sum([s.labels.counts for s in self.shards], axis=0)
                if labeled else None
            ),
            # one fleet schedule only when every shard agrees (shards
            # adopted from differently-probed indexes get no schedule)
            policy=(
                self.shards[0].policy
                if len({s.policy for s in self.shards}) == 1 else None
            ),
            report=(
                self.shards[0].report
                if len({s.report for s in self.shards}) == 1 else None
            ),
        )
        self._snapshot_gens = gens
        return self._snapshot

    def search(self, queries, *, ef: int = 64, k: int = 10,
               nav: str | None = None, expand: int = 1, filter=None,
               scatter: bool = False, probes: int | None = None,
               registry=None):
        """Fan-out/merge search over all shards (global ids).

        ``filter`` is pushed down per shard: every shard's label bitset
        mask joins its tombstone mask in the fan-out, so only live
        matching ids reach the top-k merge (``search_sharded``).

        ``scatter=True`` routes on the IVF tier instead
        (``enable_ivf_routing`` first): only shards owning the query's
        top-``probes`` lists are contacted, each runs its own local graph
        search, and their reranked top-k merge by score.  At ``probes =
        n_lists`` every member-owning shard is contacted, so results
        coincide with the full fan-out."""
        if scatter:
            return self._scatter_search(
                queries, ef=ef, k=k, probes=probes, filter=filter,
                registry=registry,
            )
        return search_sharded(
            self.snapshot(), queries, ef=ef, k=k, nav=nav, expand=expand,
            filter=filter,
        )
