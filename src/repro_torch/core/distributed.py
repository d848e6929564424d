"""Sharded QuIVer: the paper's index as a fleet of S shards.

Counterpart of ``repro/core/distributed.py``.  Fleet layout (DESIGN.md §3):

* base vectors are range-partitioned into S shards, each with its own
  BQ-native Vamana graph, built with no cross-shard dependency;
* a query fans out to every shard, runs the local beam search and the
  local float32 rerank there, and the per-shard top-k are gathered and
  merged: one (k ids, k scores) pair per shard;
* a list-partitioned fleet (DESIGN.md §13) places whole IVF lists on
  shards and scatters each query only to the shards owning its top-p
  lists, at most min(p, S) of them.

The reference is one controller driving S devices through ``shard_map``;
the port keeps that shape without a collective library.  One process
holds every shard; each shard's tensors live on that shard's device
(``device=None``: every shard on the CUDA card; a sequence of S devices
places shard s on ``device[s]``).  Shards run one after another, and the
gather copies each shard's (Q, k) ids and scores to the first shard's
device, laid out shard-major as ``all_gather`` lays them out.

Each shard searches in the metric space its graph was built in: the
backend comes from ``repro_torch.core.metric`` over the shard's own
tensors, so every distance goes through the kernel dispatch.  Nothing is
compiled, so the reference's jit caches have no counterpart here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bq
from repro_torch.core.beam import INF, beam_search
from repro_torch.core.index import QuIVerIndex, as_float32, rerank_f32
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
    Label,
    entry_label,
    estimate_selectivity,
    eval_mask,
    validate,
    widened_ef,
)
from repro_torch.ivf import build_partition, record_routes, top_lists
from repro_torch.kernels import dispatch
from repro_torch.probe import (
    CompatibilityReport,
    NavPolicy,
    merge_reports,
    probe_corpus,
    select_policy,
)

# rows of one beam search: bounds the (rows, n) visited mask of a shard
_QUERY_CHUNK = 1024


def shard_devices(device, n_shards: int) -> list[torch.device]:
    """One device a shard: ``None`` (the CUDA card) or one device for
    every shard, else a sequence of ``n_shards`` devices."""
    if device is None or isinstance(device, (str, torch.device)):
        return [resolve_device(device)] * n_shards
    devices = [resolve_device(d) for d in device]
    if len(devices) != n_shards:
        raise ValueError(f"{len(devices)} devices for {n_shards} shards")
    return devices


@dataclasses.dataclass
class ShardedIndex:
    """Per-shard index tensors, each tuple holding one entry a shard.

    The reference stacks these on a leading shard axis; here shard s's
    tensors live on its own device.  ``live`` is the per-shard validity
    mask: padding fill from an indivisible partition and streaming
    tombstones are both False and are excluded from search results
    before the merge.  ``label_words`` / ``label_entries`` (optional)
    carry the per-shard filtered-search state: a filtered query's
    predicate is evaluated per shard and pushed down into the fan-out as
    the beam's ``result_valid`` mask.
    """

    sig_words: tuple          # S x (n, 2W) int32
    adjacency: tuple          # S x (n, R+slack) int32
    medoids: np.ndarray       # (S,) int32
    vectors: tuple            # S x (n, D) float32 (cold)
    dim: int
    metric: str = "bq2"       # metric kind the shards were built in
    live: tuple | None = None          # S x (n,) bool; None == all live
    label_words: tuple | None = None   # S x (n, W_l) int32
    n_labels: int = 0
    label_entries: np.ndarray | None = None   # (S, n_labels) int32, -1
    label_counts: np.ndarray | None = None    # (n_labels,) fleet-wide
    # the fleet-wide merged probe report and the nav policy every shard
    # was built under (``build_sharded(metric="auto")``)
    policy: NavPolicy | None = None
    report: CompatibilityReport | None = None
    # each shard's BuildStats (``build_sharded``), None otherwise
    build_stats: tuple | None = None

    @property
    def n_shards(self) -> int:
        return len(self.sig_words)

    @property
    def n_per_shard(self) -> int:
        return int(self.sig_words[0].shape[0])

    @property
    def devices(self) -> list[torch.device]:
        return [w.device for w in self.sig_words]


def build_sharded(vectors, n_shards: int,
                  params: BuildParams | None = None,
                  *, metric: str = "bq2",
                  labels=None, n_labels: int | None = None,
                  label_entry_min: int = 32, device=None) -> ShardedIndex:
    """Partition + per-shard build.

    Indivisible N is handled by padding the last shard with repeats of
    the leading vectors: the fill nodes take part in their shard's graph
    but are masked out of every search result by ``live``, so all N
    input vectors, and only those, are retrievable.

    ``labels`` (optional, one int or iterable of ints per vector) gives
    each shard a label store over its slice and per-label entry points
    (``label_entry_min`` member floor); pad rows inherit the repeated
    vectors' labels but stay masked.  ``metric="auto"`` probes each
    shard's slice (seed = shard index), merges the reports fleet-wide
    and builds every shard under the one policy the merged verdict
    selects.  ``device``: see :func:`shard_devices`.
    """
    params = params or BuildParams()
    devices = shard_devices(device, n_shards)
    arr = np.asarray(vectors)
    n = len(arr)
    per = -(-n // n_shards)                      # ceil division
    pad = per * n_shards - n
    if pad:
        arr = np.concatenate([arr, arr[:pad]], axis=0)
    parts = arr.reshape(n_shards, per, arr.shape[-1])
    live = (np.arange(n_shards * per) < n).reshape(n_shards, per)
    policy = report = None
    if metric == "auto":
        # the last shard's pad fill repeats leading vectors: a < 1-shard
        # bias on fleet statistics, as on the label popcounts below
        report = merge_reports([
            probe_corpus(parts[s], seed=s, device=devices[s])
            for s in range(n_shards)
        ])
        policy = select_policy(report)
        metric = policy.nav
    label_parts = None
    if labels is not None:
        if len(labels) != n:
            raise ValueError(f"{len(labels)} label rows for {n} vectors")
        labels = list(labels)
        if n_labels is None:
            flat = [x for item in labels for x in (
                (item,) if np.isscalar(item) else tuple(item))]
            n_labels = int(max(flat)) + 1 if flat else 1
        label_parts = [
            (labels + labels[:pad])[s * per:(s + 1) * per]
            for s in range(n_shards)
        ]
    words, adjs, meds, vecs, lives, stats = [], [], [], [], [], []
    lwords, lentries, lcounts = [], [], []
    for s in range(n_shards):
        idx = QuIVerIndex.build(parts[s], params, metric=metric,
                                device=devices[s])
        if label_parts is not None:
            store = idx.attach_labels(label_parts[s], n_labels=n_labels)
            idx.build_label_entries(min_count=label_entry_min)
            lwords.append(store.words)
            lentries.append(store.entries)
            lcounts.append(store.counts)
        words.append(idx.sigs.words)
        adjs.append(idx.adjacency)
        meds.append(idx.medoid)
        vecs.append(idx.vectors)
        stats.append(idx.build_stats)
        lives.append(torch.from_numpy(live[s]).to(devices[s]))
    return ShardedIndex(
        sig_words=tuple(words),
        adjacency=tuple(adjs),
        medoids=np.asarray(meds, dtype=np.int32),
        vectors=tuple(vecs),
        dim=arr.shape[-1],
        metric=metric,
        live=tuple(lives),
        label_words=tuple(lwords) if lwords else None,
        n_labels=n_labels or 0,
        label_entries=np.stack(lentries) if lentries else None,
        # fleet-wide popcounts for selectivity routing (pad fill rows
        # inflate these by < 1 shard's worth: estimates, not truth)
        label_counts=np.sum(lcounts, axis=0) if lcounts else None,
        policy=policy,
        report=report,
        build_stats=tuple(stats),
    )


def local_search(index: ShardedIndex, s: int, q_repr, queries, *, ef: int,
                 k: int, nav: str, start: int, result_valid=None,
                 expand: int = 1):
    """Shard ``s``'s beam search and float32 rerank for queries already
    on its device; returns its (Q, k) global ids (-1 where there is no
    result) and cosine scores.  ``live`` and ``result_valid`` restrict
    what is returned, never what is traversed."""
    backend = make_backend(nav, MetricArrays(
        sigs=bq.Signature(words=index.sig_words[s], dim=index.dim),
        vectors=index.vectors[s],
    ))
    n = index.n_per_shard
    live = index.live[s] if index.live is not None else None
    res = beam_search(
        q_repr, index.adjacency[s], start, dist_fn=backend.dist_many,
        ef=ef, n=n, expand=expand, node_valid=live,
        result_valid=result_valid,
    )
    ids, scores = rerank_f32(res.ids, queries, index.vectors[s], k)
    return torch.where(ids >= 0, ids + s * n, -1), scores


def fan_out(index: ShardedIndex, q_repr, queries, *, ef: int, k: int,
            nav: str, starts, result_valid=None, expand: int = 1):
    """Every shard's local search, gathered on the first shard's device
    shard-major and merged: the reference's ``make_sharded_search`` step.
    The merge's stable sort gives a tie to the lower flat index, as
    ``lax.top_k`` does.  ``result_valid`` is one (n,) mask a shard, or
    None."""
    home = index.devices[0]
    all_ids, all_scores = [], []
    for s, dev in enumerate(index.devices):
        ids, scores = local_search(
            index, s, q_repr.to(dev), queries.to(dev), ef=ef, k=k, nav=nav,
            start=int(starts[s]), expand=expand,
            result_valid=(result_valid[s] if result_valid is not None
                          else None),
        )
        all_ids.append(ids.to(home))
        all_scores.append(scores.to(home))
    scores, pos = torch.sort(torch.cat(all_scores, dim=1), dim=1,
                             descending=True, stable=True)
    return torch.cat(all_ids, dim=1).gather(1, pos[:, :k]), scores[:, :k]


def sharded_count_fn(index: ShardedIndex):
    """``label -> member popcount`` across all shards.

    Uses the precomputed ``label_counts`` carried by the index (kept
    fresh by ``build_sharded`` / ``StreamingShardedIndex.snapshot``);
    falls back to a per-label device popcount over the live rows for
    hand-assembled indexes, cached for the lifetime of the closure.
    """
    if index.label_counts is not None:
        counts = index.label_counts
        return lambda label: int(counts[label])
    cache: dict[int, int] = {}

    def count(label: int) -> int:
        if label not in cache:
            total = 0
            for s, words in enumerate(index.label_words):
                member = eval_mask(words, Label(label))
                if index.live is not None:
                    member = member & index.live[s]
                total += int(member.sum())
            cache[label] = total
        return cache[label]

    return count


def search_sharded(index: ShardedIndex, queries, *, ef: int = 64,
                   k: int = 10, nav: str | None = None, expand: int = 1,
                   filter=None,
                   selectivity_floor: float = DEFAULT_SELECTIVITY_FLOOR):
    """Encode the queries, fan out to every shard, merge; returns
    ((Q, k) global ids, (Q, k) cosine scores) as numpy arrays.

    ``nav`` defaults to the metric the shards were built in; an
    auto-built fleet applies its :class:`NavPolicy` ``ef_scale`` when
    ``nav`` is left unset (per-query escalation is a single-index
    feature: at fleet scale the static schedule rides the one fan-out).

    ``filter`` (a label predicate) is pushed down per shard: the
    predicate mask over each shard's label words is the local beam's
    ``result_valid``, ``ef`` widens by the popcount-estimated
    selectivity over the live count, and each shard starts from its own
    per-label entry point where it has one, else its medoid.  Every shard
    contributes only matching live ids to the merge.
    """
    sched = index.policy if nav is None else None
    if sched is not None:
        ef = ef * sched.ef_scale
    nav = nav or index.metric
    home = index.devices[0]
    q = normalize(as_float32(queries, home))
    q_repr = encode_queries_for(nav, q)
    starts = index.medoids
    result_valid = None
    ef_run = ef
    if filter is not None:
        if index.label_words is None:
            raise ValueError(
                "filtered sharded search needs label_words (build with "
                "labels= or snapshot a labeled streaming index)"
            )
        expr = validate(filter, index.n_labels)
        count_fn = sharded_count_fn(index)
        n_live = (sum(int(m.sum()) for m in index.live)
                  if index.live is not None
                  else index.n_shards * index.n_per_shard)
        sel = estimate_selectivity(expr, count_fn, n_live)
        result_valid = [eval_mask(w, expr) for w in index.label_words]
        ef_run = widened_ef(ef, sel, selectivity_floor, index.n_per_shard)
        lbl = entry_label(expr, count_fn)
        if lbl is not None and index.label_entries is not None:
            ent = index.label_entries[:, lbl]
            starts = np.where(ent >= 0, ent, starts).astype(np.int32)
    out_ids, out_scores = [], []
    for c in range(0, q.shape[0], _QUERY_CHUNK):
        ids, scores = fan_out(
            index, q_repr[c:c + _QUERY_CHUNK], q[c:c + _QUERY_CHUNK],
            ef=ef_run, k=k, nav=nav, starts=starts,
            result_valid=result_valid, expand=expand,
        )
        out_ids.append(ids.cpu().numpy())
        out_scores.append(scores.cpu().numpy())
    return np.concatenate(out_ids), np.concatenate(out_scores)


# -- IVF targeted scatter (DESIGN.md §13) ---------------------------------
#
# The coarse lists double as the fleet's shard unit: whole inverted lists
# are placed on shards (greedy balance by population), the small centroid
# tier is replicated on the controller, and a query is scattered only to
# the shards owning its top-p lists.  The scatter is host-driven: routing
# on the controller, one step per contacted shard over its own tensors.


@dataclasses.dataclass
class IVFShard:
    """One shard's slice of a list-partitioned corpus."""

    sig_words: torch.Tensor   # (n_s, 2W) int32
    vectors: torch.Tensor     # (n_s, D) float32 (cold/rerank tier)
    ids: np.ndarray           # (n_s,) int32 global corpus ids
    list_ids: torch.Tensor    # (L_s, cap_s) int32 LOCAL slots, -1 pad
    lists: np.ndarray         # (L_s,) int32 global list ids owned


@dataclasses.dataclass
class IVFShardedIndex:
    """List-partitioned fleet: the routing tier on the controller plus
    per-shard member slices.  ``list_shard``/``list_local`` map a global
    list id to (owning shard, local list index): the scatter's routing
    table."""

    cent_words: torch.Tensor  # (L, 2W) int32, on the controller
    list_shard: np.ndarray    # (L,) int32 owning shard per list
    list_local: np.ndarray    # (L,) int32 local index within owner
    shards: tuple             # tuple[IVFShard, ...]
    dim: int
    default_probes: int

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def n_lists(self) -> int:
        return int(self.cent_words.shape[0])


def place_lists(counts: np.ndarray, n_shards: int) -> np.ndarray:
    """Greedy balance: lists in descending population order each go to
    the currently lightest shard; returns the (L,) owning shard."""
    order = np.argsort(-counts, kind="stable")
    load = np.zeros(n_shards, dtype=np.int64)
    list_shard = np.empty(len(counts), dtype=np.int32)
    for lst in order:
        s = int(np.argmin(load))
        list_shard[lst] = s
        load[s] += counts[lst]
    return list_shard


def build_ivf_sharded(vectors, n_shards: int, *,
                      n_lists: int | None = None, seed: int = 0,
                      device=None) -> IVFShardedIndex:
    """Partition by coarse list, then place whole lists on shards.

    The vectors are normalized with numpy on the host, as the reference
    does, then encoded; one global :func:`repro_torch.ivf.build_partition`
    runs on the first shard's device.  A list never spans shards (that is
    what makes the scatter targeted), so shard loads stay within one
    max-list of each other.  ``device``: see :func:`shard_devices`; the
    routing tier stays on the first shard's device.
    """
    v = np.asarray(vectors, dtype=np.float32)
    v = v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
    devices = shard_devices(device, n_shards)
    home = devices[0]
    sigs = bq.encode(torch.from_numpy(v).to(home))
    part = build_partition(sigs, n_lists=n_lists, seed=seed)
    L = part.n_lists
    n_shards = max(1, min(n_shards, L))
    devices = devices[:n_shards]
    list_shard = place_lists(np.diff(part.offsets), n_shards)
    list_local = np.empty(L, dtype=np.int32)

    shards = []
    for s, dev in enumerate(devices):
        owned = np.nonzero(list_shard == s)[0].astype(np.int32)
        list_local[owned] = np.arange(owned.size, dtype=np.int32)
        chunks = [part.member_ids[part.offsets[lst]:part.offsets[lst + 1]]
                  for lst in owned]
        ids = (np.concatenate(chunks) if chunks
               else np.empty((0,), np.int32)).astype(np.int32)
        cap = max(8, int(-(-max((len(c) for c in chunks), default=1)
                           // 8) * 8))
        local = np.full((max(owned.size, 1), cap), -1, dtype=np.int32)
        pos = 0
        for i, chunk in enumerate(chunks):
            local[i, :len(chunk)] = np.arange(pos, pos + len(chunk),
                                              dtype=np.int32)
            pos += len(chunk)
        rows = ids if ids.size else np.zeros((1,), np.int32)
        shards.append(IVFShard(
            sig_words=sigs.words[torch.from_numpy(rows).to(home).long()]
            .to(dev),
            vectors=torch.from_numpy(v[ids] if ids.size else v[:1] * 0.0)
            .to(dev),
            ids=ids,
            list_ids=torch.from_numpy(local).to(dev),
            lists=owned,
        ))
    return IVFShardedIndex(
        cent_words=part.cent_words,
        list_shard=list_shard,
        list_local=list_local,
        shards=tuple(shards),
        dim=v.shape[-1],
        default_probes=part.default_probes,
    )


def ivf_shard_step(shard: IVFShard, dim: int, probe_local, reprs, queries,
                   *, ef: int, k: int):
    """One contacted shard's step: score the members of its probed lists
    (``probe_local`` (Q, p) local list indexes, -1 where another shard
    owns the list), keep the best ``ef`` in bq2 space (ties to the lower
    position, as ``lax.top_k``) and rerank them in float32."""
    backend = make_backend("bq2", MetricArrays(
        sigs=bq.Signature(words=shard.sig_words, dim=dim),
        vectors=shard.vectors,
    ))
    cap = shard.list_ids.shape[1]
    mem = shard.list_ids[probe_local.clamp_min(0).long()].reshape(
        probe_local.shape[0], -1)
    valid = (probe_local >= 0).repeat_interleave(cap, dim=1) & (mem >= 0)
    d = backend.dist_many(reprs, mem.clamp_min(0))
    d = torch.where(valid, d, INF)
    ef_eff = min(ef, mem.shape[1])
    dists, pos = torch.sort(d, dim=1, stable=True)
    ids = mem.gather(1, pos[:, :ef_eff])
    ids = torch.where(dists[:, :ef_eff] < INF / 2, ids, -1)
    return rerank_f32(ids, queries, shard.vectors, k)


def merge_host(all_ids: np.ndarray, all_scores: np.ndarray, k: int):
    """Merge (Q, S, k) per-shard results on the host with the reference's
    own call (numpy's default sort, so ties fall as they do there)."""
    nq = all_ids.shape[0]
    flat_ids = all_ids.reshape(nq, -1)
    flat_scores = all_scores.reshape(nq, -1)
    order = np.argsort(-flat_scores, axis=-1)[:, :k]
    out_scores = np.take_along_axis(flat_scores, order, axis=-1)
    out_ids = np.take_along_axis(flat_ids, order, axis=-1)
    out_ids[~np.isfinite(out_scores)] = -1
    return out_ids, out_scores


def search_ivf_sharded(index: IVFShardedIndex, queries, *, k: int = 10,
                       ef: int = 64, probes: int | None = None,
                       broadcast: bool = False, registry=None):
    """Targeted scatter over the list-partitioned fleet.

    Routes each query on the centroid tier, contacts only the shards
    owning its top-p lists (at most min(p, S) of them) and merges the
    per-shard reranked top-k by cosine score.  ``broadcast=True`` sends
    every query to every shard (non-probed lists stay masked out): the
    all-shard baseline the targeted path is held equal to.  Per-list
    route counters and the shards-contacted histogram land on
    ``registry`` (default: the process registry).  Returns (global ids
    (Q, k), cosine scores (Q, k)).
    """
    home = index.cent_words.device
    q = as_float32(queries, home)
    if q.ndim == 1:
        q = q[None]
    q = normalize(q)
    nq = q.shape[0]
    reprs = encode_queries_for("bq2", q)
    p = probes or index.default_probes
    p = max(1, min(p, index.n_lists))

    ops = dispatch.list_scan_ops(index.dim, home)
    top = top_lists(ops.scan, reprs, index.cent_words, p).cpu().numpy()
    shard_of = index.list_shard[top]                       # (Q, p)
    contacted = np.array([len(np.unique(row)) for row in shard_of])
    record_routes(top, contacted, registry=registry)

    all_ids = np.full((nq, index.n_shards, k), -1, dtype=np.int64)
    all_scores = np.full((nq, index.n_shards, k), -np.inf, dtype=np.float32)
    for s, shard in enumerate(index.shards):
        if broadcast:
            rows = np.arange(nq)
        else:
            rows = np.nonzero((shard_of == s).any(axis=-1))[0]
        if rows.size == 0 or shard.ids.size == 0:
            continue                     # targeted: shard never contacted
        sub = top[rows]
        probe_local = np.where(index.list_shard[sub] == s,
                               index.list_local[sub], -1).astype(np.int32)
        dev = shard.sig_words.device
        take = torch.from_numpy(rows).to(home)
        ids, scores = ivf_shard_step(
            shard, index.dim, torch.from_numpy(probe_local).to(dev),
            reprs[take].to(dev), q[take].to(dev), ef=ef, k=k,
        )
        ids, scores = ids.cpu().numpy(), scores.cpu().numpy()
        all_ids[rows, s] = np.where(ids >= 0, shard.ids[np.maximum(ids, 0)],
                                    -1)
        all_scores[rows, s] = np.where(ids >= 0, scores, -np.inf)
    return merge_host(all_ids, all_scores, k)
