"""Graph X-ray: structural health of the BQ-native topology (DESIGN.md §15).

The paper's central claim is that a 2-bit metric space can *define*
graph topology; §10's probe tests that claim on the corpus
*distribution* before building.  Nothing so far tests it on the built
*graph* — degree collapse, medoid unreachability, or BQ↔float32 edge
disagreement stay invisible until shadow recall (§14) has already
cratered.  This module computes a device-side
:class:`GraphHealthReport` straight from the adjacency arrays:

* **degree structure** — in/out-degree histograms and means over the
  live rows, plus the *saturation* ratio (rows at the full adjacency
  bound: no slack left for reverse edges, the churn-pressure signal);
* **reciprocity** — the fraction of directed edges whose reverse edge
  also exists.  Vamana's reverse-append keeps healthy graphs well
  above a few percent; a near-zero ratio means pruning degenerated the
  graph into directed chains;
* **medoid reachability** — a batched frontier BFS from the medoid
  over the full adjacency (tombstoned rows route, per the navigation
  semantics), reporting unreachable live rows and hop-radius
  percentiles (the descent-length distribution an entry point implies);
* **tombstone density** — dead/allocated on streaming indexes;
* **edge agreement** — the paper's topology question as a live gauge:
  re-rank a sample of adjacency lists in float32 cosine and measure
  the top-k overlap with the BQ ordering that *built* them.  When BQ
  and float32 disagree about which of a node's own edges are closest,
  greedy descent follows the wrong gradient.

All statistics summarize into a calibrated ``health_score`` in [0, 1]
and a green/amber/red ``verdict`` (:class:`GraphThresholds`), persist
through index save/load/freeze (same npz-merge idiom as the §10
probe), and band-cross through :class:`GraphHealthMonitor` into the
§14 remediation ladder (amber → consolidate/replan, red → flag for
rebuild-through-probe).

The port's copy of ``repro/obs/graph.py``.  The three device-side probes
are torch on the adjacency's device (the edge agreement's bq2 scores go
through the ``dist_rows`` kernel on the card); the report, its verdict
and the monitor are host-side numpy, as in the reference.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.obs.metrics import MetricsRegistry, get_default_registry

BANDS = ("green", "amber", "red")
_BAND_CODE = {b: i for i, b in enumerate(BANDS)}

# degree-histogram bucket upper edges (counts land host-side in the
# report and, when a registry is given, in quiver_graph_*_degree)
DEGREE_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64, 128)

# reciprocity is an O(N·R²) gather; fold it blockwise so the working
# set stays ~block·R² regardless of N
_RECIP_BLOCK = 512


@dataclasses.dataclass(frozen=True)
class GraphThresholds:
    """Verdict calibration for the structural statistics.

    Measured on the surrogate tiers at N=4000, m=16 (DESIGN.md §15):
    healthy contrastive builds read unreachable ≈ 0, reciprocity
    0.15-0.4, edge agreement 0.75-0.9; sign-collapsed corpora (the
    paper's Finding-1 red zone) build graphs whose sampled edge
    agreement drops under ~0.3 because every BQ distance ties.
    """

    unreachable_amber: float = 0.005  # >0.5% live rows off the medoid tree
    unreachable_red: float = 0.05
    agreement_amber: float = 0.55     # BQ vs f32 disagree on own edges
    agreement_red: float = 0.35
    tombstone_amber: float = 0.25     # consolidation overdue
    tombstone_red: float = 0.60
    reciprocity_amber: float = 0.02   # directed-chain degeneracy
    degree_amber: float = 0.25        # mean out-degree / bound collapse


DEFAULT_GRAPH_THRESHOLDS = GraphThresholds()

_FLOAT_FIELDS = (
    "out_degree_mean", "in_degree_mean", "saturation", "reciprocity",
    "unreachable_frac", "hop_p50", "hop_p99", "hop_max",
    "tombstone_density", "edge_agreement",
)
_INT_FIELDS = (
    "n_live", "n_allocated", "n_unreachable", "n_sampled",
    "degree_bound", "agreement_k", "seed",
)


@dataclasses.dataclass(frozen=True)
class GraphHealthReport:
    """One structural X-ray of a built graph (see module docstring).

    ``edge_agreement`` is NaN when the index has no float32 cold tier
    or no sampled row carries ``2 * agreement_k`` edges; the verdict
    then rests on the purely structural statistics.
    """

    n_live: int               # rows the stats describe
    n_allocated: int          # rows with adjacency state (>= n_live)
    degree_bound: int         # adjacency width (r + reverse slack)
    out_degree_mean: float    # live-row means
    in_degree_mean: float
    saturation: float         # live rows at the full degree bound
    reciprocity: float        # edges whose reverse edge exists
    n_unreachable: int        # live rows the medoid BFS never reached
    unreachable_frac: float
    hop_p50: float            # medoid hop-radius percentiles (reached)
    hop_p99: float
    hop_max: float
    tombstone_density: float  # dead / allocated
    edge_agreement: float     # sampled BQ vs f32 top-k edge overlap
    n_sampled: int            # rows in the agreement sample
    agreement_k: int
    seed: int
    out_degree_hist: tuple = ()   # counts per DEGREE_BUCKETS edge (+inf)
    in_degree_hist: tuple = ()
    thresholds: GraphThresholds = DEFAULT_GRAPH_THRESHOLDS

    # -- calibrated summary -------------------------------------------------

    def _cascade(self) -> tuple[str, str, float, float]:
        """(band, stat, value, threshold) of the worst tripped rule."""
        t = self.thresholds
        reds = (
            ("unreachable_frac", self.unreachable_frac, t.unreachable_red,
             self.unreachable_frac > t.unreachable_red),
            ("edge_agreement", self.edge_agreement, t.agreement_red,
             not math.isnan(self.edge_agreement)
             and self.edge_agreement < t.agreement_red),
            ("tombstone_density", self.tombstone_density, t.tombstone_red,
             self.tombstone_density > t.tombstone_red),
        )
        for stat, value, threshold, hit in reds:
            if hit:
                return "red", stat, value, threshold
        degree_frac = (
            self.out_degree_mean / self.degree_bound
            if self.degree_bound else 1.0
        )
        ambers = (
            ("unreachable_frac", self.unreachable_frac, t.unreachable_amber,
             self.unreachable_frac > t.unreachable_amber),
            ("edge_agreement", self.edge_agreement, t.agreement_amber,
             not math.isnan(self.edge_agreement)
             and self.edge_agreement < t.agreement_amber),
            ("tombstone_density", self.tombstone_density, t.tombstone_amber,
             self.tombstone_density > t.tombstone_amber),
            ("reciprocity", self.reciprocity, t.reciprocity_amber,
             self.reciprocity < t.reciprocity_amber),
            ("out_degree_mean", degree_frac, t.degree_amber,
             degree_frac < t.degree_amber),
        )
        for stat, value, threshold, hit in ambers:
            if hit:
                return "amber", stat, value, threshold
        return "green", "health_score", self.health_score, 1.0

    @property
    def verdict(self) -> str:
        return self._cascade()[0]

    def worst_stat(self) -> tuple[str, float, float]:
        """(stat, value, threshold) behind the current verdict."""
        _, stat, value, threshold = self._cascade()
        return stat, value, threshold

    @property
    def health_score(self) -> float:
        """Numeric summary in [0, 1]: the min of the per-statistic
        scores, each normalized so 1.0 is comfortably healthy and 0.0
        is at (or past) its red line.  A trend signal — the banded
        ``verdict`` is the actionable output."""
        t = self.thresholds

        def clip(x):
            return float(min(max(x, 0.0), 1.0))

        scores = [
            clip(1.0 - self.unreachable_frac / t.unreachable_red),
            clip(1.0 - self.tombstone_density / t.tombstone_red),
            clip(self.reciprocity / t.reciprocity_amber),
        ]
        if self.degree_bound:
            scores.append(clip(
                self.out_degree_mean / self.degree_bound / t.degree_amber
            ))
        if not math.isnan(self.edge_agreement):
            scores.append(clip(
                (self.edge_agreement - t.agreement_red)
                / (t.agreement_amber - t.agreement_red)
            ))
        return min(scores)

    def summary(self) -> str:
        stat, value, threshold = self.worst_stat()
        return (
            f"{self.verdict}: score={self.health_score:.2f} "
            f"{stat}={value:.3f} (threshold {threshold:g}) "
            f"unreachable={self.n_unreachable}/{self.n_live} "
            f"agreement@{self.agreement_k}={self.edge_agreement:.3f} "
            f"tombstones={self.tombstone_density:.2f}"
        )

    def to_dict(self) -> dict:
        out = {f: getattr(self, f) for f in _FLOAT_FIELDS + _INT_FIELDS}
        out["out_degree_hist"] = list(self.out_degree_hist)
        out["in_degree_hist"] = list(self.in_degree_hist)
        out["health_score"] = self.health_score
        out["verdict"] = self.verdict
        return out

    # -- persistence (merged into index npz archives) ----------------------

    def to_npz_fields(self, prefix: str = "graph_") -> dict:
        out = {
            prefix + name: np.float64(getattr(self, name))
            for name in _FLOAT_FIELDS
        }
        out.update({
            prefix + name: np.int64(getattr(self, name))
            for name in _INT_FIELDS
        })
        out[prefix + "out_degree_hist"] = np.asarray(
            self.out_degree_hist, dtype=np.int64)
        out[prefix + "in_degree_hist"] = np.asarray(
            self.in_degree_hist, dtype=np.int64)
        out[prefix + "thresholds"] = np.asarray(
            [getattr(self.thresholds, f.name)
             for f in dataclasses.fields(GraphThresholds)],
            dtype=np.float64,
        )
        return out

    @classmethod
    def from_npz(cls, z, prefix: str = "graph_"):
        """Rebuild from an index archive; None when it carries none."""
        if prefix + "out_degree_mean" not in z:
            return None
        kw = {
            name: float(z[prefix + name][()])
            for name in _FLOAT_FIELDS if prefix + name in z
        }
        kw.update(
            {name: int(z[prefix + name][()]) for name in _INT_FIELDS}
        )
        for name in ("out_degree_hist", "in_degree_hist"):
            if prefix + name in z:
                kw[name] = tuple(int(v) for v in z[prefix + name])
        th = z[prefix + "thresholds"]
        names = [f.name for f in dataclasses.fields(GraphThresholds)]
        kw["thresholds"] = GraphThresholds(
            **{n: float(v) for n, v in zip(names, th)}
        )
        return cls(**kw)


# -- device-side probes -----------------------------------------------------


def _structure_stats(adjacency, allocated, *, block=_RECIP_BLOCK):
    """(out_deg, in_deg, edges, reciprocal_edges) on the adjacency's
    device; the two counts stay device scalars until the caller reads them.

    Degrees count edges leaving allocated rows (targets may be
    tombstoned: they still route).  Reciprocity folds blockwise so the
    (block, R, R) back-edge gather bounds the working set (an unblocked
    gather at N = 100 000, R = 64 would be 1.6 GB).
    """
    n = adjacency.shape[0]
    valid = (adjacency >= 0) & allocated[:, None]
    out_deg = valid.sum(-1, dtype=torch.int32)
    in_deg = torch.bincount(adjacency[valid].long(), minlength=n).to(
        torch.int32)
    edges = valid.sum()
    recip = torch.zeros((), dtype=torch.int64, device=adjacency.device)
    for s in range(0, n, block):
        ids = torch.arange(s, min(s + block, n), device=adjacency.device)
        v = valid[s:s + block]
        t = torch.where(v, adjacency[s:s + block], 0)
        back = adjacency[t.long()]                     # (B, R, R)
        rec = (back == ids[:, None, None]).any(-1) & v
        recip += rec.sum()
    return out_deg, in_deg, edges, recip


def _medoid_bfs(adjacency, allocated, medoid, *, max_hops=64):
    """Hop distance from the medoid over the full adjacency, -1 when
    unreached.  A boolean frontier: each hop scatters the neighbours of
    the rows the last hop reached (the reference scatters those of every
    reached row; the rows it adds are the same), with one host check of
    ``new.any()`` a hop, until no row turns over or ``max_hops`` is hit.
    The scatter writes only True, so duplicate targets are harmless."""
    n = adjacency.shape[0]
    dist = torch.full((n,), -1, dtype=torch.int32, device=adjacency.device)
    dist[medoid] = 0
    frontier = dist == 0
    reached = frontier.clone()
    hop = 0
    while hop < max_hops:
        valid = (adjacency >= 0) & (frontier & allocated)[:, None]
        nbr = torch.zeros((n,), dtype=torch.bool, device=adjacency.device)
        nbr[adjacency[valid].long()] = True
        frontier = nbr & ~reached
        hop += 1
        if not bool(frontier.any()):
            break
        dist[frontier] = hop
        reached |= frontier
    return dist


def _edge_agreement(words, vectors, adjacency, sample_ids, *, dim, k):
    """Mean top-k overlap between the BQ and float32-cosine orderings of
    each sampled row's own adjacency list.  Rows are pre-filtered
    host-side to carry >= k live edges, so both top-k sets draw from
    real candidates only.

    The bq2 similarities are one ``dist_rows`` call (the sampled rows'
    words as queries, their (S, R) adjacency as ids: the ``bq_dist_rows``
    kernel on the card).  Integer scores tie often; ``lax.top_k`` gives
    a tie to the lower position, and so does a stable descending sort.
    """
    adj_s = adjacency[sample_ids]                  # (S, R)
    valid = adj_s >= 0
    tgt = torch.where(valid, adj_s, 0)
    sim_bq = dispatch.bq2_ops(dim, words.device).dist_rows(
        words[sample_ids], tgt, words)             # (S, R) int32
    neg = torch.tensor(-float("inf"), device=adjacency.device)
    score_bq = torch.where(valid, sim_bq.float(), neg)
    v = vectors / vectors.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    sim = torch.einsum("sd,srd->sr", v[sample_ids], v[tgt.long()])
    score_f32 = torch.where(valid, sim, neg)
    top_b = torch.sort(score_bq, dim=1, descending=True,
                       stable=True).indices[:, :k]
    top_f = torch.sort(score_f32, dim=1, descending=True,
                       stable=True).indices[:, :k]
    overlap = (top_b[:, :, None] == top_f[:, None, :]).any(-1)
    return overlap.float().mean(-1).mean()


# -- the report entry point -------------------------------------------------


def graph_health_report(
    adjacency,
    *,
    medoid: int,
    words=None,
    dim: int | None = None,
    vectors=None,
    live=None,
    allocated=None,
    sample: int = 256,
    agreement_k: int = 8,
    max_hops: int = 64,
    seed: int = 0,
    thresholds: GraphThresholds = DEFAULT_GRAPH_THRESHOLDS,
    registry: MetricsRegistry | None = None,
) -> GraphHealthReport:
    """Compute a :class:`GraphHealthReport` from raw index tensors.

    ``adjacency`` (and ``words``, ``vectors``) are tensors on one device,
    where the probes run; ``live``/``allocated`` are host bool arrays and
    default to all-rows (immutable snapshots); streaming indexes pass
    their masks so tombstoned rows route in the BFS but never count as
    unreachable.  ``words`` + ``dim`` + ``vectors`` arm the sampled
    edge-agreement probe (NaN without them).  Deterministic for a fixed
    ``seed`` (the sample is drawn by ``np.random.default_rng(seed)``).
    """
    n = int(adjacency.shape[0])
    degree_bound = int(adjacency.shape[1])
    live_h = (np.ones(n, bool) if live is None
              else np.asarray(live, bool).copy())
    alloc_h = (live_h.copy() if allocated is None
               else np.asarray(allocated, bool).copy())
    alloc_d = torch.from_numpy(alloc_h).to(adjacency.device)
    n_live = int(live_h.sum())
    n_alloc = int(alloc_h.sum())

    out_deg, in_deg, edges, recip = _structure_stats(adjacency, alloc_d)
    dist = _medoid_bfs(adjacency, alloc_d, int(medoid), max_hops=max_hops)
    out_deg = out_deg.cpu().numpy()
    in_deg = in_deg.cpu().numpy()
    dist = dist.cpu().numpy()
    edges, recip = int(edges), int(recip)

    live_out = out_deg[live_h]
    live_in = in_deg[live_h]
    reached = (dist >= 0) & live_h
    hops = dist[reached]
    n_unreachable = int(n_live - reached.sum())
    edges_hist = list(DEGREE_BUCKETS) + [np.inf]

    agreement = float("nan")
    sampled_ids = np.zeros(0, np.int64)
    if words is not None and vectors is not None and n_live:
        # a row whose degree is exactly k makes both top-k sets the whole
        # candidate list (overlap trivially 1.0) — require 2k edges so the
        # two orderings have real choices to disagree about
        eligible = np.nonzero(live_h & (out_deg >= 2 * agreement_k))[0]
        if len(eligible):
            rng = np.random.default_rng(seed)
            take = min(int(sample), len(eligible))
            sampled_ids = np.sort(
                rng.choice(eligible, size=take, replace=False))
            agreement = float(_edge_agreement(
                words, vectors, adjacency,
                torch.from_numpy(sampled_ids).to(adjacency.device),
                dim=int(dim), k=int(agreement_k),
            ))

    report = GraphHealthReport(
        n_live=n_live,
        n_allocated=n_alloc,
        degree_bound=degree_bound,
        out_degree_mean=float(live_out.mean()) if n_live else 0.0,
        in_degree_mean=float(live_in.mean()) if n_live else 0.0,
        saturation=(
            float((live_out == degree_bound).mean()) if n_live else 0.0),
        reciprocity=float(recip / edges) if edges else 0.0,
        n_unreachable=n_unreachable,
        unreachable_frac=(n_unreachable / n_live) if n_live else 0.0,
        hop_p50=float(np.percentile(hops, 50)) if len(hops) else 0.0,
        hop_p99=float(np.percentile(hops, 99)) if len(hops) else 0.0,
        hop_max=float(hops.max()) if len(hops) else 0.0,
        tombstone_density=(
            1.0 - n_live / n_alloc if n_alloc else 0.0),
        edge_agreement=agreement,
        n_sampled=len(sampled_ids),
        agreement_k=int(agreement_k),
        seed=int(seed),
        out_degree_hist=tuple(
            int(c) for c in np.histogram(live_out, bins=edges_hist)[0]),
        in_degree_hist=tuple(
            int(c) for c in np.histogram(live_in, bins=edges_hist)[0]),
        thresholds=thresholds,
    )

    reg = registry if registry is not None else get_default_registry()
    for name, vals in (("out", live_out), ("in", live_in)):
        h = reg.histogram(
            f"quiver_graph_{name}_degree",
            f"live-row {name}-degree distribution at last health probe",
            buckets=DEGREE_BUCKETS[1:], window=0,
        )
        h.observe_many(vals)
    return report


# -- the monitor ------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GraphHealthAlarm:
    """One structural band-crossing (worsenings only, like drift)."""

    tenant: str
    prev_band: str
    band: str
    stat: str
    value: float
    threshold: float
    health_score: float
    n_live: int
    unix_ts: float

    def message(self) -> str:
        return (
            f"[graph] tenant={self.tenant} {self.prev_band}->{self.band} "
            f"{self.stat}={self.value:.3f} (threshold {self.threshold:g}, "
            f"score={self.health_score:.2f}, n_live={self.n_live})"
        )


class GraphHealthMonitor:
    """Edge-triggered banding over successive :class:`GraphHealthReport`s.

    The structural twin of :class:`~repro_torch.obs.drift.DriftMonitor`:
    arming asserts a healthy baseline (first check already amber/red
    alarms immediately), band *worsenings* raise a
    :class:`GraphHealthAlarm` through ``subscribe()`` (the hook
    :class:`~repro_torch.obs.remediate.RemediationPolicy.attach_graph` uses)
    and recoveries update state silently.  Gauges track the latest
    score/band plus the score delta between consecutive checks — the
    per-consolidation-cycle health delta.
    """

    def __init__(
        self,
        *,
        tenant: str = "default",
        registry: MetricsRegistry | None = None,
        max_events: int = 256,
        clock=time.time,
    ):
        self.tenant = tenant
        self.clock = clock
        self.band = None                # unknown until first check()
        self.last_report: GraphHealthReport | None = None
        self.last_score: float | None = None
        self.alarms: list[GraphHealthAlarm] = []
        self.events = collections.deque(maxlen=max_events)
        self._subs: list = []
        reg = registry if registry is not None else get_default_registry()
        self._c_alarms = reg.counter(
            "quiver_graph_health_alarms_total",
            "graph-health band-crossing alarms",
            labels=("tenant", "band"),
        )
        self._g_score = reg.gauge(
            "quiver_graph_health_score",
            "latest structural health score [0, 1]", labels=("tenant",),
        )
        self._g_band = reg.gauge(
            "quiver_graph_health_band",
            "latest graph band (0=green 1=amber 2=red)",
            labels=("tenant",),
        )
        self._g_delta = reg.gauge(
            "quiver_graph_health_delta",
            "health-score delta vs the previous check (per cycle)",
            labels=("tenant",),
        )

    def subscribe(self, fn) -> None:
        """Register ``fn(alarm)`` for every raised alarm."""
        self._subs.append(fn)

    def check(self, report: GraphHealthReport) -> GraphHealthAlarm | None:
        """Band a fresh report; raise on a band *worsening* only."""
        band = report.verdict
        score = report.health_score
        self._g_score.set(score, tenant=self.tenant)
        self._g_band.set(_BAND_CODE[band], tenant=self.tenant)
        if self.last_score is not None:
            self._g_delta.set(score - self.last_score, tenant=self.tenant)
        self.last_report, self.last_score = report, score
        prev, self.band = self.band, band
        if prev is None:
            prev = "green"      # arming asserts a healthy baseline
        if band == prev:
            return None
        stat, value, threshold = report.worst_stat()
        event = GraphHealthAlarm(
            tenant=self.tenant, prev_band=prev, band=band, stat=stat,
            value=value, threshold=threshold, health_score=score,
            n_live=report.n_live, unix_ts=self.clock(),
        )
        self.events.append(event)
        if _BAND_CODE[band] > _BAND_CODE[prev]:
            self.alarms.append(event)
            self._c_alarms.inc(tenant=self.tenant, band=band)
            for fn in list(self._subs):
                fn(event)
            return event
        return None

    def report(self) -> dict:
        return {
            "tenant": self.tenant,
            "band": self.band,
            "health_score": self.last_score,
            "alarms": len(self.alarms),
            "events": [dataclasses.asdict(e) for e in self.events],
            "last_report": (
                self.last_report.to_dict() if self.last_report else None
            ),
        }
