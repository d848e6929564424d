"""Shadow ground-truth sampling: live recall estimation (DESIGN.md §14).

Latency SLOs are observable from the serving path itself; **recall** is
not — the engine never knows the exact answer it should have returned.
The probe layer bounds recall *indirectly* (green/amber/red bands over
bit-plane statistics), but the multi-stage-rerank literature and the
paper's own Table 7 show quality degrades *continuously* under
distribution shift: operators need a number, not a band.

A :class:`ShadowSampler` closes that gap the way production ranking
systems do — by re-answering a deterministic fraction of live traffic
exactly:

* **sampling** is a hash of the query bytes (``crc32(q) % rate == 0``,
  default ~1/256): stateless, deterministic (the same query is always
  in or always out, so replays and A/B runs sample identically), and
  tenant-fair (no tenant can be systematically unsampled).
* **offering** happens at result-scatter time in the engine and only
  copies the sampled rows into a bounded pending queue — O(sampled)
  host work on the serving path, nothing else.
* **draining** runs after the admission window is fully finalized and
  accounted: the pending queries re-run as exact float32 brute force
  (:func:`~repro_torch.core.baselines.flat_search` over the index's cold
  vector tier) and the served-vs-exact recall@k lands in the
  :class:`MetricsRegistry` labelled by tenant, plan nav kind, and
  escalation stage, in a bounded :class:`Ring` window, and — through
  :meth:`TenantLedger.observe_recall` — in the tenant's rolling
  recall-SLO account.

The shadow lane never competes with tenants: shadow queries are not
admitted through the token buckets, never join admission windows, and
their brute-force work happens strictly after every live result of the
window has been delivered and its latency recorded.

The port's copy of ``repro/obs/quality.py``: the ground truth runs on the
device of the index's vector tier, through the port's ``flat_search``.
The sampling key is the crc32 of the query's float32 bytes *as
submitted* (the host array a caller passed), so the port samples the
same rows as the reference.
"""

from __future__ import annotations

import collections
import zlib

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry, Ring, get_default_registry

DEFAULT_RATE = 256         # ~0.4% of live queries get exact ground truth
DEFAULT_WINDOW = 512       # rolling recall window (Ring size)
RECALL_BUCKETS = (0.1, 0.25, 0.5, 0.7, 0.8, 0.9, 0.95, 0.99, 1.0)
# ground-truth rows a brute-force batch (the reference pads its batches
# to (1, 8, 32, 64) rows to bound its jit shapes; the port compiles
# nothing, and each row's top-k is its own, so it runs the real rows)
_GT_BATCH = 64


def shadow_hash(query) -> int:
    """crc32 of the query's float32 bytes — the sampling key."""
    q = np.ascontiguousarray(np.asarray(query, dtype=np.float32))
    return zlib.crc32(q.tobytes())


def should_sample(query, rate: int = DEFAULT_RATE) -> bool:
    """Deterministic membership in the shadow sample: same query bytes,
    same decision, forever — no RNG state to coordinate or replay."""
    if rate <= 1:
        return True
    return shadow_hash(query) % rate == 0


class ShadowSampler:
    """Deterministic shadow sampling + exact recall@k accounting.

    ``index`` is anything with a float32 ``vectors`` tier (the exact
    ground truth is brute force over it).  ``ledger`` (optional) is a
    :class:`~repro_torch.obs.tenant.TenantLedger`: every drained recall
    measurement feeds the tenant's rolling recall-SLO window.  The
    sampler registers itself as ``index.shadow`` so
    ``memory_breakdown()`` can report its host-side bytes.
    """

    def __init__(
        self,
        index,
        *,
        rate: int = DEFAULT_RATE,
        k: int = 10,
        registry: MetricsRegistry | None = None,
        ledger=None,
        window: int = DEFAULT_WINDOW,
        max_pending: int = 4096,
    ):
        if getattr(index, "vectors", None) is None:
            raise ValueError(
                "shadow sampling needs the float32 vector tier for "
                "exact ground truth; this index is vector-free"
            )
        self.index = index
        self.rate = int(rate)
        self.k = int(k)
        self.ledger = ledger
        self.registry = (
            registry if registry is not None else get_default_registry()
        )
        self.seen = 0              # rows offered
        self.sampled = 0           # rows that hashed into the shadow
        self.drained = 0           # rows with ground truth computed
        self.backlog_dropped = 0   # overwritten before drain (bounded q)
        self.pending = collections.deque(maxlen=int(max_pending))
        self.recalls = Ring(int(window))
        self._h_recall = self.registry.histogram(
            "quiver_shadow_recall",
            "shadow-sampled recall@k of served results vs exact",
            labels=("tenant", "nav", "stage"),
            buckets=RECALL_BUCKETS, window=window,
        )
        self._c_sampled = self.registry.counter(
            "quiver_shadow_queries_total",
            "live queries sampled into the shadow lane",
            labels=("tenant",),
        )
        self._c_dropped = self.registry.counter(
            "quiver_shadow_backlog_dropped_total",
            "shadow samples overwritten before ground truth ran",
        )
        index.shadow = self

    # -- hot-path side ------------------------------------------------------

    def offer(self, queries, served_ids, *, tenant: str = "default",
              nav: str = "bq2", stage: str = "base") -> int:
        """Offer one request's served results for shadow sampling.

        Called at result-scatter time; copies only the rows whose bytes
        hash into the sample.  Returns how many rows were enqueued.
        """
        q = np.asarray(queries, dtype=np.float32)
        if q.ndim == 1:
            q = q[None]
        ids = np.asarray(served_ids)
        if ids.ndim == 1:
            ids = ids[None]
        taken = 0
        for row in range(q.shape[0]):
            self.seen += 1
            if not should_sample(q[row], self.rate):
                continue
            if len(self.pending) == self.pending.maxlen:
                self.backlog_dropped += 1
                self._c_dropped.inc()
            self.pending.append((
                q[row].copy(), ids[row, : self.k].copy(),
                tenant, nav, stage,
            ))
            self.sampled += 1
            taken += 1
            self._c_sampled.inc(tenant=tenant)
        return taken

    # -- off-hot-path side --------------------------------------------------

    def drain(self, max_rows: int | None = None) -> list[dict]:
        """Run exact ground truth for the pending shadow queries.

        Brute-force float32 top-k over the index's vector tier, in
        batches of ``_GT_BATCH`` rows.  Each measurement lands
        in the labelled recall histogram, the rolling window, and the
        tenant ledger; the records are returned for callers that want
        the raw stream (benchmarks, tests).
        """
        # lazy: the core modules record into repro_torch.obs.metrics,
        # whose package imports this module
        from repro_torch.core.baselines import flat_search

        out: list[dict] = []
        while self.pending and (max_rows is None or len(out) < max_rows):
            take = len(self.pending)
            if max_rows is not None:
                take = min(take, max_rows - len(out))
            take = min(take, _GT_BATCH)
            batch = [self.pending.popleft() for _ in range(take)]
            qs = np.stack([b[0] for b in batch])
            vectors = self.index.vectors
            exact_ids, _ = flat_search(
                vectors, qs, k=self.k, query_batch=_GT_BATCH,
                device=vectors.device,
            )
            for (_, served, tenant, nav, stage), truth in zip(
                batch, exact_ids
            ):
                hits = len(set(served.tolist()) & set(truth.tolist()))
                recall = hits / self.k
                self.drained += 1
                self.recalls.append(recall)
                self._h_recall.observe(
                    recall, tenant=tenant, nav=nav, stage=stage
                )
                if self.ledger is not None:
                    self.ledger.observe_recall(tenant, recall)
                out.append({
                    "tenant": tenant, "nav": nav, "stage": stage,
                    "recall": recall,
                })
        return out

    # -- reporting ----------------------------------------------------------

    def memory_bytes(self) -> int:
        """Host-side bytes: pending shadow copies + the recall window
        (reported through ``memory_breakdown()`` — see DESIGN.md §14)."""
        pending = sum(
            q.nbytes + ids.nbytes for q, ids, *_ in self.pending
        )
        return int(pending + self.recalls.maxlen * 8)

    def report(self) -> dict:
        return {
            "rate": self.rate,
            "k": self.k,
            "seen": self.seen,
            "sampled": self.sampled,
            "drained": self.drained,
            "pending": len(self.pending),
            "backlog_dropped": self.backlog_dropped,
            "recall_n": len(self.recalls),
            "recall_mean": (
                round(float(self.recalls.array().mean()), 4)
                if len(self.recalls) else None
            ),
            "recall_p50": (
                round(self.recalls.percentile(50), 4)
                if len(self.recalls) else None
            ),
            "recall_p10": (
                round(self.recalls.percentile(10), 4)
                if len(self.recalls) else None
            ),
            "memory_bytes": self.memory_bytes(),
        }
