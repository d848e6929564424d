"""Labelled metrics primitives: counters, gauges, fixed-bucket histograms.

The serving hot path (``serve/engine.py``, ``plan/cache.py``) records a
handful of numbers per admission window; everything here is shaped so
that recording is allocation-cheap:

* metric instances hold a flat dict keyed by label-*value* tuples —
  recording with the same labels touches one dict slot, no string
  formatting, no per-event objects;
* histograms are **fixed-bucket**: one ``np.searchsorted`` against a
  static boundary array plus an integer bump (cumulative rendering is
  done at scrape/emit time, never on the hot path);
* recent raw observations ride a :class:`Ring` — a bounded numpy ring
  buffer — so window percentiles (p50/p99 over the *last W* events, the
  SLO number) are available without unbounded growth.  The same class
  replaces the append-forever latency list ``EngineStats`` used to keep.

A :class:`MetricsRegistry` is the unit of isolation: one per process for
serving (``get_default_registry``), fresh ones in tests.  Registries
render to plain dicts (``snapshot``) for the JSONL/stdout sinks and to
Prometheus text exposition (``repro.obs.sinks.render_prometheus``).

Import-cycle-free on purpose (stdlib + numpy only).  This is the port's
own copy of ``repro/obs/metrics.py``; the port's build records its
``quiver_build_*`` histograms into it.
"""

from __future__ import annotations

import threading

import numpy as np

# latency-flavored defaults: 100us .. 10s, roughly log-spaced (seconds)
DEFAULT_BUCKETS = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class Ring:
    """Bounded float ring buffer with window percentiles.

    Appending past capacity overwrites the oldest entry — a
    long-running engine keeps the last ``size`` observations, O(size)
    memory forever, and percentiles are computed over that window.
    """

    __slots__ = ("_buf", "_count", "_head")

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"ring size must be >= 1, got {size}")
        self._buf = np.zeros((size,), dtype=np.float64)
        self._count = 0          # total ever appended
        self._head = 0           # next write slot

    @property
    def maxlen(self) -> int:
        return len(self._buf)

    @property
    def total(self) -> int:
        """Observations ever appended (>= len once the ring wraps)."""
        return self._count

    def append(self, value: float) -> None:
        self._buf[self._head] = value
        self._head = (self._head + 1) % len(self._buf)
        self._count += 1

    def extend(self, values) -> None:
        for v in np.asarray(values, dtype=np.float64).ravel():
            self.append(float(v))

    def __len__(self) -> int:
        return min(self._count, len(self._buf))

    def array(self) -> np.ndarray:
        """The window's values (unordered; percentiles don't care)."""
        return self._buf[: len(self)].copy()

    def percentile(self, q) -> float | None:
        if len(self) == 0:
            return None
        return float(np.percentile(self._buf[: len(self)], q))


def latency_summary(ring: Ring, quantiles=(50, 99)) -> dict:
    """``{"p<q>_ms": ...}`` from a Ring of *seconds*.

    The one place window percentiles become report fields — the serve
    engine's ``stats_report`` and the tenant ledger used to each carry
    their own copy of this scale-and-round.  Empty windows report
    ``None`` for every quantile (absence of evidence, not 0ms).
    """
    out = {}
    for q in quantiles:
        v = ring.percentile(q)
        out[f"p{int(q)}_ms"] = None if v is None else round(v * 1e3, 3)
    return out


def _label_key(label_names, labels: dict) -> tuple:
    if set(labels) != set(label_names):
        raise ValueError(
            f"expected labels {label_names}, got {tuple(labels)}"
        )
    return tuple(str(labels[n]) for n in label_names)


class _Metric:
    """Shared bookkeeping: name, help text, declared label names."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labels: tuple = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self._series: dict = {}
        self._lock = threading.Lock()

    def _slot(self, labels: dict, factory):
        key = _label_key(self.label_names, labels)
        slot = self._series.get(key)
        if slot is None:
            with self._lock:
                slot = self._series.setdefault(key, factory())
        return slot

    def series(self) -> dict:
        """{label-value tuple: raw series state} (rendering input)."""
        return dict(self._series)

    def labelled(self, key: tuple) -> dict:
        return dict(zip(self.label_names, key))


class Counter(_Metric):
    """Monotonic counter; ``inc`` only moves forward."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError("counters only go up")
        slot = self._slot(labels, lambda: [0.0])
        slot[0] += value

    def value(self, **labels) -> float:
        key = _label_key(self.label_names, labels)
        slot = self._series.get(key)
        return slot[0] if slot else 0.0


class Gauge(_Metric):
    """Point-in-time value (set/add)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        slot = self._slot(labels, lambda: [0.0])
        slot[0] = float(value)

    def add(self, value: float, **labels) -> None:
        slot = self._slot(labels, lambda: [0.0])
        slot[0] += value

    def value(self, **labels) -> float:
        key = _label_key(self.label_names, labels)
        slot = self._series.get(key)
        return slot[0] if slot else 0.0


class _HistSeries:
    __slots__ = ("counts", "sum", "count", "ring")

    def __init__(self, n_buckets: int, window: int):
        # one overflow slot past the last boundary (+Inf bucket)
        self.counts = np.zeros((n_buckets + 1,), dtype=np.int64)
        self.sum = 0.0
        self.count = 0
        self.ring = Ring(window) if window else None


class Histogram(_Metric):
    """Fixed-bucket histogram with an optional percentile window.

    ``buckets`` are upper boundaries (ascending); values above the last
    boundary land in the +Inf overflow slot.  ``window`` > 0 additionally
    keeps the last ``window`` raw observations in a :class:`Ring` so
    ``percentile`` reports exact window quantiles (bucket-interpolated
    quantiles are too coarse for SLO p99s at toy scale).
    """

    kind = "histogram"

    def __init__(self, name, help="", labels=(), *,
                 buckets=DEFAULT_BUCKETS, window: int = 1024):
        super().__init__(name, help, labels)
        self.buckets = np.asarray(sorted(buckets), dtype=np.float64)
        if len(self.buckets) == 0:
            raise ValueError("histogram needs at least one bucket")
        self.window = int(window)

    def _mk(self):
        return _HistSeries(len(self.buckets), self.window)

    def observe(self, value: float, **labels) -> None:
        s = self._slot(labels, self._mk)
        s.counts[int(np.searchsorted(self.buckets, value))] += 1
        s.sum += value
        s.count += 1
        if s.ring is not None:
            s.ring.append(value)

    def observe_many(self, values, **labels) -> None:
        """Batch observe (one searchsorted for the whole array)."""
        v = np.asarray(values, dtype=np.float64).ravel()
        if v.size == 0:
            return
        s = self._slot(labels, self._mk)
        idx = np.searchsorted(self.buckets, v)
        np.add.at(s.counts, idx, 1)
        s.sum += float(v.sum())
        s.count += v.size
        if s.ring is not None:
            s.ring.extend(v)

    def percentile(self, q, **labels) -> float | None:
        key = _label_key(self.label_names, labels)
        s = self._series.get(key)
        if s is None or s.ring is None:
            return None
        return s.ring.percentile(q)


class MetricsRegistry:
    """Named metric namespace: get-or-create semantics, one snapshot.

    ``counter``/``gauge``/``histogram`` are idempotent — asking twice
    with the same name returns the same instance (and raises if the
    second ask disagrees on type or labels), so instrumented modules
    never need to coordinate creation order.
    """

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, help, labels, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, labels, **kw)
                self._metrics[name] = m
                return m
        if not isinstance(m, cls) or m.label_names != tuple(labels):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind} "
                f"with labels {m.label_names}"
            )
        return m

    def counter(self, name, help="", labels=()) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name, help="", labels=()) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=(), *,
                  buckets=DEFAULT_BUCKETS, window=1024) -> Histogram:
        return self._get(Histogram, name, help, labels,
                         buckets=buckets, window=window)

    def metrics(self) -> list[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> dict:
        """Flat, JSON-serializable view of every series.

        ``{name: {label_str: value}}`` for counters/gauges and
        ``{name: {label_str: {count, sum, p50, p99}}}`` for histograms
        (label_str is ``"k=v,k=v"``; ``""`` for unlabelled series).
        """
        out = {}
        for m in self.metrics():
            series = {}
            for key, s in m.series().items():
                lbl = ",".join(
                    f"{n}={v}" for n, v in zip(m.label_names, key)
                )
                if m.kind == "histogram":
                    series[lbl] = {
                        "count": int(s.count),
                        "sum": float(s.sum),
                        "p50": s.ring.percentile(50) if s.ring else None,
                        "p99": s.ring.percentile(99) if s.ring else None,
                    }
                else:
                    series[lbl] = float(s[0])
            out[m.name] = series
        return out


_DEFAULT = MetricsRegistry()
_DEFAULT_LOCK = threading.Lock()


def get_default_registry() -> MetricsRegistry:
    """The process-global registry (serving default: every layer's
    instrumentation lands in one scrapeable namespace)."""
    return _DEFAULT


def reset_default_registry() -> MetricsRegistry:
    """Swap in a fresh global registry (test isolation)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = MetricsRegistry()
    return _DEFAULT
