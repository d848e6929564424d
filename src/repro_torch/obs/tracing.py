"""Span-based tracing of the query lifecycle.

One request's life through the serve stack is a handful of stages —

    admission -> coalesce -> launch -> finalize [-> escalate | degrade]

(rerank is fused into the compiled plan program, so it is timed inside
launch/finalize rather than as its own span; DESIGN.md §12).  A
:class:`Tracer` hands out integer trace ids at admission, every stage
records a :class:`Span` carrying that id, and finished spans land in

* a bounded ring of recent spans (inspection/debugging — ``spans()``),
* per-stage duration histograms in a :class:`MetricsRegistry`
  (``quiver_stage_seconds{stage=...}``) — the operational signal.

Spans are plain dataclasses, ids are a counter behind a lock, and the
ring is a ``deque(maxlen=...)``: tracing a request costs two clock
reads and one deque append per stage.  No imports besides the
sibling metrics module.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time

from repro_torch.obs.metrics import MetricsRegistry

STAGES = (
    "admission", "coalesce", "launch", "finalize", "escalate", "degrade",
    "request", "window",
)


@dataclasses.dataclass
class Span:
    name: str
    trace_id: int
    start: float
    end: float | None = None
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float | None:
        return None if self.end is None else self.end - self.start

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "start": self.start,
            "seconds": self.seconds,
            **({"attrs": self.attrs} if self.attrs else {}),
        }


class Tracer:
    """Hands out trace ids and records finished spans.

    ``registry`` (optional) receives per-stage duration histograms; the
    ring keeps the last ``max_spans`` finished spans for inspection.
    ``clock`` is injectable for tests (same convention as QueryEngine).
    """

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        *,
        max_spans: int = 2048,
        clock=time.monotonic,
    ):
        self.registry = registry
        self.clock = clock
        self._spans = collections.deque(maxlen=max_spans)
        self._next = 0
        self._lock = threading.Lock()
        self._stage_hist = (
            registry.histogram(
                "quiver_stage_seconds",
                "query-lifecycle stage durations",
                labels=("stage",),
            )
            if registry is not None else None
        )

    def new_trace(self) -> int:
        with self._lock:
            self._next += 1
            return self._next

    def record(self, span: Span) -> Span:
        """File a finished span (sets ``end`` if the caller didn't)."""
        if span.end is None:
            span.end = self.clock()
        self._spans.append(span)
        if self._stage_hist is not None:
            self._stage_hist.observe(span.seconds, stage=span.name)
        return span

    @contextlib.contextmanager
    def span(self, name: str, trace_id: int = 0, **attrs):
        """Context-managed stage span; records on exit (even on error,
        so a failing launch still shows up in the stage histogram)."""
        s = Span(name=name, trace_id=trace_id, start=self.clock(),
                 attrs=dict(attrs))
        try:
            yield s
        finally:
            self.record(s)

    def spans(self, trace_id: int | None = None,
              name: str | None = None) -> list[Span]:
        out = list(self._spans)
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def report(self) -> dict:
        """Per-stage {count, total_s, mean_ms} over the span ring."""
        agg: dict[str, list] = {}
        for s in self._spans:
            if s.seconds is None:
                continue
            slot = agg.setdefault(s.name, [0, 0.0])
            slot[0] += 1
            slot[1] += s.seconds
        return {
            name: {
                "count": c,
                "total_s": round(tot, 6),
                "mean_ms": round(tot / c * 1e3, 4),
            }
            for name, (c, tot) in sorted(agg.items())
        }
