"""Trace accounting: count first runs of each named program at a new key.

Counterpart of ``repro/plan/trace.py``.  The reference counts ``jax.jit``
trace events: a jitted function's Python body runs only on a cache miss of
its (function, abstract shapes, static arguments) key, so a counter bumped
there moves on the first compilation and on every retrace.  **The port
compiles nothing**: its programs are eager PyTorch calls.  A "trace" here
marks a program's first run at a new key, where the key plays the part of
jit's abstract-shape key: the query bucket (not the tensor's row count),
and each argument's dtype and trailing shape, or its absence (whether a
mask rides along).  Steady-state traffic inside warmed buckets therefore
counts zero retraces, and a new bucket counts one, as in the reference.

:func:`counting_program` wraps a program; :func:`note_trace` is the raw
hook.  The serve path pins "steady-state retraces == 0" down with
:func:`assert_no_retrace` / :func:`snapshot` deltas, and
:func:`trace_report` exposes the counters ``memory_breakdown``-style.
Each event is mirrored into the port's process metrics registry
(``quiver_jit_traces_total{program=...}``).
"""

from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.obs.metrics import get_default_registry

_LOCK = threading.Lock()
_COUNTS: dict[str, int] = {}


def note_trace(name: str) -> None:
    """Record one trace event for program ``name``."""
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + 1
    get_default_registry().counter(
        "quiver_jit_traces_total",
        "jit trace (compilation) events per program",
        labels=("program",),
    ).inc(program=name)


def _spec(arg):
    """An argument's part of a program key: what jit's abstract shape
    holds apart from the batch rows."""
    if arg is None:
        return None
    if isinstance(arg, torch.Tensor):
        return str(arg.dtype), tuple(arg.shape[1:])
    return type(arg).__name__


class CountingProgram:
    """``fun`` run eagerly; its first run at each new key notes one trace
    event under ``name``."""

    def __init__(self, fun, name: str):
        self.fun = fun
        self.name = name
        self._keys: set = set()
        self._lock = threading.Lock()

    def note(self, *args, bucket: int) -> None:
        """Count a run of ``args`` at ``bucket`` (a trace event if its key
        is new); the caller runs ``fun``."""
        key = (bucket, *map(_spec, args))
        with self._lock:
            fresh = key not in self._keys
            self._keys.add(key)
        if fresh:
            note_trace(self.name)

    def __call__(self, *args, bucket: int):
        self.note(*args, bucket=bucket)
        return self.fun(*args)


def counting_program(fun, name: str | None = None) -> CountingProgram:
    """``fun`` whose first run at each (bucket, argument spec) key is
    counted under ``name`` (default: the function's ``__name__``)."""
    return CountingProgram(fun, name or getattr(fun, "__name__",
                                                "anonymous"))


def trace_counts(prefix: str = "") -> dict[str, int]:
    """Per-program trace counts (filtered to names under ``prefix``)."""
    with _LOCK:
        return {k: v for k, v in _COUNTS.items() if k.startswith(prefix)}


def total_traces(prefix: str = "") -> int:
    return sum(trace_counts(prefix).values())


def reset(prefix: str = "") -> None:
    with _LOCK:
        for k in [k for k in _COUNTS if k.startswith(prefix)]:
            del _COUNTS[k]


def trace_report(prefix: str = "") -> dict:
    """``memory_breakdown``-style report: per-program trace counts plus
    the total; diff two of these across a serving window to get the
    window's retrace count."""
    counts = trace_counts(prefix)
    return {
        "programs": dict(sorted(counts.items())),
        "distinct_programs": len(counts),
        "total_traces": sum(counts.values()),
    }


class TraceSnapshot:
    """Point-in-time counter snapshot; ``delta()`` is the traces since."""

    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self._base = trace_counts(prefix)

    def delta(self) -> int:
        now = trace_counts(self.prefix)
        return sum(now.values()) - sum(self._base.values())

    def delta_by_program(self) -> dict[str, int]:
        now = trace_counts(self.prefix)
        out = {}
        for k, v in now.items():
            d = v - self._base.get(k, 0)
            if d:
                out[k] = d
        return out


def snapshot(prefix: str = "") -> TraceSnapshot:
    return TraceSnapshot(prefix)


@contextlib.contextmanager
def assert_no_retrace(prefix: str = "", what: str = "steady state"):
    """Context manager asserting zero trace events inside the block: the
    serving guarantee "steady-state retraces == 0"."""
    snap = snapshot(prefix)
    yield snap
    d = snap.delta()
    if d:
        raise AssertionError(
            f"{what}: expected 0 retraces, got {d}: "
            f"{snap.delta_by_program()}"
        )
