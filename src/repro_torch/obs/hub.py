"""ObsHub — one handle bundling registry + tracer + sinks.

Every instrumented component takes (or builds) a hub: the
:class:`~repro_torch.serve.engine.QueryEngine` records per-tenant metrics and
lifecycle spans into ``hub.registry``/``hub.tracer``; ``hub.emit()``
pushes one snapshot record through every sink.  A default hub writes
into the process-global registry — so beam/filter/stream
instrumentation recorded through ``get_default_registry()`` appears in
the same scrape — with no sinks (pure pull, zero I/O), which is the
test-friendly shape; serving processes build one ``from_env()`` with
whatever the launcher staged.

:class:`PeriodicReporter` is the operational push loop: a daemon thread
emitting ``hub.emit(extra_fn())`` every ``interval`` seconds — this is
what turns ``stats_report``/``trace_report`` from pull-only dicts into
a live telemetry stream.  ``autostart`` wires the
reporter + Prometheus endpoint from the env (``REPRO_OBS_INTERVAL_S``,
``REPRO_METRICS_PORT``).
"""

from __future__ import annotations

import atexit
import os
import threading
import time

from repro_torch.obs.metrics import MetricsRegistry, get_default_registry
from repro_torch.obs.sinks import PrometheusServer, Sink, sinks_from_env
from repro_torch.obs.tracing import Tracer


class ObsHub:
    """Registry + tracer + sinks, bundled."""

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        tracer: Tracer | None = None,
        sinks: list[Sink] | tuple = (),
    ):
        self.registry = (
            registry if registry is not None else get_default_registry()
        )
        self.tracer = (
            tracer if tracer is not None else Tracer(self.registry)
        )
        self.sinks = list(sinks)
        self._closed = False
        if self.sinks:
            # flush-and-close at interpreter exit: a process torn down
            # without an orderly engine.shutdown() still closes its
            # flight recorder cleanly (close() is idempotent, so the
            # orderly path costs nothing extra)
            atexit.register(self.close)

    @classmethod
    def from_env(cls, env=None) -> "ObsHub":
        """Hub over the global registry with env-staged sinks
        (``launch/serve.py`` sets the variables up front)."""
        return cls(sinks=sinks_from_env(env))

    def emit(self, extra: dict | None = None) -> dict:
        """Snapshot metrics + span aggregates (+ caller extras) and push
        the record through every sink; returns the record either way, so
        a sink-less hub still serves as the pull API."""
        record = {
            "unix_ts": round(time.time(), 3),
            "metrics": self.registry.snapshot(),
            "spans": self.tracer.report(),
        }
        if extra:
            record.update(extra)
        for sink in self.sinks:
            sink.emit(record)
        return record

    def close(self) -> None:
        """Close every sink exactly once (idempotent: engine shutdown
        and the atexit hook may both land here)."""
        if self._closed:
            return
        self._closed = True
        for sink in self.sinks:
            sink.close()


class PeriodicReporter(threading.Thread):
    """Emit ``hub.emit(extra_fn())`` every ``interval`` seconds.

    Daemon thread: dies with the process; ``stop()`` emits one final
    snapshot so short runs always leave at least one record behind.
    """

    def __init__(self, hub: ObsHub, *, interval: float = 5.0,
                 extra_fn=None):
        super().__init__(daemon=True, name="obs-reporter")
        self.hub = hub
        self.interval = float(interval)
        self.extra_fn = extra_fn
        self._stopped = False
        # NB: not named _stop — Thread.join() calls self._stop()
        # internally, and an Event attribute would shadow it
        self._halt = threading.Event()

    def _extra(self) -> dict | None:
        if self.extra_fn is None:
            return None
        try:
            return self.extra_fn()
        except Exception as e:       # keep the loop alive; surface why
            return {"reporter_error": repr(e)}

    def start(self) -> None:
        # registered at start (not construction) so only a *running*
        # loop owes the world a final snapshot; atexit runs LIFO, so
        # this fires before the hub's own sink-close hook — the flush
        # lands in an open flight recorder
        atexit.register(self.stop)
        super().start()

    def run(self) -> None:
        while not self._halt.wait(self.interval):
            self.hub.emit(self._extra())

    def stop(self) -> None:
        """Stop the loop and flush one final snapshot (idempotent:
        engine shutdown and the atexit hook may both call it, and the
        snapshot must not be double-emitted)."""
        if self._stopped:
            return
        self._stopped = True
        self._halt.set()
        if self.is_alive():
            self.join(timeout=2 * self.interval)
        self.hub.emit(self._extra())


def autostart(
    hub: ObsHub, *, extra_fn=None, health_fn=None, env=None
) -> tuple[PeriodicReporter | None, PrometheusServer | None]:
    """Start the push loop / scrape endpoint the env asks for.

    ``REPRO_OBS_INTERVAL_S`` (default 5) paces the reporter — started
    only when the hub has sinks to feed; ``REPRO_METRICS_PORT`` starts
    the Prometheus snapshot endpoint on that port (``health_fn`` —
    typically ``engine.health_verdicts`` — adds its ``GET /healthz``
    verdict route).  Returns whichever were started (callers
    ``stop()``/``close()`` them on shutdown).
    """
    env = os.environ if env is None else env
    reporter = server = None
    if hub.sinks:
        interval = float(env.get("REPRO_OBS_INTERVAL_S", "5"))
        reporter = PeriodicReporter(hub, interval=interval,
                                    extra_fn=extra_fn)
        reporter.start()
    port = env.get("REPRO_METRICS_PORT")
    if port:
        server = PrometheusServer(hub.registry, port=int(port),
                                  health_fn=health_fn)
    return reporter, server
