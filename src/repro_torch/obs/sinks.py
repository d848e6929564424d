"""Pluggable emission sinks + Prometheus text exposition.

``stats_report``/``trace_report`` used to be pull-only dicts nothing
consumed in production; a :class:`Sink` is the push side.  Each
``emit(record)`` receives one JSON-serializable snapshot (metrics +
spans + whatever the caller attaches) and ships it somewhere:

* :class:`JsonlSink` — append one JSON line per snapshot to a file (the
  fleet-telemetry flight recorder; trivially greppable/parseable);
* :class:`StdoutSink` — terse human-readable summary to stderr (the
  operator's tail -f);
* :func:`render_prometheus` / :class:`PrometheusServer` — Prometheus
  text-exposition snapshot of a registry, optionally served on an HTTP
  endpoint (``GET /metrics``) for a scraper.  Stdlib ``http.server``
  in a daemon thread: no new dependencies.

``sinks_from_env`` builds the sink list the launcher stages
(``launch/serve.py``): ``REPRO_OBS_JSONL=<path>``,
``REPRO_OBS_STDOUT=1``.
"""

from __future__ import annotations

import http.server
import json
import os
import pathlib
import sys
import threading

from repro_torch.obs.metrics import MetricsRegistry


class Sink:
    """One destination for telemetry snapshots."""

    def emit(self, record: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class JsonlSink(Sink):
    """Append-one-JSON-line-per-snapshot file sink with size rotation.

    A long-running serve emits a snapshot per admission window; without
    a bound the flight recorder eventually fills the disk.  When the
    live file would exceed ``max_bytes`` the sink rolls it logrotate
    style — ``path`` -> ``path.1`` -> ... -> ``path.<keep>``, oldest
    dropped — before writing, so every line lands whole in exactly one
    generation and the newest data is always in ``path`` itself.
    ``max_bytes=0`` (the default) disables rotation.
    """

    def __init__(self, path, *, max_bytes: int = 0, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.max_bytes = int(max_bytes)
        self.keep = int(keep)
        self._fh = self.path.open("a")
        self._lock = threading.Lock()
        self._closed = False

    def _rotate(self) -> None:
        self._fh.close()
        oldest = self.path.with_name(f"{self.path.name}.{self.keep}")
        oldest.unlink(missing_ok=True)
        for i in range(self.keep - 1, 0, -1):
            src = self.path.with_name(f"{self.path.name}.{i}")
            if src.exists():
                src.rename(self.path.with_name(f"{self.path.name}.{i + 1}"))
        self.path.rename(self.path.with_name(f"{self.path.name}.1"))
        self._fh = self.path.open("a")

    def emit(self, record: dict) -> None:
        line = json.dumps(record, default=_json_default) + "\n"
        with self._lock:
            if self._closed:
                # a straggler snapshot after close (reporter's atexit
                # flush racing the hub's) is dropped, not a crash
                return
            if (
                self.max_bytes > 0
                and self._fh.tell() > 0
                and self._fh.tell() + len(line) > self.max_bytes
            ):
                self._rotate()
            self._fh.write(line)
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._fh.close()


class StdoutSink(Sink):
    """Terse one-line-per-snapshot pretty printer (stderr by default:
    benchmark CSV owns stdout)."""

    def __init__(self, stream=None, prefix: str = "[obs]"):
        self.stream = stream if stream is not None else sys.stderr
        self.prefix = prefix

    def emit(self, record: dict) -> None:
        bits = []
        for key in ("unix_ts", "requests", "done", "dropped", "rejected"):
            if key in record:
                bits.append(f"{key}={record[key]}")
        metrics = record.get("metrics", {})
        for name in sorted(metrics):
            series = metrics[name]
            if isinstance(series, dict) and len(series) <= 4:
                for lbl, v in series.items():
                    tag = f"{name}{{{lbl}}}" if lbl else name
                    if isinstance(v, dict):      # histogram summary
                        bits.append(f"{tag}.count={v.get('count')}")
                    else:
                        bits.append(f"{tag}={v:g}")
        print(f"{self.prefix} " + " ".join(bits), file=self.stream)


def _json_default(o):
    try:
        return float(o)
    except (TypeError, ValueError):
        return str(o)


# -- health verdicts -------------------------------------------------------


_BAND_ORDER = {"green": 0, "amber": 1, "red": 2}


def health_snapshot(health_fn) -> tuple[dict, int]:
    """Evaluate ``health_fn`` into a ``/healthz`` body + HTTP status.

    ``health_fn`` returns ``{component: verdict}`` (e.g. graph / drift
    / recall-SLO bands); the overall verdict is the *worst* band and
    the status is 503 only on red — amber is degraded-but-serving, a
    scraper page not a load-balancer eviction.  A crashing probe is
    itself a red verdict: the endpoint must never take the server down,
    and "health check broken" is not health.
    """
    components: dict = {}
    if health_fn is not None:
        try:
            components = dict(health_fn())
        except Exception as e:
            components = {"health_probe": "red", "error": repr(e)}
    worst = "green"
    for v in components.values():
        if _BAND_ORDER.get(v, 0) > _BAND_ORDER[worst]:
            worst = v
    return (
        {"verdict": worst, "components": components},
        503 if worst == "red" else 200,
    )


# -- Prometheus text exposition -------------------------------------------


def _escape(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _fmt_labels(names, values, extra=()) -> str:
    pairs = [
        f'{n}="{_escape(v)}"' for n, v in (*zip(names, values), *extra)
    ]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def render_prometheus(registry: MetricsRegistry) -> str:
    """Text-exposition-format snapshot of every series in ``registry``
    (counters/gauges verbatim; histograms as cumulative ``_bucket``
    series plus ``_sum``/``_count``, the standard shape)."""
    lines = []
    for m in registry.metrics():
        lines.append(f"# HELP {m.name} {m.help or m.name}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        for key, s in sorted(m.series().items()):
            if m.kind == "histogram":
                cum = 0
                for bound, c in zip(m.buckets, s.counts):
                    cum += int(c)
                    lbl = _fmt_labels(m.label_names, key,
                                      extra=(("le", f"{bound:g}"),))
                    lines.append(f"{m.name}_bucket{lbl} {cum}")
                cum += int(s.counts[-1])
                lbl = _fmt_labels(m.label_names, key,
                                  extra=(("le", "+Inf"),))
                lines.append(f"{m.name}_bucket{lbl} {cum}")
                base = _fmt_labels(m.label_names, key)
                lines.append(f"{m.name}_sum{base} {s.sum:g}")
                lines.append(f"{m.name}_count{base} {s.count}")
            else:
                lbl = _fmt_labels(m.label_names, key)
                lines.append(f"{m.name}{lbl} {s[0]:g}")
    return "\n".join(lines) + "\n"


class PrometheusServer:
    """``GET /metrics`` snapshot endpoint over a registry.

    Stdlib ``ThreadingHTTPServer`` on a daemon thread — a scrape reads
    whatever the registry holds at that instant; nothing blocks the
    serving loop.  ``port=0`` binds an ephemeral port (tests).

    ``health_fn`` (optional) adds a ``GET /healthz`` liveness verdict:
    a JSON body of per-component bands (graph topology, probe drift,
    recall SLO — whatever the caller wires in) with 200 while no
    component reads red and 503 once one does, so a load balancer can
    evict a replica whose graph has structurally collapsed without
    parsing the full metrics exposition.
    """

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1", health_fn=None):
        self.registry = registry
        self.health_fn = health_fn
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                path = self.path.rstrip("/")
                if path == "/healthz":
                    record, status = health_snapshot(outer.health_fn)
                    body = json.dumps(record).encode()
                    self.send_response(status)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if path not in ("", "/metrics"):
                    self.send_error(404)
                    return
                body = render_prometheus(outer.registry).encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):        # keep scrapes silent
                pass

        self._httpd = http.server.ThreadingHTTPServer(
            (host, port), Handler
        )
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"prometheus:{self.port}",
        )
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def sinks_from_env(env=None) -> list[Sink]:
    """Build the sink list from the env the launcher staged:
    ``REPRO_OBS_JSONL`` (file path), ``REPRO_OBS_JSONL_MAX_BYTES`` /
    ``REPRO_OBS_JSONL_KEEP`` (size rotation), ``REPRO_OBS_STDOUT``
    (=1)."""
    env = os.environ if env is None else env
    sinks: list[Sink] = []
    path = env.get("REPRO_OBS_JSONL")
    if path:
        sinks.append(JsonlSink(
            path,
            max_bytes=int(env.get("REPRO_OBS_JSONL_MAX_BYTES", "0")),
            keep=int(env.get("REPRO_OBS_JSONL_KEEP", "3")),
        ))
    if env.get("REPRO_OBS_STDOUT", "0") == "1":
        sinks.append(StdoutSink())
    return sinks
