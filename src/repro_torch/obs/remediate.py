"""Closed-loop drift remediation: alarms -> actions (DESIGN.md §14).

The observability stack ends in two *event* streams — probe-drift
alarms (:class:`~repro_torch.obs.drift.DriftMonitor`, bit-plane statistics
crossing the calibrated bands) and recall-SLO breaches
(:class:`~repro_torch.obs.tenant.TenantLedger`, shadow-sampled recall p50
dropping below a tenant's quota).  Both mean the same thing: the nav
schedule chosen at build time is no longer earning its recall.  A
:class:`RemediationPolicy` subscribes to both and walks an ordered
action ladder, cheapest-first, until an action plausibly restores
recall:

1. ``reprobe``      — re-run the probe diagnostics on the *live* corpus
   (the accumulator's exact entropies, or a fresh sampled probe).  A
   drift alarm whose re-probe still reads green is a false alarm:
   resolve, no serving change.
2. ``replan``       — the re-probe's :func:`~repro_torch.probe.select_policy`
   wants a different nav rung: switch the index's default via
   ``replan(nav=...)``, invalidating only the old family's compiled
   plans (every other tenant's executables survive — zero retraces).
3. ``escalate_ef``  — the rung is already right but recall is short:
   double the engine's default ef bucket (capped at ``ef_cap`` x the
   original) — spend compute, keep the schedule.
4. ``flag_red``     — the ladder is exhausted: flag the corpus red and
   route the default to the exact float32 ladder (``adc`` when the
   index is vector-free).  Loud, expensive, and correct — the paper's
   boundary says BQ navigation has no business here.

One trigger advances the ladder by one *plausible* action; repeated
triggers (recall still breaching after a replan) walk further down.
Every action is emitted as a span + a
``quiver_remediation_actions_total{action,trigger}`` counter, so the
closed loop is itself observable.

The port's copy of ``repro/obs/remediate.py``, over the port's probe
(re-probes run on the device of the index's tensors) and ``replan``.
"""

from __future__ import annotations

import collections
import time

from repro_torch.obs.metrics import MetricsRegistry, get_default_registry

ACTIONS = ("reprobe", "replan", "escalate_ef", "consolidate", "flag_red")


class RemediationPolicy:
    """Subscribe to quality alarms and walk the remediation ladder.

    ``engine`` is a :class:`~repro_torch.serve.engine.QueryEngine` (anything
    with ``.index``, ``.default_ef``, ``.tenants`` and optionally
    ``.obs``); the index is always read through the engine so snapshot
    swaps (``engine.swap_index``) are followed automatically.

    ``auto=True`` (default) acts on every subscribed event the moment
    it fires; ``auto=False`` queues triggers for an operator-paced
    :meth:`check` (benchmarks and cautious fleets).  Both drift alarms
    and SLO breaches are edge-triggered at their source, so auto mode
    sees one trigger per degradation episode, not a flood.

    ``probe_source`` overrides where re-probes come from: a callable
    returning a :class:`CompatibilityReport`, or any object with a
    ``probe_report()`` method (a mutable index, a sharded fleet).  By
    default the policy prefers, in order: the index's own
    ``probe_report()``, its live :class:`ProbeAccumulator`, a fresh
    sampled probe of the cold vectors, and finally a signature-only
    accumulator report.
    """

    def __init__(
        self,
        engine,
        *,
        probe_source=None,
        auto: bool = True,
        ef_cap: float = 8.0,
        probe_sample: int = 1024,
        registry: MetricsRegistry | None = None,
        max_events: int = 256,
        clock=time.time,
    ):
        self.engine = engine
        self.probe_source = probe_source
        self.auto = bool(auto)
        self.ef_cap = float(ef_cap)
        self.probe_sample = int(probe_sample)
        self.clock = clock
        self.base_ef = int(engine.default_ef)
        self.flagged_red = False
        self.last_report = None            # most recent re-probe
        self.triggers = collections.deque(maxlen=max_events)
        self.events = collections.deque(maxlen=max_events)
        self.action_counts = {a: 0 for a in ACTIONS}
        obs = getattr(engine, "obs", None)
        self.tracer = obs.tracer if obs is not None else None
        reg = registry
        if reg is None:
            reg = obs.registry if obs is not None else get_default_registry()
        self._c_actions = reg.counter(
            "quiver_remediation_actions_total",
            "remediation-ladder actions by trigger",
            labels=("action", "trigger"),
        )
        # the ledger's breach events are already wired to the engine
        engine.tenants.subscribe(self._on_breach)

    @property
    def index(self):
        return self.engine.index

    # -- subscriptions -------------------------------------------------------

    def attach(self, monitor) -> "RemediationPolicy":
        """Subscribe to a :class:`DriftMonitor`'s alarms; returns self
        (``policy.attach(m1).attach(m2)`` chains over a fleet)."""
        monitor.subscribe(self._on_drift)
        return self

    def _on_drift(self, alarm) -> None:
        self._trigger({
            "kind": "drift",
            "tenant": alarm.tenant,
            "band": alarm.band,
            "stat": alarm.stat,
            "value": alarm.value,
        })

    def attach_graph(self, monitor) -> "RemediationPolicy":
        """Subscribe to a :class:`~repro_torch.obs.graph.GraphHealthMonitor`'s
        structural band crossings (chainable, like :meth:`attach`).
        Graph triggers walk their own short ladder in :meth:`step`:
        amber is a topology-repair problem (consolidate / replan
        recommendation), not an ef problem — spending beam width on a
        disconnected graph buys nothing."""
        monitor.subscribe(self._on_graph)
        return self

    def _on_graph(self, alarm) -> None:
        self._trigger({
            "kind": "graph_health",
            "tenant": alarm.tenant,
            "band": alarm.band,
            "stat": alarm.stat,
            "value": alarm.value,
        })

    def _on_breach(self, event: dict) -> None:
        self._trigger(dict(event))         # kind == "recall_slo"

    def _trigger(self, trigger: dict) -> None:
        if self.auto:
            self.step(trigger)
        else:
            self.triggers.append(trigger)

    def check(self) -> dict | None:
        """Process queued triggers (``auto=False`` mode).  All pending
        triggers coalesce into **one** ladder step — they describe the
        same degradation episode; acting once and re-observing beats
        racing down the ladder on correlated alarms."""
        if not self.triggers:
            return None
        trigger = self.triggers.popleft()
        self.triggers.clear()
        return self.step(trigger)

    # -- the ladder ----------------------------------------------------------

    def step(self, trigger: dict) -> dict:
        """Advance the ladder one plausible action for ``trigger``;
        returns the event record describing what was done."""
        kind = trigger.get("kind", "manual")
        if self.flagged_red:
            # already at the bottom: nothing cheaper left to try
            return self._emit("flag_red", kind, trigger,
                              note="already red-flagged")
        if kind == "graph_health":
            return self._step_graph(trigger)
        report = self._reprobe()
        self.last_report = report
        verdict = report.verdict if report is not None else "amber"
        if kind == "drift" and verdict == "green":
            # the sampled probe overrules the cheap entropy banding:
            # false alarm, no serving change
            return self._emit("reprobe", kind, trigger,
                              verdict=verdict, note="false alarm")
        self._emit("reprobe", kind, trigger, verdict=verdict)
        target = self._target_policy(report)
        current = self._current_nav()
        if target is not None and target.nav != current:
            self.index.replan(
                nav=target.nav, ef_scale=target.ef_scale,
                adaptive=target.adaptive, source="remediation",
            )
            return self._emit("replan", kind, trigger,
                              nav=f"{current}->{target.nav}")
        cap = int(self.base_ef * self.ef_cap)
        if self.engine.default_ef < cap:
            new_ef = min(2 * self.engine.default_ef, cap)
            old_ef, self.engine.default_ef = self.engine.default_ef, new_ef
            return self._emit("escalate_ef", kind, trigger,
                              ef=f"{old_ef}->{new_ef}")
        self.flagged_red = True
        fallback = "float32" if self.index.vectors is not None else "adc"
        if current != fallback:
            self.index.replan(nav=fallback, source="remediation:red")
        return self._emit("flag_red", kind, trigger, nav=fallback)

    def _step_graph(self, trigger: dict) -> dict:
        """The structural branch of the ladder.  Amber means the
        topology needs *repair*, so the cheapest plausible action is a
        consolidation cycle (splice-and-reprune, slot reclamation) when
        the index is mutable — an immutable snapshot gets a
        consolidate/replan recommendation instead.  Red means the graph
        contradicts its own metric space (mass unreachability, BQ/f32
        edge disagreement): no serve-time knob fixes that, so flag for
        a rebuild through the probe (``build(nav="auto")``)."""
        band = trigger.get("band", "amber")
        if band == "red":
            self.flagged_red = True
            return self._emit("flag_red", "graph_health", trigger,
                              note="rebuild-through-probe")
        idx = self.index
        if hasattr(idx, "consolidate"):
            rep = idx.consolidate()
            return self._emit(
                "consolidate", "graph_health", trigger,
                repaired=int(rep.get("repaired_rows", 0)),
                reclaimed=int(rep.get("reclaimed", 0)),
            )
        return self._emit(
            "consolidate", "graph_health", trigger,
            note="immutable snapshot: consolidate/replan at next swap",
        )

    def resolve(self, note: str = "operator resolve") -> None:
        """Clear the red flag and restore the original ef bucket —
        the operator (or a recovered SLO) declaring the episode over;
        the next trigger walks the ladder from the top again."""
        self.flagged_red = False
        self.engine.default_ef = self.base_ef
        self.events.append({
            "action": "resolve", "trigger": "manual", "note": note,
            "unix_ts": self.clock(),
        })

    # -- internals -----------------------------------------------------------

    def _current_nav(self) -> str:
        idx = self.index
        policy = getattr(idx, "policy", None)
        return policy.nav if policy is not None else idx.metric_kind

    def _target_policy(self, report):
        if report is None:
            return None
        from repro_torch.probe import select_policy
        idx = self.index
        return select_policy(
            report,
            have_vectors=getattr(idx, "vectors", None) is not None,
            have_ivf=getattr(idx, "ivf", None) is not None,
        )

    def _reprobe(self):
        src = self.probe_source
        if callable(src):
            return src()
        if src is not None and hasattr(src, "probe_report"):
            return src.probe_report()
        idx = self.index
        if hasattr(idx, "probe_report"):
            return idx.probe_report()
        acc = getattr(idx, "probe_acc", None)
        if acc is not None and getattr(acc, "n", 0):
            from repro_torch.probe import report_from_accumulator
            return report_from_accumulator(acc)
        if getattr(idx, "vectors", None) is not None:
            from repro_torch.probe import probe_corpus
            return probe_corpus(idx.vectors, sample=self.probe_sample,
                                device=idx.vectors.device)
        # vector-free immutable index: exact signature statistics are
        # all we have — fold them into an accumulator report
        from repro_torch.probe import ProbeAccumulator, report_from_accumulator
        acc = ProbeAccumulator(idx.sigs.dim)
        acc.add(idx.sigs.words)
        return report_from_accumulator(acc)

    def _emit(self, action: str, trigger_kind: str, trigger: dict,
              **detail) -> dict:
        self.action_counts[action] += 1
        self._c_actions.inc(action=action, trigger=trigger_kind)
        event = {
            "action": action, "trigger": trigger_kind,
            "tenant": trigger.get("tenant", "default"),
            **detail, "unix_ts": self.clock(),
        }
        self.events.append(event)
        if self.tracer is not None:
            with self.tracer.span("remediate", 0, action=action,
                                  trigger=trigger_kind, **detail):
                pass
        return event

    def report(self) -> dict:
        return {
            "auto": self.auto,
            "flagged_red": self.flagged_red,
            "base_ef": self.base_ef,
            "default_ef": int(self.engine.default_ef),
            "current_nav": self._current_nav(),
            "pending_triggers": len(self.triggers),
            "actions": dict(self.action_counts),
            "last_verdict": (
                self.last_report.verdict
                if self.last_report is not None else None
            ),
            "events": list(self.events),
        }
