"""Declarative alerting & SLO plane: live rules over metrics + history.

The port's copy of ``torchmpi_tpu/obs/alerts.py``: the same rule kinds,
default pack and pending → firing → resolved lifecycle, so the same
samples on the same clock give the same state sequence.  A declarative
rules engine evaluated on the history
:class:`~torchmpi_tpu_torch.obs.history.Sampler` cadence:

* :class:`AlertRule` — one named rule over one metric series (a
  flattened history key, labels included) and a predicate *kind*:

  ============  =========================================================
  kind          fires when
  ============  =========================================================
  ``threshold`` the newest sample in ``window_s`` compares ``op`` vs
                ``value`` (``gt``/``lt``/``ge``/``le``)
  ``absence``   no sample for the metric landed within ``window_s``
                (staleness: the series went dark, not just low)
  ``rate``      the trailing per-second slope (:meth:`HistoryStore.rate`)
                compares ``op`` vs ``value``
  ``drift``     recent-vs-trailing-baseline ratio
                (:meth:`HistoryStore.drift`; ``of_rate`` for counters)
                compares ``op`` vs ``value``
  ``movement``  the summed increase of the named counter(s) over
                ``window_s`` reaches ``value`` (the watched-counter
                discipline from ``/healthz``, made windowed + tunable)
  ``share``     one labelled series of a gauge family holds >= ``value``
                of the family's total movement over ``window_s`` (the
                straggler-skew shape; the annotation names the label)
  ``mark_age``  a health progress mark's age exceeds ``value`` x its
                stalled threshold (watchdog-near-expiry: fire while the
                in-process watchdog still has budget left)
  ============  =========================================================

* the ``for_s`` duration gives every rule the
  **pending → firing → resolved** lifecycle: the predicate must hold
  for ``for_s`` seconds before the alert fires (one noisy sample can
  never page), and a firing alert resolves on the first clean
  evaluation — recovery is observable, not sticky.
* :data:`DEFAULT_PACK` encodes the stack's known failure signatures
  (nonfinite movement, numerics divergence, step-rate sag,
  overlap-fraction collapse, PS fence/failover storm, trace/journal
  drop-loss, straggler skew share, autotune byte-mix drift,
  watchdog-near-expiry, a missing leader) so the plane is useful with
  zero authored rules.  ``autotune_mix_drift`` watches the gauge
  ``collectives/autotune.mix_drift`` publishes, at the
  ``retune_mix_threshold`` knob.  ``leader_missing`` watches the
  gauge ``runtime/election.HealthzDetector.probe_leader`` publishes.
* **phase attribution**: the engine publishes
  ``tmpi_step_phase_seconds{phase=data_wait|dispatch|collective|optimizer|ps}``
  per step (``serve.publish_step``; :func:`phase_seconds` derives the
  same decomposition from recorded spans), and a firing rule with
  ``phase="auto"`` names the phase whose history drifted UP the most —
  the alert says *which* phase regressed, not just "step got slower".

Integration: every lifecycle transition journals a typed ``alert.*``
event (``obs/journal.py``); a firing ``critical`` rule triggers a flight
dump (``obs/flight.on_failure`` — still gated by ``obs_flight``); firing
alerts feed the ``/healthz`` state machine as ``degraded`` (never above
``stalled``/``diverged`` in precedence); served live as ``GET /alerts``
(obs/serve.py).

Off by default (``alert_enabled``): :func:`maybe_start` is one config
read, no rules are compiled, the sampler hook stays None.  All knob
reads funnel through :func:`alerts_config` (the ``journal_config``
discipline): ``alert_enabled``, ``alert_default_pack``,
``alert_rules_path``, ``alert_eval_every``, ``alert_for_s``,
``alert_flight``.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

__all__ = [
    "AlertEngine",
    "AlertRule",
    "DEFAULT_PACK",
    "KINDS",
    "PHASES",
    "SEVERITIES",
    "alerts_config",
    "default_rules",
    "engine",
    "load_rules",
    "maybe_start",
    "phase_seconds",
    "reset",
    "snapshot",
    "stop",
]

SCHEMA = "tmpi-alerts-v1"

KINDS = ("threshold", "absence", "rate", "drift", "movement", "share",
         "mark_age")
SEVERITIES = ("warning", "critical")
STATES = ("inactive", "pending", "firing", "resolved")

#: the per-step phase decomposition the engine publishes
#: (``tmpi_step_phase_seconds{phase=...}``), in publication order.
PHASES = ("data_wait", "dispatch", "collective", "optimizer", "ps")

#: engine/plane span names -> step phase, for :func:`phase_seconds` (the
#: span-derived twin of the engine's direct-timestamp decomposition).
SPAN_PHASE = {
    "engine.stage": "data_wait",
    "engine.dispatch": "dispatch",
    "engine.grad": "dispatch",
    "engine.sync": "collective",
    "engine.inflight_wait": "collective",
    "engine.optimizer": "optimizer",
}

_OPS: Dict[str, Callable[[float, float], bool]] = {
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
}


def alerts_config() -> dict:
    """The alert knobs in one read — the single config touchpoint for
    the ``alert_`` family (the ``journal_config`` discipline)."""
    from ..runtime import config

    return {
        "enabled": bool(config.get("alert_enabled")),
        "default_pack": bool(config.get("alert_default_pack")),
        "rules_path": str(config.get("alert_rules_path")),
        "eval_every": int(config.get("alert_eval_every")),
        "for_s": float(config.get("alert_for_s")),
        "flight": bool(config.get("alert_flight")),
    }


# ----------------------------------------------------------------- rules

class AlertRule:
    """One declarative rule.  ``spec`` keys:

    ``name`` (required), ``kind`` (required, one of :data:`KINDS`),
    ``metric`` (flattened history key, labels included; a list for
    ``movement``'s summed counters; the FAMILY name for ``share``; the
    health mark name for ``mark_age``), ``op``/``value`` (the
    comparison), ``window_s`` (trailing window, default 60),
    ``for_s`` (hold duration before firing; None = the ``alert_for_s``
    knob default), ``severity`` (``warning``/``critical``),
    ``of_rate`` (drift kind only), ``recent_s``/``baseline_s`` (drift
    windows; default window_s/4 and 3*window_s/4), ``min_total``
    (share kind: total family movement below this never fires — share
    of nothing is noise), ``min_baseline`` (drift kind: the baseline
    window's mean — or base RATE with ``of_rate`` — must reach this
    before a drop can fire: a "collapse" presupposes there was
    something to lose), ``phase`` (``"auto"`` = name the
    max-drifted ``tmpi_step_phase_seconds`` phase at firing time, a
    phase name = static attribution, None = no phase),
    ``summary`` (human template; ``{value}`` interpolated).
    """

    def __init__(self, spec: Mapping[str, Any],
                 default_for_s: float = 3.0):
        self.name = str(spec["name"])
        self.kind = str(spec["kind"])
        if self.kind not in KINDS:
            raise ValueError(f"rule {self.name!r}: unknown kind "
                             f"{self.kind!r} (known: {KINDS})")
        self.metric = spec.get("metric")
        if self.kind != "mark_age" and not self.metric:
            raise ValueError(f"rule {self.name!r}: kind {self.kind!r} "
                             "needs a metric")
        self.op = str(spec.get("op", "ge"))
        if self.op not in _OPS:
            raise ValueError(f"rule {self.name!r}: unknown op {self.op!r}")
        self.value = float(spec.get("value", 1.0))
        self.window_s = float(spec.get("window_s", 60.0))
        for_s = spec.get("for_s")
        self.for_s = default_for_s if for_s is None else float(for_s)
        self.severity = str(spec.get("severity", "warning"))
        if self.severity not in SEVERITIES:
            raise ValueError(f"rule {self.name!r}: unknown severity "
                             f"{self.severity!r}")
        self.of_rate = bool(spec.get("of_rate", False))
        self.recent_s = float(spec.get("recent_s", self.window_s / 4))
        self.baseline_s = float(spec.get("baseline_s",
                                         self.window_s * 3 / 4))
        self.min_total = float(spec.get("min_total", 0.0))
        self.min_baseline = float(spec.get("min_baseline", 0.0))
        self.phase = spec.get("phase")
        self.summary = str(spec.get("summary", ""))

    def metrics(self) -> List[str]:
        if isinstance(self.metric, (list, tuple)):
            return [str(m) for m in self.metric]
        return [str(self.metric)] if self.metric else []

    def to_doc(self) -> Dict[str, Any]:
        return {
            "name": self.name, "kind": self.kind, "metric": self.metric,
            "op": self.op, "value": self.value, "window_s": self.window_s,
            "for_s": self.for_s, "severity": self.severity,
            "phase": self.phase,
        }

    # ---------------------------------------------------------- predicate

    def check(self, store, health=None,
              now: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """The predicate: None when clean, else an annotation dict
        (observed value + whatever names the culprit).  Pure reads over
        the history store / health marks — never mutates either."""
        if self.kind == "mark_age":
            return self._check_mark(health)
        if store is None:
            return None
        if self.kind == "threshold":
            pts = store.series(self.metric, self.window_s, now=now)
            if not pts:
                return None
            v = pts[-1][1]
            return {"value": v} if _OPS[self.op](v, self.value) else None
        if self.kind == "absence":
            newest = store.newest_t() if now is None else now
            if newest is None:
                return None
            pts = store.series(self.metric, self.window_s, now=newest)
            if pts:
                return None
            # Never seen at all = not armed yet (a plane that never
            # published is config, not an incident); seen before but not
            # in the window = went dark.
            if self.metric not in store.all_keys():
                return None
            return {"value": None, "window_s": self.window_s}
        if self.kind == "rate":
            v = store.rate(self.metric, self.window_s, now=now)
            if v is None:
                return None
            return {"value": v} if _OPS[self.op](v, self.value) else None
        if self.kind == "drift":
            v = store.drift(self.metric, self.recent_s, self.baseline_s,
                            now=now, of_rate=self.of_rate)
            if v is None:
                return None
            if self.min_baseline > 0:
                base = self._baseline(store, now)
                if base is None or base < self.min_baseline:
                    return None
            return {"value": v} if _OPS[self.op](v, self.value) else None
        if self.kind == "movement":
            moved = sum(self._movement(store, m, now)
                        for m in self.metrics())
            return ({"value": moved} if _OPS[self.op](moved, self.value)
                    else None)
        if self.kind == "share":
            prefix = str(self.metric) + "{"
            moves: Dict[str, float] = {}
            for key in store.all_keys():
                if not key.startswith(prefix):
                    continue
                # increase() semantics, same as the movement kind: a
                # labelled series BORN inside the window (the first skew
                # fold creates the straggler's gauge) counts its full
                # value when an older row proves the absence.
                moved = self._movement(store, key, now)
                if moved > 0.0:
                    moves[key] = moved
            total = sum(moves.values())
            if total <= 0 or total < self.min_total:
                return None
            top = max(moves, key=moves.get)
            share = moves[top] / total
            if not _OPS[self.op](share, self.value):
                return None
            return {"value": share, "series": top, "total": total,
                    "rank": _label_int(top, "rank")}
        return None

    def _movement(self, store, metric: str,
                  now: Optional[float]) -> float:
        """Windowed counter increase (Prometheus ``increase()`` shape).
        A counter BORN inside the window — python-side counters only
        register on their first ``inc()``, so a first failover creates
        ``tmpi_ps_failover_total`` at 1 — counts its full value, but
        only when an older row proves the absence: at process start the
        store is younger than its counters, and a pre-existing total
        must not read as fresh movement."""
        pts = store.series(metric, self.window_s, now=now)
        if not pts:
            return 0.0
        base = pts[0][1]
        if store.absent_before(metric, pts[0][0]):
            base = 0.0
        return max(0.0, pts[-1][1] - base)

    def _baseline(self, store, now: Optional[float]) -> Optional[float]:
        """The drift rule's baseline quantity (the denominator): the
        base RATE with ``of_rate``, else the baseline-window mean."""
        anchor = store.newest_t() if now is None else now
        if anchor is None:
            return None
        if self.of_rate:
            return store.rate(self.metric, self.baseline_s,
                              now=anchor - self.recent_s)
        pts = store.series(self.metric, self.recent_s + self.baseline_s,
                           now=anchor)
        cut = anchor - self.recent_s
        base_v = [v for t, v in pts if t <= cut]
        return sum(base_v) / len(base_v) if base_v else None

    def _check_mark(self, health) -> Optional[Dict[str, Any]]:
        if health is None:
            return None
        ages = health.mark_ages()
        m = ages.get(str(self.metric))
        if m is None:
            return None
        age, _dg, stalled = m
        if stalled <= 0:
            return None
        frac = age / stalled
        if not _OPS[self.op](frac, self.value):
            return None
        return {"value": frac, "age_s": round(age, 3),
                "stalled_after_s": stalled}


def _label_int(key: str, label: str) -> Optional[int]:
    marker = f'{label}="'
    i = key.find(marker)
    if i < 0:
        return None
    j = key.find('"', i + len(marker))
    try:
        return int(key[i + len(marker):j])
    except (TypeError, ValueError):
        return None


# ----------------------------------------------------------- default pack

#: the stack's known failure signatures as rule specs.  Windows are in
#: seconds of WALL time, so they hold at any sampler interval; for_s
#: values use the ``alert_for_s`` knob default unless a signature is
#: urgent enough to fire on first confirmation (for_s=0).
DEFAULT_PACK: Sequence[Dict[str, Any]] = (
    {"name": "nonfinite_grads", "kind": "movement",
     "metric": "tmpi_numerics_nonfinite_total", "op": "ge", "value": 1.0,
     "window_s": 60.0, "for_s": 0.0, "severity": "critical",
     "summary": "the in-step sentinels counted nonfinite gradient values "
                "— the loss surface or the input data went bad"},
    {"name": "numerics_divergence", "kind": "movement",
     "metric": "tmpi_numerics_divergence_total", "op": "ge", "value": 1.0,
     "window_s": 120.0, "for_s": 0.0, "severity": "critical",
     "summary": "the cross-rank auditor observed a parameter divergence "
                "— some replica is computing numbers the consensus "
                "disowns"},
    {"name": "step_rate_sag", "kind": "drift",
     "metric": "tmpi_engine_steps_total", "of_rate": True,
     "op": "le", "value": 0.7, "window_s": 60.0,
     "severity": "warning", "phase": "auto",
     "summary": "step rate sagged to {value:.2f}x its trailing baseline"},
    {"name": "overlap_collapse", "kind": "drift",
     "metric": "tmpi_engine_sync_overlap_fraction",
     "op": "le", "value": 0.5, "window_s": 60.0, "min_baseline": 0.5,
     "severity": "warning", "phase": "auto",
     "summary": "the collective overlap fraction collapsed to "
                "{value:.2f}x its trailing baseline — the async pipeline "
                "stopped hiding gradient sync (input waits are excluded; "
                "a slow producer pages step_rate_sag instead)"},
    {"name": "ps_storm", "kind": "movement",
     "metric": ["tmpi_ps_client_fenced_total", "tmpi_ps_failover_total",
                "tmpi_ps_promote_total"],
     "op": "ge", "value": 2.0, "window_s": 60.0, "for_s": 0.0,
     "severity": "critical", "phase": "ps",
     "summary": "PS fence/failover/promotion events moved {value:.0f} "
                "times in the window — the parameter-server plane is "
                "limping through failures"},
    {"name": "journal_drop_loss", "kind": "movement",
     "metric": ["tmpi_journal_errors_total",
                'tmpi_trace_dropped_total{plane="hostcomm"}',
                'tmpi_trace_dropped_total{plane="ps"}',
                "tmpi_obs_span_dropped_total"],
     "op": "ge", "value": 1.0, "window_s": 120.0,
     "severity": "warning",
     "summary": "the forensic record is lossy: journal appends failed "
                "or trace rings dropped events ({value:.0f} in the "
                "window) — the post-mortem will have holes"},
    {"name": "straggler_skew", "kind": "share",
     "metric": "tmpi_rank_skew_attributed_seconds",
     "op": "ge", "value": 0.5, "window_s": 120.0, "min_total": 0.05,
     "severity": "warning", "phase": "collective",
     "summary": "one rank holds {value:.0%} of the job's attributed "
                "straggler skew — every collective is gated on it"},
    {"name": "autotune_mix_drift", "kind": "threshold",
     "metric": "tmpi_autotune_mix_drift", "op": "ge", "value": 0.5,
     "window_s": 120.0, "severity": "warning", "phase": "collective",
     "summary": "{value:.0%} of live collective traffic rides "
                "(op, bytes-bucket) cells the autotune winner cache never "
                "measured — the cached verdicts no longer describe this "
                "job's byte mix (the retune controller re-benches on "
                "this)"},
    {"name": "watchdog_near_expiry", "kind": "mark_age",
     "metric": "watchdog", "op": "ge", "value": 0.75, "for_s": 0.0,
     "severity": "critical",
     "summary": "the watchdog mark aged past {value:.0%} of its stalled "
                "threshold — the step loop is about to be declared "
                "wedged"},
    {"name": "leader_missing", "kind": "threshold",
     "metric": "tmpi_leader_missing", "op": "ge", "value": 1.0,
     "window_s": 60.0, "for_s": 0.0, "severity": "critical",
     "summary": "the control-plane leader stopped answering its /healthz "
                "probe — resize proposals have no owner until the "
                "election layer re-elects (runtime/election.py; the "
                "tmpi_leader_rank gauge names the successor once it "
                "does)"},
)


def default_rules(default_for_s: float = 3.0) -> List[AlertRule]:
    from ..runtime import config

    out = []
    for spec in DEFAULT_PACK:
        if spec["name"] == "autotune_mix_drift":
            # The firing level is the retune_mix_threshold knob: the
            # gauge's publisher and this watcher agree on what counts as
            # drifted (the spec's 0.5 is the knob's default).
            spec = dict(spec,
                        value=float(config.get("retune_mix_threshold")))
        out.append(AlertRule(spec, default_for_s=default_for_s))
    return out


def load_rules(path: str, default_for_s: float = 3.0) -> List[AlertRule]:
    """Author-supplied rules: a JSON file holding a list of rule specs
    (or ``{"rules": [...]}``).  A rule whose ``name`` collides with a
    default-pack rule REPLACES it at engine build time — overriding a
    threshold must not need code."""
    with open(path) as f:
        doc = json.load(f)
    specs = doc.get("rules") if isinstance(doc, dict) else doc
    if not isinstance(specs, list):
        raise ValueError(f"{path}: expected a JSON list of rule specs "
                         "(or {'rules': [...]})")
    return [AlertRule(spec, default_for_s=default_for_s) for spec in specs]


# ---------------------------------------------------------------- engine

class AlertEngine:
    """The evaluator: rules x (history store, health marks) -> alert
    states, on the Sampler's cadence (``Sampler.sample_once`` calls
    :meth:`evaluate` right after folding the snapshot — the rules always
    see the row that was just recorded).  Thread-safe: evaluation runs
    on the sampler thread while ``GET /alerts`` snapshots from HTTP
    handler threads.

    ``registry`` receives the engine's own observability
    (``tmpi_alerts_firing``, ``tmpi_alert_transitions_total``,
    ``tmpi_alert_eval_seconds_total``) — the watcher is itself watched.
    """

    def __init__(self, rules: Sequence[AlertRule], store=None,
                 health=None, registry=None, rank: int = 0,
                 eval_every: int = 1, flight_on_critical: bool = True):
        self.rules = list(rules)
        self.store = store
        self.health = health
        self.registry = registry
        self.rank = int(rank)
        self.eval_every = max(1, int(eval_every))
        self.flight_on_critical = bool(flight_on_critical)
        self._lock = threading.Lock()
        self._states: Dict[str, Dict[str, Any]] = {
            r.name: {"state": "inactive", "since": None,
                     "firing_since": None, "annotation": None}
            for r in self.rules}
        self._ticks = 0
        self.evaluations = 0
        self.transitions = 0

    # ----------------------------------------------------------- reading

    def firing(self) -> List[Dict[str, Any]]:
        """The currently-firing alerts (name, severity, phase,
        annotation) — what ``/healthz`` and the autoscaler consume."""
        with self._lock:
            out = []
            for rule in self.rules:
                st = self._states[rule.name]
                if st["state"] == "firing":
                    out.append({
                        "name": rule.name,
                        "severity": rule.severity,
                        "since": st["firing_since"],
                        "phase": (st["annotation"] or {}).get("phase"),
                        "annotation": dict(st["annotation"] or {}),
                    })
            return out

    def snapshot(self) -> Dict[str, Any]:
        """The ``GET /alerts`` document: every rule with its live state."""
        with self._lock:
            states = []
            for rule in self.rules:
                st = self._states[rule.name]
                states.append(dict(rule.to_doc(), state=st["state"],
                                   since=st["since"],
                                   firing_since=st["firing_since"],
                                   annotation=st["annotation"]))
        return {
            "schema": SCHEMA,
            "rank": self.rank,
            "rules": len(self.rules),
            "evaluations": self.evaluations,
            "transitions": self.transitions,
            "firing": self.firing(),
            "states": states,
        }

    # -------------------------------------------------------- evaluation

    def tick(self) -> Optional[List[Dict[str, Any]]]:
        """The sampler hook: evaluate every ``eval_every`` ticks (None
        on skipped ticks).  Exceptions stay inside — a bad rule must not
        end the sampler for the rest of the job."""
        self._ticks += 1
        if self._ticks % self.eval_every:
            return None
        try:
            return self.evaluate()
        except Exception:  # noqa: BLE001 — the job outranks its watcher
            return None

    def evaluate(self, now: Optional[float] = None,
                 ) -> List[Dict[str, Any]]:
        """One pass over every rule; returns the lifecycle TRANSITIONS
        this pass produced (each already journaled).  ``now`` anchors
        the history queries (tests replay seeded stores)."""
        t0 = time.perf_counter()
        wall = time.time() if now is None else float(now)
        transitions: List[Dict[str, Any]] = []
        for rule in self.rules:
            try:
                annotation = rule.check(self.store, health=self.health,
                                        now=now)
            except Exception:  # noqa: BLE001 — one bad rule, not the pass
                continue
            tr = self._advance(rule, annotation, wall)
            if tr is not None:
                transitions.append(tr)
        self.evaluations += 1
        if self.registry is not None:
            self._publish(time.perf_counter() - t0)
        for tr in transitions:
            self._emit(tr)
        return transitions

    def _advance(self, rule: AlertRule, annotation: Optional[Dict[str, Any]],
                 wall: float) -> Optional[Dict[str, Any]]:
        with self._lock:
            st = self._states[rule.name]
            state = st["state"]
            if annotation is not None:
                if rule.phase == "auto":
                    annotation["phase"] = self._auto_phase()
                elif rule.phase:
                    annotation["phase"] = str(rule.phase)
                if rule.summary:
                    try:
                        annotation["summary"] = rule.summary.format(
                            **annotation)
                    except (KeyError, ValueError, IndexError):
                        annotation["summary"] = rule.summary
                st["annotation"] = annotation
                if state in ("inactive", "resolved"):
                    st["state"], st["since"] = "pending", wall
                    if wall - st["since"] < rule.for_s:
                        return self._transition(rule, state, "pending",
                                                wall)
                    # for_s == 0: fall through to fire on this pass.
                    state = "pending"
                if state == "pending" and wall - st["since"] >= rule.for_s:
                    st["state"], st["firing_since"] = "firing", wall
                    return self._transition(rule, "pending", "firing", wall)
                return None
            # predicate clean
            if state == "firing":
                st["state"], st["since"] = "resolved", wall
                st["firing_since"] = None
                return self._transition(rule, "firing", "resolved", wall)
            if state == "pending":
                # a flap inside for_s never fired and never resolves —
                # it just goes back to inactive, unjournaled noise.
                st["state"], st["since"] = "inactive", None
                st["annotation"] = None
            return None

    def _transition(self, rule: AlertRule, prev: str, new: str,
                    wall: float) -> Dict[str, Any]:
        self.transitions += 1
        st = self._states[rule.name]
        return {
            "rule": rule.name,
            "severity": rule.severity,
            "from": prev,
            "to": new,
            "wall": wall,
            "annotation": dict(st["annotation"] or {}),
        }

    def _auto_phase(self) -> Optional[str]:
        """Name the step phase whose gauge history drifted UP the most —
        the attribution a ``phase="auto"`` rule attaches at firing time.
        Absolute-seconds movement breaks ties toward the phase that
        actually costs wall time (a 3x drift of a 10 us phase must not
        outrank a 1.5x drift of a 300 ms one)."""
        if self.store is None:
            return None
        best, best_score = None, 0.0
        for phase in PHASES:
            key = f'tmpi_step_phase_seconds{{phase="{phase}"}}'
            drift = self.store.drift(key, self.recent_s_for_phase(),
                                     self.baseline_s_for_phase())
            pts = self.store.series(key, self.recent_s_for_phase())
            level = pts[-1][1] if pts else 0.0
            if drift is None or drift <= 1.0:
                continue
            score = (drift - 1.0) * max(level, 1e-9)
            if score > best_score:
                best, best_score = phase, score
        return best

    @staticmethod
    def recent_s_for_phase() -> float:
        return 15.0

    @staticmethod
    def baseline_s_for_phase() -> float:
        return 45.0

    # ----------------------------------------------------------- effects

    def _publish(self, eval_s: float) -> None:
        try:
            firing = self.firing()
            self.registry.gauge(
                "tmpi_alerts_firing",
                "alert rules currently in the firing state").set(
                    float(len(firing)))
            self.registry.counter(
                "tmpi_alert_transitions_total",
                "alert lifecycle transitions since start").set_to(
                    float(self.transitions))
            self.registry.counter(
                "tmpi_alert_eval_seconds_total",
                "cumulative wall seconds spent evaluating alert rules",
            ).inc(max(0.0, eval_s))
        except Exception:  # noqa: BLE001
            pass

    def _emit(self, tr: Dict[str, Any]) -> None:
        """Journal the transition + the critical-firing flight dump.
        Both paths swallow — the watcher must never compound what it
        watched."""
        from . import journal as journal_mod

        journal_mod.emit(f"alert.{tr['to']}", rank=self.rank,
                         rule=tr["rule"], severity=tr["severity"],
                         previous=tr["from"],
                         annotation=tr["annotation"])
        if (tr["to"] == "firing" and tr["severity"] == "critical"
                and self.flight_on_critical):
            try:
                from . import flight

                flight.on_failure(f"alert_{tr['rule']}",
                                  rule=tr["rule"],
                                  severity=tr["severity"],
                                  **{k: v for k, v in
                                     tr["annotation"].items()
                                     if isinstance(v, (int, float, str))})
            except Exception:  # noqa: BLE001
                pass


# ------------------------------------------------------ phase attribution

def phase_seconds(spans: Sequence[Mapping[str, Any]],
                  ) -> Dict[str, float]:
    """The span-derived step decomposition: bucket the child spans of
    the LAST complete ``engine.step`` by :data:`SPAN_PHASE` (plus the
    plane prefixes — ``hostcomm.*`` time is ``collective``, ``ps.*`` is
    ``ps``), in seconds.  The engine's live gauges use its own
    timestamps (they publish even with tracing off); this function is
    the offline twin for obsdump analysis and the math the tests pin —
    both must tell the same story about where the step's time went."""
    steps = [s for s in spans if s.get("name") == "engine.step"]
    out = {p: 0.0 for p in PHASES}
    if not steps:
        return out
    step = steps[-1]
    t0, t1 = step["t0_ns"], step["t1_ns"]
    for s in spans:
        name = s.get("name", "")
        if s is step or s["t0_ns"] < t0 or s["t1_ns"] > t1:
            continue
        phase = SPAN_PHASE.get(name)
        if phase is None:
            if name.startswith("hostcomm."):
                phase = "collective"
            elif name.startswith("ps."):
                phase = "ps"
            else:
                continue
        out[phase] += (s["t1_ns"] - s["t0_ns"]) / 1e9
    return out


# ------------------------------------------------- process-level singleton

_engine: Optional[AlertEngine] = None
_lock = threading.Lock()


def engine() -> Optional[AlertEngine]:
    """The process alert engine (None until armed) — what ``GET
    /alerts`` serves and ``/healthz`` consults."""
    return _engine


def snapshot() -> Optional[Dict[str, Any]]:
    e = _engine
    return e.snapshot() if e is not None else None


def build_engine(store=None, health=None, registry=None, rank: int = 0,
                 cfg: Optional[dict] = None) -> AlertEngine:
    """Assemble an engine from config (callers build private ones per
    simulated rank; :func:`maybe_start` builds the process singleton).
    Path rules override same-named default-pack rules."""
    cfg = cfg or alerts_config()
    rules: List[AlertRule] = (default_rules(cfg["for_s"])
                              if cfg["default_pack"] else [])
    if cfg["rules_path"]:
        extra = load_rules(cfg["rules_path"], default_for_s=cfg["for_s"])
        override = {r.name for r in extra}
        rules = [r for r in rules if r.name not in override] + extra
    return AlertEngine(rules, store=store, health=health,
                       registry=registry, rank=rank,
                       eval_every=cfg["eval_every"],
                       flight_on_critical=cfg["flight"])


def maybe_start(rank: int = 0) -> Optional[AlertEngine]:
    """Arm the process alert engine iff ``alert_enabled`` is on and none
    is armed (called by ``history.maybe_start`` right after the sampler
    starts — the rules ride its cadence).  One config read when off.
    The engine binds the process history store, the process health
    state (firing alerts degrade ``/healthz``) and the process registry.
    """
    global _engine
    cfg = alerts_config()
    if not cfg["enabled"]:
        return None
    with _lock:
        if _engine is not None:
            return _engine
        from . import history as history_mod
        from . import serve as serve_mod
        from .metrics import registry as registry_

        eng = build_engine(store=history_mod.store(),
                           health=serve_mod.health,
                           registry=registry_, rank=rank, cfg=cfg)
        serve_mod.health.attach_alerts(eng.firing)
        sampler = history_mod.sampler()
        if sampler is not None:
            sampler.alert_engine = eng
        _engine = eng
        return eng


def stop() -> None:
    """Disarm the process engine (no-op when not armed): detach from the
    sampler and the health state; states are dropped — a re-arm starts
    clean."""
    global _engine
    with _lock:
        eng, _engine = _engine, None
    if eng is None:
        return
    from . import history as history_mod
    from . import serve as serve_mod

    sampler = history_mod.sampler()
    if sampler is not None and sampler.alert_engine is eng:
        sampler.alert_engine = None
    serve_mod.health.attach_alerts(None)


def reset() -> None:
    """Tests: disarm and forget (the singleton is process-global)."""
    stop()
