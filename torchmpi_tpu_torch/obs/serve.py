"""Live telemetry & health plane: the per-rank HTTP endpoint.

The port's copy of ``torchmpi_tpu/obs/serve.py``.  A supervisor asks a
rank "are you moving?" without waiting for its exit code, a dashboard
scrapes it while the job runs.  The surface is a stdlib ``http.server``
on a daemon thread, loopback-bound by default, gated by the ``obs_http``
/ ``obs_http_port`` / ``obs_http_bind`` knobs and started/stopped by
``runtime/lifecycle.py``:

* ``GET /metrics``  — live Prometheus exposition from the metrics
  registry (a ``scrape_native()`` pass first, so the C-ABI counters are
  fresh), one snapshot walk via ``Registry.collect``.
* ``GET /healthz``  — the health state machine below, as JSON with
  machine-readable reasons.  ``healthy``/``degraded`` answer 200,
  ``stalled``/``diverged``/``draining`` answer 503 so a dumb LB/poller
  can act on the status code alone.
* ``GET /spans``    — the most recent finished spans (peeked, never
  drained — a probe must not steal a later export's history), bounded by
  ``?limit=``.
* ``GET /journal``  — bounded tail of this process's event journal
  (``obs/journal.py``; in-memory copy, never a disk read on the request
  path), with the active segment path so a poller can find the full
  on-disk record.  ``?limit=``.
* ``GET /history``  — the on-disk metrics history (``obs/history.py``):
  tier shapes + key list, or with ``?metric=&window_s=`` the series,
  trailing ``rate`` and rate-``drift`` for one metric — the trend feed a
  dashboard or an autoscaler polls.
* ``GET /alerts``   — the declarative alert plane's live state
  (``obs/alerts.py``): every rule with its pending/firing/resolved
  lifecycle state and the currently-firing list.
* ``POST /flight``  — trigger an on-demand flight-recorder dump
  (``obs/flight.py``); returns the bundle path.
* ``POST /resize``  — queue a resize request for the leader
  (``runtime/resize.enqueue_request``; 409 while ``resize_enabled`` is
  off); a non-leader answers a typed 307 naming the leader
  (``runtime/election.leader_info``).

* ``GET /retune``  — the installed retune controller's snapshot
  (``collectives/retune.installed``), or ``{"enabled": false}`` when none
  is installed.

Health state machine (:class:`HealthState`): five states with strict
precedence ``stalled > diverged > draining > degraded > healthy``,
derived from

* **progress marks** — named monotonic heartbeats (``note(name)``): the
  engine step loop and ``runtime/failure.Watchdog.kick`` publish them.
  A mark older than its degraded/stalled threshold moves the state; a
  registered watchdog derives the thresholds from its own timeout
  (degraded at 25%, stalled at 50% — so an external poller converts a
  wedge to ``EXIT_STALLED`` *before* the in-process watchdog expires).
* **watched error counters** — the PS fence/failover/exception family:
  a counter that moved within ``error_window_s`` reads ``degraded``
  (the job is limping through failovers, not dead).
* **the drain flag** — ``set_draining(True)`` during intentional
  teardown/handoff, so a supervisor distinguishes "leaving on purpose"
  from "wedged".
* **the diverged flag** — ``set_diverged(...)`` when the numerics
  auditor (``obs/numerics.py``) names this rank the outlier of a
  cross-rank parameter divergence: the rank is alive and moving but
  computing the WRONG numbers, which no liveness mark can see.  Cleared
  by the next clean audit (``clear_diverged``) — recovery is
  observable, not sticky.

The aggregator half (federation, the job verdict) is ``obs/cluster.py``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from . import native as obs_native
from . import tracer

__all__ = [
    "HealthState",
    "ObsHTTPServer",
    "health",
    "maybe_start",
    "metrics_feed",
    "note",
    "publish_input",
    "publish_step",
    "server",
    "start",
    "stop",
    "url",
]

STATES = ("healthy", "degraded", "diverged", "stalled", "draining")


#: mark thresholds when nothing tighter is known (no watchdog registered
#: and the mark was not monitor()'d with explicit bounds).
DEFAULT_DEGRADED_S = 30.0
DEFAULT_STALLED_S = 120.0
#: a registered watchdog tightens the defaults to fractions of its own
#: timeout: /healthz must flip to ``stalled`` while the watchdog still
#: has half its budget left, so a poller (elastic_launch --health-poll)
#: converts the wedge to EXIT_STALLED faster than in-process expiry.
WATCHDOG_DEGRADED_FRACTION = 0.25
WATCHDOG_STALLED_FRACTION = 0.5

#: registry counters whose *movement* (not value) marks the process
#: degraded: a rank riding PS fences/failovers/exceptions is limping.
WATCHED_COUNTERS = (
    "tmpi_ps_client_fenced_total",
    "tmpi_ps_failover_total",
    "tmpi_ps_promote_total",
    "tmpi_ps_server_exception_total",
    "tmpi_ps_snapshot_error_total",
    "tmpi_ps_forward_error_total",
    # numerics plane (obs/numerics.py): a rank that OBSERVED a
    # cross-rank divergence is limping even when it is not the outlier
    # (the outlier itself trips the dedicated `diverged` state below).
    "tmpi_numerics_divergence_total",
)

#: strict state precedence.  ``diverged`` (the numerics auditor's
#: replica-fork verdict) sits ABOVE draining — wrong numbers trump an
#: intentional teardown — and BELOW stalled: a wedged process cannot
#: serve traffic at all, and stall conversion must keep winning the
#: supervisor race.
_SEVERITY = {"healthy": 0, "degraded": 1, "draining": 2, "diverged": 3,
             "stalled": 4}


class HealthState:
    """The per-process health state machine (module singleton
    :data:`health`; several replicas or ranks in one process build private
    instances).

    Thread-safety: :meth:`note` is the hot path (once per training step,
    once per watchdog kick) — a dict lookup plus a list-slot store, no
    lock (each mark's slot is only ever replaced, and a torn read of a
    float timestamp is impossible under the GIL).  Everything else locks.
    """

    def __init__(self, error_window_s: float = 60.0,
                 name: str = ""):
        self._lock = threading.Lock()
        # name -> [last_beat_monotonic, degraded_after_s|None,
        #          stalled_after_s|None]  (None = derived defaults)
        self._marks: Dict[str, List[Any]] = {}
        self._draining = False
        self._diverged: Optional[Dict[str, Any]] = None
        self._watchdog_timeout: Optional[float] = None
        # counter -> [last_seen_value, last_move_monotonic|None]
        self._counters: Dict[str, List[Any]] = {}
        self.error_window_s = float(error_window_s)
        self.default_degraded_s = DEFAULT_DEGRADED_S
        self.default_stalled_s = DEFAULT_STALLED_S
        # callable returning the firing alerts (obs/alerts.py attaches
        # the process engine's .firing); None = no alert plane armed.
        self._alerts_provider: Optional[Any] = None
        #: journal label when several instances run in one process
        self.name = str(name)
        # last verdict, for journaling TRANSITIONS only (obs/journal.py):
        # a healthy rank polled every second must not write a line per
        # poll — only the edges are state changes worth the journal.
        self._last_state: Optional[str] = None

    # ------------------------------------------------------------ inputs

    def note(self, name: str) -> None:
        """Record progress on ``name`` now (auto-registers the mark with
        derived thresholds on first sight)."""
        m = self._marks.get(name)
        if m is None:
            with self._lock:
                m = self._marks.setdefault(
                    name, [time.monotonic(), None, None])
        m[0] = time.monotonic()

    def monitor(self, name: str,
                degraded_after_s: Optional[float] = None,
                stalled_after_s: Optional[float] = None) -> None:
        """Register ``name`` as a monitored progress mark with explicit
        thresholds (None = the derived defaults), beating it now."""
        with self._lock:
            self._marks[name] = [time.monotonic(), degraded_after_s,
                                 stalled_after_s]

    def clear(self, name: str) -> None:
        """Forget a mark — a loop that ENDED on purpose must not read as
        stalled forever after (the engine clears ``engine_step`` when
        ``train()`` returns; ``Watchdog.stop`` clears ``watchdog``)."""
        with self._lock:
            self._marks.pop(name, None)

    def register_watchdog(self, timeout_s: float) -> None:
        """A :class:`runtime.failure.Watchdog` exists with this timeout:
        tighten the derived thresholds to fractions of it and start the
        ``watchdog`` mark (kicks keep it beating)."""
        with self._lock:
            self._watchdog_timeout = float(timeout_s)
            self._marks["watchdog"] = [time.monotonic(), None, None]

    def unregister_watchdog(self) -> None:
        with self._lock:
            self._watchdog_timeout = None
            self._marks.pop("watchdog", None)

    def set_draining(self, flag: bool = True) -> None:
        with self._lock:
            self._draining = bool(flag)

    @property
    def draining(self) -> bool:
        return self._draining

    def set_diverged(self, leaf: str = "", step: Optional[int] = None,
                     outlier_ranks: Optional[List[int]] = None,
                     detail: str = "") -> None:
        """The numerics auditor's verdict: this rank's parameters forked
        from the replica consensus at ``leaf`` — /healthz reads
        ``diverged`` (503) until :meth:`clear_diverged`."""
        with self._lock:
            self._diverged = {
                "leaf": str(leaf),
                "step": None if step is None else int(step),
                "outlier_ranks": (None if outlier_ranks is None
                                  else [int(r) for r in outlier_ranks]),
                "detail": str(detail),
                "since": time.monotonic(),
            }

    def clear_diverged(self) -> None:
        """A clean audit: the replicas agree again (or the divergent rank
        was restored) — the state must recover, not stick."""
        with self._lock:
            self._diverged = None

    @property
    def diverged(self) -> Optional[Dict[str, Any]]:
        return self._diverged

    def attach_alerts(self, provider) -> None:
        """Feed firing alerts into the verdict (obs/alerts.py): the
        provider is called per evaluation and each firing alert reads
        ``degraded`` — never higher.  A wedge still outranks an alert
        (stall conversion must keep winning the supervisor race), and a
        diverged replica still outranks a page.  ``None`` detaches."""
        with self._lock:
            self._alerts_provider = provider

    def mark_ages(self) -> Dict[str, Tuple[float, float, float]]:
        """Every progress mark as ``name -> (age_s, degraded_after_s,
        stalled_after_s)`` — the read the alert plane's ``mark_age``
        rules (watchdog-near-expiry) poll without forcing a full
        /healthz evaluation (which journals transitions)."""
        now = time.monotonic()
        with self._lock:
            marks = {k: list(v) for k, v in self._marks.items()}
        out: Dict[str, Tuple[float, float, float]] = {}
        for name, m in marks.items():
            dg, st = self._thresholds(m)
            out[name] = (now - m[0], dg, st)
        return out

    def reset(self) -> None:
        """Back to a fresh instance's state (tests; the singleton is
        process-global)."""
        with self._lock:
            self._marks.clear()
            self._counters.clear()
            self._draining = False
            self._diverged = None
            self._watchdog_timeout = None
            self._last_state = None
            self._alerts_provider = None

    # ----------------------------------------------------------- verdict

    def _thresholds(self, mark: List[Any]) -> Tuple[float, float]:
        dg, st = mark[1], mark[2]
        if dg is None:
            dg = (self._watchdog_timeout * WATCHDOG_DEGRADED_FRACTION
                  if self._watchdog_timeout else self.default_degraded_s)
        if st is None:
            st = (self._watchdog_timeout * WATCHDOG_STALLED_FRACTION
                  if self._watchdog_timeout else self.default_stalled_s)
        return float(dg), float(st)

    def evaluate(self, registry=None) -> Dict[str, Any]:
        """The /healthz verdict: state + machine-readable reasons +
        every input that fed the decision.  ``registry`` (default: the
        process registry) supplies the watched error counters; the first
        evaluation baselines them so pre-existing counts never flag."""
        if registry is None:
            from .metrics import registry as registry_
            registry = registry_
        now = time.monotonic()
        reasons: List[Dict[str, Any]] = []
        worst = "healthy"

        def raise_to(state: str) -> None:
            nonlocal worst
            if _SEVERITY[state] > _SEVERITY[worst]:
                worst = state

        with self._lock:
            marks = {k: list(v) for k, v in self._marks.items()}
            draining = self._draining
            diverged = dict(self._diverged) if self._diverged else None
            wd_timeout = self._watchdog_timeout

        mark_view: Dict[str, Any] = {}
        for name, m in sorted(marks.items()):
            age = now - m[0]
            dg, st = self._thresholds(m)
            mark_view[name] = {"age_s": round(age, 3),
                               "degraded_after_s": dg,
                               "stalled_after_s": st}
            if st > 0 and age > st:
                raise_to("stalled")
                reasons.append({
                    "code": f"stalled:{name}",
                    "detail": f"no {name} progress for {age:.1f}s "
                              f"(stalled threshold {st:.1f}s)"})
            elif dg > 0 and age > dg:
                raise_to("degraded")
                reasons.append({
                    "code": f"degraded:{name}",
                    "detail": f"no {name} progress for {age:.1f}s "
                              f"(degraded threshold {dg:.1f}s)"})

        counter_view: Dict[str, float] = {}
        for cname in WATCHED_COUNTERS:
            try:
                # peek, never get-or-create: a registry that has not
                # scraped these families must not grow empty ones just
                # because /healthz looked.
                m = registry.peek(cname)
                if m is None:
                    continue
                v = float(m.value())
            except Exception:
                continue
            counter_view[cname] = v
            with self._lock:
                seen = self._counters.get(cname)
                if seen is None:
                    self._counters[cname] = [v, None]
                    continue
                if v > seen[0]:
                    seen[0], seen[1] = v, now
                moved_at = seen[1]
            if moved_at is not None and now - moved_at <= self.error_window_s:
                raise_to("degraded")
                reasons.append({
                    "code": f"counter:{cname}",
                    "detail": f"{cname} moved {now - moved_at:.1f}s ago "
                              f"(window {self.error_window_s:.0f}s)"})

        # Firing alerts (obs/alerts.py) read DEGRADED — and only
        # degraded: the alert plane may page, but it must never outrank
        # the liveness machine (stalled) or the numerics auditor
        # (diverged) in the supervisor's eyes.  Precedence is enforced
        # by construction: raise_to("degraded") cannot lower a higher
        # state.
        firing_view: List[Dict[str, Any]] = []
        with self._lock:
            provider = self._alerts_provider
        if provider is not None:
            try:
                firing_view = list(provider())
            except Exception:  # noqa: BLE001 — the watcher must not
                firing_view = []   # take the health verdict down with it
            for al in firing_view:
                raise_to("degraded")
                reasons.append({
                    "code": f"alert:{al.get('name')}",
                    "detail": f"alert {al.get('name')} is firing "
                              f"(severity {al.get('severity')}"
                              + (f", phase {al['phase']}"
                                 if al.get("phase") else "") + ")"})

        if draining:
            raise_to("draining")
            reasons.append({"code": "draining",
                            "detail": "drain flag set (intentional "
                                      "teardown/handoff in progress)"})
        if diverged is not None:
            raise_to("diverged")
            age = now - diverged.pop("since", now)
            reasons.append({
                "code": f"diverged:{diverged.get('leaf') or 'params'}",
                "detail": "cross-rank parameter divergence at "
                          f"{diverged.get('leaf') or '(unknown leaf)'} "
                          f"({age:.1f}s ago, step "
                          f"{diverged.get('step')}, outliers "
                          f"{diverged.get('outlier_ranks')}) — this rank "
                          "is computing numbers the replica consensus "
                          "disowns"})
        # Journal the TRANSITION (obs/journal.py; one config read when
        # journaling is off): the live verdict vanishes within one scrape
        # window — the edge healthy->stalled at 14:03:07 is exactly what
        # a post-mortem reconstructs the incident from.
        with self._lock:
            prev, self._last_state = self._last_state, worst
        if prev != worst:
            from . import journal as _journal

            _journal.emit("health.transition",
                          **{"from": prev, "to": worst,
                             "name": self.name,
                             "reasons": [c["code"] for c in reasons]})
        return {
            "state": worst,
            "reasons": reasons,
            "marks": mark_view,
            "counters": counter_view,
            "draining": draining,
            "alerts_firing": [a.get("name") for a in firing_view],
            "diverged": diverged,
            "watchdog_timeout_s": wd_timeout,
            "planes": {p: obs_native.loaded(p) for p in ("hostcomm", "ps")},
            "pid": os.getpid(),
            "t_mono_ns": tracer.now_ns(),
        }


# ------------------------------------------------------------ HTTP server

class _Handler(BaseHTTPRequestHandler):
    server_version = "tmpi-obs/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, *args: Any) -> None:  # silence per-request noise
        pass

    def _send(self, code: int, body: bytes,
              ctype: str = "application/json") -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj: Any,
                   location: Optional[str] = None) -> None:
        body = json.dumps(obj, indent=1).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        if location:
            self.send_header("Location", location)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _scraped_registry(self):
        srv = self.server
        if srv.tmpi_scrape:
            try:
                srv.tmpi_registry.scrape_native()
            except Exception:
                pass  # half a panel beats a 500 (flight.py's discipline)
        return srv.tmpi_registry

    def do_GET(self) -> None:  # noqa: N802 - http.server API
        parsed = urlparse(self.path)
        if parsed.path == "/metrics":
            text = self._scraped_registry().to_prometheus()
            self._send(200, text.encode(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif parsed.path in ("/healthz", "/health"):
            verdict = self.server.tmpi_health.evaluate(
                self._scraped_registry())
            verdict["rank"] = self.server.tmpi_rank
            code = 200 if verdict["state"] in ("healthy", "degraded") else 503
            self._send_json(code, verdict)
        elif parsed.path == "/spans":
            try:
                limit = int(parse_qs(parsed.query).get("limit", ["256"])[0])
            except (TypeError, ValueError):
                limit = 256
            limit = max(1, min(limit, 4096))
            from . import aggregate  # lazy: pulls numpy

            spans = tracer.peek()[-limit:]
            self._send_json(200, {
                "returned": len(spans),
                "dropped": tracer.dropped(),
                "spans": [dict(s, attrs=aggregate.json_attrs(s["attrs"]))
                          for s in spans],
            })
        elif parsed.path == "/journal":
            from . import journal as journal_mod

            try:
                limit = int(parse_qs(parsed.query).get("limit", ["64"])[0])
            except (TypeError, ValueError):
                limit = 64
            records = journal_mod.tail(max(1, min(limit, 1024)))
            self._send_json(200, {
                "enabled": journal_mod.enabled(),
                "returned": len(records),
                "segment": journal_mod.active_segment(),
                "errors": journal_mod.errors(),
                "records": records,
            })
        elif parsed.path == "/alerts":
            from . import alerts as alerts_mod

            eng = self.server.tmpi_alerts
            if eng is None:
                eng = alerts_mod.engine()
            if eng is None:
                self._send_json(200, {"enabled": False, "rules": 0,
                                      "firing": [], "states": []})
                return
            doc = eng.snapshot()
            doc["enabled"] = True
            doc["rank"] = self.server.tmpi_rank
            self._send_json(200, doc)
        elif parsed.path == "/history":
            from . import history as history_mod

            st = self.server.tmpi_history
            if st is None:
                st = history_mod.store()
            q = parse_qs(parsed.query)
            if st is None:
                self._send_json(200, {"enabled": False, "tiers": [],
                                      "keys": []})
                return
            doc: Dict[str, Any] = {"enabled": True, "tiers": st.tiers()}
            metric = (q.get("metric") or [None])[0]
            if metric is None:
                doc["keys"] = st.keys()
            else:
                try:
                    window_s = float((q.get("window_s") or ["600"])[0])
                except (TypeError, ValueError):
                    window_s = 600.0
                doc["metric"] = metric
                doc["window_s"] = window_s
                doc["series"] = st.series(metric, window_s)[-2048:]
                doc["rate"] = st.rate(metric, window_s)
                doc["drift"] = st.drift(metric, window_s / 4,
                                        window_s * 3 / 4, of_rate=True)
            self._send_json(200, doc)
        elif parsed.path == "/retune":
            from ..collectives import retune as retune_mod

            ctl = retune_mod.installed()
            if ctl is None:
                self._send_json(200, {"enabled": False})
                return
            doc = ctl.snapshot()
            doc["enabled"] = True
            doc["rank"] = self.server.tmpi_rank
            self._send_json(200, doc)
        else:
            self._send_json(404, {"error": f"no route {parsed.path}",
                                  "routes": ["/metrics", "/healthz",
                                             "/spans", "/journal",
                                             "/history", "/alerts",
                                             "/retune",
                                             "POST /flight",
                                             "POST /resize"]})

    def do_POST(self) -> None:  # noqa: N802 - http.server API
        # Drain the body BEFORE responding: under this handler's
        # HTTP/1.1 keep-alive, unread body bytes would be parsed as the
        # next request line on a reused connection (curl -d / Session).
        # The first MiB is kept for routes that read it (/resize).
        try:
            length = int(self.headers.get("Content-Length", 0) or 0)
        except (TypeError, ValueError):
            length = 0
        body = bytearray()
        while length > 0:
            chunk = self.rfile.read(min(length, 1 << 16))
            if not chunk:
                break
            if len(body) < (1 << 20):
                body += chunk
            length -= len(chunk)
        parsed = urlparse(self.path)
        if parsed.path == "/flight":
            from . import flight

            try:
                path = flight.dump("http_request")
            except Exception as e:  # noqa: BLE001 - surfaced to the caller
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send_json(200, {"path": path})
        elif parsed.path == "/resize":
            # Elastic-resize request inbox (runtime/resize.py): the body
            # queues for the LEADER rank's controller, which shapes and
            # validates it at the next step boundary.  Gated by
            # resize_enabled: an unarmed endpoint must not make
            # membership mutable from the network.  A NON-leader answers
            # a typed 307 carrying the current leader's endpoint
            # (runtime/election.leader_info, or the server's ``leader=``
            # provider) instead of queueing into an inbox nobody pops.
            from ..runtime import resize as resize_mod

            info = None
            provider = getattr(self.server, "tmpi_leader", None)
            try:
                if callable(provider):
                    info = provider()
                else:
                    from ..runtime import election as election_mod

                    info = election_mod.leader_info()
            except Exception:  # noqa: BLE001 — an unresolvable leader
                info = None    # view must not 500 the inbox
            if isinstance(info, dict) and not info.get("is_self", True):
                ep = info.get("endpoint")
                loc = (f"http://{ep[0]}:{ep[1]}/resize"
                       if ep and len(ep) == 2 else None)
                self._send_json(307, {
                    "error": "this rank is not the control-plane leader",
                    "redirect": True,
                    "leader_rank": info.get("rank"),
                    "leader_endpoint": (list(ep) if ep else None),
                    "location": loc,
                }, location=loc)
                return
            try:
                doc = json.loads(bytes(body).decode() or "{}")
            except (ValueError, UnicodeDecodeError):
                doc = None
            if not isinstance(doc, dict):
                # 400 = fix your payload; 409 below is reserved for the
                # unarmed endpoint (resize_enabled off) so clients can
                # tell the two apart.
                self._send_json(400, {"error": "body must be a JSON "
                                               "object resize request"})
                return
            try:
                queued = resize_mod.enqueue_request(doc)
            except resize_mod.ResizeRejected as e:
                self._send_json(409, {"error": str(e)})
                return
            self._send_json(200, {"queued": queued})
        else:
            self._send_json(404, {"error": f"no route POST {parsed.path}"})


class ObsHTTPServer:
    """One rank's live endpoint: ``ThreadingHTTPServer`` + daemon thread.

    ``registry``/``health`` default to the process singletons; pass
    private instances to stand several replicas or ranks up in one
    process.
    ``scrape=False`` skips the per-request ``scrape_native`` pass (for
    registries that are NOT views of this process's native counters).
    """

    def __init__(self, bind: str = "127.0.0.1", port: int = 0,
                 registry=None, health: Optional[HealthState] = None,
                 scrape: bool = True, rank: int = 0, history=None,
                 alerts=None, leader=None):
        if registry is None:
            from .metrics import registry as registry_
            registry = registry_
        self._httpd = ThreadingHTTPServer((bind, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.tmpi_registry = registry
        self._httpd.tmpi_health = health if health is not None else globals()["health"]
        self._httpd.tmpi_scrape = bool(scrape)
        self._httpd.tmpi_rank = int(rank)
        # None = resolve the process history store per request (it may
        # start after the endpoint); callers may pass private stores.
        self._httpd.tmpi_history = history
        # Same contract for the alert engine (obs/alerts.py): None =
        # resolve the process engine per request.
        self._httpd.tmpi_alerts = alerts
        # Leader view for POST /resize's 307 redirect: a callable
        # returning runtime/election.leader_info()'s shape.  None =
        # resolve the process's election view per request.
        self._httpd.tmpi_leader = leader
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            daemon=True, name=f"tmpi-obs-http-{self.port}")
        self._thread.start()

    @property
    def address(self) -> Tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def port(self) -> int:
        return int(self._httpd.server_address[1])

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self) -> "ObsHTTPServer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


# ------------------------------------------------- process-level singletons

#: the process health state every instrumented layer publishes into.
health = HealthState()

_server: Optional[ObsHTTPServer] = None
_server_lock = threading.Lock()


def server() -> Optional[ObsHTTPServer]:
    return _server


def url() -> Optional[str]:
    """This process's live endpoint base URL (None when not serving)."""
    s = _server
    return s.url if s is not None else None


def start(port: Optional[int] = None, bind: Optional[str] = None,
          rank: int = 0) -> ObsHTTPServer:
    """Start the process endpoint (knob defaults for port/bind); raises
    if already serving — two endpoints for one process is a config bug."""
    global _server
    cfg = obs_native.serve_config()
    with _server_lock:
        if _server is not None:
            raise RuntimeError(
                f"obs http endpoint already serving at {_server.url}")
        _server = ObsHTTPServer(
            bind=cfg["bind"] if bind is None else bind,
            port=cfg["port"] if port is None else port,
            rank=rank)
        return _server


def stop() -> None:
    """Stop the process endpoint (no-op when not serving)."""
    global _server
    with _server_lock:
        s, _server = _server, None
    if s is not None:
        s.close()


def maybe_start(rank: int = 0) -> Optional[ObsHTTPServer]:
    """Start the endpoint iff the ``obs_http`` knob is on and nothing is
    serving yet (``runtime/lifecycle.start``'s entry point).  A taken
    port logs and returns None instead of failing runtime start — the
    job matters more than its instrument panel."""
    cfg = obs_native.serve_config()
    if not cfg["http"]:
        return None
    if _server is not None:
        return _server
    try:
        return start(rank=rank)
    except OSError as e:
        from ..utils.logging import get_logger

        get_logger("torchmpi_tpu_torch.obs.serve").warning(
            "obs http endpoint could not bind %s:%s (%s) — continuing "
            "without live telemetry", cfg["bind"], cfg["port"], e)
        return None


# ----------------------------------------------------- engine feed helpers

def metrics_feed() -> bool:
    """Whether the engine should publish its per-step gauges: someone is
    (or could be) watching — the endpoint is up, its knob is on, tracing
    is on (the gauges also land in obsdump metric snapshots), or the
    numerics plane is on (its sentinels are per-step gauges)."""
    from ..runtime import config
    from . import numerics

    return (_server is not None or bool(config.get("obs_http"))
            or bool(config.get("obs_trace"))
            or str(config.get("numerics_mode")) in numerics.SENTINEL_MODES)


def note(name: str) -> None:
    """Module-level convenience for :meth:`HealthState.note` on the
    singleton (what the hot paths call)."""
    health.note(name)


def begin_drain(reason: str = "") -> None:
    """Publicly enter the draining state on the singleton health.

    Historically the drain flag was only flipped by the clean-stop paths
    (``runtime/lifecycle.stop`` / ``scripts/ps_server``), so a serving
    replica about to hand its keys off had no way to make ``/healthz``
    read ``draining`` *before* shutdown.  The router's cutover protocol
    needs exactly that window: call this first, let the router's probe
    see ``draining`` (503) and route around the replica, then drain the
    engine and stop.  Pair with :func:`end_drain` after a roll-restart."""
    health.set_draining(True)
    from . import journal as _journal

    _journal.emit("serve.drain", phase="begin", reason=str(reason))


def end_drain() -> None:
    """Leave the draining state (the replica rejoined after a restart)."""
    health.set_draining(False)


def publish_step(step_s: float, examples: int, staged_bytes: int,
                 overlap_fraction: float, step: Optional[int] = None,
                 registry=None, numerics: Optional[Dict[str, Any]] = None,
                 phases: Optional[Dict[str, float]] = None,
                 ) -> None:
    """The engine's per-step live feed (``engine/sgdengine.py``): last
    step time, examples/s, staged bytes, and the sync/dispatch overlap
    fraction as gauges, plus monotonic step/example counters a poller
    turns into rates.  Also beats the ``engine_step`` health mark.

    ``numerics``: the step's in-step sentinel stats
    (``obs/numerics.sentinel_stats``' tensors, still on the device),
    recorded as ``tmpi_numerics_*`` gauges and histogram and appended to
    the sentinel history ring (``numerics.record_sentinels``).

    ``phases``: the step's phase decomposition in seconds (a subset of
    ``obs/alerts.PHASES``: data_wait / dispatch / collective /
    optimizer / ps), published as
    ``tmpi_step_phase_seconds{phase=...}`` gauges — the per-phase feed
    a firing alert's ``phase="auto"`` attribution reads, so "step got
    slower" becomes "data_wait regressed".  The engine derives them
    from the timestamps it already takes under the feed gate."""
    if registry is None:
        from .metrics import registry as registry_
        registry = registry_
    if numerics is not None:
        from . import numerics as numerics_mod

        numerics_mod.record_sentinels(step, numerics, registry=registry)
    step_s = max(float(step_s), 1e-12)
    registry.gauge(
        "tmpi_engine_step_seconds",
        "wall time of the most recent engine step").set(step_s)
    registry.gauge(
        "tmpi_engine_examples_per_sec",
        "throughput of the most recent engine step").set(examples / step_s)
    registry.gauge(
        "tmpi_engine_staged_bytes",
        "host bytes staged to device by the most recent step").set(
            float(staged_bytes))
    registry.gauge(
        "tmpi_engine_overlap_fraction",
        "fraction of the most recent step the host was NOT blocked on "
        "staging/sync — the dispatch/compute overlap the async pipeline "
        "exists to maximize").set(
            min(1.0, max(0.0, float(overlap_fraction))))
    registry.counter(
        "tmpi_engine_steps_total",
        "engine steps completed by this process").inc()
    registry.counter(
        "tmpi_engine_examples_total",
        "examples processed by this process").inc(float(examples))
    if phases:
        g = registry.gauge(
            "tmpi_step_phase_seconds",
            "wall seconds of the most recent engine step attributed to "
            "each phase (data_wait / dispatch / collective / optimizer "
            "/ ps) — the decomposition a firing alert names the "
            "regressed phase from")
        for phase, secs in phases.items():
            g.set(max(0.0, float(secs)), labels={"phase": str(phase)})
        # Sync-only overlap: input-blocked time excluded from BOTH
        # sides, so a starving producer moves data_wait (and the sag
        # rule), not this gauge — the overlap_collapse alert watches
        # collective overlap specifically, and must not page for an
        # input problem wearing an overlap costume.
        denom = max(step_s - float(phases.get("data_wait", 0.0)), 1e-9)
        registry.gauge(
            "tmpi_engine_sync_overlap_fraction",
            "fraction of the step's non-input wall time the host was "
            "NOT blocked in gradient-sync/inflight waits — the "
            "collective-overlap health the overlap_collapse alert "
            "watches").set(min(1.0, max(
                0.0, 1.0 - float(phases.get("collective", 0.0)) / denom)))
    if step is not None:
        registry.gauge(
            "tmpi_engine_step", "most recent global step index").set(
                float(step))
    health.note("engine_step")


def publish_input(staged_bytes: int, stage_s: float, wait_s: float,
                  overlap_fraction: float, registry=None) -> None:
    """The data pipeline's per-batch live feed (``data/device.py``):
    bytes staged, staging-call latency, consumer wait, and the running
    input-overlap fraction.  Gated by the same :func:`metrics_feed` discipline as
    :func:`publish_step` (the stage publishes only when someone is — or
    could be — watching)."""
    if registry is None:
        from .metrics import registry as registry_
        registry = registry_
    registry.counter(
        "tmpi_data_staged_bytes_total",
        "host bytes the input pipeline staged to device").inc(
            max(0.0, float(staged_bytes)))
    registry.counter(
        "tmpi_data_batches_total",
        "batches the input pipeline delivered to the consumer").inc()
    registry.counter(
        "tmpi_data_wait_seconds_total",
        "seconds the consumer blocked waiting on the input pipeline").inc(
            max(0.0, float(wait_s)))
    registry.histogram(
        "tmpi_data_stage_seconds",
        "latency of one background staging call (host reshape/cast + "
        "device_put dispatch)").observe(max(0.0, float(stage_s)))
    registry.gauge(
        "tmpi_data_input_overlap_fraction",
        "fraction of the consumer's wall time the input pipeline did NOT "
        "block it — 1.0 = staging fully hidden behind compute").set(
            min(1.0, max(0.0, float(overlap_fraction))))
