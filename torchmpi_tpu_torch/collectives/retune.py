"""Alert-triggered retune controller: a firing performance alert answered
by a measured probe and a knob flip, at a step boundary, mid-job.

Counterpart of ``torchmpi_tpu/collectives/retune.py``.  The lifecycle, the
journal kinds (``retune.probe``, ``retune.decision``, ``retune.apply``,
``retune.cooldown``, ``retune.revert``), the counters and the flips are the
JAX package's:

* **idle -> evidence**: a trigger rule (``step_rate_sag``,
  ``overlap_collapse``, ``autotune_mix_drift``) is firing; a flap that
  resolves inside ``retune_debounce_s`` returns to idle unjournaled.
* **evidence -> probing**: the firing held through the debounce.  The
  probe runs on its own thread while steps keep flowing.
* **probing -> apply**: the measured overlap winner picks the
  ``engine_async_drain`` discipline and steers ``gradient_bucket_bytes``
  (a ready win halves the buckets, floor 4 MiB; a barrier win doubles
  them, cap 64 MiB), and a fresh pass doc reinstalls the winner cache.
* **apply -> cooldown**: no new probe for ``retune_cooldown_s``; a step
  rate at or below ``retune_revert_drift`` x the pre-probe baseline inside
  ``retune_revert_window_s`` reverts the flips.

One process per rank changes two things.  The default probe's thread runs
only the overlap A/B (``autotune.overlap_ab``: a loopback host ring local
to the process); the fresh eager pass, whose collectives must never share
a process group or a ring state with the step's, runs at the boundary
where the verdict is applied, on every rank at once, as a measured pause
(``retune.pause`` journaled with its ``pause_ms``).  And with a ``comm`` of
several ranks the controller agrees: rank 0 of ``comm`` runs the lifecycle
on its own alert engine, history and clock, and at every poll broadcasts
what the boundary does (nothing, apply this verdict, revert), so that
every rank applies the same flips at the same step boundary (a bucket
geometry that one rank alone changed would change its bucket plan, and
wrong sums would follow).  Every rank of ``comm`` must poll at the same
steps.

Every ``retune_*`` knob is read through :func:`retune_config`.  Each poll
publishes ``tmpi_autotune_mix_drift`` (``autotune.mix_drift``), the series
the ``autotune_mix_drift`` alert watches.  ``obs/rca.py``'s
``perf_retune`` rule chains ``alert.firing -> retune.probe ->
retune.decision -> retune.apply`` from journals alone.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..obs import journal as _journal
from ..runtime import config
from . import autotune

#: default-pack rules whose firing counts as retune evidence.
TRIGGER_RULES = ("step_rate_sag", "overlap_collapse", "autotune_mix_drift")

#: controller states.
IDLE = "idle"
EVIDENCE = "evidence"
PROBING = "probing"
COOLDOWN = "cooldown"

#: gradient bucket geometry rails for measured flips.
_BUCKET_FLOOR = 4 << 20
_BUCKET_CAP = 64 << 20
#: overlap-fraction margin below which the A/B is a wash: no flip.
_OVERLAP_MARGIN = 0.05

_installed: Optional["RetuneController"] = None
_lock = threading.Lock()


def retune_config() -> Dict[str, Any]:
    """Every ``retune_*`` knob in one read."""
    return {
        "enabled": bool(config.get("retune_enabled")),
        "poll_interval_steps": max(
            1, int(config.get("retune_poll_interval_steps"))),
        "debounce_s": float(config.get("retune_debounce_s")),
        "cooldown_s": float(config.get("retune_cooldown_s")),
        "revert_window_s": float(config.get("retune_revert_window_s")),
        "revert_drift": float(config.get("retune_revert_drift")),
        "mix_threshold": float(config.get("retune_mix_threshold")),
        "mix_min_samples": int(config.get("retune_mix_min_samples")),
    }


class RetuneController:
    """The step-boundary performance controller.  ``alert_engine`` and
    ``store`` default to the process singletons, ``bench_fn`` to
    :meth:`_default_bench` (the overlap A/B), ``now_fn`` to wall time.
    The applying boundary runs a fresh eager pass in a started world (or
    over ``comm``), with ``pass_kw`` for ``autotune.run_pass``.  ``comm``:
    the ranks that agree (see the module docstring); None or one rank acts
    alone, as JAX's does."""

    def __init__(self, alert_engine=None, store=None,
                 bench_fn: Optional[Callable[[], Dict[str, Any]]] = None,
                 now_fn: Callable[[], float] = time.time,
                 cfg: Optional[Dict[str, Any]] = None, comm=None,
                 pass_kw: Optional[Dict[str, Any]] = None):
        self.cfg = {**retune_config(), **(cfg or {})}
        self._alert_engine = alert_engine
        self._store = store
        self._bench_fn = bench_fn or self._default_bench
        self._now = now_fn
        self._comm = comm
        self._pass_kw = dict(pass_kw or {})
        self.state = IDLE
        self.retunes = 0
        self.reverts = 0
        self.last_pause_ms: Optional[float] = None
        self._steps = 0
        self._evidence_since: Optional[float] = None
        self._evidence_rules: List[str] = []
        self._probe_lock = threading.Lock()
        self._probe_result: Optional[Dict[str, Any]] = None
        self._probe_thread: Optional[threading.Thread] = None
        self._probe_baseline_rate: Optional[float] = None
        self._cooldown_until = 0.0
        # Last apply: {"t", "flips", "priors", "baseline_rate"}; None once
        # reverted or the window closed.
        self._applied: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------- wiring

    def _engine(self):
        if self._alert_engine is not None:
            return self._alert_engine
        from ..obs import alerts

        return alerts.engine()

    def _history(self):
        if self._store is not None:
            return self._store
        from ..obs import history

        return history.store()

    def _firing(self) -> List[str]:
        eng = self._engine()
        if eng is None:
            return []
        try:
            return [f["name"] for f in eng.firing()
                    if f["name"] in TRIGGER_RULES]
        except Exception:  # noqa: BLE001 — a broken engine is no evidence
            return []

    def _step_rate(self, now: float) -> Optional[float]:
        st = self._history()
        if st is None:
            return None
        try:
            return st.rate("tmpi_engine_steps_total", 30.0, now=now)
        except Exception:  # noqa: BLE001
            return None

    def _agreeing(self) -> bool:
        return self._comm is not None and self._comm.size > 1

    def _leader(self) -> bool:
        return not self._agreeing() or self._comm.rank == 0

    # -------------------------------------------------- the step hook

    def step_boundary(self) -> str:
        """Consulted by the engine once per step; returns the state.
        Never raises; probes run on their own thread, and a boundary pass
        is the one measured pause."""
        self._steps += 1
        if self._steps % self.cfg["poll_interval_steps"]:
            return self.state
        try:
            self._tick(self._now())
        except Exception:  # noqa: BLE001 — the train loop outranks us
            pass
        return self.state

    def _tick(self, now: float) -> None:
        # Feed the detector every poll (one histogram walk).
        autotune.mix_drift(min_samples=self.cfg["mix_min_samples"])
        order = self._lead(now) if self._leader() else None
        if not self._agreeing():
            self._execute(now, order)
            return
        msg = self._broadcast({"order": order, "state": self.state,
                               "window_open": self._applied is not None})
        self._execute(now, msg["order"])
        if self._comm.rank != 0:
            # The leader's clock and history decide the windows: a
            # follower mirrors its state (an applied verdict put both in
            # cooldown already).
            if msg["order"] is None or msg["order"]["kind"] != "apply":
                self.state = msg["state"]
                if self.state == IDLE:
                    self._evidence_rules = []
            if not msg["window_open"]:
                self._applied = None

    def _broadcast(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """Rank 0's message for this boundary, on every rank of ``comm``."""
        import torch.distributed as dist

        box = [msg if self._comm.rank == 0 else None]
        kw = {}
        if dist.get_backend(self._comm.group) == "nccl":
            kw["device"] = autotune._device()
        dist.broadcast_object_list(box, src=self._comm.global_rank(0),
                                   group=self._comm.group, **kw)
        return box[0]

    def _lead(self, now: float) -> Optional[Dict[str, Any]]:
        """The leader's lifecycle step: what this boundary does."""
        if self.state == COOLDOWN:
            order = None
            ap = self._applied
            if ap is not None:
                if now - ap["t"] > self.cfg["revert_window_s"]:
                    self._applied = None  # window closed clean; flips stay
                elif self._regressed(now, ap):
                    order = {"kind": "revert"}
            if now >= self._cooldown_until:
                self.state = IDLE
                self._evidence_rules = []
            return order
        if self.state == PROBING:
            with self._probe_lock:
                res, self._probe_result = self._probe_result, None
            if res is None:
                return None  # still measuring; steps keep flowing
            self._probe_thread = None
            return {"kind": "apply", "res": res,
                    "rules": list(self._evidence_rules),
                    "baseline_rate": self._probe_baseline_rate}
        firing = self._firing()
        if self.state == IDLE:
            if firing:
                self.state = EVIDENCE
                self._evidence_since = now
                self._evidence_rules = list(firing)
            return None
        # EVIDENCE: hold through the debounce; a flap returns to idle.
        if not firing:
            self.state = IDLE
            self._evidence_since = None
            self._evidence_rules = []
            return None
        self._evidence_rules = sorted(set(self._evidence_rules) | set(firing))
        if now - self._evidence_since >= self.cfg["debounce_s"]:
            self._start_probe(now)
        return None

    def _execute(self, now: float, order: Optional[Dict[str, Any]]) -> None:
        """What the boundary does, the same on every rank."""
        if order is None:
            return
        if order["kind"] == "apply":
            if not self._leader():
                self._evidence_rules = list(order["rules"])
                self._probe_baseline_rate = order["baseline_rate"]
            res = dict(order["res"] or {})
            res.update(self._pass_pause())
            self._apply(now, res)
        elif order["kind"] == "revert" and self._applied is not None:
            self._revert(now, self._applied)

    # ------------------------------------------------------ the probe

    def _start_probe(self, now: float) -> None:
        self.state = PROBING
        self._probe_baseline_rate = self._step_rate(now)
        _journal.emit("retune.probe", rules=list(self._evidence_rules),
                      debounce_s=self.cfg["debounce_s"],
                      baseline_rate=self._probe_baseline_rate)
        _counter("tmpi_retune_probes_total",
                 "retune probes launched (sustained alert evidence "
                 "survived the controller's debounce)")

        def run() -> None:
            try:
                res = self._bench_fn()
            except Exception as e:  # noqa: BLE001 — verdict, not crash
                res = {"error": f"{type(e).__name__}: {str(e)[:200]}"}
            with self._probe_lock:
                self._probe_result = res

        t = threading.Thread(target=run, name="tmpi-retune-probe",
                             daemon=True)
        self._probe_thread = t
        t.start()

    def _default_bench(self) -> Dict[str, Any]:
        """The off-hot-path probe: the overlap A/B over a chaos-delayed
        loopback ring (no device, no process group)."""
        out: Dict[str, Any] = {}
        try:
            out["overlap"] = autotune.overlap_ab(reps=1, update_passes=30)
        except Exception as e:  # noqa: BLE001
            out["overlap_error"] = f"{type(e).__name__}: {str(e)[:200]}"
        return out

    def _pass_pause(self) -> Dict[str, Any]:
        """The fresh eager pass at this boundary, on every rank at once:
        the one pause the controller puts on the step loop, timed and
        journaled as ``retune.pause``.  Unless ``pass_kw`` names the ops,
        it times only those with a choice of namespace
        (``autotune.decisive_ops``): a cell of one candidate has no
        verdict to refresh.  With no ``comm`` and no started world there
        is nothing to measure."""
        from ..runtime import lifecycle

        out: Dict[str, Any] = {}
        if self._comm is None and not lifecycle.started():
            return out
        kw = dict(self._pass_kw)
        t0 = time.perf_counter()
        try:
            if "ops" not in kw:
                kw["ops"] = autotune.decisive_ops(
                    kw.get("placement", "tpu"), kw.get("scope"))
            out["pass_doc"] = autotune.run_pass(comm=self._comm,
                                                install=False, **kw)
        except Exception as e:  # noqa: BLE001
            out["pass_error"] = f"{type(e).__name__}: {str(e)[:200]}"
        self.last_pause_ms = (time.perf_counter() - t0) * 1e3
        _journal.emit("retune.pause", pause_ms=self.last_pause_ms,
                      cells=len((out.get("pass_doc") or {}).get("cells",
                                                                {})),
                      error=out.get("pass_error"))
        return out

    # ------------------------------------------------------ the apply

    def _apply(self, now: float, res: Dict[str, Any]) -> None:
        flips: Dict[str, Any] = {}
        basis: Dict[str, Any] = {}
        ov = (res or {}).get("overlap")
        if isinstance(ov, dict) and "win" in ov:
            basis["overlap_win"] = ov["win"]
            want = "ready" if float(ov["win"]) > 0 else "barrier"
            if str(config.get("engine_async_drain")) != want and (
                    abs(float(ov["win"])) >= _OVERLAP_MARGIN):
                flips["engine_async_drain"] = want
            cur = int(config.get("gradient_bucket_bytes"))
            if float(ov["win"]) >= _OVERLAP_MARGIN and cur > _BUCKET_FLOOR:
                flips["gradient_bucket_bytes"] = max(_BUCKET_FLOOR, cur // 2)
            elif float(ov["win"]) <= -_OVERLAP_MARGIN and cur < _BUCKET_CAP:
                flips["gradient_bucket_bytes"] = min(_BUCKET_CAP, cur * 2)
        doc = (res or {}).get("pass_doc")
        install_doc = isinstance(doc, dict) and doc.get("cells")
        if install_doc:
            basis["pass_digest"] = doc.get("digest")
            basis["pass_cells"] = len(doc.get("cells", {}))
        action = "apply" if (flips or install_doc) else "none"
        _journal.emit("retune.decision", rules=list(self._evidence_rules),
                      action=action, flips=dict(flips), basis=basis,
                      error=(res or {}).get("error"))
        applied: Dict[str, Any] = {}
        priors: Dict[str, Any] = {}
        refused = None
        if action == "apply":
            try:
                for k, v in flips.items():
                    prior = config.get(k)
                    config.set(k, v)
                    priors[k] = prior
                    applied[k] = v
            except RuntimeError as e:
                # A config that refuses writes: the refusal is the record.
                refused = str(e)[:200]
            if install_doc:
                autotune.activate(doc)
            else:
                autotune.rekey()
            self.retunes += 1
            _counter("tmpi_retune_applies_total",
                     "retune decisions applied (knob flips and/or a "
                     "reinstalled winner cache)")
        _journal.emit("retune.apply", applied=applied, priors=priors,
                      reinstalled_cache=bool(install_doc),
                      refused=refused)
        self._applied = ({"t": now, "flips": applied, "priors": priors,
                          "baseline_rate": self._probe_baseline_rate}
                         if applied else None)
        self._enter_cooldown(now)

    def _enter_cooldown(self, now: float) -> None:
        self.state = COOLDOWN
        self._cooldown_until = now + self.cfg["cooldown_s"]
        self._evidence_since = None
        _journal.emit("retune.cooldown", until_s=self.cfg["cooldown_s"],
                      revert_window_s=self.cfg["revert_window_s"])

    # ----------------------------------------------- cooldown / revert

    def _regressed(self, now: float, ap: Dict[str, Any]) -> bool:
        base = ap.get("baseline_rate")
        if not base or base <= 0:
            return False
        rate = self._step_rate(now)
        if rate is None:
            return False
        return (rate / base) <= self.cfg["revert_drift"]

    def _revert(self, now: float, ap: Dict[str, Any]) -> None:
        restored: Dict[str, Any] = {}
        try:
            for k, v in ap["priors"].items():
                config.set(k, v)
                restored[k] = v
        except RuntimeError:
            pass
        autotune.rekey()
        self.reverts += 1
        self._applied = None
        _counter("tmpi_retune_reverts_total",
                 "retunes reverted inside the post-apply window (the "
                 "post-retune step rate regressed vs the pre-probe "
                 "baseline)")
        _journal.emit("retune.revert", restored=restored,
                      baseline_rate=ap.get("baseline_rate"),
                      rate=self._step_rate(now),
                      revert_drift=self.cfg["revert_drift"])

    # ----------------------------------------------------- inspection

    def probe_in_flight(self) -> bool:
        t = self._probe_thread
        return t is not None and t.is_alive()

    def join(self, timeout: float = 30.0) -> None:
        """Wait for an in-flight probe thread."""
        t = self._probe_thread
        if t is not None:
            t.join(timeout)

    def snapshot(self) -> Dict[str, Any]:
        """The live state GET /retune serves."""
        return {
            "state": self.state,
            "steps": self._steps,
            "retunes": self.retunes,
            "reverts": self.reverts,
            "evidence_rules": list(self._evidence_rules),
            "probe_in_flight": self.probe_in_flight(),
            "cooldown_until": self._cooldown_until,
            "applied": ({k: v for k, v in self._applied.items()
                         if k != "priors"}
                        if self._applied else None),
            "last_pause_ms": self.last_pause_ms,
            "cfg": dict(self.cfg),
        }


def maybe_install(engine=None, **kwargs) -> Optional[RetuneController]:
    """Arm the controller when ``retune_enabled`` is set: construct it,
    hang it on ``engine.retune_controller`` and register it for GET
    /retune.  Off: one config read, None."""
    global _installed
    if not bool(config.get("retune_enabled")):
        return None
    ctl = RetuneController(**kwargs)
    if engine is not None:
        engine.retune_controller = ctl
    with _lock:
        _installed = ctl
    return ctl


def installed() -> Optional[RetuneController]:
    with _lock:
        return _installed


def uninstall() -> None:
    """Drop the registered controller."""
    global _installed
    with _lock:
        _installed = None


def _counter(name: str, help_: str) -> None:
    from ..obs import metrics

    metrics.registry.counter(name, help_).inc()
