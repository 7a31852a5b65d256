"""Automated root-cause analysis over the journals.

The port's copy of the JAX package's ``obs/rca.py`` (standard library over
the journal; the port keeps its own).  The evidence a job leaves behind,
the event journal (``obs/journal.py``, every rank), flight bundles
(``obs/flight.py``) and the metrics history (``obs/history.py``), is
merged onto one wall-clock timeline, a small causality rulebook is walked
over it, and the top-scoring verdicts are reported with their evidence
chain attached.

Each rule is an ordered chain of event matchers; a verdict scores by how
much of its chain is present (the root-cause link weighs most):

* ``silent_corruption_divergence``: a wire corruption followed by a
  numerics audit naming an outlier and the diverged health state;
* ``straggler_stall``: straggler injections on one rank, the health
  machine degrading to ``stalled``, then a watchdog expiry or rc=44 exit;
* ``ps_primary_loss``: a process kill followed by the parameter-server
  client's failover and promotion;
* ``crash_loop``: dense supervisor exits ending in its crash-loop verdict;
* ``aborted_resize``: a membership change (``resize.propose`` /
  ``resize.quiesce``, ``runtime/resize.py``) hit by a fault inside the
  resize window and aborted atomically (``resize.abort``, epoch
  unchanged);
* ``straggler_evict``: straggler evidence followed by a ``resize.propose``
  carrying evictees and the ``resize.commit`` that removed them;
* ``leader_failover``: the control-plane leader lost and the election
  layer recovering (``runtime/election.py``): ``election.detect`` ->
  ``election.elected`` -> ``election.resume``, with the resolved verdict
  of an in-flight resize window (``election.resolve``) and a
  ``leader_missing`` firing as confirmatory anchors;
* ``perf_retune``: a firing perf alert answered by a retune controller's
  probe -> decision -> apply chain;
* ``transport_fault_restart``: a chaos wire fault followed by
  ``elastic.restore`` (``runtime/failure.run_elastic``), the fallback when
  nothing more specific fits.

The declarative alert plane (``obs/alerts.py``) journals ``alert.*``
records; the specific chains carry an optional ``alert`` anchor matching
the corresponding rule's ``alert.firing``.

Pure functions over explicit inputs; :func:`analyze` assembles a real
directory.  Output: a machine-readable dict and human text
(:func:`format_report`).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

from . import journal as journal_mod

__all__ = [
    "Rule",
    "RULES",
    "analyze",
    "build_timeline",
    "format_report",
    "load_evidence",
]


# ------------------------------------------------------------- evidence

def load_evidence(directory: str) -> Dict[str, Any]:
    """Everything forensic under ``directory`` (recursive): journal
    segments, flight bundles, persisted history files.  Unreadable files
    are skipped with a note — a torn artifact must not kill the
    post-mortem that exists because something already went wrong."""
    notes: List[str] = []
    seen_segments = set()
    for root, _dirs, _files in os.walk(directory):
        for p in journal_mod.segments(root):
            seen_segments.add(p)
    # Streaming k-way merge over ALL segments (hundreds of per-rank files
    # after a scale-out drill): one open file + one buffered record per
    # process stream while merging, and the records arrive already in
    # global (wall, rank, seq) order.
    records: List[Dict[str, Any]] = list(
        journal_mod.merge_segments(sorted(seen_segments)))

    flights: List[Dict[str, Any]] = []
    for p in sorted(glob.glob(os.path.join(directory, "**", "flight-*.json"),
                              recursive=True)):
        try:
            with open(p) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            notes.append(f"{os.path.basename(p)}: unreadable, skipped")
            continue
        if isinstance(doc, dict):
            doc["_path"] = p
            flights.append(doc)

    histories: List[Dict[str, Any]] = []
    for p in sorted(glob.glob(os.path.join(directory, "**",
                                           "history-*.json"),
                              recursive=True)):
        st = None
        try:
            from . import history as history_mod

            st = history_mod.load(p)
        except Exception:  # noqa: BLE001
            st = None
        if st is None:
            notes.append(f"{os.path.basename(p)}: unreadable/not a "
                         "history file, skipped")
            continue
        histories.append({"path": p, "store": st})

    return {"records": records, "flights": flights,
            "histories": histories, "notes": notes,
            "segments": sorted(seen_segments)}


def build_timeline(evidence: Dict[str, Any]) -> List[Dict[str, Any]]:
    """One wall-clock-ordered event list: journal records as-is, each
    flight bundle folded in as a synthetic ``flight.bundle`` event (its
    ``wall_time`` is comparable — both sides stamp ``time.time()``).
    Wall time is the only clock comparable across PROCESSES (the aligned
    ``t_ns`` covers ranks of one clock-synced job; the supervisor and a
    restarted incarnation are different processes entirely)."""
    out: List[Dict[str, Any]] = []
    for rec in evidence.get("records", []):
        out.append(rec)
    for fl in evidence.get("flights", []):
        out.append({
            "v": 1,
            "wall": float(fl.get("wall_time", 0.0)),
            "t_ns": int(fl.get("monotonic_ns", 0)),
            "rank": (fl.get("context") or {}).get("rank", -2),
            "pid": fl.get("pid"),
            "seq": 0,
            "kind": "flight.bundle",
            "corr": 0,
            "data": {"reason": fl.get("reason"),
                     "path": fl.get("_path"),
                     "journal_segment": fl.get("journal_segment"),
                     "exception": (fl.get("exception") or {}).get("type")
                     if fl.get("exception") else None},
        })
    out.sort(key=lambda r: (r.get("wall", 0.0), r.get("rank", 0),
                            r.get("seq", 0)))
    return out


# ------------------------------------------------------------- the rules

def _kind(rec: Dict[str, Any]) -> str:
    return str(rec.get("kind", ""))


def _data(rec: Dict[str, Any]) -> Dict[str, Any]:
    d = rec.get("data")
    return d if isinstance(d, dict) else {}


def _is_fault(rec, fault: str) -> bool:
    return _kind(rec) == "chaos.fault" and _data(rec).get("fault") == fault


def _health_to(rec, *states: str) -> bool:
    return (_kind(rec) == "health.transition"
            and _data(rec).get("to") in states)


def _is_alert_firing(rec, *rules: str) -> bool:
    """An ``alert.firing`` journal record from the declarative alert
    plane (obs/alerts.py) for one of the named rules — the anchor that
    lets a `why` chain read "the alert fired, THEN the supervisor
    acted" instead of reconstructing the symptom from raw counters."""
    return (_kind(rec) == "alert.firing"
            and (not rules or _data(rec).get("rule") in rules))


class Rule:
    """One causality chain.  ``links`` are ``(name, weight, matcher)``
    triples in causal order; links match IN ORDER (a chain, not a bag).
    ``required`` links anchor the chain: they are matched first, in
    order among themselves, and a missing one kills the verdict;
    optional links then fit into the gaps BETWEEN their neighbouring
    required anchors — so an out-of-order "injection after the symptom"
    reads as a partial chain, not a full one, and an optional prefix can
    never consume past a required anchor.  Confidence is the weighted
    fraction of links matched; ``priority`` scales the RANKING score
    only (a 2-link fallback rule completes too easily to outrank a
    5-link specific chain on raw confidence)."""

    def __init__(self, name: str, cause: str,
                 links: Sequence[tuple],
                 required: Sequence[str],
                 summarize: Callable[[Dict[str, Dict[str, Any]]], str],
                 priority: float = 1.0):
        self.name = name
        self.cause = cause
        self.links = list(links)
        self.required = set(required)
        self.summarize = summarize
        self.priority = float(priority)

    def match(self, timeline: Sequence[Dict[str, Any]],
              ) -> Optional[Dict[str, Any]]:
        # Pass 1: the required anchors, in order among themselves.
        anchor_idx: Dict[str, int] = {}
        idx = 0
        for lname, _w, matcher in self.links:
            if lname not in self.required:
                continue
            hit = None
            for i in range(idx, len(timeline)):
                if matcher(timeline[i]):
                    hit = i
                    break
            if hit is None:
                return None
            anchor_idx[lname] = hit
            idx = hit + 1
        # Pass 2: optional links fit between their neighbouring anchors.
        matched: Dict[str, Dict[str, Any]] = {
            n: timeline[i] for n, i in anchor_idx.items()}
        cursor = 0
        for pos, (lname, _w, matcher) in enumerate(self.links):
            if lname in anchor_idx:
                cursor = anchor_idx[lname] + 1
                continue
            bound = len(timeline)
            for nname, _nw, _nm in self.links[pos + 1:]:
                if nname in anchor_idx:
                    bound = anchor_idx[nname]
                    break
            for i in range(cursor, bound):
                if matcher(timeline[i]):
                    matched[lname] = timeline[i]
                    cursor = i + 1
                    break
        if not matched:
            return None
        total = sum(w for _n, w, _m in self.links)
        got = sum(w for n, w, _m in self.links if n in matched)
        confidence = round(got / total, 3) if total else 0.0
        evidence = sorted(matched.values(),
                          key=lambda r: r.get("wall", 0.0))
        return {
            "rule": self.name,
            "cause": self.cause,
            "confidence": confidence,
            "score": round(confidence * self.priority, 3),
            "links_matched": [n for n, _w, _m in self.links
                              if n in matched],
            "links_missing": [n for n, _w, _m in self.links
                              if n not in matched],
            "summary": self.summarize(matched),
            "evidence": [{
                "wall": r.get("wall"),
                "rank": r.get("rank"),
                "kind": r.get("kind"),
                "data": r.get("data"),
            } for r in evidence],
        }


def _rank_of(rec: Optional[Dict[str, Any]], key: str = "rank") -> Any:
    if rec is None:
        return "?"
    return _data(rec).get(key, rec.get("rank", "?"))


def _sum_corruption(m):
    audit = m.get("divergence")
    leaf = _data(audit).get("first_divergent_leaf") if audit else None
    outliers = _data(audit).get("outlier_ranks") if audit else None
    return ("silent data corruption (injected byte flip, CRC off) forked "
            f"rank(s) {outliers} at leaf {leaf!r}; the numerics auditor "
            "caught the divergence and the outlier's /healthz read "
            "diverged/503")


def _sum_straggler(m):
    inj = m.get("injection")
    rank = inj.get("rank", "?") if inj else "?"
    killed = ("converted by the supervisor health poll"
              if "supervisor_kill" in m else
              "expired the in-process watchdog" if "watchdog" in m
              else "stalled")
    alerted = (" — the alert plane fired "
               f"{_data(m['alert']).get('rule')} before the supervisor "
               "acted" if "alert" in m else "")
    return (f"compute-plane straggler/wedge on rank {rank} "
            f"(chaos-injected delay) drove /healthz to stalled and "
            f"{killed} (EXIT_STALLED path){alerted}")


def _sum_ps_loss(m):
    kill = m.get("kill")
    fo = m.get("failover")
    slot = _data(fo).get("slot", "?") if fo else "?"
    how = ("promotion of its backup" if "promote" in m
           else "cutover to its handoff successor" if "cutover" in m
           else "reconnect failover")
    pid = _data(kill).get("pid") if kill else None
    return (f"PS server (slot {slot}"
            + (f", pid {pid}" if pid else "")
            + f") was killed; the surviving client rode it out via {how}"
              " with the shadow re-seed making adds exactly-once")


def _sum_crash_loop(m):
    cl = m.get("crash_loop")
    fails = _data(cl).get("failures", "?") if cl else "?"
    return (f"deterministic crash loop: {fails} worker failures inside "
            "the supervisor's window — the fault reproduces on every "
            "incarnation (bad config / poisoned state), restart cannot "
            "fix it")


def _sum_aborted_resize(m):
    ab = m.get("abort")
    epoch = _data(ab).get("epoch", "?") if ab else "?"
    reason = _data(ab).get("reason", "") if ab else ""
    inj = m.get("injection")
    origin = (f"an injected {_data(inj).get('fault')} fault"
              if inj else "a fault")
    resumed = ("; a later membership change committed — the job carried "
               "on" if "resumed" in m else "")
    return (f"a resize proposal was aborted mid-protocol by {origin} "
            f"during the resize window ({reason or 'no reason recorded'}); "
            f"membership stayed at epoch {epoch} on every rank — the "
            f"epoch machine never split{resumed}")


def _sum_straggler_evict(m):
    prop = m.get("propose")
    evicted = _data(prop).get("evict", []) if prop else []
    inj = m.get("injection")
    injected = (" (chaos-injected delay)" if inj else "")
    commit = m.get("commit")
    epoch = _data(commit).get("epoch", "?") if commit else "?"
    return (f"the autoscaler converted straggler detection into action: "
            f"rank(s) {evicted} kept attracting skew attribution"
            f"{injected} and were EVICTED — membership committed to "
            f"epoch {epoch} without them, no restart")


def _sum_leader_failover(m):
    det = m.get("detect")
    dead = _data(det).get("dead", []) if det else []
    el = m.get("elect")
    epoch = _data(el).get("epoch", "?") if el else "?"
    size = _data(el).get("size", "?") if el else "?"
    inj = m.get("injection")
    injected = " (chaos-injected kill)" if inj else ""
    res = m.get("resolve")
    resolved = ""
    if res:
        resolved = (f"; the in-flight resize window resolved to exactly "
                    f"one verdict — {_data(res).get('verdict', '?')} — "
                    "on every survivor")
    resumed = ("; the new leader journaled resume and the loop "
               "continued" if "resume" in m else "")
    return (f"the control-plane leader died{injected} (dead rank(s) "
            f"{dead}); the survivors proved it over /healthz, the "
            f"lowest live rank claimed epoch {epoch} under the fence "
            f"and {size} survivor(s) rewired without a restart"
            f"{resolved}{resumed}")


def _sum_perf_retune(m):
    alert = m.get("alert")
    rule = _data(alert).get("rule", "a perf alert") if alert else "?"
    inj = m.get("injection")
    injected = " (chaos-injected slowdown)" if inj else ""
    apply_ = m.get("apply")
    flips = _data(apply_).get("applied", {}) if apply_ else {}
    cache = (_data(apply_).get("reinstalled_cache") if apply_ else False)
    acted = (", ".join(f"{k}={v}" for k, v in sorted(flips.items()))
             or ("reinstalled the winner cache" if cache
                 else "no knob moved"))
    reverted = ("; the post-retune window regressed and the flips "
                "REVERTED" if "revert" in m else "")
    return (f"{rule} fired{injected} and the retune controller acted: "
            f"probed off the hot path, then applied {acted} mid-job "
            f"without ending the step loop{reverted}")


def _sum_transport(m):
    fault = m.get("fault")
    rec = m.get("restore")
    fcls = _data(rec).get("fault", "?") if rec else "?"
    origin = (f"injected {_data(fault).get('fault')} fault on the wire"
              if fault else "a recoverable fault (no labelled injection "
              "in the journal)")
    return (f"{origin} surfaced as {fcls}; run_elastic restored the "
            "last checkpoint and rebuilt")


RULES: List[Rule] = [
    Rule(
        "silent_corruption_divergence",
        "silent data corruption",
        links=[
            ("injection", 3.0, lambda r: _is_fault(r, "corrupt")),
            ("divergence", 4.0,
             lambda r: _kind(r) == "numerics.audit"
             and _data(r).get("ok") is False),
            ("health", 1.0, lambda r: _health_to(r, "diverged")),
            ("flight", 0.5,
             lambda r: _kind(r) == "flight.dump"
             and "numerics" in str(_data(r).get("reason", ""))
             or (_kind(r) == "flight.bundle"
                 and "numerics" in str(_data(r).get("reason", "")))),
            ("recovery", 0.5,
             lambda r: _kind(r) == "numerics.audit"
             and _data(r).get("ok") is True
             and _data(r).get("recovered") is True),
            # Weight 0 = confirmatory-only: a matched firing joins
            # the evidence chain (and the summary), but an alerts-off
            # job — the default — is never penalized for not paging.
            ("alert", 0.0,
             lambda r: _is_alert_firing(r, "numerics_divergence",
                                        "nonfinite_grads")),
        ],
        required=["divergence"],
        summarize=_sum_corruption,
    ),
    Rule(
        "straggler_stall",
        "straggler / wedged rank",
        links=[
            ("injection", 3.0, lambda r: _is_fault(r, "straggler")),
            ("degraded", 0.5, lambda r: _health_to(r, "degraded")),
            ("stalled", 3.0, lambda r: _health_to(r, "stalled")),
            ("watchdog", 1.0, lambda r: _kind(r) == "watchdog.expired"),
            ("supervisor_kill", 1.0,
             lambda r: _kind(r) == "supervisor.health_kill"),
            ("exit", 1.0,
             lambda r: _kind(r) == "supervisor.worker_exit"
             and _data(r).get("rc") in (44, -9)),
            # Alert-plane anchor (last: a firing can land anywhere after
            # the injection without breaking the in-order optional fit).
            ("alert", 0.0,
             lambda r: _is_alert_firing(r, "straggler_skew",
                                        "step_rate_sag",
                                        "watchdog_near_expiry")),
        ],
        required=["stalled"],
        summarize=_sum_straggler,
    ),
    Rule(
        "ps_primary_loss",
        "parameter-server primary loss",
        links=[
            ("kill", 2.0,
             lambda r: _is_fault(r, "kill")
             or (_kind(r) == "supervisor.worker_exit"
                 and _data(r).get("rc") == -9)),
            ("failover", 3.0, lambda r: _kind(r) == "ps.failover"),
            ("promote", 2.0, lambda r: _kind(r) == "ps.promote"),
            ("cutover", 0.5, lambda r: _kind(r) == "ps.cutover"),
            ("restart", 0.5,
             lambda r: _kind(r) == "supervisor.restart"),
            ("alert", 0.0, lambda r: _is_alert_firing(r, "ps_storm")),
        ],
        required=["failover"],
        summarize=_sum_ps_loss,
    ),
    Rule(
        "crash_loop",
        "crash-looping worker",
        links=[
            ("exit1", 1.0,
             lambda r: _kind(r) == "supervisor.worker_exit"),
            ("exit2", 1.0,
             lambda r: _kind(r) == "supervisor.worker_exit"),
            ("crash_loop", 4.0,
             lambda r: _kind(r) == "supervisor.crash_loop"),
        ],
        required=["crash_loop"],
        summarize=_sum_crash_loop,
    ),
    Rule(
        "aborted_resize",
        "resize aborted by a fault in the resize window",
        links=[
            ("propose", 1.0, lambda r: _kind(r) == "resize.propose"),
            ("injection", 1.5,
             lambda r: _kind(r) == "chaos.fault"
             and _data(r).get("fault") in ("kill", "blackhole", "reset",
                                           "corrupt")),
            ("quiesce", 0.5, lambda r: _kind(r) == "resize.quiesce"),
            ("abort", 4.0, lambda r: _kind(r) == "resize.abort"),
            ("resumed", 0.5, lambda r: _kind(r) == "resize.commit"),
        ],
        required=["abort"],
        summarize=_sum_aborted_resize,
    ),
    Rule(
        "straggler_evict",
        "persistent straggler evicted by the autoscaler",
        links=[
            ("injection", 2.0, lambda r: _is_fault(r, "straggler")),
            ("decision", 1.0,
             lambda r: _kind(r) == "supervisor.scale"
             and _data(r).get("action") == "evict"),
            ("propose", 3.0,
             lambda r: _kind(r) == "resize.propose"
             and bool(_data(r).get("evict"))),
            ("commit", 2.0, lambda r: _kind(r) == "resize.commit"),
            ("depart", 0.5,
             lambda r: _kind(r) == "resize.depart"
             and _data(r).get("evicted") is True),
        ],
        required=["propose", "commit"],
        summarize=_sum_straggler_evict,
    ),
    Rule(
        "leader_failover",
        "control-plane leader lost and re-elected",
        links=[
            ("injection", 1.5,
             lambda r: _is_fault(r, "kill")
             or (_kind(r) == "supervisor.worker_exit"
                 and _data(r).get("rc") == -9)),
            ("detect", 2.0, lambda r: _kind(r) == "election.detect"),
            ("elect", 3.0,
             lambda r: _kind(r) == "election.elected"
             and _data(r).get("planned") is False),
            ("resolve", 0.5, lambda r: _kind(r) == "election.resolve"),
            ("resume", 1.0, lambda r: _kind(r) == "election.resume"),
            # Confirmatory only (weight 0): the detector's gauge feeds
            # the leader_missing rule, but an unalerted failover is
            # still this story.
            ("alert", 0.0,
             lambda r: _is_alert_firing(r, "leader_missing")),
        ],
        required=["detect", "elect"],
        summarize=_sum_leader_failover,
    ),
    Rule(
        "perf_retune",
        "perf alert answered by a mid-job retune",
        links=[
            ("injection", 1.0,
             lambda r: _kind(r) == "chaos.fault"
             and _data(r).get("fault") in ("delay", "straggler",
                                           "bandwidth")),
            # REQUIRED and weighted, unlike the confirmatory-only alert
            # anchors elsewhere: the controller only acts on a firing,
            # so a retune chain without one is not this story.
            ("alert", 2.0,
             lambda r: _is_alert_firing(r, "step_rate_sag",
                                        "overlap_collapse",
                                        "autotune_mix_drift")),
            ("probe", 2.0, lambda r: _kind(r) == "retune.probe"),
            ("decision", 1.0, lambda r: _kind(r) == "retune.decision"),
            ("apply", 3.0,
             lambda r: _kind(r) == "retune.apply"
             and (bool(_data(r).get("applied"))
                  or bool(_data(r).get("reinstalled_cache")))),
            ("cooldown", 0.5, lambda r: _kind(r) == "retune.cooldown"),
            ("revert", 0.5, lambda r: _kind(r) == "retune.revert"),
        ],
        required=["alert", "probe", "apply"],
        summarize=_sum_perf_retune,
    ),
    Rule(
        "transport_fault_restart",
        "transport fault ridden out by elastic restart",
        links=[
            ("fault", 1.0,
             lambda r: _kind(r) == "chaos.fault"
             and _data(r).get("fault") in ("reset", "blackhole",
                                           "corrupt")),
            ("restore", 2.0, lambda r: _kind(r) == "elastic.restore"),
        ],
        required=["restore"],
        summarize=_sum_transport,
        # The generic fallback: a 2-link chain completes on almost any
        # faulted run and must rank below a complete specific chain.
        priority=0.5,
    ),
]


# -------------------------------------------------------------- analysis

def analyze(directory: str, top: int = 5) -> Dict[str, Any]:
    """The full post-mortem over one evidence directory: load, merge,
    walk the rulebook, rank.  Pure output — printing/exit codes are the
    CLI's business."""
    evidence = load_evidence(directory)
    timeline = build_timeline(evidence)
    verdicts = []
    for rule in RULES:
        v = rule.match(timeline)
        if v is not None:
            verdicts.append(v)
    verdicts.sort(key=lambda v: (-v["score"], -v["confidence"]))
    trend = _trend_context(evidence)
    return {
        "directory": os.path.abspath(directory),
        "events": len(timeline),
        "journal_segments": len(evidence["segments"]),
        "flight_bundles": len(evidence["flights"]),
        "history_files": len(evidence["histories"]),
        "notes": evidence["notes"],
        "verdicts": verdicts[:max(1, int(top))],
        "root_cause": verdicts[0]["cause"] if verdicts else None,
        "trend": trend,
        "first_event_wall": timeline[0]["wall"] if timeline else None,
        "last_event_wall": timeline[-1]["wall"] if timeline else None,
    }


def _trend_context(evidence: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Step-rate context from the newest persisted history: the incident
    usually has a prologue (rate sagging before the trip) the journal's
    discrete events cannot show."""
    best = None
    for h in evidence.get("histories", []):
        st = h["store"]
        rate = st.rate("tmpi_engine_steps_total", 600.0)
        drift = st.drift("tmpi_engine_steps_total", 150.0, 450.0,
                         of_rate=True)
        if rate is None and drift is None:
            continue
        row = {"path": h["path"],
               "step_rate_per_s": None if rate is None else round(rate, 4),
               "step_rate_drift": (None if drift is None
                                   else round(drift, 4))}
        if best is None or (row["step_rate_drift"] is not None
                            and best.get("step_rate_drift") is None):
            best = row
    return best


def format_report(report: Dict[str, Any]) -> str:
    """Human rendering of an :func:`analyze` result."""
    import time as _time

    lines = [
        f"root cause — {report['directory']}",
        f"  evidence: {report['events']} events over "
        f"{report['journal_segments']} journal segment(s), "
        f"{report['flight_bundles']} flight bundle(s), "
        f"{report['history_files']} history file(s)",
    ]
    if report.get("trend"):
        t = report["trend"]
        lines.append(
            f"  trend: step rate {t.get('step_rate_per_s')}/s, "
            f"drift {t.get('step_rate_drift')} "
            "(recent vs trailing baseline; <1 = slowing)")
    if not report["verdicts"]:
        lines.append("  no rulebook chain matched — the journal holds "
                     "no recognized incident (see the raw events)")
        return "\n".join(lines)
    for i, v in enumerate(report["verdicts"], 1):
        lines.append("")
        lines.append(f"  #{i} [{v['confidence']:.0%}] {v['cause']} "
                     f"({v['rule']})")
        lines.append(f"     {v['summary']}")
        lines.append("     evidence chain:")
        for e in v["evidence"]:
            stamp = (_time.strftime("%H:%M:%S",
                                    _time.localtime(e["wall"]))
                     if e.get("wall") else "--:--:--")
            data = json.dumps(e.get("data", {}), sort_keys=True)
            if len(data) > 110:
                data = data[:107] + "..."
            lines.append(f"       {stamp} rank={e.get('rank')} "
                         f"{e['kind']} {data}")
        if v["links_missing"]:
            lines.append("     (unmatched links: "
                         + ", ".join(v["links_missing"]) + ")")
    for n in report.get("notes", []):
        lines.append(f"  note: {n}")
    return "\n".join(lines)
