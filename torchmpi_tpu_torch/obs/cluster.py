"""Cluster aggregation over the live per-rank endpoints (``obs/serve.py``).

Counterpart of ``torchmpi_tpu/obs/cluster.py``, the same code with the
port's imports; its federation exposition is byte-equal to JAX's for the
same documents.  The serve module gives each rank an instrument panel;
this module is the control room: every rank's ``/healthz`` + ``/metrics``
federated into one job-level view —

* :func:`fetch` — poll N endpoints concurrently with a BOUNDED per-rank
  timeout and fan-out (``obs_federation_fanout``); a SIGKILLed or
  blackholed rank comes back ``unreachable`` after the bound, never a
  hang.
* :func:`job_view` — the aggregate verdict: per-rank health state and step
  rate (from the engine feed's gauges and counters), MFU, straggler
  attribution from the live ``tmpi_rank_skew_attributed_seconds`` gauges,
  parameter-server health sums, and ONE job-level state (worst rank wins;
  an unreachable rank degrades the job; a diverged or stalled rank is the
  job's verdict).
* :func:`federate` — all ranks' ``/metrics`` documents merged into one
  Prometheus exposition with a ``rank`` label injected per sample and
  ``# TYPE``/``# HELP`` exactly once per family — one scrape target
  standing in for N.
* :func:`render_table` / :func:`top` — the refreshing terminal view
  (``python -m torchmpi_tpu_torch.obs top``).

Endpoints are plain base URLs; :func:`endpoints_from_ring` derives them
from a host-ring endpoint list (the rank-ordered ``[(host, port)]`` every
rank already agrees on) plus the obs HTTP base port.
"""

from __future__ import annotations

import json
import re
import sys
import threading
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from .metrics import escape_label_value, unescape_label_value

__all__ = [
    "endpoints_from_ring",
    "federate",
    "federation_fanout",
    "fetch",
    "fetch_alerts",
    "fetch_journal",
    "fetch_rank",
    "job_view",
    "merge_federated",
    "parse_prometheus",
    "render_table",
    "shard_summary",
    "top",
]

#: job/rank states beyond the per-rank machine: a rank that answered
#: nothing inside the bound.
UNREACHABLE = "unreachable"

_STATE_SEVERITY = {"healthy": 0, "degraded": 1, "draining": 2,
                   UNREACHABLE: 2, "diverged": 3, "stalled": 4}


def federation_fanout(fanout: Optional[int] = None) -> int:
    """The federation tree's fan-in (``obs_federation_fanout``): shard
    size for tree merges AND the sweep's concurrent-probe bound.  An
    explicit positive argument wins (drills compare fanouts in one run);
    outside a configured runtime the default is 16."""
    if fanout is not None and int(fanout) > 0:
        return int(fanout)
    try:
        from . import native as obs_native

        return max(1, int(obs_native.cluster_config()["federation_fanout"]))
    except Exception:  # noqa: BLE001 — stdlib-side callers (supervisor)
        return 16


def endpoints_from_ring(ring_endpoints: Sequence[Tuple[str, int]],
                        http_port: int, stride: int = 1) -> List[str]:
    """Obs endpoint URLs from a hostcomm endpoint list: rank ``r`` (at
    ``(host, hc_port)``) serves obs on ``http_port + r * stride`` of the
    same host.  ``stride=1`` is the one-host-many-ranks test/drill shape
    (each rank needs its own port); ``stride=0`` is the one-rank-per-host
    pod shape (every host uses the same well-known port)."""
    return [f"http://{host}:{int(http_port) + r * int(stride)}"
            for r, (host, _hc_port) in enumerate(ring_endpoints)]


# ----------------------------------------------------------------- fetching

def _get(url: str, timeout_s: float) -> str:
    """GET returning the body even for error statuses — /healthz answers
    503 for stalled/draining and the verdict JSON is IN that body."""
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as r:
            return r.read().decode()
    except urllib.error.HTTPError as e:
        return e.read().decode()


#: the step-trend probe `obs top` asks each rank's /history for:
#: the step counter's rate over the trailing window, and its drift
#: (recent rate vs the trailing baseline — <1 the job is slowing down).
TREND_METRIC = "tmpi_engine_steps_total"
TREND_WINDOW_S = 600.0


def fetch_rank(base_url: str, timeout_s: float = 2.0,
               want_metrics: bool = True,
               want_history: bool = False,
               want_alerts: bool = False) -> Dict[str, Any]:
    """One rank's live state: ``/healthz`` (always) + ``/metrics`` text
    (+ the ``/history`` step-trend probe with ``want_history``, + the
    ``/alerts`` snapshot with ``want_alerts``).  Any transport failure
    marks the rank unreachable — with the error, never an exception:
    the aggregate view must render with dead ranks in it."""
    out: Dict[str, Any] = {"endpoint": base_url, "reachable": False,
                           "health": {"state": UNREACHABLE}}
    try:
        out["health"] = json.loads(_get(base_url + "/healthz", timeout_s))
        out["reachable"] = True
    except Exception as e:  # noqa: BLE001 - every failure = unreachable
        out["error"] = f"{type(e).__name__}: {e}"
        return out
    if want_metrics:
        try:
            out["metrics_text"] = _get(base_url + "/metrics", timeout_s)
        except Exception as e:  # noqa: BLE001
            out["error"] = f"{type(e).__name__}: {e}"
    if want_history:
        try:
            out["history"] = json.loads(_get(
                base_url + f"/history?metric={TREND_METRIC}"
                           f"&window_s={TREND_WINDOW_S:g}", timeout_s))
        except Exception:  # noqa: BLE001 — a rank without the history
            pass           # plane just has no trend column
    if want_alerts:
        try:
            out["alerts"] = json.loads(_get(base_url + "/alerts",
                                            timeout_s))
        except Exception:  # noqa: BLE001 — a rank without the alert
            pass           # plane just has no alerts column
    return out


def fetch(endpoints: Sequence[str], timeout_s: float = 2.0,
          want_metrics: bool = True,
          want_history: bool = False,
          want_alerts: bool = False,
          pool: Optional[int] = None) -> List[Dict[str, Any]]:
    """All ranks, index = rank, probed by a bounded aggregator pool
    (``obs_federation_fanout`` concurrent probes, each with its own
    socket deadline; ``pool`` overrides).  Total wall time is bounded by
    ONE shared backstop window over the whole sweep — even an endpoint
    that defeats the socket deadline by trickling a byte per interval
    (urllib's timeout bounds each blocking op, not the request) costs
    the sweep at most the backstop, and a probe thread that never
    returns is abandoned, never joined.  Publishes the sweep's cost into
    the aggregator's own registry (``tmpi_federation_sweep_seconds`` /
    ``tmpi_federation_unreachable_total``) so a supervisor watching 256
    ranks is itself observable."""
    if not endpoints:
        return []

    def fallback(ep: str, msg: str) -> Dict[str, Any]:
        return {"endpoint": ep, "reachable": False,
                "health": {"state": UNREACHABLE}, "error": msg}

    t0 = time.monotonic()
    results = _sweep(
        endpoints,
        lambda ep: fetch_rank(ep, timeout_s, want_metrics,
                              want_history=want_history,
                              want_alerts=want_alerts),
        timeout_s, "probe", fallback, pool=pool)
    try:
        from .metrics import registry

        registry.gauge(
            "tmpi_federation_sweep_seconds",
            "wall seconds of the last bounded federation sweep",
        ).set(time.monotonic() - t0)
        dead = sum(1 for r in results if not r.get("reachable"))
        if dead:
            registry.counter(
                "tmpi_federation_unreachable_total",
                "endpoints that read unreachable across federation "
                "sweeps").inc(dead)
    except Exception:  # noqa: BLE001 — telemetry must not kill the sweep
        pass
    return results


def _sweep(endpoints: Sequence[str], probe_one, timeout_s: float,
           name: str, fallback,
           pool: Optional[int] = None) -> List[Dict[str, Any]]:
    """The bounded parallel-probe scaffold every federation sweep rides
    (:func:`fetch` / :func:`fetch_journal` / :func:`fetch_alerts`):
    ``probe_one(endpoint)`` per rank, exceptions folded into
    ``fallback(endpoint, message)``.

    Concurrency is a BOUNDED worker pool (``obs_federation_fanout``
    aggregators pulling endpoints off a shared work list), not one
    thread per rank — a 256-endpoint sweep used to spawn 256 probe
    threads, which is exactly the resource storm the federation tree
    exists to avoid.  Plain DAEMON workers, not a ThreadPoolExecutor:
    the executor's __exit__/atexit both join worker threads, so one
    probe wedged past the socket deadline (an endpoint trickling a byte
    per interval — urllib's timeout bounds each blocking op, not the
    request) would re-create the very hang the backstop exists to
    prevent, at sweep end or at interpreter exit.  A wedged daemon
    worker is abandoned, never joined; ONE shared backstop window
    (``timeout_s * 3 + 1``) bounds the whole sweep — workers stop
    STARTING probes at the deadline, so endpoints the budget never
    reached (and probes still wedged at the backstop) read the timeout
    fallback instead of extending the sweep."""
    if not endpoints:
        return []
    slots: List[Optional[Dict[str, Any]]] = [None] * len(endpoints)
    deadline = time.monotonic() + timeout_s * 3 + 1
    pending = list(enumerate(endpoints))
    pending.reverse()                      # pop() serves rank order
    qlock = threading.Lock()

    def worker() -> None:
        while True:
            with qlock:
                if not pending:
                    return
                i, ep = pending.pop()
            if time.monotonic() >= deadline:
                return                     # budget spent; rest fall back
            try:
                slots[i] = probe_one(ep)
            except Exception as e:  # noqa: BLE001 - never kill the sweep
                slots[i] = fallback(ep, f"{type(e).__name__}: {e}")

    width = min(len(endpoints), federation_fanout(pool))
    threads = [threading.Thread(target=worker, daemon=True,
                                name=f"tmpi-obs-{name}-{w}")
               for w in range(width)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    return [slot if slot is not None else
            fallback(ep, "TimeoutError: probe exceeded the sweep "
                         "backstop")
            for ep, slot in zip(endpoints, slots)]


def shard_summary(results: Sequence[Mapping[str, Any]],
                  fanout: Optional[int] = None) -> Dict[str, Any]:
    """Per-shard unreachable rollup over one :func:`fetch` sweep: at
    N=256 a preemption wave must not produce 256 individual verdicts —
    each fan-in shard reports a count plus a bounded sample of its dead
    ranks, and the job-level line is one number."""
    f = federation_fanout(fanout)
    shards: List[Dict[str, Any]] = []
    total_dead = 0
    for s0 in range(0, len(results), f):
        chunk = results[s0:s0 + f]
        dead = [s0 + i for i, r in enumerate(chunk)
                if not r.get("reachable")]
        total_dead += len(dead)
        shards.append({
            "shard": s0 // f,
            "ranks": [s0, s0 + len(chunk) - 1],
            "n": len(chunk),
            "unreachable_count": len(dead),
            "unreachable_sample": dead[:8],
        })
    return {"fanout": f, "n": len(results), "shards": shards,
            "unreachable_total": total_dead}


# ----------------------------------------------- Prometheus text handling

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> Dict[str, Any]:
    """Parse an exposition document into ``{samples, types, helps}``:
    samples are ``{name, labels, value}`` rows in document order (value
    kept as its original string — re-emission must not reformat)."""
    samples: List[Dict[str, Any]] = []
    types: Dict[str, str] = {}
    helps: Dict[str, str] = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) == 4:
                types[parts[2]] = parts[3]
        elif line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) >= 3:
                helps[parts[2]] = parts[3] if len(parts) == 4 else ""
        elif line and not line.startswith("#"):
            m = _SAMPLE_RE.match(line)
            if not m:
                continue
            labels = {k: unescape_label_value(v)
                      for k, v in _LABEL_RE.findall(m.group(2) or "")}
            samples.append({"name": m.group(1), "labels": labels,
                            "value": m.group(3)})
    return {"samples": samples, "types": types, "helps": helps}


def _family_of(sample_name: str, types: Mapping[str, str]) -> str:
    """Histogram series (`x_bucket`/`x_sum`/`x_count`) belong to family
    `x` — the name the `# TYPE` line is on."""
    for suffix in ("_bucket", "_sum", "_count"):
        if sample_name.endswith(suffix):
            base = sample_name[:-len(suffix)]
            if types.get(base) == "histogram":
                return base
    return sample_name


def _federate_flat(texts: Mapping[int, str]) -> str:
    """The leaf federation step: N ranks' ``/metrics`` documents -> ONE
    exposition with the ``rank`` label injected per sample (see
    :func:`federate`).  Exposed separately so the flat merge can be timed
    as the baseline the tree beats."""
    families: Dict[str, Dict[str, Any]] = {}
    order: List[str] = []
    for rank in sorted(texts):
        parsed = parse_prometheus(texts[rank])
        for s in parsed["samples"]:
            fam_name = _family_of(s["name"], parsed["types"])
            fam = families.get(fam_name)
            if fam is None:
                fam = families[fam_name] = {
                    "kind": parsed["types"].get(fam_name, "untyped"),
                    "help": parsed["helps"].get(fam_name, ""),
                    "lines": []}
                order.append(fam_name)
            elif not fam["help"] and parsed["helps"].get(fam_name):
                fam["help"] = parsed["helps"][fam_name]
            labels = dict(s["labels"])
            if "rank" in labels:
                labels["source_rank"] = labels.pop("rank")
            labels["rank"] = str(rank)
            body = ",".join(f'{k}="{escape_label_value(v)}"'
                            for k, v in sorted(labels.items()))
            fam["lines"].append(f"{s['name']}{{{body}}} {s['value']}")
    lines: List[str] = []
    for name in order:
        fam = families[name]
        if fam["help"]:
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {fam['kind']}")
        lines.extend(fam["lines"])
    return "\n".join(lines) + "\n"


def merge_federated(docs: Sequence[str]) -> str:
    """The tree's inner node: merge ALREADY-federated exposition
    documents (samples carry their ``rank`` labels from the leaf step)
    into one, keeping ``# TYPE``/``# HELP`` exactly once per family in
    first-seen order.  Sample lines pass through byte-identical — the
    leaf emitted sorted-label bodies and preserved value strings, so a
    tree merge of shard documents equals the flat merge of the same
    ranks (the correctness contract the federation tests pin)."""
    families: Dict[str, Dict[str, Any]] = {}
    order: List[str] = []
    for doc in docs:
        parsed = parse_prometheus(doc)
        for s in parsed["samples"]:
            fam_name = _family_of(s["name"], parsed["types"])
            fam = families.get(fam_name)
            if fam is None:
                fam = families[fam_name] = {
                    "kind": parsed["types"].get(fam_name, "untyped"),
                    "help": parsed["helps"].get(fam_name, ""),
                    "lines": []}
                order.append(fam_name)
            elif not fam["help"] and parsed["helps"].get(fam_name):
                fam["help"] = parsed["helps"][fam_name]
            body = ",".join(f'{k}="{escape_label_value(v)}"'
                            for k, v in sorted(s["labels"].items()))
            fam["lines"].append(f"{s['name']}{{{body}}} {s['value']}")
    lines: List[str] = []
    for name in order:
        fam = families[name]
        if fam["help"]:
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {fam['kind']}")
        lines.extend(fam["lines"])
    return "\n".join(lines) + "\n"


def federate(texts: Mapping[int, str],
             fanout: Optional[int] = None) -> str:
    """N ranks' ``/metrics`` documents -> ONE exposition: every sample
    re-emitted with a ``rank="<r>"`` label injected (an existing rank
    label — the skew gauges carry one naming the ATTRIBUTED rank — is
    preserved as ``source_rank``), and ``# TYPE``/``# HELP`` exactly
    once per family no matter how many ranks exposed it.

    Above ``obs_federation_fanout`` ranks the merge runs as a TREE:
    rank-sharded leaf merges (fan-in ≈ fanout) whose documents then
    merge pairwise-flat at the root — each step touches a bounded
    number of documents, where the flat merge held every rank's parse
    in flight at once.  The output is identical either way
    (:func:`merge_federated`)."""
    f = federation_fanout(fanout)
    ranks = sorted(texts)
    if len(ranks) <= f:
        return _federate_flat(texts)
    docs = [_federate_flat({r: texts[r] for r in ranks[s0:s0 + f]})
            for s0 in range(0, len(ranks), f)]
    return merge_federated(docs)


# -------------------------------------------------------------- job view

def _gauge_value(parsed: Mapping[str, Any], name: str) -> Optional[float]:
    for s in parsed["samples"]:
        if s["name"] == name:
            try:
                return float(s["value"])
            except ValueError:
                return None
    return None


def job_view(results: Sequence[Mapping[str, Any]],
             prev: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """The job-level verdict over one :func:`fetch` sweep.

    ``prev`` (the previous sweep's view) turns the monotonic
    ``tmpi_engine_steps_total`` counters into real step RATES; without
    it the instantaneous ``1 / tmpi_engine_step_seconds`` stands in.
    Verdict: worst rank state wins, with ``unreachable``/``draining``
    counting as degraded-severity — one dead rank means the job is
    degraded even though the survivors are healthy."""
    now = time.monotonic()
    prev_ranks = {r["rank"]: r for r in (prev or {}).get("ranks", [])}
    prev_t = (prev or {}).get("polled_mono")
    ranks: List[Dict[str, Any]] = []
    skew_by_rank: Dict[int, float] = {}
    ps_sums: Dict[str, float] = {}
    worst = "healthy"
    for r, res in enumerate(results):
        h = res.get("health") or {}
        state = h.get("state", UNREACHABLE)
        if not res.get("reachable"):
            state = UNREACHABLE
        if _STATE_SEVERITY.get(state, 3) > _STATE_SEVERITY[worst]:
            worst = state
        row: Dict[str, Any] = {
            "rank": r,
            "state": state,
            "endpoint": res.get("endpoint"),
            "reasons": [c.get("code") for c in h.get("reasons", [])],
            "error": res.get("error"),
        }
        text = res.get("metrics_text")
        if text:
            parsed = parse_prometheus(text)
            step_s = _gauge_value(parsed, "tmpi_engine_step_seconds")
            steps = _gauge_value(parsed, "tmpi_engine_steps_total")
            row["step_ms"] = (round(step_s * 1e3, 3)
                              if step_s is not None else None)
            row["steps"] = steps
            row["examples_per_s"] = _gauge_value(
                parsed, "tmpi_engine_examples_per_sec")
            row["overlap_fraction"] = _gauge_value(
                parsed, "tmpi_engine_overlap_fraction")
            # Compute-efficiency feed (obs/numerics.py publish_flops):
            # absent off the card / before the probe — the column just reads "-".
            row["mfu"] = _gauge_value(parsed, "tmpi_mfu_estimate")
            row["step_flops"] = _gauge_value(parsed, "tmpi_step_flops")
            rate = None
            p = prev_ranks.get(r)
            if (p is not None and prev_t is not None
                    and p.get("steps") is not None and steps is not None
                    and now > prev_t):
                rate = max(0.0, (steps - p["steps"]) / (now - prev_t))
            elif step_s:
                rate = 1.0 / step_s
            row["step_rate"] = round(rate, 3) if rate is not None else None
            # Step-rate TREND from the rank's /history route (the
            # on-disk metrics history, obs/history.py): recent step rate
            # vs the trailing baseline — 1.0 steady, <1 slowing.  Absent
            # without the history plane; the column just reads "-".
            alerts_doc = res.get("alerts")
            if isinstance(alerts_doc, dict):
                # Structured (rule, phase) pairs — formatting is the
                # renderer's job; the rollup below must never re-parse
                # a display string (author-supplied rule names are
                # free-form).
                row["alerts"] = [
                    {"rule": str(a.get("name")), "phase": a.get("phase")}
                    for a in alerts_doc.get("firing") or []
                    if isinstance(a, dict)]
            hist = res.get("history")
            if isinstance(hist, dict):
                drift = hist.get("drift")
                row["step_trend"] = (round(float(drift), 4)
                                     if isinstance(drift, (int, float))
                                     else None)
                hrate = hist.get("rate")
                row["step_rate_hist"] = (round(float(hrate), 4)
                                         if isinstance(hrate, (int, float))
                                         else None)
            for s in parsed["samples"]:
                if s["name"] == "tmpi_rank_skew_attributed_seconds":
                    try:
                        who = int(s["labels"].get("rank", r))
                        skew_by_rank[who] = (skew_by_rank.get(who, 0.0)
                                             + float(s["value"]))
                    except (TypeError, ValueError):
                        pass
                elif s["name"] in (
                        "tmpi_ps_forward_error_total",
                        "tmpi_ps_handoff_torn_total",
                        "tmpi_ps_client_fenced_total",
                        "tmpi_ps_failover_total",
                        "tmpi_ps_promote_total",
                        "tmpi_ps_snapshot_torn_total"):
                    try:
                        ps_sums[s["name"]] = (ps_sums.get(s["name"], 0.0)
                                              + float(s["value"]))
                    except ValueError:
                        pass
        ranks.append(row)
    # diverged passes through like stalled: one replica computing wrong
    # numbers is a job-level emergency, not a "degraded" shrug.
    verdict = (worst if worst in ("healthy", "stalled", "diverged")
               else "degraded")
    straggler = (max(skew_by_rank, key=skew_by_rank.get)
                 if any(v > 0 for v in skew_by_rank.values()) else None)
    # Job-level firing-alert rollup: rule -> the ranks it fires on
    # (what `obs top` prints under the table and `obs
    # alerts` renders in full).
    alerts_by_rule: Dict[str, List[int]] = {}
    for row in ranks:
        for al in row.get("alerts") or []:
            alerts_by_rule.setdefault(al["rule"], []).append(row["rank"])
    view = {
        "verdict": verdict,
        "worst_state": worst,
        "alerts": alerts_by_rule,
        "ranks": ranks,
        "skew_attributed_s": {int(k): round(v, 6)
                              for k, v in sorted(skew_by_rank.items())},
        "straggler": straggler,
        "ps": ps_sums,
        "polled_mono": now,
        "polled_at": time.time(),
    }
    # Past one fan-in worth of ranks, dead ranks summarize per shard
    # (count + bounded sample) — a preemption wave at N=256 must not
    # render as 256 individual verdicts.
    if len(results) > federation_fanout():
        view["shards"] = shard_summary(results)
    return view


def fetch_journal(endpoints: Sequence[str], limit: int = 64,
                  timeout_s: float = 2.0) -> Dict[str, Any]:
    """Federate every rank's ``GET /journal`` tail into ONE merged record
    list (wall-time order, rank attributed from the endpoint index when
    the record's own rank is absent).  Dead ranks read ``unreachable``
    and contribute nothing — the sweep is bounded exactly like
    :func:`fetch`, never a hang."""
    slots = _sweep(
        endpoints,
        lambda ep: json.loads(_get(
            ep + f"/journal?limit={int(limit)}", timeout_s)),
        timeout_s, "journal", lambda _ep, msg: {"error": msg})
    ranks: List[Dict[str, Any]] = []
    records: List[Dict[str, Any]] = []
    for i, (ep, slot) in enumerate(zip(endpoints, slots)):
        row = {"rank": i, "endpoint": ep,
               "reachable": "records" in slot,
               "enabled": slot.get("enabled"),
               "segment": slot.get("segment"),
               "returned": slot.get("returned", 0),
               "error": slot.get("error")}
        ranks.append(row)
        for rec in slot.get("records") or []:
            if isinstance(rec, dict):
                rec.setdefault("rank", i)
                records.append(rec)
    records.sort(key=lambda r: (r.get("wall", 0.0), r.get("rank", 0),
                                r.get("seq", 0)))
    return {"ranks": ranks, "records": records,
            "unreachable": [r["rank"] for r in ranks
                            if not r["reachable"]]}


def fetch_alerts(endpoints: Sequence[str],
                 timeout_s: float = 2.0) -> Dict[str, Any]:
    """Federate every rank's ``GET /alerts`` into ONE job-level alert
    view (the CLI's ``alerts``): per-rank reachability +
    enablement, every firing alert rank-attributed, and a
    rule -> firing-ranks rollup.  Dead ranks read ``unreachable`` and
    contribute nothing — bounded exactly like :func:`fetch`, never a
    hang."""
    slots = _sweep(
        endpoints,
        lambda ep: json.loads(_get(ep + "/alerts", timeout_s)),
        timeout_s, "alerts", lambda _ep, msg: {"error": msg})
    ranks: List[Dict[str, Any]] = []
    firing: List[Dict[str, Any]] = []
    by_rule: Dict[str, List[int]] = {}
    for i, (ep, slot) in enumerate(zip(endpoints, slots)):
        row = {"rank": i, "endpoint": ep,
               "reachable": "error" not in slot,
               "enabled": slot.get("enabled"),
               "rules": slot.get("rules", 0),
               "firing": len(slot.get("firing") or []),
               "error": slot.get("error")}
        ranks.append(row)
        for al in slot.get("firing") or []:
            if isinstance(al, dict):
                firing.append(dict(al, rank=i))
                by_rule.setdefault(str(al.get("name")), []).append(i)
    return {"ranks": ranks, "firing": firing, "by_rule": by_rule,
            "unreachable": [r["rank"] for r in ranks
                            if not r["reachable"]]}


# -------------------------------------------------------------- rendering

def render_table(view: Mapping[str, Any]) -> str:
    """``obs top``'s terminal rendering of a :func:`job_view`."""
    lines = [
        f"job verdict: {view['verdict']}"
        + (f" (worst rank state: {view['worst_state']})"
           if view["worst_state"] != view["verdict"] else "")
        + (f"   straggler: rank {view['straggler']}"
           if view.get("straggler") is not None else ""),
        "",
        f"{'rank':>4} {'state':<12} {'step/s':>8} {'trend':>7} "
        f"{'ms/step':>9} "
        f"{'ex/s':>10} {'overlap':>8} {'mfu':>6} {'skew_s':>9} "
        f"{'alerts':>7}  reasons",
    ]
    skew = view.get("skew_attributed_s", {})
    for row in view["ranks"]:
        def fmt(v, spec):
            if isinstance(v, (int, float)):
                return format(v, spec)
            return format("-", ">" + spec.split(".")[0])
        alerts = row.get("alerts")
        lines.append(
            f"{row['rank']:>4} {row['state']:<12} "
            f"{fmt(row.get('step_rate'), '8.2f')} "
            f"{fmt(row.get('step_trend'), '7.2f')} "
            f"{fmt(row.get('step_ms'), '9.2f')} "
            f"{fmt(row.get('examples_per_s'), '10.1f')} "
            f"{fmt(row.get('overlap_fraction'), '8.2f')} "
            f"{fmt(row.get('mfu'), '6.3f')} "
            f"{fmt(skew.get(row['rank']), '9.4f')} "
            f"{(str(len(alerts)) if alerts is not None else '-'):>7}  "
            + (",".join(row.get("reasons") or [])
               or (row.get("error") or "")))
    if view.get("alerts"):
        lines.append("")
        lines.append("alerts firing: " + "  ".join(
            f"{rule}@r{','.join(str(r) for r in ranks_)}"
            for rule, ranks_ in sorted(view["alerts"].items())))
    if view.get("ps"):
        lines.append("")
        lines.append("ps: " + "  ".join(
            f"{k.removeprefix('tmpi_ps_').removesuffix('_total')}="
            f"{int(v)}" for k, v in sorted(view["ps"].items())))
    return "\n".join(lines)


def top(endpoints: Sequence[str], interval_s: float = 2.0,
        iterations: Optional[int] = None, timeout_s: float = 2.0,
        out=None, clear: bool = True, sink=None) -> Dict[str, Any]:
    """The refreshing cluster table: poll, render, repeat.  Returns the
    last :func:`job_view` (what ``--once --json`` prints).  ``sink`` is
    called with ``(view, fetch_results)`` after each sweep — the CLI's
    ``--federate`` writes the federation document from the SAME sweep
    the table showed (one snapshot, no doubled probe load)."""
    out = out if out is not None else sys.stdout
    view: Dict[str, Any] = {}
    prev: Optional[Dict[str, Any]] = None
    i = 0
    while True:
        results = fetch(endpoints, timeout_s=timeout_s, want_history=True,
                        want_alerts=True)
        view = job_view(results, prev=prev)
        if sink is not None:
            sink(view, results)
        prefix = "\x1b[2J\x1b[H" if clear else ""
        stamp = time.strftime("%H:%M:%S", time.localtime(view["polled_at"]))
        print(f"{prefix}torchmpi_tpu_torch.obs top — {len(endpoints)} "
              f"rank(s) @ {stamp}\n{render_table(view)}", file=out,
              flush=True)
        prev = view
        i += 1
        if iterations is not None and i >= iterations:
            return view
        time.sleep(interval_s)
