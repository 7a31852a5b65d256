"""Cluster aggregation: per-rank obsdump bundles + the straggler detector.

The port's copy of ``torchmpi_tpu/obs/aggregate.py``: the same bundle
schema (``tmpi-obsdump-v1``), so either package's ``merge_ranks`` reads
the other's bundles.  Two halves:

* **obsdump bundles** — each rank serializes its whole observability
  state (finished spans, drained native ring tails, metrics snapshot,
  clock calibration, loss counters) into one self-describing
  ``obsdump-<rank>.json`` file, written tmp->fsync->rename.  Bundles are
  produced on demand (:func:`write_obsdump`) and at runtime shutdown
  (``runtime/lifecycle.py`` when ``obs_dump_dir`` is set);
  ``obs/export.merge_ranks`` joins N of them into one aligned Chrome
  trace.

* **straggler / skew detector** — the "Tail at Scale" question: which
  rank's late arrival gates every synchronous collective?  From the
  aligned native ``start`` events of the same collective across ranks,
  :func:`collective_skew` computes per-collective arrival skew
  (max - min start) and attributes it to the last-arriving rank;
  :func:`skew_report` folds that into per-rank totals and a ranked
  top-contributors list (:func:`format_report` renders it), and
  :func:`fold_skew_into_registry` feeds the metrics registry
  (``tmpi_collective_skew_seconds{op}`` histograms + the per-rank
  ``tmpi_rank_skew_attributed_seconds{rank}`` gauge).

Cross-rank matching: correlation ids derived via
``tracer.cluster_correlation`` are identical on every rank, so when the
same (op, correlation) appears on >= 2 ranks the detector matches by
exact id.  Workloads using plain per-process ids fall back to occurrence
order — the k-th allreduce on rank 0 matches the k-th on rank 1, the
standard SPMD trace-join assumption.
"""

from __future__ import annotations

import glob
import os
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np

from . import export
from . import native as obs_native
from . import tracer

SCHEMA = "tmpi-obsdump-v1"

_EVENT_FIELDS = ("t_ns", "correlation", "bytes", "rank", "plane", "op",
                 "phase")


def events_to_rows(events) -> List[Dict[str, int]]:
    """EVENT_DTYPE structured array -> JSON-able list of dict rows."""
    return [{f: int(e[f]) for f in _EVENT_FIELDS} for e in events]


def rows_to_events(rows: Iterable[Mapping[str, int]]) -> np.ndarray:
    """Inverse of :func:`events_to_rows` (for offline tooling that wants
    the structured-array form back)."""
    rows = list(rows)
    out = np.zeros((len(rows),), obs_native.EVENT_DTYPE)
    for i, r in enumerate(rows):
        for f in _EVENT_FIELDS:
            out[i][f] = int(r.get(f, 0))
    return out


def json_attrs(attrs: Mapping[str, Any]) -> Dict[str, Any]:
    """Span/context attrs made JSON-safe: primitives pass through,
    everything else is ``repr``'d (shared by obsdump bundles and flight
    bundles so the two cannot drift in shape)."""
    return {k: v if isinstance(v, (int, float, str, bool, type(None)))
            else repr(v) for k, v in attrs.items()}


def make_bundle(rank: int,
                spans: Sequence[Dict[str, Any]],
                events: Iterable[Mapping[str, int]],
                clock: Optional[Dict[str, Any]] = None,
                metrics_snapshot: Optional[Dict[str, Any]] = None,
                extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Assemble a self-describing obsdump bundle from explicit parts —
    the shape ``export.merge_ranks`` consumes.  ``clock`` is a
    ``ClockMap``-entry-shaped dict (``offset_ns``, ``uncertainty_ns``,
    ``applied``); omitted means "raw local clock, offset unknown" (rank
    0 of an aligned group, or a single-host run)."""
    clock = dict(clock or {})
    clock.setdefault("offset_ns", 0)
    clock.setdefault("uncertainty_ns", 0)
    clock.setdefault("applied", False)
    bundle = {
        "schema": SCHEMA,
        "rank": int(rank),
        "pid": os.getpid(),
        "wall_time": time.time(),
        "clock": clock,
        "spans": [dict(s, attrs=json_attrs(s["attrs"])) for s in spans],
        "events": (events if isinstance(events, list)
                   else events_to_rows(events)),
        "dropped": {
            "spans": tracer.dropped(),
            "hostcomm": obs_native.dropped("hostcomm"),
            "ps": obs_native.dropped("ps"),
        },
    }
    if metrics_snapshot is not None:
        bundle["metrics"] = metrics_snapshot
    if extra:
        bundle["extra"] = dict(extra)
    return bundle


def write_obsdump(directory: str, rank: int = 0,
                  clock: Optional[Dict[str, Any]] = None,
                  extra: Optional[Dict[str, Any]] = None) -> str:
    """Drain this process's observability state into
    ``directory/obsdump-<rank>.json`` (atomic rename; a SIGKILL mid-dump
    never leaves a torn bundle).  Draining is destructive by design — a
    bundle IS the export of this window; the rings and span buffer start
    fresh after.  Also folds the drained spans into the registry's span
    and per-op collective histograms (exactly once per span) and embeds
    the metrics snapshot.  ``clock`` defaults to this process's last
    :func:`clocksync.align` calibration (raw/unknown when none ran)."""
    from . import clocksync
    from .metrics import registry

    if clock is None:
        clock = clocksync.last_calibration()
    os.makedirs(directory, exist_ok=True)
    spans = tracer.drain()
    # Per-plane loaded() guards (flight.py's discipline): draining an
    # UNLOADED plane would force its first-use g++ build — at shutdown
    # time, after this drain already emptied the span buffer, a failed
    # build would discard everything.  A never-loaded engine has no
    # events to lose.
    chunks = [obs_native.drain_events(p) for p in ("hostcomm", "ps")
              if obs_native.loaded(p)]
    events = (np.concatenate(chunks) if chunks
              else np.empty((0,), obs_native.EVENT_DTYPE))
    registry.observe_spans(spans)
    registry.observe_collectives(spans)
    registry.scrape_native()
    bundle = make_bundle(rank, spans, events_to_rows(events), clock=clock,
                         metrics_snapshot=registry.snapshot(), extra=extra)
    path = os.path.join(directory, f"obsdump-{int(rank)}.json")
    return export.atomic_write_json(path, bundle, indent=1)


def load_obsdumps(directory: str) -> List[Dict[str, Any]]:
    """Every ``obsdump-*.json`` bundle in ``directory``, rank order."""
    import json

    out = []
    for path in glob.glob(os.path.join(directory, "obsdump-*.json")):
        with open(path) as f:
            out.append(json.load(f))
    return sorted(out, key=lambda d: int(d.get("rank", 0)))


# ------------------------------------------------------------- detector

_PHASE_START = 1   # trace.h kPhStart
_PLANE_HC = 0      # collectives live on the hostcomm plane


def _aligned_starts(dumps: Sequence[Mapping[str, Any]],
                    ) -> Dict[int, List[Dict[str, int]]]:
    """rank -> its hostcomm collective *start* events on the aligned
    timeline, drain order preserved (= emission order per rank)."""
    out: Dict[int, List[Dict[str, int]]] = {}
    for d in dumps:
        clock = d.get("clock") or {}
        off = 0 if clock.get("applied") else int(clock.get("offset_ns", 0))
        rank = int(d["rank"])
        rows = out.setdefault(rank, [])
        for e in d.get("events", []):
            if (int(e["plane"]) == _PLANE_HC
                    and int(e["phase"]) == _PHASE_START):
                rows.append({"t_ns": int(e["t_ns"]) - off,
                             "op": int(e["op"]),
                             "correlation": int(e["correlation"])})
    return out


def collective_skew(dumps: Sequence[Mapping[str, Any]],
                    ) -> List[Dict[str, Any]]:
    """Per-collective arrival-skew records from N rank bundles.

    Matching the "same collective" across ranks: when any correlation id
    is shared by >= 2 ranks (cluster correlations), groups key on
    (op, correlation, occurrence-within-that-correlation) — one cluster
    id can cover several same-op collectives (a step's bucketed
    allreduces) and each must be scored; otherwise on plain
    (op, occurrence index) — the SPMD assumption that every rank runs
    the same collective sequence.
    Records: ``{op, key, arrivals: {rank: t_ns}, skew_ns, straggler}``
    where ``straggler`` is the LAST-arriving rank (the one gating the
    synchronous op), sorted by descending skew."""
    starts = _aligned_starts(dumps)
    # Only CLUSTER correlations (top bit set, tracer.cluster_correlation)
    # are id-matchable across ranks: per-process ids embed just 16 pid
    # bits, and two ranks whose pids share them would otherwise flip this
    # into correlation mode and silently discard every non-colliding
    # event.
    corr_ranks: Dict[int, set] = {}
    for rank, rows in starts.items():
        for e in rows:
            if e["correlation"] & (1 << 63):
                corr_ranks.setdefault(e["correlation"], set()).add(rank)
    by_correlation = any(len(rs) >= 2 for rs in corr_ranks.values())

    groups: Dict[Any, Dict[int, int]] = {}
    for rank, rows in starts.items():
        seen: Dict[Any, int] = {}
        for e in rows:
            if by_correlation:
                if len(corr_ranks.get(e["correlation"], ())) < 2:
                    continue
                # One cluster correlation covers a whole step's WORTH of
                # collectives (every bucketed allreduce under one
                # engine.step span shares the id), so the key carries a
                # per-rank occurrence index within (op, correlation):
                # the k-th same-op collective of step t on rank 0
                # matches the k-th on rank 1, and a 20-bucket gradient
                # sync contributes 20 skew records, not 1.
                base = (e["op"], e["correlation"])
                occ = seen.get(base, 0)
                seen[base] = occ + 1
                key = base + (occ,)
            else:
                occ = seen.get(e["op"], 0)
                seen[e["op"]] = occ + 1
                key = (e["op"], occ)
            groups.setdefault(key, {}).setdefault(rank, e["t_ns"])

    records: List[Dict[str, Any]] = []
    for key, arrivals in groups.items():
        if len(arrivals) < 2:
            continue
        last = max(arrivals, key=arrivals.get)
        first = min(arrivals.values())
        records.append({
            "op": obs_native.op_name(_PLANE_HC, key[0]),
            "key": (f"{key[1]:#x}+{key[2]}" if by_correlation
                    else int(key[1])),
            "matched_by": ("correlation" if by_correlation
                           else "occurrence"),
            "arrivals": {int(r): int(t) for r, t in arrivals.items()},
            "skew_ns": int(arrivals[last] - first),
            "straggler": int(last),
        })
    records.sort(key=lambda r: -r["skew_ns"])
    return records


def skew_report(dumps: Sequence[Mapping[str, Any]], top: int = 10,
                records: Optional[List[Dict[str, Any]]] = None,
                ) -> Dict[str, Any]:
    """The cluster skew verdict: per-rank attributed-skew totals (every
    collective's skew charged to its last-arriving rank), the worst
    single collectives, and the named straggler — the rank with the
    largest attributed total (None below 2 matched collectives: one
    sample is an anecdote, not a tail).  Pass ``records`` (a
    :func:`collective_skew` result) to skip re-deriving them."""
    if records is None:
        records = collective_skew(dumps)
    per_rank: Dict[int, Dict[str, Any]] = {}
    per_op: Dict[str, Dict[str, Any]] = {}
    for r in records:
        st = per_rank.setdefault(r["straggler"],
                                 {"attributed_ns": 0, "collectives": 0})
        st["attributed_ns"] += r["skew_ns"]
        st["collectives"] += 1
        op = per_op.setdefault(r["op"], {"skew_ns_total": 0, "count": 0,
                                         "skew_ns_max": 0})
        op["skew_ns_total"] += r["skew_ns"]
        op["count"] += 1
        op["skew_ns_max"] = max(op["skew_ns_max"], r["skew_ns"])
    straggler = None
    if len(records) >= 2 and per_rank:
        straggler = max(per_rank, key=lambda r: per_rank[r]["attributed_ns"])
    return {
        "collectives_matched": len(records),
        "matched_by": records[0]["matched_by"] if records else None,
        "straggler": straggler,
        "per_rank": {int(k): v for k, v in sorted(per_rank.items())},
        "per_op": per_op,
        "top": records[:top],
    }


def fold_skew_into_registry(records: Sequence[Mapping[str, Any]],
                            registry=None) -> None:
    """Feed the detector's verdicts to the metrics registry: a
    per-collective skew histogram keyed by op and a per-rank
    attributed-skew gauge (the dashboard's "who is gating the job right
    now" number)."""
    if registry is None:
        from .metrics import registry as registry_
        registry = registry_
    h = registry.histogram(
        "tmpi_collective_skew_seconds",
        "cross-rank arrival skew (max - min aligned start) per "
        "synchronous collective")
    g = registry.gauge(
        "tmpi_rank_skew_attributed_seconds",
        "total collective arrival skew attributed to this rank arriving "
        "last (the straggler signal)")
    totals: Dict[int, float] = {}
    for r in records:
        h.observe(r["skew_ns"] / 1e9, labels={"op": r["op"]})
        totals[r["straggler"]] = (totals.get(r["straggler"], 0.0)
                                  + r["skew_ns"] / 1e9)
    for rank, total in totals.items():
        g.set(total, labels={"rank": str(rank)})


def format_report(report: Mapping[str, Any]) -> str:
    """Human-oriented rendering of :func:`skew_report`."""
    lines = [
        f"collectives matched : {report['collectives_matched']} "
        f"(by {report['matched_by']})",
        f"straggler verdict   : "
        + (f"rank {report['straggler']}" if report["straggler"] is not None
           else "none (too few matched collectives)"),
        "",
        "per-rank attributed skew:",
    ]
    for rank, st in report["per_rank"].items():
        lines.append(f"  rank {rank:<3} {st['attributed_ns'] / 1e6:10.3f} ms"
                     f"  over {st['collectives']} collectives")
    lines.append("")
    lines.append("top skew contributors:")
    for r in report["top"]:
        base = min(r["arrivals"].values())
        arrivals = " ".join(f"r{k}+{(v - base) / 1e3:.1f}us"
                            for k, v in sorted(r["arrivals"].items()))
        lines.append(f"  {r['op']:<12} key={r['key']} "
                     f"skew={r['skew_ns'] / 1e6:8.3f} ms "
                     f"straggler=r{r['straggler']}  [{arrivals}]")
    return "\n".join(lines)
