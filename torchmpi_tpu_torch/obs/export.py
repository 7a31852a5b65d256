"""Merged Chrome/Perfetto trace export: single-rank and cluster-wide.

The port's copy of ``torchmpi_tpu/obs/export.py``.  Single rank
(:func:`chrome_trace`) — three timelines, one ``traceEvents`` JSON (load
in ``chrome://tracing`` or ui.perfetto.dev):

* Python spans (``obs.tracer``)       -> pid "python", complete ("X")
  events, one tid per OS thread;
* native phase events (``obs.native``) -> one pid per plane, instant
  ("i") events for start/chunk/retry/error and synthesized "X" events
  for start..complete pairs of the same (correlation, op, rank);
* the device timeline -> pid "device", one tid per CUDA stream.  This
  is the one place where the two packages' formats differ: JAX reads an
  XLA xplane capture through ``_compat``; the port reads the Chrome
  trace that ``utils/profiler.StepWindowProfiler`` (or
  ``utils/profiler.trace``) writes through ``torch.profiler``'s
  ``export_chrome_trace``, and takes its CUDA kernel, memcpy and memset
  events (:func:`_device_events`).

Cluster (:func:`merge_ranks`) — N per-rank obsdump bundles
(``obs/aggregate.py``) onto ONE timeline: each rank's spans/events are
shifted by the clock offset its bundle recorded (``obs/clocksync.py``;
bundles whose stamps were pre-aligned at source are not shifted twice),
each rank gets its own process lanes ("rank 3 · python", "rank 3 ·
hostcomm", ...), and **flow arrows** connect every correlation id that
appears on more than one rank — the same engine step / collective drawn
as one arc across the cluster (the Dapper cross-host join).
:func:`flow_join_report` is the acceptance check: every cross-rank
correlation must yield a complete flow (one "s" + >= 1 "f" anchor).

Correlation join: a native event *joins* when its correlation id matches
a drained Python span's.  :func:`span_join_rate` is the per-rank
acceptance metric (OBS artifact: >= 90% of native hostcomm/PS events
must join).

``save`` writes tmp -> fsync -> atomic rename (the checkpoint
discipline): a SIGKILL mid-dump leaves the previous file or nothing —
never a torn JSON a post-mortem reader half-parses.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from . import native as obs_native

_PID_PYTHON = 1
_PID_HC = 2
_PID_PS = 3
_PID_DEVICE = 10

#: per-rank lane layout for merge_ranks: rank r's planes live at pids
#: [_RANK_STRIDE * r + 1 .. + 3], keeping ranks grouped in the UI sort.
_RANK_STRIDE = 100


def _meta(pid: int, name: str) -> Dict[str, Any]:
    return {"ph": "M", "pid": pid, "name": "process_name",
            "args": {"name": name}}


def _span_events(spans: Sequence[Dict[str, Any]], t0: int,
                 pid: int = _PID_PYTHON) -> List[Dict[str, Any]]:
    out = []
    for s in spans:
        out.append({
            "ph": "X",
            "name": s["name"],
            "cat": "python",
            "pid": pid,
            "tid": s["thread"] % 100000,
            "ts": (s["t0_ns"] - t0) / 1e3,          # Chrome wants us
            "dur": max(s["t1_ns"] - s["t0_ns"], 1) / 1e3,
            "args": {"correlation": f"{s['correlation']:#x}",
                     **{k: repr(v) for k, v in s["attrs"].items()}},
        })
    return out


def _native_events(events, t0: int,
                   plane_pids: Mapping[int, int] = {0: _PID_HC, 1: _PID_PS},
                   ) -> List[Dict[str, Any]]:
    """Instant events per phase + synthesized complete events for
    start..complete/error pairs keyed on (plane, correlation, op, rank)."""
    out: List[Dict[str, Any]] = []
    open_ops: Dict[Tuple[int, int, int, int], Any] = {}

    def _pid(plane: int) -> int:
        return plane_pids.get(plane, _PID_HC)

    def _instant(ev, phase_name: str) -> Dict[str, Any]:
        plane = int(ev["plane"])
        op = obs_native.op_name(plane, int(ev["op"]))
        return {
            "ph": "i",
            "s": "t",
            "name": f"{op}.{phase_name}",
            "cat": "native",
            "pid": _pid(plane),
            "tid": int(ev["rank"]) if int(ev["rank"]) >= 0 else 99,
            "ts": (int(ev["t_ns"]) - t0) / 1e3,
            "args": {"correlation": f"{int(ev['correlation']):#x}",
                     "bytes": int(ev["bytes"]), "phase": phase_name},
        }

    for ev in events:
        plane = int(ev["plane"])
        phase = obs_native.PHASES.get(int(ev["phase"]), "?")
        key = (plane, int(ev["correlation"]), int(ev["op"]), int(ev["rank"]))
        if phase == "start":
            # A re-started key (same op again under one correlation, e.g.
            # a retried request) flushes the superseded start as an
            # instant so it is not silently lost.
            prev = open_ops.get(key)
            if prev is not None:
                out.append(_instant(prev, "start"))
            open_ops[key] = ev
        elif phase in ("complete", "error") and key in open_ops:
            start = open_ops.pop(key)
            op = obs_native.op_name(plane, int(ev["op"]))
            out.append({
                "ph": "X",
                "name": op + (" (error)" if phase == "error" else ""),
                "cat": "native",
                "pid": _pid(plane),
                "tid": int(ev["rank"]) if int(ev["rank"]) >= 0 else 99,
                "ts": (int(start["t_ns"]) - t0) / 1e3,
                "dur": max(int(ev["t_ns"]) - int(start["t_ns"]), 1) / 1e3,
                "args": {"correlation": f"{int(ev['correlation']):#x}",
                         "bytes": int(ev["bytes"]), "phase": phase},
            })
        else:
            out.append(_instant(ev, phase))
    # ops whose complete never made the drain (trace-off flip, ring
    # overflow, still in flight) surface as start instants, not silence
    for ev in open_ops.values():
        out.append(_instant(ev, "start"))
    return out


#: the torch.profiler Chrome-trace categories of device work.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _device_events(trace_path: str, t0_us: float) -> List[Dict[str, Any]]:
    """The device work of a ``torch.profiler`` Chrome trace (a file, or a
    directory whose newest ``*.json`` is taken, as
    ``utils/profiler.op_breakdown`` reads it) as Chrome events shifted to
    start at ``t0_us``: one pid per device, one tid per stream.  A CPU
    run's trace holds no device events and yields none."""
    import glob

    if os.path.isdir(trace_path):
        files = glob.glob(os.path.join(trace_path, "**", "*.json"),
                          recursive=True)
        if not files:
            raise ValueError(f"no trace (.json) under {trace_path!r}")
        trace_path = max(files, key=os.path.getmtime)
    with open(trace_path) as f:
        data = json.load(f)
    kernels = [e for e in data.get("traceEvents", [])
               if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not kernels:
        return []
    base = min(float(e["ts"]) for e in kernels)
    devices = sorted({int(e.get("args", {}).get("device", 0) or 0)
                      for e in kernels})
    out: List[Dict[str, Any]] = []
    for e in kernels:
        args = e.get("args", {})
        dev = int(args.get("device", 0) or 0)
        out.append({
            "ph": "X",
            "name": e["name"],
            "cat": "device",
            "pid": _PID_DEVICE + devices.index(dev),
            "tid": int(args.get("stream", e.get("tid", 0)) or 0),
            "ts": t0_us + (float(e["ts"]) - base),
            "dur": max(float(e.get("dur", 0.0)), 1e-3),
            "args": {"kind": e["cat"]},
        })
    return out


def chrome_trace(spans: Sequence[Dict[str, Any]],
                 events,
                 device_trace: Optional[str] = None) -> Dict[str, Any]:
    """Merge Python spans, native trace events and (optionally) the device
    lane of a ``torch.profiler`` Chrome trace (``device_trace``, a file or
    a directory) into one Chrome-trace dict (``{"traceEvents": [...]}``).
    Timestamps are normalized to the earliest host event; the device lane
    starts at 0 (its clock is the profiler's, not CLOCK_MONOTONIC)."""
    t0_candidates = [s["t0_ns"] for s in spans]
    t0_candidates += [int(e["t_ns"]) for e in events]
    t0 = min(t0_candidates) if t0_candidates else 0
    trace: List[Dict[str, Any]] = [
        _meta(_PID_PYTHON, "python spans"),
        _meta(_PID_HC, "native hostcomm"),
        _meta(_PID_PS, "native ps"),
    ]
    trace += _span_events(spans, t0)
    trace += _native_events(events, t0)
    if device_trace is not None:
        trace.append(_meta(_PID_DEVICE, "device (torch.profiler)"))
        trace += _device_events(device_trace, 0.0)
    return {"traceEvents": trace,
            "displayTimeUnit": "ms",
            "metadata": {"clock": "CLOCK_MONOTONIC, normalized",
                         "t0_ns": t0}}


# ---------------------------------------------------------------- cluster

def _aligned(dump: Mapping[str, Any],
             ) -> Tuple[List[Dict[str, Any]], List[Any]]:
    """One obsdump bundle's (spans, events) shifted onto the reference
    timeline.  A bundle whose stamps were already aligned at the source
    (``clocksync.apply`` before recording) is passed through untouched —
    shifting it again would double-correct."""
    clock = dump.get("clock") or {}
    off = 0 if clock.get("applied") else int(clock.get("offset_ns", 0))
    spans = dump.get("spans", [])
    events = dump.get("events", [])
    if off:
        spans = [dict(s, t0_ns=s["t0_ns"] - off, t1_ns=s["t1_ns"] - off)
                 for s in spans]
        events = [dict(e, t_ns=int(e["t_ns"]) - off) for e in events]
    return spans, events


def _flow_anchors(trace_events: Sequence[Dict[str, Any]],
                  ) -> Dict[str, List[Dict[str, Any]]]:
    """correlation-hex -> the anchorable events carrying it (X and i
    events; metas and flows themselves have no correlation arg)."""
    by_corr: Dict[str, List[Dict[str, Any]]] = {}
    for e in trace_events:
        corr = e.get("args", {}).get("correlation")
        if corr and corr != "0x0" and e.get("ph") in ("X", "i"):
            by_corr.setdefault(corr, []).append(e)
    return by_corr


def merge_ranks(dumps: Sequence[Mapping[str, Any]],
                flows: bool = True) -> Dict[str, Any]:
    """Merge N per-rank obsdump bundles (``obs/aggregate.py`` shape: at
    least ``rank``, ``spans``, ``events``, ``clock``) into ONE Chrome
    trace on the aligned timeline: per-rank process lanes, plus flow
    events ("s"/"f" pairs) connecting every correlation id that appears
    on more than one rank.  ``metadata.cross_rank`` carries the flow
    accounting (:func:`flow_join_report` re-derives it from the trace
    alone)."""
    per_rank: List[Tuple[int, List[Dict[str, Any]], List[Any],
                         Mapping[str, Any]]] = []
    for d in dumps:
        spans, events = _aligned(d)
        per_rank.append((int(d["rank"]), spans, events, d))
    t0_candidates = [s["t0_ns"] for _, spans, _, _ in per_rank
                     for s in spans]
    t0_candidates += [int(e["t_ns"]) for _, _, events, _ in per_rank
                      for e in events]
    t0 = min(t0_candidates) if t0_candidates else 0

    trace: List[Dict[str, Any]] = []
    # corr -> rank -> that rank's EARLIEST anchor event carrying it
    # (accumulated in the lane pass; the flow pass below reuses it, so
    # the events are scanned once).
    first_anchor: Dict[str, Dict[int, Dict[str, Any]]] = {}
    for rank, spans, events, dump in sorted(per_rank, key=lambda x: x[0]):
        base = _RANK_STRIDE * rank
        clock = dump.get("clock") or {}
        unc = int(clock.get("uncertainty_ns", 0))
        suffix = f" (±{unc / 1e3:.0f}us)" if unc else ""
        trace.append(_meta(base + _PID_PYTHON,
                           f"rank {rank} · python{suffix}"))
        trace.append(_meta(base + _PID_HC, f"rank {rank} · hostcomm"))
        trace.append(_meta(base + _PID_PS, f"rank {rank} · ps"))
        evs = _span_events(spans, t0, pid=base + _PID_PYTHON)
        evs += _native_events(events, t0,
                              plane_pids={0: base + _PID_HC,
                                          1: base + _PID_PS})
        trace += evs
        for corr, anchors in _flow_anchors(evs).items():
            by_rank = first_anchor.setdefault(corr, {})
            best = min(anchors, key=lambda e: e["ts"])
            cur = by_rank.get(rank)
            if cur is None or best["ts"] < cur["ts"]:
                by_rank[rank] = best

    cross = {c for c, by_rank in first_anchor.items() if len(by_rank) >= 2}
    flows_emitted = 0
    if flows and cross:
        # One flow per cross-rank correlation: "s" on the earliest anchor,
        # "f" (bind-enclosing) on the earliest anchor of every OTHER rank
        # carrying it — the arc every rank's lane hangs off.
        for corr in sorted(cross):
            ordered = sorted(first_anchor[corr].values(),
                             key=lambda e: e["ts"])
            fid = corr
            for i, e in enumerate(ordered):
                trace.append({
                    "ph": "s" if i == 0 else "f",
                    **({} if i == 0 else {"bp": "e"}),
                    "id": fid,
                    "name": "xrank",
                    "cat": "xrank",
                    "pid": e["pid"],
                    "tid": e["tid"],
                    "ts": e["ts"],
                })
                flows_emitted += 1

    return {
        "traceEvents": trace,
        "displayTimeUnit": "ms",
        "metadata": {
            "clock": "aligned to reference rank (obs/clocksync), "
                     "normalized",
            "t0_ns": t0,
            "ranks": sorted(r for r, *_ in per_rank),
            "cross_rank": {
                "correlations": len(cross),
                "flow_events": flows_emitted,
            },
        },
    }


def flow_join_report(trace: Mapping[str, Any]) -> Dict[str, Any]:
    """Validate a merged trace's flows from the trace alone: every
    cross-rank correlation (an id carried by anchor events on >= 2
    distinct rank lanes) must have a complete flow — exactly one "s" and
    >= 1 "f" step, each sitting at ts/pid/tid of a real anchor event.
    ``rate`` is joined / cross-rank correlations (None when there are no
    cross-rank correlations to join)."""
    events = trace["traceEvents"]
    anchors = _flow_anchors(events)
    cross = {c for c, evs in anchors.items()
             if len({e["pid"] // _RANK_STRIDE for e in evs}) >= 2}
    anchor_keys = {(e["pid"], e["tid"], round(e["ts"], 6))
                   for evs in anchors.values() for e in evs}
    flows: Dict[str, Dict[str, int]] = {}
    dangling = 0
    for e in events:
        if e.get("cat") != "xrank":
            continue
        st = flows.setdefault(e["id"], {"s": 0, "f": 0})
        st[e["ph"]] += 1
        if (e["pid"], e["tid"], round(e["ts"], 6)) not in anchor_keys:
            dangling += 1
    joined = sum(1 for c in cross
                 if flows.get(c, {}).get("s") == 1
                 and flows.get(c, {}).get("f", 0) >= 1)
    return {
        "cross_rank_correlations": len(cross),
        "joined": joined,
        "rate": (joined / len(cross)) if cross else None,
        "dangling_flow_events": dangling,
        "flow_events": sum(v["s"] + v["f"] for v in flows.values()),
    }


def span_join_rate(spans: Sequence[Dict[str, Any]], events,
                   ) -> Dict[str, Any]:
    """Fraction of native events whose correlation id joins a Python span
    (the acceptance metric).  Unattributed events (correlation 0) count as
    un-joined — they are exactly the frames no span dispatched."""
    span_ids = {s["correlation"] for s in spans} - {0}
    total = joined = 0
    per_plane: Dict[str, Dict[str, int]] = {}
    for ev in events:
        plane = obs_native.PLANES.get(int(ev["plane"]), "?")
        st = per_plane.setdefault(plane, {"events": 0, "joined": 0})
        st["events"] += 1
        total += 1
        if int(ev["correlation"]) in span_ids:
            st["joined"] += 1
            joined += 1
    return {
        "native_events": total,
        "joined": joined,
        "rate": (joined / total) if total else None,
        "per_plane": per_plane,
        "spans": len(spans),
    }


def atomic_write_json(path: str, obj: Any, indent: Optional[int] = None,
                      ) -> str:
    """tmp -> fsync -> atomic rename -> best-effort dir fsync (the
    checkpoint/update_artifact discipline): a reader never observes a
    half-written file, and a SIGKILL mid-dump leaves the previous
    version or nothing — never a torn JSON.  Shared by trace export,
    obsdump bundles and flight-recorder dumps."""
    path = os.fspath(path)
    d = os.path.dirname(path) or "."
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp.{os.getpid()}")
    try:
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=indent)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    try:
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass  # the rename is durable-enough on filesystems that refuse
    return path


def save(path: str, trace: Dict[str, Any]) -> str:
    return atomic_write_json(path, trace)
