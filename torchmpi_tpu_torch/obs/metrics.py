"""Metrics registry: counters / gauges / histograms with Prometheus text
and JSON snapshot exporters.

The port's copy of ``torchmpi_tpu/obs/metrics.py``: the same families,
label escaping and exposition text, byte for byte, for the same calls.
:meth:`Registry.scrape_native` pulls the C-ABI counters of the port's own
parameter-server engine (``parameterserver/native.py``), the native trace
rings' and the span tracer's loss counters and the journal's suppressed
appends into canonical metric names, so a monitor polls one surface.

Thread-safe; metric identity is (name, sorted label items), the
Prometheus data model.  No client library: the text format is emitted
directly.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict[str, str]]) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))


def escape_label_value(v: str) -> str:
    """Escape a label value per the Prometheus text exposition spec
    (backslash, double-quote and line-feed): a label carrying an endpoint
    string, an error message or a span attr must not be able to corrupt
    the text format.  Order matters — backslash first, or the escapes
    themselves get re-escaped."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def unescape_label_value(v: str) -> str:
    """Inverse of :func:`escape_label_value` (the round-trip contract the
    tests pin).  Single left-to-right pass, so ``\\\\n`` decodes to a
    backslash + 'n', not a newline."""
    out: List[str] = []
    i = 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"n": "\n", '"': '"', "\\": "\\"}.get(nxt, c + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _escape_help(text: str) -> str:
    """HELP lines escape backslash and line-feed (spec); quotes are legal
    there."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _label_str(key: _LabelKey) -> str:
    if not key:
        return ""
    return ("{" + ",".join(f'{k}="{escape_label_value(v)}"'
                           for k, v in key) + "}")


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str):
        self.name = name
        self.help = help_
        self._values: Dict[_LabelKey, Any] = {}
        self._lock = threading.Lock()

    def _items(self) -> List[Tuple[_LabelKey, Any]]:
        with self._lock:
            out = []
            for k, v in sorted(self._values.items()):
                if isinstance(v, dict):
                    # Histogram state mutates in place under observe(); a
                    # snapshot must hand out copies, not live references.
                    v = dict(v, buckets=list(v["buckets"]))
                out.append((k, v))
            return out


class Counter(_Metric):
    """Monotonic counter.  ``set_to`` exists for scraped sources that are
    already monotonic at the origin (the C-ABI counters): it refuses to go
    backwards, so a scrape can never un-count an event."""

    kind = "counter"

    def inc(self, value: float = 1.0, labels: Optional[Dict[str, str]] = None,
            ) -> None:
        if value < 0:
            raise ValueError("counters only go up")
        k = _label_key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value

    def set_to(self, value: float, labels: Optional[Dict[str, str]] = None,
               ) -> None:
        k = _label_key(labels)
        with self._lock:
            self._values[k] = max(float(value), self._values.get(k, 0.0))

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return float(self._values.get(_label_key(labels), 0.0))


class Gauge(_Metric):
    kind = "gauge"

    def clear(self) -> None:
        """Drop every label row.  For info-style gauges whose label set
        IS the value (the autotuner's active-cache gauge): ``set`` under
        a new label key ADDS a row, so advertising a replacement requires
        clearing the old row first.  Gauges only — counters are monotonic
        and never forget."""
        with self._lock:
            self._values.clear()

    def replace(self, value: float,
                labels: Optional[Dict[str, str]] = None) -> None:
        """clear() + set() under ONE lock hold: a concurrent scrape sees
        either the old row or the new one, never zero rows and never
        both — the single-row info-gauge update."""
        k = _label_key(labels)
        with self._lock:
            self._values.clear()
            self._values[k] = float(value)

    def set(self, value: float, labels: Optional[Dict[str, str]] = None,
            ) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def value(self, labels: Optional[Dict[str, str]] = None) -> float:
        with self._lock:
            return float(self._values.get(_label_key(labels), 0.0))


def bytes_bucket(n: Any) -> str:
    """Power-of-two payload bucket label (``"0"``, ``"64B"``, ``"4KiB"``,
    ``"16MiB"`` ...): the smallest power of two >= n, with binary units.
    Bucketing keeps the label-set cardinality logarithmic in payload
    size — the shape an autotuner cache and a dashboard both want."""
    try:
        n = int(n)
    except (TypeError, ValueError):
        return "?"
    if n <= 0:
        return "0"
    b = 1 << (n - 1).bit_length()
    for unit, scale in (("GiB", 1 << 30), ("MiB", 1 << 20),
                        ("KiB", 1 << 10)):
        if b >= scale:
            return f"{b // scale}{unit}"
    return f"{b}B"


#: default histogram buckets: micro-seconds to tens of seconds in decades —
#: host-plane ops span 5 orders of magnitude (a loopback barrier vs a
#: retried 16 MiB allreduce through a sick network).
DEFAULT_BUCKETS = (1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help_: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help_)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def observe(self, value: float,
                labels: Optional[Dict[str, str]] = None) -> None:
        k = _label_key(labels)
        with self._lock:
            st = self._values.setdefault(
                k, {"count": 0, "sum": 0.0,
                    "buckets": [0] * len(self.buckets)})
            st["count"] += 1
            st["sum"] += float(value)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    st["buckets"][i] += 1


class Registry:
    """Get-or-create registry (one per process by default: :data:`registry`).

    Re-requesting a name returns the existing metric; a kind clash raises —
    two subsystems silently sharing a name with different semantics is the
    drift this registry exists to end.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help_: str, **kw) -> Any:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help_, **kw)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            elif not m.help and help_:
                # A help-less first touch (a bare read before the real
                # registration) must not eat the family's HELP forever.
                m.help = help_
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(Counter, name, help_)

    def peek(self, name: str) -> Optional[_Metric]:
        """The metric registered under ``name``, or None — a READ that
        never creates (the get-or-create accessors would plant an empty
        help-less family just by asking; /healthz's watched-counter scan
        must not pollute registries that never scraped)."""
        with self._lock:
            return self._metrics.get(name)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(Gauge, name, help_)

    def histogram(self, name: str, help_: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help_, buckets=buckets)

    # ------------------------------------------------------------- scraping

    def scrape_native(self) -> None:
        """Pull every C-ABI observable into canonical metrics: the PS
        resilience counters (retry/timeout/CRC/server-exception — the
        retired peepholes) and the trace planes' drop-oldest loss counters.
        Monotonic at the origin, recorded via ``Counter.set_to``.  A
        never-loaded PS engine's counters are necessarily zero and are
        reported as such without forcing its first-use build (a
        hostcomm-only process scraping must not compile ps.so)."""
        from . import native as obs_native

        if obs_native.loaded("ps"):
            from ..parameterserver import native as ps_native

            ps_vals = (ps_native.retry_count(), ps_native.timeout_count(),
                       ps_native.crc_failure_count(),
                       int(ps_native.lib().tmpi_ps_server_exception_count()))
            snap_vals = (ps_native.snapshot_count(),
                         ps_native.snapshot_error_count(),
                         ps_native.snapshot_restore_count(),
                         ps_native.snapshot_torn_count(),
                         ps_native.epoch_fence_count(),
                         ps_native.client_fenced_count())
            repl_vals = (ps_native.forward_count(),
                         ps_native.forward_error_count(),
                         ps_native.handoff_count(),
                         ps_native.handoff_torn_count())
        else:
            ps_vals = (0, 0, 0, 0)
            snap_vals = (0, 0, 0, 0, 0, 0)
            repl_vals = (0, 0, 0, 0)
        self.counter(
            "tmpi_ps_retry_total",
            "PS client re-attempts after a failed request attempt",
        ).set_to(ps_vals[0])
        self.counter(
            "tmpi_ps_timeout_total",
            "expired PS per-request socket deadlines",
        ).set_to(ps_vals[1])
        self.counter(
            "tmpi_ps_crc_failure_total",
            "client-detected PS frame-integrity faults",
        ).set_to(ps_vals[2])
        self.counter(
            "tmpi_ps_server_exception_total",
            "connections the PS server dropped because a worker threw",
        ).set_to(ps_vals[3])
        # Durability + failover plane (the snapshot engine's observables;
        # tmpi_ps_failover_total / tmpi_ps_reseed_total are Python-side
        # counters inc'd directly by parameterserver's failover paths).
        self.counter(
            "tmpi_ps_snapshot_total",
            "durable PS shard snapshots landed (write+fsync+rename)",
        ).set_to(snap_vals[0])
        self.counter(
            "tmpi_ps_snapshot_error_total",
            "failed PS snapshot/epoch-marker writes",
        ).set_to(snap_vals[1])
        self.counter(
            "tmpi_ps_snapshot_restore_total",
            "successful PS snapshot restores at server start",
        ).set_to(snap_vals[2])
        self.counter(
            "tmpi_ps_snapshot_torn_total",
            "PS snapshot files rejected by restore validation (skipped, "
            "never loaded)",
        ).set_to(snap_vals[3])
        self.counter(
            "tmpi_ps_epoch_fence_total",
            "pushes this process's PS server NACKed with a stale epoch",
        ).set_to(snap_vals[4])
        self.counter(
            "tmpi_ps_client_fenced_total",
            "fenced NACKs this process's PS client received",
        ).set_to(snap_vals[5])
        # Replication & handoff plane (tmpi_ps_promote_total lives beside
        # tmpi_ps_failover_total/_reseed_total as a Python-side counter
        # inc'd by parameterserver's promotion path — the decision is
        # client-side, there is no native event to scrape).
        self.counter(
            "tmpi_ps_forward_total",
            "pushes the PS primary forwarded onto backup servers (landed)",
        ).set_to(repl_vals[0])
        self.counter(
            "tmpi_ps_forward_error_total",
            "forward frames provably lost to a backup (send failure, "
            "queue overflow, stop-time abandon) — repaired by re-seed at "
            "promotion",
        ).set_to(repl_vals[1])
        self.counter(
            "tmpi_ps_handoff_total",
            "completed live shard handoffs (ship + fence)",
        ).set_to(repl_vals[2])
        self.counter(
            "tmpi_ps_handoff_torn_total",
            "handoffs torn mid-ship (the old owner un-drained and kept "
            "serving; nothing cut over)",
        ).set_to(repl_vals[3])
        from . import tracer

        self.counter(
            "tmpi_trace_dropped_total",
            "trace events lost to the bounded rings (drop-oldest)",
        ).set_to(obs_native.dropped("hostcomm"), labels={"plane": "hostcomm"})
        self.counter(
            "tmpi_trace_dropped_total",
        ).set_to(obs_native.dropped("ps"), labels={"plane": "ps"})
        self.counter(
            "tmpi_obs_span_dropped_total",
            "finished Python spans lost to the bounded span buffer",
        ).set_to(tracer.dropped())
        from . import journal as obs_journal

        self.counter(
            "tmpi_journal_errors_total",
            "journal appends suppressed by a write failure (the only "
            "trace a failed append leaves; the alert plane's "
            "journal_drop_loss rule watches its movement)",
        ).set_to(obs_journal.errors())

    def observe_spans(self, spans: Iterable[Dict[str, Any]]) -> None:
        """Fold finished tracer spans into per-name duration histograms
        (``tmpi_span_seconds{span=...}``)."""
        h = self.histogram("tmpi_span_seconds",
                           "duration of finished tracer spans")
        for s in spans:
            h.observe((s["t1_ns"] - s["t0_ns"]) / 1e9,
                      labels={"span": s["name"]})

    def observe_collectives(self, spans: Iterable[Dict[str, Any]]) -> None:
        """Fold host-plane op spans (``hostcomm.*`` / ``ps.*``) into
        per-op latency histograms
        ``tmpi_collective_seconds{op,plane,bytes_bucket}`` — the measured
        per-(op, size) feed a collective autotuner's winner cache keys
        on.  Zero-length spans (async dispatch marks) are skipped: the
        latency lives in the matching ``handle.wait``, and a 0 s
        observation per dispatch would poison the low buckets.  Call on
        spans exactly once (e.g. on a ``tracer.drain()`` batch)."""
        h = self.histogram(
            "tmpi_collective_seconds",
            "host-plane collective latency from span durations, keyed by "
            "op, plane and power-of-two payload bucket")
        for s in spans:
            plane, _, op = s["name"].partition(".")
            if plane not in ("hostcomm", "ps") or not op:
                continue
            dur_ns = s["t1_ns"] - s["t0_ns"]
            if dur_ns <= 0:
                continue
            h.observe(dur_ns / 1e9, labels={
                "op": op, "plane": plane,
                "bytes_bucket": bytes_bucket(s["attrs"].get("bytes", 0)),
            })

    # ------------------------------------------------------------ exporters

    def collect(self) -> List[Dict[str, Any]]:
        """ONE consistent snapshot pass over the registry: a list of
        family dicts ``{name, kind, help, values, buckets?}`` with
        ``values`` the copied ``(label_key, value)`` pairs.  Takes the
        registry lock once and each metric's lock once; both exporters
        (and the ``/metrics`` HTTP endpoint) derive from a ``collect``
        result, so a caller needing text AND JSON of the same instant
        pays a single lock walk instead of two divergent ones."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        out: List[Dict[str, Any]] = []
        for name, m in metrics:
            fam: Dict[str, Any] = {"name": name, "kind": m.kind,
                                   "help": m.help, "values": m._items()}
            if isinstance(m, Histogram):
                fam["buckets"] = m.buckets
            out.append(fam)
        return out

    @staticmethod
    def _grouped(families: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Merge same-name families (federation hands ``to_prometheus``
        per-rank collects whose names repeat): values concatenate, first
        non-empty help wins — so ``# TYPE``/``# HELP`` can be emitted
        exactly once per family even when one family arrives as several
        chunks with disjoint label sets."""
        grouped: Dict[str, Dict[str, Any]] = {}
        order: List[str] = []
        for fam in families:
            g = grouped.get(fam["name"])
            if g is None:
                grouped[fam["name"]] = dict(fam, values=list(fam["values"]))
                order.append(fam["name"])
            else:
                g["values"].extend(fam["values"])
                if not g["help"] and fam["help"]:
                    g["help"] = fam["help"]
        return [grouped[n] for n in order]

    def to_prometheus(self,
                      families: Optional[List[Dict[str, Any]]] = None,
                      ) -> str:
        """Prometheus text exposition format.  ``families`` (a
        :meth:`collect` result, possibly concatenated across sources)
        reuses an existing snapshot pass instead of walking the locks
        again; ``# TYPE``/``# HELP`` lines are emitted exactly once per
        metric family regardless of how the family's label sets were
        chunked."""
        if families is None:
            families = self.collect()
        lines: List[str] = []
        for fam in self._grouped(families):
            name = fam["name"]
            if fam["help"]:
                lines.append(f"# HELP {name} {_escape_help(fam['help'])}")
            lines.append(f"# TYPE {name} {fam['kind']}")
            for key, val in fam["values"]:
                if fam["kind"] == "histogram":
                    cumulative = dict(key)
                    for b, c in zip(fam["buckets"], val["buckets"]):
                        lbl = _label_str(tuple(sorted(
                            {**cumulative, "le": repr(b)}.items())))
                        lines.append(f"{name}_bucket{lbl} {c}")
                    inf = _label_str(tuple(sorted(
                        {**cumulative, "le": "+Inf"}.items())))
                    lines.append(f"{name}_bucket{inf} {val['count']}")
                    lines.append(f"{name}_sum{_label_str(key)} {val['sum']}")
                    lines.append(
                        f"{name}_count{_label_str(key)} {val['count']}")
                else:
                    lines.append(f"{name}{_label_str(key)} {val}")
        return "\n".join(lines) + "\n"

    def snapshot(self, families: Optional[List[Dict[str, Any]]] = None,
                 ) -> Dict[str, Any]:
        """JSON-serializable snapshot: name -> {kind, help, values}.
        ``families`` reuses a :meth:`collect` pass (shared with
        :meth:`to_prometheus` — no double lock walk)."""
        if families is None:
            families = self.collect()
        out: Dict[str, Any] = {}
        for fam in self._grouped(families):
            out[fam["name"]] = {
                "kind": fam["kind"],
                "help": fam["help"],
                "values": [
                    {"labels": dict(k), "value": v}
                    for k, v in fam["values"]
                ],
            }
        return out

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), indent=1, sort_keys=True)


#: the process-default registry every scrape/export path uses.
registry = Registry()
