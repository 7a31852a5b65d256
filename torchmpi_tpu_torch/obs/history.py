"""Bounded on-disk metrics history: the trend memory behind the gauges.

The port's copy of ``torchmpi_tpu/obs/history.py``.  ``/metrics`` is
instantaneous — a scrape window later, the value is gone.  An autoscaler
needs *trends* (step-rate drift), and a post-mortem needs the minutes
BEFORE the incident.  This module is that memory:

* :class:`HistoryStore` — tiered rings of registry snapshots.  Tier 0
  holds one row per ``history_interval_s``; each coarser tier aggregates
  ``history_downsample`` finer rows into one (per-key mean, plus min/max
  so spikes survive downsampling), every tier bounded at
  ``history_tier_len`` rows.  With the defaults (1 s x 512, x30, x30)
  that is ~8.5 min of 1 s rows, ~4.3 h of 30 s rows and ~4.2 days of
  15 min rows in a few hundred KB.
* trend queries — :meth:`HistoryStore.rate` (per-second slope of a
  monotonic counter over a trailing window), :meth:`HistoryStore.drift`
  (recent mean vs the trailing-baseline mean, as a ratio), and
  :meth:`HistoryStore.series` (the rows themselves, finest tier that
  covers the window) — what a trend column or an autoscaler polls.
* :class:`Sampler` — the background thread: every ``history_interval_s``
  it scrapes the native counters, folds ``Registry.collect()`` into the
  store, and (with ``history_dir`` set) periodically persists
  ``history-<rank>.json`` via the shared atomic-write discipline, so the
  history survives the process for the post-mortem.

Off by default (``history_enabled``): no thread, no samples, and
:func:`maybe_start` is one config read — ``runtime/lifecycle.start`` calls
it next to the HTTP endpoint and ``lifecycle.stop`` stops it (final
persist included).  Served live as ``GET /history`` (obs/serve.py).
"""

from __future__ import annotations

import collections
import json
import os
import threading
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "HistoryStore",
    "Sampler",
    "flatten_families",
    "history_config",
    "load",
    "maybe_start",
    "reset",
    "sampler",
    "stop",
    "store",
]

SCHEMA = "tmpi-history-v1"


def history_config() -> dict:
    """The history knobs in one read — the single config touchpoint for
    the ``history_*`` family."""
    from ..runtime import config

    return {
        "enabled": bool(config.get("history_enabled")),
        "interval_s": float(config.get("history_interval_s")),
        "dir": str(config.get("history_dir")),
        "tier_len": int(config.get("history_tier_len")),
        "downsample": int(config.get("history_downsample")),
    }


def flatten_families(families: Sequence[Dict[str, Any]],
                     ) -> Dict[str, float]:
    """One ``Registry.collect()`` result -> flat ``{key: value}`` rows.
    Counters/gauges keep their label string in the key
    (``name{a="b"}``); histograms contribute ``name_count`` and
    ``name_sum`` (per label set) — enough to derive rates and means, at a
    fraction of the bucket vector's weight."""
    from .metrics import _label_str  # the exporters' own label spelling

    out: Dict[str, float] = {}
    for fam in families:
        name, kind = fam["name"], fam["kind"]
        for key, val in fam["values"]:
            lbl = _label_str(key)
            if kind == "histogram":
                out[f"{name}_count{lbl}"] = float(val["count"])
                out[f"{name}_sum{lbl}"] = float(val["sum"])
            else:
                try:
                    out[f"{name}{lbl}"] = float(val)
                except (TypeError, ValueError):
                    continue
    return out


class HistoryStore:
    """Tiered metric history (thread-safe).  Rows are
    ``{"t": wall_seconds, "m": {key: value}}``; coarse rows additionally
    carry ``"lo"``/``"hi"`` (per-key min/max of the aggregated group) and
    ``"n"`` (group size).  Tier ``k`` covers
    ``tier_len * downsample**k * interval_s`` seconds."""

    def __init__(self, interval_s: float = 1.0, tier_len: int = 512,
                 downsample: int = 30, tiers: int = 3):
        self.interval_s = max(1e-3, float(interval_s))
        self.tier_len = max(8, int(tier_len))
        self.downsample = max(2, int(downsample))
        self._lock = threading.Lock()
        self._tiers: List[Deque[Dict[str, Any]]] = [
            collections.deque(maxlen=self.tier_len)
            for _ in range(max(1, int(tiers)))]
        # rows accumulated toward the next coarse row, per coarse tier
        self._pending: List[List[Dict[str, Any]]] = [
            [] for _ in range(len(self._tiers) - 1)]
        self.samples_total = 0

    # ------------------------------------------------------------ writing

    def record(self, t: float, values: Dict[str, float]) -> None:
        """Append one tier-0 row and cascade full groups into the coarser
        tiers (each group of ``downsample`` rows folds into ONE row with
        per-key mean + min/max — the mean preserves rate math over
        monotonic counters and level math over gauges; min/max preserve
        the spikes a mean would iron out)."""
        row = {"t": float(t), "m": dict(values)}
        with self._lock:
            self.samples_total += 1
            self._tiers[0].append(row)
            carry = row
            for k in range(len(self._tiers) - 1):
                pend = self._pending[k]
                pend.append(carry)
                if len(pend) < self.downsample:
                    break
                carry = _aggregate(pend)
                self._tiers[k + 1].append(carry)
                self._pending[k] = []

    # ------------------------------------------------------------ reading

    def tiers(self) -> List[Dict[str, Any]]:
        """Shape summary (what ``GET /history`` answers without a query):
        per tier, its effective interval, row count and covered span."""
        with self._lock:
            out = []
            for k, ring in enumerate(self._tiers):
                step = self.interval_s * (self.downsample ** k)
                out.append({
                    "tier": k,
                    "interval_s": step,
                    "rows": len(ring),
                    "capacity": ring.maxlen,
                    "span_s": (ring[-1]["t"] - ring[0]["t"]
                               if len(ring) > 1 else 0.0),
                })
            return out

    def keys(self) -> List[str]:
        """Metric keys present in the newest row (the queryable names)."""
        with self._lock:
            for ring in self._tiers:
                if ring:
                    return sorted(ring[-1]["m"])
        return []

    def all_keys(self) -> List[str]:
        """Every key any RETAINED row carries (:meth:`keys` reads only
        the newest row; a series that went dark is exactly one the
        newest row no longer carries — what an absence/staleness query
        needs, obs/alerts.py)."""
        seen: set = set()
        with self._lock:
            for ring in self._tiers:
                for row in ring:
                    seen.update(row["m"])
        return sorted(seen)

    def absent_before(self, key: str, t: float) -> bool:
        """Whether the retained row nearest BEFORE ``t`` exists and
        lacks ``key`` — the proof a series first APPEARED at ``t``
        rather than merely entering a query window (the alert plane's
        counter-born-in-window discipline, obs/alerts.py)."""
        with self._lock:
            for ring in self._tiers:
                for row in reversed(ring):
                    if row["t"] < t:
                        return key not in row["m"]
        return False

    def newest_t(self) -> Optional[float]:
        """Timestamp of the newest retained row (None when empty) — the
        anchor for callers replaying queries against recorded time."""
        with self._lock:
            return self._newest_t()

    def series(self, key: str, window_s: float,
               now: Optional[float] = None) -> List[Tuple[float, float]]:
        """``(t, value)`` rows for ``key`` over the window ``(now -
        window_s, now]``, read from the FINEST tier whose ring still
        covers the window start — the downsampling contract: recent
        history at full resolution, old history coarse but present.
        ``now`` may sit in the past (the drift baseline anchors there);
        rows after it are excluded."""
        with self._lock:
            if now is None:
                now = self._newest_t()
            if now is None:
                return []
            start = now - float(window_s)

            def cut(ring):
                return [(r["t"], r["m"][key]) for r in ring
                        if start <= r["t"] <= now and key in r["m"]]

            for ring in self._tiers:
                if ring and ring[0]["t"] <= start:
                    return cut(ring)
            # No tier reaches back to the window start (young store):
            # the tier with the MOST history wins, finer on ties — the
            # coarsest ring may hold fewer aggregated rows than a finer
            # one early in the job.
            best = max((ring for ring in self._tiers if ring),
                       key=lambda ring: now - ring[0]["t"], default=None)
            return cut(best) if best is not None else []

    def _newest_t(self) -> Optional[float]:
        for ring in self._tiers:
            if ring:
                return ring[-1]["t"]
        return None

    def rate(self, key: str, window_s: float,
             now: Optional[float] = None) -> Optional[float]:
        """Per-second slope of ``key`` over the trailing window —
        ``(last - first) / (t_last - t_first)`` over the covered rows
        (Prometheus ``rate()`` shape, for the monotonic counters).  None
        without two rows."""
        pts = self.series(key, window_s, now=now)
        if len(pts) < 2 or pts[-1][0] <= pts[0][0]:
            return None
        return (pts[-1][1] - pts[0][1]) / (pts[-1][0] - pts[0][0])

    def drift(self, key: str, recent_s: float, baseline_s: float,
              now: Optional[float] = None,
              of_rate: bool = False) -> Optional[float]:
        """Recent-vs-baseline ratio: mean over the last ``recent_s``
        divided by the mean over the ``baseline_s`` window that PRECEDES
        it (1.0 = no drift; >1 the metric moved up).  ``of_rate`` drifts
        the windowed :meth:`rate` instead of the level — the right shape
        for monotonic counters (a counter's level always rises; its RATE
        is what drifts when the job slows down)."""
        with self._lock:
            anchor = self._newest_t() if now is None else now
        if anchor is None:
            return None
        if of_rate:
            recent = self.rate(key, recent_s, now=anchor)
            # The baseline window PRECEDES the recent one (anchored at
            # its start) — a baseline that included the recent samples
            # would dilute exactly the slowdown being measured.
            base = self.rate(key, baseline_s, now=anchor - float(recent_s))
            if recent is None or base is None or base == 0:
                return None
            return recent / base
        pts = self.series(key, recent_s + baseline_s, now=anchor)
        cut = anchor - float(recent_s)
        recent_v = [v for t, v in pts if t > cut]
        base_v = [v for t, v in pts if t <= cut]
        if not recent_v or not base_v:
            return None
        base_mean = sum(base_v) / len(base_v)
        if base_mean == 0:
            return None
        return (sum(recent_v) / len(recent_v)) / base_mean

    # -------------------------------------------------------- persistence

    def to_doc(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "schema": SCHEMA,
                "interval_s": self.interval_s,
                "downsample": self.downsample,
                "tier_len": self.tier_len,
                "samples_total": self.samples_total,
                "tiers": [list(ring) for ring in self._tiers],
                "pending": [list(p) for p in self._pending],
            }

    def save(self, path: str) -> str:
        """Atomic persist (tmp -> fsync -> rename, the shared
        ``atomic_write_json``): a reader — or the post-mortem — never
        sees a torn history."""
        from .export import atomic_write_json

        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        return atomic_write_json(path, self.to_doc())

    @classmethod
    def from_doc(cls, doc: Dict[str, Any]) -> "HistoryStore":
        st = cls(interval_s=doc.get("interval_s", 1.0),
                 tier_len=doc.get("tier_len", 512),
                 downsample=doc.get("downsample", 30),
                 tiers=max(1, len(doc.get("tiers") or [1])))
        st.samples_total = int(doc.get("samples_total", 0))
        for k, rows in enumerate(doc.get("tiers") or []):
            if k < len(st._tiers):
                st._tiers[k].extend(rows)
        for k, rows in enumerate(doc.get("pending") or []):
            if k < len(st._pending):
                st._pending[k] = list(rows)
        return st


def _aggregate(rows: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One coarse row from a group of finer rows: per-key mean over the
    rows that carry the key, min/max alongside, stamped at the group's
    LAST timestamp (the row answers "as of t, the last group averaged
    v").  Rows that are themselves aggregates contribute their OWN
    ``lo``/``hi`` envelopes (not their means) — a one-sample spike must
    survive every downsampling tier, not just the first."""
    means: Dict[str, List[float]] = {}
    los: Dict[str, List[float]] = {}
    his: Dict[str, List[float]] = {}
    n = 0
    for r in rows:
        n += int(r.get("n", 1))
        r_lo, r_hi = r.get("lo", {}), r.get("hi", {})
        for k, v in r["m"].items():
            means.setdefault(k, []).append(v)
            los.setdefault(k, []).append(r_lo.get(k, v))
            his.setdefault(k, []).append(r_hi.get(k, v))
    return {
        "t": rows[-1]["t"],
        "n": n,
        "m": {k: sum(vs) / len(vs) for k, vs in means.items()},
        "lo": {k: min(vs) for k, vs in los.items()},
        "hi": {k: max(vs) for k, vs in his.items()},
    }


def load(path: str) -> Optional[HistoryStore]:
    """Read one persisted history file (None on missing/torn — the
    atomic write makes torn unlikely, but the reader stays tolerant)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("schema") != SCHEMA:
        return None
    return HistoryStore.from_doc(doc)


# ------------------------------------------------------------- the sampler

class Sampler:
    """The background snapshot thread.  Every ``interval_s``: scrape the
    native counters (loaded planes only — a sampler must not g++-build an
    engine), fold ``registry.collect()`` into ``store``, and every
    ``persist_every`` samples write ``history-<rank>.json`` when a
    directory is configured.  ``stop()`` joins the thread and persists one
    final time so the on-disk history includes the teardown."""

    def __init__(self, store: HistoryStore, registry=None,
                 interval_s: float = 1.0, directory: str = "",
                 rank: int = 0, persist_every: int = 10,
                 scrape: bool = True):
        if registry is None:
            from .metrics import registry as registry_
            registry = registry_
        self.store = store
        self.registry = registry
        self.interval_s = max(1e-3, float(interval_s))
        self.directory = directory
        self.rank = int(rank)
        self.persist_every = max(1, int(persist_every))
        self.scrape = bool(scrape)
        # The alert plane's evaluation hook (obs/alerts.AlertEngine):
        # None = no alerts armed, and sample_once pays one attribute
        # read.  Assigned by alerts.maybe_start, cleared by alerts.stop.
        self.alert_engine = None
        self._stop = threading.Event()
        self._since_persist = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"tmpi-history-{rank}")
        self._thread.start()

    @property
    def path(self) -> Optional[str]:
        if not self.directory:
            return None
        return os.path.join(self.directory, f"history-{self.rank}.json")

    def sample_once(self) -> None:
        import time as _time

        if self.scrape:
            try:
                self.registry.scrape_native()
            except Exception:  # noqa: BLE001 — half a panel beats no row
                pass
        self.store.record(_time.time(),
                          flatten_families(self.registry.collect()))
        # Alert rules ride the sampler cadence: evaluate right after the
        # fold so every rule sees the row just recorded (obs/alerts.py;
        # tick() swallows rule failures — a bad rule must not end the
        # sampler).
        eng = self.alert_engine
        if eng is not None:
            eng.tick()
        self._since_persist += 1
        if self.path and self._since_persist >= self.persist_every:
            self._persist()

    def _persist(self) -> None:
        self._since_persist = 0
        try:
            self.store.save(self.path)
        except Exception:  # noqa: BLE001 — the job outranks its history
            pass

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 — a bad scrape must not end
                pass           # the sampler for the rest of the job

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        if self.path:
            self._persist()

    def __enter__(self) -> "Sampler":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()


# ------------------------------------------------- process-level singletons

_store: Optional[HistoryStore] = None
_sampler: Optional[Sampler] = None
_lock = threading.Lock()


def store() -> Optional[HistoryStore]:
    """The process store (None until the sampler started) — what
    ``GET /history`` serves."""
    return _store


def sampler() -> Optional[Sampler]:
    return _sampler


def maybe_start(rank: int = 0) -> Optional[Sampler]:
    """Start the process sampler iff ``history_enabled`` is on and none
    is running (``runtime/lifecycle.start``'s entry point).  One config
    read when off."""
    global _store, _sampler
    cfg = history_config()
    if not cfg["enabled"]:
        return None
    with _lock:
        if _sampler is not None:
            return _sampler
        _store = HistoryStore(interval_s=cfg["interval_s"],
                              tier_len=cfg["tier_len"],
                              downsample=cfg["downsample"])
        _sampler = Sampler(_store, interval_s=cfg["interval_s"],
                           directory=cfg["dir"], rank=rank)
    # Arm the alert plane on the sampler's cadence (obs/alerts.py; one
    # config read when alert_enabled is off).  Outside the lock: alerts
    # reads store()/sampler() back through this module.
    from . import alerts as alerts_mod

    alerts_mod.maybe_start(rank=rank)
    return _sampler


def stop() -> None:
    """Stop the process sampler (final persist included); no-op when not
    running.  The store stays readable — the post-mortem may still want
    it after the job wound down."""
    global _sampler
    from . import alerts as alerts_mod

    alerts_mod.stop()
    with _lock:
        s, _sampler = _sampler, None
    if s is not None:
        s.stop()


def reset() -> None:
    """Stop AND forget the process store (tests; the singleton is
    process-global and a later ``maybe_start`` must see a fresh one)."""
    global _store
    stop()
    with _lock:
        _store = None
