"""Persistent per-rank event journal: append-only JSONL of state changes.

The port's copy of the JAX package's ``obs/journal.py``: its write side,
the in-memory tail the live endpoint serves (``GET /journal``) and the
reading side ``obs/rca.py`` builds its timeline from (:func:`segments`,
:func:`merge_segments`, :func:`load_dir`).  Each record is ONE JSON
line::

    {"v": 1, "t_ns": ..., "wall": ..., "rank": r, "pid": ..., "seq": n,
     "kind": "...", "corr": <correlation id>, "data": {...}}

Segments ``journal-r<rank>-p<pid>-<seq>.jsonl`` live under
``journal_dir``, rotate past ``journal_segment_bytes``, and the newest
``journal_keep`` are kept per rank.  Off by default (``journal_enabled``):
:func:`emit` with the knob off is a single config read.  Emitting never
raises into the code path it observes.
"""

from __future__ import annotations

import glob
import heapq
import json
import os
import re
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from ..runtime import config
from . import tracer

VERSION = 1
_SEGMENT_RE = re.compile(r"journal-r(-?\d+)-p(\d+)-(\d+)\.jsonl$")

_lock = threading.Lock()


def _env_rank() -> int:
    """Default rank stamp: ``TORCHMPI_TPU_JOURNAL_RANK``, else 0."""
    try:
        return int(os.environ.get("TORCHMPI_TPU_JOURNAL_RANK", "0") or 0)
    except ValueError:
        return 0


_rank = _env_rank()
_seq = 0                    # per-process record counter
_file = None                # the open active segment
_file_path: Optional[str] = None
_file_bytes = 0
_segment_seq = 0
_tail: List[Dict[str, Any]] = []   # bounded in-memory tail
_TAIL_CAP = 256
_errors = 0                 # suppressed append failures (never raised)


def journal_config() -> dict:
    """The journal knobs in one read."""
    return {
        "enabled": bool(config.get("journal_enabled")),
        "dir": str(config.get("journal_dir")),
        "segment_bytes": int(config.get("journal_segment_bytes")),
        "keep": int(config.get("journal_keep")),
        "fsync": bool(config.get("journal_fsync")),
    }


def enabled() -> bool:
    return bool(config.get("journal_enabled"))


def set_rank(rank: int) -> None:
    """Stamp later records with ``rank`` (``runtime/lifecycle.start``
    calls it once the world is up); an open segment keeps its name."""
    global _rank
    _rank = int(rank)


def rank() -> int:
    return _rank


def active_segment() -> Optional[str]:
    """Path of the open segment (None before the first append)."""
    return _file_path


def errors() -> int:
    """Suppressed append failures so far: emit() never raises into the
    failure path it records, so this is the only trace a failed write
    leaves."""
    return _errors


def _roll_locked(cfg: dict) -> None:
    """Open the next segment (and prune) — caller holds ``_lock``."""
    global _file, _file_bytes, _segment_seq, _file_path
    if _file is not None:
        try:
            _file.close()
        except OSError:
            pass
        _file = None
    directory = cfg["dir"] or "."
    os.makedirs(directory, exist_ok=True)
    _segment_seq += 1
    path = os.path.join(
        directory, f"journal-r{_rank}-p{os.getpid()}-{_segment_seq:04d}.jsonl")
    _file = open(path, "a", encoding="utf-8")
    _file_path = path
    _file_bytes = _file.tell()
    prune_files(directory, f"journal-r{_rank}-*.jsonl",
                keep=max(1, cfg["keep"]))


def emit(kind: str, rank: Optional[int] = None, **data: Any) -> None:
    """Append one event.  Off = one config read.  On: one locked JSONL
    append (flush, optional fsync), rotating past the segment bound.
    Never raises — the callers are failure paths."""
    global _seq, _file_bytes, _errors
    try:
        if not enabled():
            return
        cfg = journal_config()
        rec = {
            "v": VERSION,
            "t_ns": tracer.now_ns(),
            "wall": time.time(),
            "rank": _rank if rank is None else int(rank),
            "pid": os.getpid(),
            "kind": str(kind),
            "corr": tracer.current_correlation(),
            "data": _jsonable(data),
        }
        with _lock:
            _seq += 1
            rec["seq"] = _seq
            line = json.dumps(rec, separators=(",", ":")) + "\n"
            nbytes = len(line.encode("utf-8"))
            if (_file is None
                    or _file_bytes + nbytes > max(1024,
                                                  cfg["segment_bytes"])):
                _roll_locked(cfg)
            _file.write(line)
            _file.flush()
            if cfg["fsync"]:
                os.fsync(_file.fileno())
            _file_bytes += nbytes
            _tail.append(rec)
            del _tail[:-_TAIL_CAP]
    except Exception:  # noqa: BLE001 — the journal must never compound
        with _lock:
            _errors += 1


def _jsonable(obj: Any) -> Any:
    """Best-effort JSON coercion — an append must not fail on a payload."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, BaseException):
        return f"{type(obj).__name__}: {obj}"
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return [_jsonable(v) for v in obj]
    try:
        return float(obj) if hasattr(obj, "dtype") else str(obj)
    except Exception:  # noqa: BLE001
        return str(obj)


def tail(limit: int = 64) -> List[Dict[str, Any]]:
    """The most recent records this process emitted (never touches disk)."""
    with _lock:
        return list(_tail[-max(1, int(limit)):])


def reset() -> None:
    """Close the active segment and forget in-memory state (tests; the
    on-disk segments stay)."""
    global _file, _file_bytes, _segment_seq, _seq, _errors, _file_path
    with _lock:
        if _file is not None:
            try:
                _file.close()
            except OSError:
                pass
        _file = None
        _file_path = None
        _file_bytes = 0
        _segment_seq = 0
        _seq = 0
        _errors = 0
        _tail.clear()


def prune_files(directory: str, pattern: str, keep: int) -> List[str]:
    """Drop the oldest files matching ``pattern`` beyond ``keep`` (mtime
    order, path as tiebreak).  Returns the pruned paths."""
    paths = sorted(glob.glob(os.path.join(directory, pattern)),
                   key=lambda p: (os.path.getmtime(p), p))
    doomed = paths[:-keep] if len(paths) > keep else []
    for p in doomed:
        try:
            os.unlink(p)
        except OSError:
            pass
    return doomed


# --------------------------------------------------------------- reading

def segments(directory: str, rank: Optional[int] = None) -> List[str]:
    """Journal segment paths under ``directory`` (every rank, or one),
    ordered (rank, pid, segment seq) so concatenated reads replay each
    process's stream in order."""
    out: List[Tuple[int, int, int, str]] = []
    for p in glob.glob(os.path.join(directory, "journal-r*-p*-*.jsonl")):
        m = _SEGMENT_RE.search(os.path.basename(p))
        if not m:
            continue
        r = int(m.group(1))
        if rank is not None and r != rank:
            continue
        out.append((r, int(m.group(2)), int(m.group(3)), p))
    return [p for *_key, p in sorted(out)]


def read_records(path: str) -> Iterator[Dict[str, Any]]:
    """Records of one segment, torn/garbled lines skipped.  A crash mid-
    append leaves at most one partial LAST line — skipping it can never
    poison the records before it, which is the crash-safety contract the
    tests pin (they truncate mid-line and mid-record)."""
    try:
        with open(path, encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn append / partial writeback
                if isinstance(rec, dict) and "kind" in rec:
                    yield rec
    except OSError:
        return


def _merge_key(rec: Dict[str, Any]) -> Tuple[float, int, int]:
    """The cross-process ordering: wall time (the only clock comparable
    across processes), then (rank, seq) as the stable tiebreak."""
    return (rec.get("wall", 0.0), rec.get("rank", 0), rec.get("seq", 0))


def _stream(paths: Sequence[str]) -> Iterator[Dict[str, Any]]:
    """One process's record stream: its segments chained in rotation
    order (each process appends under a lock, so a stream is already
    wall-ordered unless the system clock stepped backwards mid-run)."""
    for p in paths:
        yield from read_records(p)


def merge_segments(paths: Sequence[str]) -> Iterator[Dict[str, Any]]:
    """Streaming k-way merge of journal segment files in global
    :func:`_merge_key` order with BOUNDED memory: one open segment and
    one buffered record per (rank, pid) stream, however many hundreds of
    segments a 256-rank run left behind — where the old read path
    materialized every record before sorting.  Segments are grouped into
    per-process streams by their ``journal-r<rank>-p<pid>-<seq>`` names
    (rotation order within a stream); unparseable names are treated as
    one single-segment stream each rather than dropped."""
    streams: Dict[Tuple[int, int, str], List[Tuple[int, str]]] = {}
    for p in paths:
        m = _SEGMENT_RE.search(os.path.basename(p))
        if m:
            key = (int(m.group(1)), int(m.group(2)), "")
            streams.setdefault(key, []).append((int(m.group(3)), p))
        else:
            streams.setdefault((0, 0, p), []).append((0, p))
    its = [_stream([p for _seg, p in sorted(chunks)])
           for _key, chunks in sorted(streams.items())]
    return heapq.merge(*its, key=_merge_key)


def iter_dir(directory: str, rank: Optional[int] = None,
             ) -> Iterator[Dict[str, Any]]:
    """Every record in ``directory``'s segments as a streaming merge in
    global ``(wall, rank, seq)`` order — :func:`merge_segments` over the
    directory's segment files.  The bounded-memory read surface
    (``obs/rca.py`` loads its evidence through it); :func:`load_dir` is
    this plus materialization."""
    return merge_segments(segments(directory, rank=rank))


def load_dir(directory: str, rank: Optional[int] = None,
             ) -> List[Dict[str, Any]]:
    """Every record in ``directory``'s segments, merged and sorted by
    wall time (the only clock comparable across processes), stable on
    (rank, seq) — the input ``obs/rca.py`` builds its timeline from.
    Rides the streaming merge; the final sort only reorders across a
    backwards system-clock step inside one stream (timsort on the
    already-merged runs is near-linear)."""
    recs = list(iter_dir(directory, rank=rank))
    recs.sort(key=_merge_key)
    return recs
