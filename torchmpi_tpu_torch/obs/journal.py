"""Persistent per-rank event journal: append-only JSONL of state changes.

The port's copy of the JAX package's ``obs/journal.py``, cut to the write
side the serving engine uses (``serve.drain``, ``serve.shed``,
``serve.evict``, ``serve.scheduler_error``).  Each record is ONE JSON
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
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from ..runtime import config
from . import tracer

VERSION = 1

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


def errors() -> int:
    """Suppressed append failures so far: emit() never raises into the
    failure path it records, so this is the only trace a failed write
    leaves."""
    return _errors


def _roll_locked(cfg: dict) -> None:
    """Open the next segment (and prune) — caller holds ``_lock``."""
    global _file, _file_bytes, _segment_seq
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
    global _file, _file_bytes, _segment_seq, _seq, _errors
    with _lock:
        if _file is not None:
            try:
                _file.close()
            except OSError:
                pass
        _file = None
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
