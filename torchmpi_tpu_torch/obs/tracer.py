"""Span tracer: thread-safe, contextvar-correlated, bounded.

The port's copy of the JAX package's ``obs/tracer.py``.  A *span* is a named [t0, t1) interval on the
CLOCK_MONOTONIC timeline carrying a 64-bit **correlation id**.  The id
lives in a :mod:`contextvars` variable: the first span on a context
allocates a fresh id and nested spans inherit it.

Finished spans land in a bounded drop-oldest buffer (``obs_span_capacity``
knob): a slow drainer loses the oldest history, the hot path never blocks.

Gating: every entry point checks the ``obs_trace`` knob.  Off (the
default), :func:`span` returns one shared no-op context manager.
"""

from __future__ import annotations

import collections
import contextvars
import itertools
import os
import threading
import time
from typing import Any, Deque, Dict, List, Optional

from ..runtime import config

_correlation: contextvars.ContextVar[int] = contextvars.ContextVar(
    "tmpi_obs_correlation", default=0)

# Correlation ids are unique per process and non-zero.  The pid in the high
# bits keeps ids from colliding when traces of several processes merge.
_counter = itertools.count(1)


def new_correlation() -> int:
    return ((os.getpid() & 0xFFFF) << 40) | next(_counter)


def cluster_correlation(*parts: Any) -> int:
    """Deterministic correlation id from ``parts`` alone: the same id on
    every rank that derives it from the same parts (an engine step's
    number), with the top bit set so it never collides with a
    :func:`new_correlation` id.  ``obs/export.merge_ranks`` draws such ids
    as cross-rank flows and ``obs/aggregate.collective_skew`` matches
    collectives by them."""
    import hashlib

    h = hashlib.blake2b("/".join(str(p) for p in parts).encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "big") | (1 << 63)


# Cross-rank clock alignment (obs/clocksync.apply): spans are stamped
# ``monotonic - offset``, as the native rings are.
_clock_offset_ns = 0


def set_clock_offset(offset_ns: int) -> None:
    global _clock_offset_ns
    _clock_offset_ns = int(offset_ns)


def clock_offset() -> int:
    return _clock_offset_ns


def now_ns() -> int:
    """The tracer's clock: CLOCK_MONOTONIC minus the applied alignment
    offset (0 unless :func:`obs.clocksync.apply` ran)."""
    return time.monotonic_ns() - _clock_offset_ns


def current_correlation() -> int:
    """The context's correlation id (0 when no span is open here)."""
    return _correlation.get()


def enabled() -> bool:
    return bool(config.get("obs_trace"))


# ------------------------------------------------------------------ buffer

_lock = threading.Lock()
_spans: Deque[Dict[str, Any]] = collections.deque(maxlen=4096)
_dropped = 0


def _resize_locked() -> None:
    global _spans
    cap = int(config.get("obs_span_capacity"))
    if cap > 0 and cap != _spans.maxlen:
        _spans = collections.deque(_spans, maxlen=cap)


def record(name: str, t0_ns: int, t1_ns: int, correlation: int = 0,
           **attrs: Any) -> None:
    """Append a finished span (drop-oldest when the buffer is full, the
    loss counted in :func:`dropped`)."""
    global _dropped
    span_rec = {
        "name": name,
        "correlation": int(correlation),
        "t0_ns": int(t0_ns),
        "t1_ns": int(t1_ns),
        "thread": threading.get_ident(),
        "attrs": attrs,
    }
    with _lock:
        _resize_locked()
        if len(_spans) == _spans.maxlen:
            _dropped += 1
        _spans.append(span_rec)


def drain() -> List[Dict[str, Any]]:
    """All finished spans, oldest first; the buffer forgets them."""
    with _lock:
        out = list(_spans)
        _spans.clear()
    return out


def peek() -> List[Dict[str, Any]]:
    """All finished spans, oldest first, without draining them."""
    with _lock:
        return list(_spans)


def dropped() -> int:
    """Monotonic count of spans lost to the bounded buffer."""
    return _dropped


# ------------------------------------------------------------------- spans

class _NullSpan:
    """Shared no-op context for the trace-off fast path."""

    __slots__ = ()

    def __enter__(self) -> int:
        return 0

    def __exit__(self, *exc: Any) -> bool:
        return False


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "attrs", "corr", "t0", "_token")

    def __init__(self, name: str, correlation: Optional[int],
                 attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self.corr = correlation
        self.t0 = 0
        self._token: Optional[contextvars.Token] = None

    def __enter__(self) -> int:
        corr = self.corr or _correlation.get() or new_correlation()
        self.corr = corr
        self._token = _correlation.set(corr)
        self.t0 = now_ns()
        return corr

    def __exit__(self, exc_type: Any, *exc: Any) -> bool:
        t1 = now_ns()
        if exc_type is not None:
            self.attrs["error"] = getattr(exc_type, "__name__", str(exc_type))
        record(self.name, self.t0, t1, self.corr, **self.attrs)
        if self._token is not None:
            _correlation.reset(self._token)
        return False


def span(name: str, correlation: Optional[int] = None, **attrs: Any):
    """Context manager for one traced interval; yields the correlation id
    (0 when tracing is off).  Inherits the context's id, or allocates a
    fresh one for a top-level span; pass ``correlation=`` to adopt an id
    captured on another thread."""
    if not enabled():
        return _NULL
    return _Span(name, correlation, attrs)


def dispatch_mark(name: str, correlation: Optional[int] = None,
                  **attrs: Any) -> int:
    """A zero-length span marking a dispatch or a decision; returns its
    correlation id (0 when tracing is off)."""
    if not enabled():
        return 0
    corr = correlation or _correlation.get() or new_correlation()
    t = now_ns()
    record(name, t, t, corr, **attrs)
    return corr
