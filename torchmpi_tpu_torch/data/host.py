"""Host-side stage: background batch production with a real lifecycle.

The port's copy of ``torchmpi_tpu/data/host.py`` (pure Python there too;
the algebra is the same line for line):

* each ``iter()`` returns a dedicated :class:`HostStageIterator` with
  ``close()``, context-manager support and a ``__del__`` that stops the
  producer, so abandoning the iterator releases its threads promptly under
  CPython refcounting.  The thread bodies are module-level functions over
  the shared primitives (queue, stop event, condition) and hold no
  reference to the iterator: a thread whose target is a bound method would
  keep its owner alive, and ``__del__`` could never run;
* producer exceptions (the source's or a transform worker's) surface on
  the consumer thread at the position they occurred;
* a bounded queue plus an in-flight permit semaphore bound memory to
  ``depth + workers`` batches (plus the one in the producer's or reader's
  hand) however slow the consumer is;
* optional ``workers`` > 0 run a per-batch ``transform`` on a thread pool
  with sequence-number reordering, so the order stays deterministic:
  pipeline-on and pipeline-off runs see bit-identical batch sequences.
"""

from __future__ import annotations

import queue as _queue
import threading
from typing import Any, Callable, Optional

__all__ = ["HostStage", "HostStageIterator"]

_DONE = object()


class _Raised:
    """Exception captured on a producer/worker thread, re-raised on the
    consumer at the sequence position it occurred."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


# ---------------------------------------------------------- thread bodies
# Module-level on purpose: these close over the shared primitives only.
# A bound-method target would make each thread a strong reference to the
# iterator — the iterator could then never be garbage collected while
# its own thread runs, and abandonment would leak its threads.


def _bounded_put(q: _queue.Queue, stop: threading.Event, item) -> bool:
    """Bounded put that gives up when the consumer has left."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except _queue.Full:
            continue
    return False


def _bounded_get(q: _queue.Queue, stop: threading.Event,
                 producer: threading.Thread):
    """One item from a producer-fed bounded queue, riding out the
    producer-exit race: the producer may exit BETWEEN an empty get and
    the liveness check, with its final items (last batch, sentinel, or a
    forwarded exception) landing in that gap — they must not be dropped
    as exhaustion.  Shared by both stages' consumers (the race is
    identical and a fix must never land in only one).  Raises
    ``StopIteration`` on close or true exhaustion."""
    while True:
        try:
            return q.get(timeout=0.1)
        except _queue.Empty:
            if stop.is_set():
                raise StopIteration
            if not producer.is_alive():
                try:
                    return q.get_nowait()
                except _queue.Empty:
                    raise StopIteration


def _produce_serial(source, transform, q: _queue.Queue,
                    stop: threading.Event) -> None:
    try:
        for batch in source:
            if transform is not None:
                batch = transform(batch)
            if not _bounded_put(q, stop, batch):
                return
            if stop.is_set():
                return
    except BaseException as e:  # noqa: BLE001 — forwarded to consumer
        _bounded_put(q, stop, _Raised(e))
        return
    _bounded_put(q, stop, _DONE)


def _finish(cv: threading.Condition, done: dict, seq: int, marker) -> None:
    with cv:
        done[seq] = marker
        cv.notify_all()


def _read(source, permits: threading.Semaphore, work: _queue.Queue,
          cv: threading.Condition, done: dict,
          stop: threading.Event) -> None:
    seq = 0
    try:
        for batch in source:
            # Acquire an in-flight permit BEFORE enqueueing: this is the
            # memory bound (released by the consumer per emitted item).
            while not permits.acquire(timeout=0.1):
                if stop.is_set():
                    return
            if stop.is_set():
                return
            work.put((seq, batch))
            seq += 1
    except BaseException as e:  # noqa: BLE001 — surfaces at seq's slot
        _finish(cv, done, seq, _Raised(e))
        return
    _finish(cv, done, seq, _DONE)


def _work_loop(transform, work: _queue.Queue, cv: threading.Condition,
               done: dict, stop: threading.Event) -> None:
    while not stop.is_set():
        try:
            seq, batch = work.get(timeout=0.1)
        except _queue.Empty:
            continue
        try:
            out = transform(batch)
        except BaseException as e:  # noqa: BLE001 — deterministic slot
            out = _Raised(e)
        _finish(cv, done, seq, out)


class HostStage:
    """Bounded background host-side stage over any batch iterable.

    ``depth``: queued batches beyond the one the consumer holds.
    ``workers``: transform worker threads (0 = the single-producer form;
    requires ``transform`` when > 0).  ``transform``: per-batch callable
    applied on the workers (or inline on the producer at ``workers=0``).

    Re-iterable: each ``iter()`` spawns fresh threads, so epochs work
    naturally (a generator source, as ever, exhausts after one pass).
    """

    def __init__(self, it, depth: int = 2, workers: int = 0,
                 transform: Optional[Callable[[Any], Any]] = None):
        if workers < 0:
            raise ValueError(f"workers must be >= 0, got {workers}")
        if workers > 0 and transform is None:
            raise ValueError("workers > 0 requires a transform to run on "
                             "them (plain production is inherently serial)")
        self.it = it
        self.depth = max(1, int(depth))
        self.workers = int(workers)
        self.transform = transform

    def __len__(self):
        return len(self.it)

    def __iter__(self) -> "HostStageIterator":
        return HostStageIterator(self.it, self.depth, self.workers,
                                 self.transform)


class HostStageIterator:
    """One epoch's live iterator: owns the threads, dies cleanly."""

    def __init__(self, source, depth: int, workers: int,
                 transform: Optional[Callable[[Any], Any]]):
        self._stop = threading.Event()
        self._threads = []
        self._exhausted = False
        self._cv: Optional[threading.Condition] = None
        # Dispatch flag, NOT a stored bound method: self._next = <bound
        # method> would be a self-reference cycle, and a cycle is only
        # collected by the gc pass — abandonment must free the threads
        # under plain refcounting.
        self._serial = workers == 0
        if workers == 0:
            # Single producer: pull + (inline) transform -> bounded queue.
            self._q: _queue.Queue = _queue.Queue(maxsize=depth)
            t = threading.Thread(
                target=_produce_serial,
                args=(source, transform, self._q, self._stop),
                daemon=True, name="tmpi-data-host")
            t.start()
            self._threads.append(t)
        else:
            # Reader assigns sequence numbers; workers transform; the
            # consumer reorders by seq.  Total in-flight (work queue +
            # in-worker + done-but-unconsumed) is bounded by the permit
            # semaphore at depth + workers, the memory bound a slow
            # consumer relies on.
            self._permits = threading.Semaphore(depth + workers)
            self._work: _queue.Queue = _queue.Queue()
            self._done: dict = {}
            self._cv = threading.Condition()
            self._want = 0            # next sequence the consumer emits
            t = threading.Thread(
                target=_read,
                args=(source, self._permits, self._work, self._cv,
                      self._done, self._stop),
                daemon=True, name="tmpi-data-host-read")
            t.start()
            self._threads.append(t)
            for i in range(workers):
                t = threading.Thread(
                    target=_work_loop,
                    args=(transform, self._work, self._cv, self._done,
                          self._stop),
                    daemon=True, name=f"tmpi-data-host-w{i}")
                t.start()
                self._threads.append(t)

    # ------------------------------------------------------- consumer side

    def _next(self):
        return self._next_serial() if self._serial else \
            self._next_reordered()

    def _next_serial(self):
        return _bounded_get(self._q, self._stop, self._threads[0])

    def _next_reordered(self):
        with self._cv:
            while self._want not in self._done:
                if self._stop.is_set():
                    raise StopIteration
                self._cv.wait(timeout=0.1)
            item = self._done.pop(self._want)
        if item is not _DONE and not isinstance(item, _Raised):
            self._want += 1
            self._permits.release()
        return item

    def __iter__(self) -> "HostStageIterator":
        return self

    def __next__(self):
        if self._exhausted or self._stop.is_set():
            raise StopIteration
        item = self._next()
        if item is _DONE:
            self._exhausted = True
            self.close()
            raise StopIteration
        if isinstance(item, _Raised):
            self._exhausted = True
            self.close()
            raise item.exc
        return item

    def close(self) -> None:
        """Stop production and release the threads.  Idempotent; also run
        by ``__del__``, so simply dropping the iterator frees everything
        promptly (the leak the old generator form had)."""
        self._stop.set()
        if self._cv is not None:
            with self._cv:
                self._cv.notify_all()
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(timeout=5)

    def __del__(self):  # pragma: no cover - exercised via the leak test
        try:
            self._stop.set()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def __enter__(self) -> "HostStageIterator":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
