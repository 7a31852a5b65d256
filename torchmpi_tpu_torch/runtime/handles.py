"""Synchronization handles of asynchronous operations.

Counterpart of ``torchmpi_tpu/runtime/handles.py``: one handle type over
the ways async work completes, one ``wait()`` that returns the handle's
payload (for a collective, its result), and a registry that bounds how
many handles may be outstanding.  The arms, in torch:

* tensors already computed (:meth:`SynchronizationHandle.from_arrays`),
  optionally fenced by a CUDA event that ``wait`` synchronizes;
* a ``concurrent.futures.Future`` (:meth:`~SynchronizationHandle.from_future`);
* a native wait function (:meth:`~SynchronizationHandle.from_native`);
* a ``torch.distributed`` ``Work`` of a collective issued with
  ``async_op=True`` (:meth:`~SynchronizationHandle.from_work`), whose
  ``wait`` waits the work and then applies the collective's epilogue to
  the payload (a mean's divide, a host-staged result's copy back).

A handle is done once it has been waited, as in JAX; ``wait`` is
idempotent, and callbacks added before run at the first wait.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Any, Callable, Iterable, List, Optional

import torch


class SynchronizationHandle:
    """One outstanding async operation; see the module docstring."""

    __slots__ = ("_event", "_future", "_native_wait", "_work", "_finish",
                 "_payload", "_done", "_callbacks")

    def __init__(self, *, event: Optional[torch.cuda.Event] = None,
                 future: Optional[Future] = None,
                 native_wait: Optional[Callable[[], Any]] = None,
                 work: Any = None,
                 finish: Optional[Callable[[Any], Any]] = None,
                 payload: Any = None):
        self._event = event
        self._future = future
        self._native_wait = native_wait
        self._work = work
        self._finish = finish
        self._payload = payload
        self._done = False
        self._callbacks: List[Callable[[], None]] = []

    @classmethod
    def from_arrays(cls, arrays: Any, payload: Any = None,
                    event: Optional[torch.cuda.Event] = None,
                    ) -> "SynchronizationHandle":
        """Tensors already computed (the payload unless one is given);
        ``wait`` synchronizes ``event`` when there is one."""
        return cls(event=event,
                   payload=payload if payload is not None else arrays)

    @classmethod
    def from_future(cls, future: Future,
                    payload: Any = None) -> "SynchronizationHandle":
        """Host-offloaded work; without a payload, the future's result is
        the payload."""
        return cls(future=future, payload=payload)

    @classmethod
    def from_native(cls, wait_fn: Callable[[], Any],
                    payload: Any = None) -> "SynchronizationHandle":
        """Work of a native runtime, waited by ``wait_fn``; without a
        payload, its return value is the payload."""
        return cls(native_wait=wait_fn, payload=payload)

    @classmethod
    def from_work(cls, work: Any, payload: Any,
                  finish: Optional[Callable[[Any], Any]] = None,
                  ) -> "SynchronizationHandle":
        """A ``torch.distributed`` collective issued with ``async_op=True``
        writing into ``payload``; the payload after the wait is
        ``finish(payload)`` when ``finish`` is given."""
        return cls(work=work, finish=finish, payload=payload)

    @classmethod
    def ready(cls, payload: Any = None) -> "SynchronizationHandle":
        h = cls(payload=payload)
        h._done = True
        return h

    def add_done_callback(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` at the first wait, or now if the handle is done."""
        if self._done:
            fn()
        else:
            self._callbacks.append(fn)

    def wait(self) -> Any:
        """Block until the work is complete; return the payload."""
        if not self._done:
            from ..obs import tracer as _tracer

            with _tracer.span("handle.wait"):
                if self._event is not None:
                    self._event.synchronize()
                if self._future is not None:
                    result = self._future.result()
                    if self._payload is None:
                        self._payload = result
                if self._native_wait is not None:
                    result = self._native_wait()
                    if self._payload is None:
                        self._payload = result
                if self._work is not None:
                    self._work.wait()
                    if self._finish is not None:
                        self._payload = self._finish(self._payload)
            self._done = True
            for fn in self._callbacks:
                fn()
            self._callbacks.clear()
        return self._payload

    @property
    def done(self) -> bool:
        return self._done

    def __repr__(self) -> str:
        kind = ("work" if self._work is not None
                else "future" if self._future is not None
                else "native" if self._native_wait is not None
                else "arrays")
        return f"SynchronizationHandle<{kind}, done={self._done}>"


class ParameterServerSynchronizationHandle(SynchronizationHandle):
    """A parameter-server push or pull in flight (reference:
    resources.cpp:1225-1242): waited by the native client's ``wait_fn``.
    With tracing on, the wait also records the operation's end-to-end span
    (``op_label``, from its dispatch to its completion, under the
    dispatching span's correlation id)."""

    @classmethod
    def from_native(cls, wait_fn: Callable[[], Any], payload: Any = None,
                    correlation: int = 0, op_label: Optional[str] = None,
                    op_bytes: int = 0, dispatch_t_ns: int = 0,
                    ) -> "ParameterServerSynchronizationHandle":
        if not (correlation and op_label):
            return cls(native_wait=wait_fn, payload=payload)

        def timed():
            from ..obs import tracer as _tracer

            out = wait_fn()
            _tracer.record(op_label, dispatch_t_ns, _tracer.now_ns(),
                           correlation, bytes=op_bytes)
            return out

        return cls(native_wait=timed, payload=payload)


def fence(x: Any) -> Optional[torch.cuda.Event]:
    """An event recorded on the current stream after the work that wrote
    ``x``, when ``x`` is a CUDA tensor; else None."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(x.device))
        return ev
    return None


def wait(handle: Optional[SynchronizationHandle]) -> Any:
    """The handle's payload once complete; ``wait(None)`` is a no-op."""
    if handle is None:
        return None
    return handle.wait()


def wait_all(handles: Iterable[Optional[SynchronizationHandle]]) -> List[Any]:
    return [wait(h) for h in handles]


class _InFlightRegistry:
    """Bounds the outstanding async handles: when ``limit`` are registered,
    all of them are waited and the registry empties.  A handle its owner
    has waited is no longer outstanding and leaves at the next
    registration, so the registry does not keep its payload (a reduced
    gradient bucket) alive; the JAX registry keeps waited handles until it
    flushes."""

    def __init__(self) -> None:
        self._handles: List[SynchronizationHandle] = []
        self._lock = threading.Lock()

    def register(self, handle: SynchronizationHandle, limit: int) -> None:
        flush: List[SynchronizationHandle] = []
        with self._lock:
            self._handles = [h for h in self._handles if not h.done]
            self._handles.append(handle)
            if len(self._handles) >= limit:
                flush, self._handles = self._handles, []
        for h in flush:
            h.wait()

    def sync_all(self) -> None:
        """Wait every outstanding handle."""
        with self._lock:
            pending, self._handles = self._handles, []
        for h in pending:
            h.wait()

    def __len__(self) -> int:
        return len(self._handles)


in_flight = _InFlightRegistry()


def register(handle: SynchronizationHandle) -> SynchronizationHandle:
    """Add ``handle`` to the in-flight registry under the
    ``num_async_collectives_in_flight`` limit; returns it."""
    from . import config

    in_flight.register(handle, int(config.get(
        "num_async_collectives_in_flight")))
    return handle


def sync_all() -> None:
    """Wait all outstanding async work before an order-sensitive
    operation."""
    in_flight.sync_all()
