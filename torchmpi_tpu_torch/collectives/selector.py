"""Collective selector: the static table, two cells of the device column.

Counterpart of the ``autotune_mode=off`` path of
``torchmpi_tpu/collectives/selector.py``: its device column's single-node
sync and async cells (JAX's ``"tpu"`` placement).  A cell lists namespaces in
preference order, and :func:`resolve` returns the first one that implements
a collective:

* ``xla`` — the vendor path: ``collectives.eager`` over
  ``torch.distributed`` (the name is kept so the table reads as JAX's);
* ``pallas`` — the hand-written ring kernels, ``collectives.cuda_ring``,
  first when ``use_pallas_collectives`` is on (the name is kept likewise).

The ring namespace applies the small-message cutoff itself: a message of
at most ``small_allreduce_size_gpu`` elements, a grouped call or an op other
than sum/mean goes to ``eager``.

Two cells are ported, the sync and the async one (``mode``), with the same
preference order, as in JAX.  An async executable returns a
:class:`~torchmpi_tpu_torch.runtime.handles.SynchronizationHandle`
registered in flight.  ``xla`` has native async forms (``eager.*_async``);
the ring namespace has none: its async form runs the sync call and wraps
the result (:func:`_wrap_async`), and since every ring call is
host-synchronised, the work is complete when the handle is returned.  The
multi-node cells come with the slice that ports the hierarchical
collectives.
"""

from __future__ import annotations

from typing import Callable, Dict, List

from ..runtime import config
from ..runtime import handles as _handles
from ..runtime.handles import SynchronizationHandle

MODES = ("sync", "async")


def preferences() -> List[str]:
    """The cell's namespaces in preference order (JAX's rule, the same for
    both modes)."""
    if config.get("use_pallas_collectives"):
        return ["pallas", "xla"]
    return ["xla", "pallas"]


def _pallas_ring_eligible(comm, x, op, groups) -> bool:
    """Whole-communicator sum/mean of a flat vector above the small-message
    cutoff."""
    return (groups is None and x.ndim == 1 and op in ("sum", "mean")
            and x.numel() > int(config.get("small_allreduce_size_gpu")))


def _pallas_allreduce(comm, x, op="sum", groups=None):
    from . import cuda_ring, eager

    if not _pallas_ring_eligible(comm, x, op, groups):
        return eager.allreduce(comm, x, op=op, groups=groups)
    return cuda_ring.ring_allreduce(comm, x, op=op)


def _pallas_reduce_scatter(comm, x, op="sum", groups=None):
    from . import cuda_ring, eager

    if (not _pallas_ring_eligible(comm, x, op, groups)
            or x.numel() % comm.size != 0):
        return eager.reduce_scatter(comm, x, op=op, groups=groups)
    out = cuda_ring.ring_reduce_scatter(comm, x, op="sum")
    return eager._mean_div(op, out, comm.size)


def _pallas_allgather(comm, x, groups=None):
    """Ring allgather in eager.allgather's ``(p, n)`` layout."""
    from . import cuda_ring, eager

    if not _pallas_ring_eligible(comm, x, "sum", groups):
        return eager.allgather(comm, x, groups=groups)
    return cuda_ring.ring_allgather(comm, x).view(comm.size, x.numel())


def _wrap_async(sync_fn: Callable) -> Callable:
    """Async form of a namespace without a native one: run the sync call
    and return its result in a handle registered in flight."""
    def fn(comm, x, **kw):
        out = sync_fn(comm, x, **kw)
        h = SynchronizationHandle.from_arrays(out, event=_handles.fence(out))
        return _handles.register(h)

    fn.__name__ = sync_fn.__name__ + "_async"
    return fn


def _xla_fn(name: str) -> Callable:
    def fn(comm, x=None, **kw):
        from . import eager

        if name == "barrier":
            return eager.barrier(comm)
        return getattr(eager, name)(comm, x, **kw)

    fn.__name__ = f"_xla_{name}"
    return fn


_DISPATCH: Dict[tuple, Callable] = {
    ("allreduce", "xla", "sync"): _xla_fn("allreduce"),
    ("allreduce", "xla", "async"): _xla_fn("allreduce_async"),
    ("allreduce", "pallas", "sync"): _pallas_allreduce,
    ("allreduce", "pallas", "async"): _wrap_async(_pallas_allreduce),
    ("broadcast", "xla", "sync"): _xla_fn("broadcast"),
    ("broadcast", "xla", "async"): _xla_fn("broadcast_async"),
    ("reduce", "xla", "sync"): _xla_fn("reduce"),
    ("reduce", "xla", "async"): _xla_fn("reduce_async"),
    ("allgather", "xla", "sync"): _xla_fn("allgather"),
    ("allgather", "xla", "async"): _xla_fn("allgather_async"),
    ("allgather", "pallas", "sync"): _pallas_allgather,
    ("allgather", "pallas", "async"): _wrap_async(_pallas_allgather),
    ("sendreceive", "xla", "sync"): _xla_fn("sendreceive"),
    ("sendreceive", "xla", "async"): _xla_fn("sendreceive_async"),
    ("reduce_scatter", "xla", "sync"): _xla_fn("reduce_scatter"),
    ("reduce_scatter", "xla", "async"): _wrap_async(
        _xla_fn("reduce_scatter")),
    ("reduce_scatter", "pallas", "sync"): _pallas_reduce_scatter,
    ("reduce_scatter", "pallas", "async"): _wrap_async(
        _pallas_reduce_scatter),
    ("barrier", "xla", "sync"): _xla_fn("barrier"),
}


def resolve(collective: str, mode: str = "sync") -> Callable:
    """The executable for ``collective`` in ``mode`` ("sync" or "async"):
    the first namespace of :func:`preferences` that implements it."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    for impl in preferences():
        fn = _DISPATCH.get((collective, impl, mode))
        if fn is not None:
            return fn
    raise KeyError(f"no implementation of {collective!r} ({mode}) in any "
                   f"namespace")
