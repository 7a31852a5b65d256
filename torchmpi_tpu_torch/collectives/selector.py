"""Collective selector: the static table, one cell of the device column.

Counterpart of the ``autotune_mode=off`` path of
``torchmpi_tpu/collectives/selector.py``: its device column's single-node
sync cell (JAX's ``"tpu"`` placement).  The cell lists namespaces in
preference order, and :func:`resolve` returns the first one that implements
a collective:

* ``xla`` — the vendor path: ``collectives.eager`` over
  ``torch.distributed`` (the name is kept so the table reads as JAX's);
* ``pallas`` — the hand-written ring kernels, ``collectives.cuda_ring``,
  first when ``use_pallas_collectives`` is on (the name is kept likewise).

The ring namespace applies the small-message cutoff itself: a message of
at most ``small_allreduce_size_gpu`` elements, a grouped call or an op other
than sum/mean goes to ``eager``.  The multi-node and async cells come with
the slices that port the hierarchical and async collectives.
"""

from __future__ import annotations

from typing import Callable, Dict, List

from ..runtime import config


def preferences() -> List[str]:
    """The cell's namespaces in preference order (JAX's rule)."""
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


def _xla_fn(name: str) -> Callable:
    def fn(comm, x=None, **kw):
        from . import eager

        if name == "barrier":
            return eager.barrier(comm)
        return getattr(eager, name)(comm, x, **kw)

    fn.__name__ = f"_xla_{name}"
    return fn


_DISPATCH: Dict[tuple, Callable] = {
    ("allreduce", "xla"): _xla_fn("allreduce"),
    ("allreduce", "pallas"): _pallas_allreduce,
    ("broadcast", "xla"): _xla_fn("broadcast"),
    ("reduce", "xla"): _xla_fn("reduce"),
    ("allgather", "xla"): _xla_fn("allgather"),
    ("allgather", "pallas"): _pallas_allgather,
    ("reduce_scatter", "xla"): _xla_fn("reduce_scatter"),
    ("reduce_scatter", "pallas"): _pallas_reduce_scatter,
    ("barrier", "xla"): _xla_fn("barrier"),
}


def resolve(collective: str) -> Callable:
    """The executable for ``collective``: the first namespace of
    :func:`preferences` that implements it."""
    for impl in preferences():
        fn = _DISPATCH.get((collective, impl))
        if fn is not None:
            return fn
    raise KeyError(f"no implementation of {collective!r} in any namespace")
