"""Collective selector: the static table of implementations per (placement,
scope, mode), and the executable each collective resolves to.

Counterpart of the ``autotune_mode=off`` path of
``torchmpi_tpu/collectives/selector.py``, with its whole table.  A cell
lists namespaces in preference order, and :func:`resolve` returns the
first one that implements a collective:

* ``xla`` — the vendor path: ``collectives.eager`` over
  ``torch.distributed`` (the name is kept so the table reads as JAX's);
* ``hierarchical`` — the tree and cartesian composition across the levels
  of a split (``collectives/hierarchical.py``), in the multi-node cells
  while ``use_hierarchical_collectives`` is on;
* ``pallas`` — the hand-written ring kernels, ``collectives.cuda_ring``,
  first on the device column when ``use_pallas_collectives`` is on (the
  name is kept likewise);
* ``hostcomm`` — the host plane's TCP ring attached to the communicator
  (``comm.host_ring``, a ``hostcomm.HostCommunicator``), first on the host
  column.

Placement is where the payload lives.  The device column keeps JAX's name,
``"tpu"``.  A CPU tensor goes to the host column (``"cpu"``) only in a world
started on the card; in a world started with ``device="cpu"``, where CPU
tensors stand in for the card's, they stay on the device column, and the
host column is reached by asking for ``placement="cpu"``.  A CUDA tensor
never runs on the host ring: the host column hands it to ``eager``.  Scope
is ``"multinode"`` when a level of the stack crosses hosts
(``lifecycle.need_inter_node_collectives``).

The ring namespace applies the small-message cutoff itself: a message of
at most ``small_allreduce_size_gpu`` elements, a grouped call or an op
other than sum/mean goes to ``eager``.  An async executable returns a
:class:`~torchmpi_tpu_torch.runtime.handles.SynchronizationHandle`
registered in flight; a namespace without native async forms runs the sync
call and wraps the result (:func:`_wrap_async`).  The table follows its
knobs: a lookup after ``use_pallas_collectives`` or
``use_hierarchical_collectives`` changed rebuilds it (JAX's waits for the
next ``configure()``).  The measured cells of JAX's autotuner are not
ported: the table is static.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from ..runtime import config
from ..runtime import handles as _handles
from ..runtime.handles import SynchronizationHandle

PLACEMENTS = ("tpu", "cpu")
SCOPES = ("singlenode", "multinode")
MODES = ("sync", "async")

_table: Dict[tuple, List[str]] = {}
# The knobs the table was built from (None: not built yet).
_built_with: Optional[tuple] = None


def _knobs() -> tuple:
    return (bool(config.get("use_pallas_collectives")),
            bool(config.get("use_hierarchical_collectives")))


def configure() -> None:
    """Build the table from the knobs; the order within a cell is the
    preference, with fallback.  ``start()`` builds it, and a lookup
    rebuilds it when one of its knobs has changed since."""
    global _built_with
    _table.clear()
    prefer_pallas, hierarchical = _knobs()
    for placement in PLACEMENTS:
        for scope in SCOPES:
            for mode in MODES:
                prefs: List[str] = []
                if placement == "cpu":
                    prefs.append("hostcomm")
                if placement == "tpu" and prefer_pallas:
                    prefs.append("pallas")
                if scope == "multinode" and hierarchical:
                    prefs.append("hierarchical")
                prefs.append("xla")
                if not (placement == "tpu" and prefer_pallas):
                    prefs.append("pallas")
                _table[(placement, scope, mode)] = prefs
    _built_with = (prefer_pallas, hierarchical)


def _ensure() -> None:
    if _built_with != _knobs():
        configure()


def _auto_placement(payload=None) -> str:
    """``"cpu"`` for a CPU tensor in a world started on the card, else the
    device column."""
    from ..runtime import lifecycle

    if (isinstance(payload, torch.Tensor) and payload.device.type == "cpu"
            and lifecycle.started() and lifecycle.device().type == "cuda"):
        return "cpu"
    return "tpu"


def _auto_scope() -> str:
    from ..runtime import lifecycle

    return ("multinode" if lifecycle.need_inter_node_collectives()
            else "singlenode")


def _key(placement, scope, mode, payload) -> tuple:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    _ensure()
    key = (placement or _auto_placement(payload), scope or _auto_scope(),
           mode)
    if key not in _table:
        raise KeyError(f"no selector entry for {key}")
    return key


def select(placement: Optional[str] = None, scope: Optional[str] = None,
           mode: str = "sync", payload=None) -> str:
    """The cell's preferred namespace; ``None`` placement and scope are
    read from the payload and the stack."""
    return _table[_key(placement, scope, mode, payload)][0]


def preferences(placement: Optional[str] = None, scope: Optional[str] = None,
                mode: str = "sync", payload=None) -> List[str]:
    """The cell's namespaces in preference order."""
    return list(_table[_key(placement, scope, mode, payload)])


# ------------------------------------------------------- executable dispatch

def _xla_fn(name: str) -> Callable:
    """The eager entry point of ``name``: the xla implementation of a
    collective is exactly that."""
    def fn(comm, x=None, **kw):
        from . import eager

        if name == "barrier":
            return eager.barrier(comm)
        return getattr(eager, name)(comm, x, **kw)

    fn.__name__ = f"_xla_{name}"
    return fn


def _hierarchical_allreduce(comm, x, op="sum", groups=None):
    from . import eager, hierarchical

    if groups is not None:
        return eager.allreduce(comm, x, op=op, groups=groups)
    return hierarchical.allreduce_hierarchical(comm, x, op=op)


def _hierarchical_broadcast(comm, x, root=0, groups=None):
    from . import eager, hierarchical

    if groups is not None:
        return eager.broadcast(comm, x, root=root, groups=groups)
    return hierarchical.broadcast_hierarchical(comm, x, root=root)


def _hierarchical_reduce(comm, x, root=0, op="sum", groups=None):
    from . import eager, hierarchical

    if groups is not None:
        return eager.reduce(comm, x, root=root, op=op, groups=groups)
    return hierarchical.reduce_hierarchical(comm, x, root=root, op=op)


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


def _hostcomm_fn(name: str) -> Callable:
    """The host column's cell: a CPU tensor runs on the ring attached to
    the communicator (``comm.host_ring``; attaching one is the opt-in).
    The ring works on this rank's own tensor, in place on a copy that is
    returned; its allgather returns the flat rank-order concatenation, and
    so does this cell's fallback.  Without a ring, or for a CUDA tensor,
    the cell falls back to ``eager`` — except that a CPU tensor with no
    ring in a world of several processes raises, as JAX's does: the host
    column was asked for, and there is no host plane to run it on."""
    def fn(comm, x, **kw):
        from . import eager

        ring = getattr(comm, "host_ring", None)
        on_host = isinstance(x, torch.Tensor) and x.device.type == "cpu"
        if ring is None or not on_host:
            from ..runtime import lifecycle

            if (ring is None and on_host and lifecycle.started()
                    and lifecycle.process_count() > 1):
                raise RuntimeError(
                    f"host-column {name} without an attached ring in a "
                    f"{lifecycle.process_count()}-process world: attach a "
                    f"HostCommunicator (comm.host_ring) so host payloads "
                    f"cross processes, or resolve through the xla column")
            out = getattr(eager, name)(comm, x, **kw)
            if name == "allgather" and kw.get("groups") is None:
                out = out.reshape(-1)
            return out
        if kw.get("groups") is not None:
            raise ValueError(
                "per-call groups= is a device-plane feature; a host ring's "
                "grouping is fixed at construction "
                "(HierarchicalHostCommunicator) — attach one, or resolve "
                "through the xla column")
        arr = x.clone(memory_format=torch.contiguous_format)
        op = kw.get("op", "sum")
        # The ring reduces sum/max/min; mean is the sum's divide, which
        # would round an integer payload: refuse it.
        if op == "mean" and not arr.is_floating_point():
            raise TypeError(
                f"op='mean' on the host ring needs a float payload "
                f"(got {arr.dtype}); reduce with op='sum' and divide")
        ring_op = "sum" if op == "mean" else op
        if name == "allreduce":
            ring.allreduce(arr, op=ring_op)
            if op == "mean":
                arr = (arr / ring.size).to(arr.dtype)
        elif name == "broadcast":
            ring.broadcast(arr, root=kw.get("root", 0))
        elif name == "reduce":
            root = kw.get("root", 0)
            ring.reduce(arr, op=ring_op, root=root)
            if op == "mean" and ring.rank == root:
                arr = (arr / ring.size).to(arr.dtype)
        elif name == "sendreceive":
            ring.sendreceive(arr, src=kw["src"], dst=kw["dst"])
        elif name == "allgather":
            return ring.allgather(arr)
        else:  # pragma: no cover - the table names only the five above
            raise KeyError(name)
        return arr

    fn.__name__ = f"_hostcomm_{name}"
    return fn


def _hostcomm_barrier(comm, x=None, **kw):
    """The attached ring's barrier; the process group's without a ring."""
    ring = getattr(comm, "host_ring", None)
    if ring is None:
        from . import eager

        return eager.barrier(comm)
    return ring.barrier()


def _wrap_async(sync_fn: Callable) -> Callable:
    """Async form of a namespace without a native one: run the sync call
    and return its result in a handle registered in flight."""
    def fn(comm, x, **kw):
        out = sync_fn(comm, x, **kw)
        h = SynchronizationHandle.from_arrays(out, event=_handles.fence(out))
        return _handles.register(h)

    fn.__name__ = sync_fn.__name__ + "_async"
    return fn


_DISPATCH: Dict[tuple, Callable] = {
    ("allreduce", "xla", "sync"): _xla_fn("allreduce"),
    ("allreduce", "xla", "async"): _xla_fn("allreduce_async"),
    ("allreduce", "hierarchical", "sync"): _hierarchical_allreduce,
    ("allreduce", "hierarchical", "async"): _wrap_async(
        _hierarchical_allreduce),
    ("allreduce", "pallas", "sync"): _pallas_allreduce,
    ("allreduce", "pallas", "async"): _wrap_async(_pallas_allreduce),
    ("broadcast", "xla", "sync"): _xla_fn("broadcast"),
    ("broadcast", "xla", "async"): _xla_fn("broadcast_async"),
    ("broadcast", "hierarchical", "sync"): _hierarchical_broadcast,
    ("broadcast", "hierarchical", "async"): _wrap_async(
        _hierarchical_broadcast),
    ("reduce", "xla", "sync"): _xla_fn("reduce"),
    ("reduce", "xla", "async"): _xla_fn("reduce_async"),
    ("reduce", "hierarchical", "sync"): _hierarchical_reduce,
    ("reduce", "hierarchical", "async"): _wrap_async(_hierarchical_reduce),
    ("allgather", "xla", "sync"): _xla_fn("allgather"),
    ("allgather", "xla", "async"): _xla_fn("allgather_async"),
    ("allgather", "pallas", "sync"): _pallas_allgather,
    ("allgather", "pallas", "async"): _wrap_async(_pallas_allgather),
    ("sendreceive", "xla", "sync"): _xla_fn("sendreceive"),
    ("sendreceive", "xla", "async"): _xla_fn("sendreceive_async"),
    ("allreduce", "hostcomm", "sync"): _hostcomm_fn("allreduce"),
    ("allreduce", "hostcomm", "async"): _wrap_async(
        _hostcomm_fn("allreduce")),
    ("broadcast", "hostcomm", "sync"): _hostcomm_fn("broadcast"),
    ("broadcast", "hostcomm", "async"): _wrap_async(
        _hostcomm_fn("broadcast")),
    ("reduce", "hostcomm", "sync"): _hostcomm_fn("reduce"),
    ("reduce", "hostcomm", "async"): _wrap_async(_hostcomm_fn("reduce")),
    ("sendreceive", "hostcomm", "sync"): _hostcomm_fn("sendreceive"),
    ("sendreceive", "hostcomm", "async"): _wrap_async(
        _hostcomm_fn("sendreceive")),
    ("allgather", "hostcomm", "sync"): _hostcomm_fn("allgather"),
    ("allgather", "hostcomm", "async"): _wrap_async(
        _hostcomm_fn("allgather")),
    ("barrier", "hostcomm", "sync"): _hostcomm_barrier,
    ("barrier", "xla", "sync"): _xla_fn("barrier"),
    ("reduce_scatter", "xla", "sync"): _xla_fn("reduce_scatter"),
    ("reduce_scatter", "xla", "async"): _wrap_async(
        _xla_fn("reduce_scatter")),
    ("reduce_scatter", "pallas", "sync"): _pallas_reduce_scatter,
    ("reduce_scatter", "pallas", "async"): _wrap_async(
        _pallas_reduce_scatter),
    ("alltoall", "xla", "sync"): _xla_fn("alltoall"),
    ("alltoall", "xla", "async"): _wrap_async(_xla_fn("alltoall")),
}


def resolve(collective: str, placement: Optional[str] = None,
            scope: Optional[str] = None, mode: str = "sync",
            payload=None) -> Callable:
    """The executable for ``collective``: the first namespace of the
    cell's preference order that implements it."""
    for impl in preferences(placement, scope, mode, payload):
        fn = _DISPATCH.get((collective, impl, mode))
        if fn is not None:
            return fn
    raise KeyError(f"no implementation of {collective!r} in any namespace "
                   f"for mode={mode!r}")


def availability() -> str:
    """The table, one cell a line."""
    _ensure()
    lines = ["implementation availability (preference order per cell):"]
    for placement in PLACEMENTS:
        for scope in SCOPES:
            for mode in MODES:
                prefs = _table[(placement, scope, mode)]
                lines.append(f"  {placement:>3} x {scope:<10} x {mode:<5} "
                             f"-> {' > '.join(prefs)}")
    return "\n".join(lines)
