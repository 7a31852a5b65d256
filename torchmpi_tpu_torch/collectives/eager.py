"""Synchronous collectives over ``torch.distributed``, one tensor per rank.

Counterpart of the sync surface of ``torchmpi_tpu/collectives/eager.py``
with the same op contracts.  There a collective takes a rank-major
``(p, *s)`` array under one controller; here each process passes its own
tensor ``(*s)`` and gets its own result, which is the JAX package's row r
for rank r:

* ``allreduce`` (sum, mean, max, min): every rank gets the reduction;
  mean divides the sum by p in the tensor's dtype;
* ``broadcast``: every rank gets rank ``root``'s tensor;
* ``reduce``: rank ``root`` gets the reduction, the others keep theirs;
* ``allgather``: every rank gets ``(p, *s)``, rank r's tensor in row r;
* ``reduce_scatter`` (sum, mean): rank r gets the r-th of p equal parts of
  the reduction of a flat ``(n,)`` vector;
* ``sendreceive``: rank ``dst`` gets rank ``src``'s tensor, the others
  keep theirs;
* ``barrier`` and ``allreduce_scalar``.

``allreduce_async``, ``broadcast_async``, ``reduce_async``,
``allgather_async`` and ``sendreceive_async`` issue the same collective
with ``async_op=True`` and return a :class:`SynchronizationHandle`,
registered in flight, whose ``wait()`` returns what the sync form returns.

The reduction order is the backend's (gloo's or NCCL's), not a ring's:
callers that need the ring's exact order use ``cuda_ring``.  Grouped
(``groups=``) and v-forms are not ported yet: they raise and name their
slice.
"""

from __future__ import annotations

import torch

from ..runtime import handles as _handles
from ..runtime.communicator import Communicator
from ..runtime.handles import SynchronizationHandle

_REDUCE_OPS = ("sum", "max", "min", "mean")
_LATER = ("the grouped and v-form collectives come with the hierarchical "
          "collectives of a later slice (ROADMAP.md slice 3, item 4)")


def _no_groups(groups) -> None:
    if groups is not None:
        raise NotImplementedError(f"groups=: {_LATER}")


def _dist_op(op: str):
    import torch.distributed as dist

    if op not in _REDUCE_OPS:
        raise ValueError(f"unsupported reduction {op!r} (have {_REDUCE_OPS})")
    return {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
            "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]


def _host_staged(comm: Communicator, x: torch.Tensor) -> bool:
    """gloo takes CUDA tensors in all_reduce and broadcast only: the other
    collectives of a gloo group stage a CUDA tensor through the host."""
    import torch.distributed as dist

    return x.device.type == "cuda" and dist.get_backend(comm.group) == "gloo"


def _mean_div(op: str, out: torch.Tensor, p: int) -> torch.Tensor:
    if op == "mean":
        return out / torch.tensor(p, dtype=out.dtype, device=out.device)
    return out


def _check_root(comm: Communicator, root: int) -> None:
    if not 0 <= root < comm.size:
        raise ValueError(f"root position {root} out of range for group of "
                         f"size {comm.size}")


# Each collective below is written once, as an issue step that returns
# (work, payload, finish): the work of ``torch.distributed`` (None when the
# call was synchronous), the tensor it writes, and the epilogue that turns
# that tensor into the result.  The sync form waits the work and finishes
# at once; the async form hands all three to a handle.

def _issue_allreduce(comm, x, op, async_op):
    import torch.distributed as dist

    out = x.clone()
    work = dist.all_reduce(out, op=_dist_op(op), group=comm.group,
                           async_op=async_op)
    return work, out, lambda o: _mean_div(op, o, comm.size)


def _issue_broadcast(comm, x, root, async_op):
    import torch.distributed as dist

    _check_root(comm, root)
    out = x.clone()
    work = dist.broadcast(out, src=comm.global_rank(root), group=comm.group,
                          async_op=async_op)
    return work, out, None


def _issue_reduce(comm, x, root, op, async_op):
    import torch.distributed as dist

    _check_root(comm, root)
    out = x.cpu() if _host_staged(comm, x) else x.clone()
    work = dist.reduce(out, dst=comm.global_rank(root), op=_dist_op(op),
                       group=comm.group, async_op=async_op)

    def finish(o):
        if comm.rank != root:
            return x.clone()
        return _mean_div(op, o.to(x.device), comm.size)

    return work, out, finish


def _issue_allgather(comm, x, async_op):
    import torch.distributed as dist

    src = x.cpu() if _host_staged(comm, x) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(comm.size)]
    work = dist.all_gather(parts, src, group=comm.group, async_op=async_op)
    return work, parts, lambda ps: torch.stack(ps).to(x.device)


def _issue_sendreceive(comm, x, src, dst, async_op):
    """``dst`` receives ``src``'s tensor (point to point; gloo stages a
    CUDA tensor through the host); every other rank keeps its own."""
    import torch.distributed as dist

    _check_root(comm, src)
    _check_root(comm, dst)
    me = comm.rank
    if src == dst or me not in (src, dst):
        return None, x.clone(), None
    host = x.device.type == "cuda" and dist.get_backend(comm.group) == "gloo"
    if me == src:
        buf = x.cpu() if host else x.contiguous()
        send = dist.isend if async_op else dist.send
        work = send(buf, dst=comm.global_rank(dst), group=comm.group)
        # The epilogue holds the send buffer until the work is waited.
        return (work if async_op else None), x.clone(), lambda o, _b=buf: o
    buf = torch.empty_like(x, device="cpu" if host else x.device)
    recv = dist.irecv if async_op else dist.recv
    work = recv(buf, src=comm.global_rank(src), group=comm.group)
    return (work if async_op else None), buf, lambda b: b.to(x.device)


def _sync(issued) -> torch.Tensor:
    work, out, finish = issued
    if work is not None:
        work.wait()
    return finish(out) if finish is not None else out


def _async(issued) -> SynchronizationHandle:
    work, out, finish = issued
    if work is None:
        h = SynchronizationHandle.from_arrays(
            finish(out) if finish is not None else out)
    else:
        h = SynchronizationHandle.from_work(work, out, finish)
    return _handles.register(h)


def allreduce(comm: Communicator, x: torch.Tensor, op: str = "sum",
              groups=None) -> torch.Tensor:
    """Every rank's tensor reduced by ``op``; a new tensor."""
    _no_groups(groups)
    return _sync(_issue_allreduce(comm, x, op, False))


def broadcast(comm: Communicator, x: torch.Tensor, root: int = 0,
              groups=None) -> torch.Tensor:
    """Rank ``root``'s tensor on every rank; a new tensor."""
    _no_groups(groups)
    return _sync(_issue_broadcast(comm, x, root, False))


def reduce(comm: Communicator, x: torch.Tensor, root: int = 0,
           op: str = "sum", groups=None) -> torch.Tensor:
    """The reduction on rank ``root``; every other rank keeps its input."""
    _no_groups(groups)
    return _sync(_issue_reduce(comm, x, root, op, False))


def allgather(comm: Communicator, x: torch.Tensor,
              groups=None) -> torch.Tensor:
    """``(p, *s)``: rank r's tensor in row r, on every rank."""
    _no_groups(groups)
    return _sync(_issue_allgather(comm, x, False))


def sendreceive(comm: Communicator, x: torch.Tensor, src: int,
                dst: int) -> torch.Tensor:
    """Rank ``dst`` gets rank ``src``'s tensor; every other rank keeps its
    own (a new tensor on every rank)."""
    return _sync(_issue_sendreceive(comm, x, src, dst, False))


def allreduce_async(comm: Communicator, x: torch.Tensor, op: str = "sum",
                    groups=None) -> SynchronizationHandle:
    _no_groups(groups)
    return _async(_issue_allreduce(comm, x, op, True))


def broadcast_async(comm: Communicator, x: torch.Tensor, root: int = 0,
                    groups=None) -> SynchronizationHandle:
    _no_groups(groups)
    return _async(_issue_broadcast(comm, x, root, True))


def reduce_async(comm: Communicator, x: torch.Tensor, root: int = 0,
                 op: str = "sum", groups=None) -> SynchronizationHandle:
    _no_groups(groups)
    return _async(_issue_reduce(comm, x, root, op, True))


def allgather_async(comm: Communicator, x: torch.Tensor,
                    groups=None) -> SynchronizationHandle:
    _no_groups(groups)
    return _async(_issue_allgather(comm, x, True))


def sendreceive_async(comm: Communicator, x: torch.Tensor, src: int,
                      dst: int) -> SynchronizationHandle:
    return _async(_issue_sendreceive(comm, x, src, dst, True))


def reduce_scatter(comm: Communicator, x: torch.Tensor, op: str = "sum",
                   groups=None) -> torch.Tensor:
    """Rank r's part ``[r n/p, (r+1) n/p)`` of the reduction of the flat
    ``(n,)`` vectors (sum or mean).  Reduced with one allreduce, since gloo
    has no reduce-scatter."""
    _no_groups(groups)
    if x.ndim != 1:
        raise ValueError("reduce_scatter expects this rank's flat (n,) vector")
    if op not in ("sum", "mean"):
        raise ValueError("reduce_scatter supports sum/mean")
    p, n = comm.size, x.numel()
    if n % p != 0:
        raise ValueError(f"reduce_scatter data axis {n} not divisible by "
                         f"group size {p}")
    full = allreduce(comm, x, op=op)
    return full[comm.rank * (n // p):(comm.rank + 1) * (n // p)].clone()


def barrier(comm: Communicator) -> None:
    """Rendezvous of the communicator's ranks."""
    import torch.distributed as dist

    dist.barrier(group=comm.group)


def allreduce_scalar(comm: Communicator, value, op: str = "sum",
                     dtype=torch.float64, groups=None):
    """This rank's one-element reduction, as a Python number."""
    return allreduce(comm, torch.tensor([value], dtype=dtype), op=op,
                     groups=groups).item()


def _later(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"{name}: {_LATER}")

    fn.__name__ = name
    return fn


allgatherv = _later("allgatherv")
alltoall = _later("alltoall")
