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
* ``barrier`` and ``allreduce_scalar``.

The reduction order is the backend's (gloo's or NCCL's), not a ring's:
callers that need the ring's exact order use ``cuda_ring``.  Grouped
(``groups=``), asynchronous and v-forms are not ported yet: they raise and
name their slice.
"""

from __future__ import annotations

import torch

from ..runtime.communicator import Communicator

_REDUCE_OPS = ("sum", "max", "min", "mean")
_LATER = ("the grouped, asynchronous and v-form collectives come with the "
          "hierarchical and async collectives of a later slice (ROADMAP.md "
          "slice 3, item 4)")


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


def allreduce(comm: Communicator, x: torch.Tensor, op: str = "sum",
              groups=None) -> torch.Tensor:
    """Every rank's tensor reduced by ``op``; a new tensor."""
    import torch.distributed as dist

    _no_groups(groups)
    out = x.clone()
    dist.all_reduce(out, op=_dist_op(op), group=comm.group)
    return _mean_div(op, out, comm.size)


def broadcast(comm: Communicator, x: torch.Tensor, root: int = 0,
              groups=None) -> torch.Tensor:
    """Rank ``root``'s tensor on every rank; a new tensor."""
    import torch.distributed as dist

    _no_groups(groups)
    if not 0 <= root < comm.size:
        raise ValueError(f"root position {root} out of range for group of "
                         f"size {comm.size}")
    out = x.clone()
    dist.broadcast(out, src=comm.global_rank(root), group=comm.group)
    return out


def reduce(comm: Communicator, x: torch.Tensor, root: int = 0,
           op: str = "sum", groups=None) -> torch.Tensor:
    """The reduction on rank ``root``; every other rank keeps its input."""
    import torch.distributed as dist

    _no_groups(groups)
    if not 0 <= root < comm.size:
        raise ValueError(f"root position {root} out of range for group of "
                         f"size {comm.size}")
    out = x.cpu() if _host_staged(comm, x) else x.clone()
    dist.reduce(out, dst=comm.global_rank(root), op=_dist_op(op),
                group=comm.group)
    if comm.rank != root:
        return x.clone()
    return _mean_div(op, out.to(x.device), comm.size)


def allgather(comm: Communicator, x: torch.Tensor,
              groups=None) -> torch.Tensor:
    """``(p, *s)``: rank r's tensor in row r, on every rank."""
    import torch.distributed as dist

    _no_groups(groups)
    src = x.cpu() if _host_staged(comm, x) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(comm.size)]
    dist.all_gather(parts, src, group=comm.group)
    return torch.stack(parts).to(x.device)


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
allreduce_async = _later("allreduce_async")
broadcast_async = _later("broadcast_async")
reduce_async = _later("reduce_async")
allgather_async = _later("allgather_async")
sendreceive = _later("sendreceive")
alltoall = _later("alltoall")
