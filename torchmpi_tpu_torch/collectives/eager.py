"""Synchronous and asynchronous collectives over ``torch.distributed``, one
tensor per rank.

Counterpart of ``torchmpi_tpu/collectives/eager.py`` with the same op
contracts.  There a collective takes a rank-major ``(p, *s)`` array under
one controller; here each process passes its own tensor ``(*s)`` and gets
its own result, which is the JAX package's row r for rank r:

* ``allreduce`` (sum, mean, max, min): every rank gets the reduction;
  mean divides the sum by the group's size in the tensor's dtype;
* ``broadcast``: every rank gets the tensor of position ``root``;
* ``reduce``: position ``root`` gets the reduction, the others keep theirs;
* ``allgather``: every rank gets ``(g, *s)``, the group's tensors in the
  group's order;
* ``allgatherv``: ``(out, counts)``, ``out`` the group's tensors padded
  with zero rows to the largest group, ``counts[r]`` the size of rank r's
  group (for any groups, even or not);
* ``reduce_scatter`` (sum, mean): position i gets the i-th of g equal
  parts of the group's reduction of a flat ``(n,)`` vector;
* ``sendreceive``: rank ``dst`` gets rank ``src``'s tensor, the others
  keep theirs;
* ``alltoall``: rank r's result is chunk r (of p along dim 0) of every
  rank's tensor, in rank order;
* ``barrier`` and the scalar forms, ``allreduce_scalar``,
  ``broadcast_scalar``, ``reduce_scalar`` and ``sendreceive_scalar``,
  which take this rank's value and return a Python number.

``groups=`` (tuples of positions in the communicator) runs a collective in
each group at once, as JAX's ``axis_index_groups`` do: a rank in no group
keeps its value (a group of its own), and ``root`` is a position in the
group.  Each group is a process group of its own, made at the partition's
first call (``runtime/communicator.py:process_groups``): every rank of the
world makes each call, so the groups are made in the same order
everywhere.

``allreduce_async``, ``broadcast_async``, ``reduce_async``,
``allgather_async`` and ``sendreceive_async`` issue the same collective
with ``async_op=True`` and return a :class:`SynchronizationHandle`,
registered in flight, whose ``wait()`` returns what the sync form returns.

The reduction order is the backend's (gloo's or NCCL's), not a ring's:
callers that need the ring's exact order use ``cuda_ring``.  A gloo group
takes CUDA tensors in ``all_reduce`` and ``broadcast`` only: the other
collectives stage a CUDA tensor through the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..runtime import communicator as _comm_mod
from ..runtime import handles as _handles
from ..runtime.communicator import Communicator
from ..runtime.handles import SynchronizationHandle

Groups = Optional[Tuple[Tuple[int, ...], ...]]

_REDUCE_OPS = ("sum", "max", "min", "mean")


# ------------------------------------------------------------ group plumbing

def _complete_groups(comm: Communicator, groups: Groups) -> Groups:
    """``groups`` with a group of its own for every rank they leave out, so
    that they cover every rank (the rank then keeps its value)."""
    if groups is None:
        return None
    covered = {r for g in groups for r in g}
    return (tuple(tuple(g) for g in groups)
            + tuple((r,) for r in range(comm.size) if r not in covered))


def _validate_rooted_groups(comm: Communicator, user_groups: Groups,
                            root: int) -> None:
    """Every group must hold position ``root``; with no groups the whole
    communicator is the group."""
    if root < 0:
        raise ValueError(f"root must be non-negative, got {root}")
    sizes = ([len(g) for g in user_groups] if user_groups is not None
             else [comm.size])
    for s in sizes:
        if root >= s:
            raise ValueError(
                f"root position {root} out of range for group of size {s}")


def _validate_full_equal_groups(comm: Communicator, user_groups: Groups,
                                what: str) -> None:
    """allgather and reduce_scatter change the shape: the groups must cover
    every rank and be of one size."""
    if user_groups is None:
        return
    covered = sorted(r for g in user_groups for r in g)
    if covered != list(range(comm.size)):
        raise ValueError(
            f"grouped {what} requires groups covering every rank "
            f"(uncovered ranks would need a different output shape); "
            f"got coverage {covered} of {comm.size} ranks")
    sizes = {len(g) for g in user_groups}
    if len(sizes) != 1:
        raise ValueError(
            f"grouped {what} requires equal-sized groups, got sizes "
            f"{sorted(len(g) for g in user_groups)}")


class _Sub:
    """This rank's group in one call: its process group, its global ranks
    in the group's order, this rank's position in it, and whether every
    group of the call has its size (the mean's divisor is then a
    constant, see :func:`_mean_div`)."""

    __slots__ = ("group", "ranks", "pos", "uniform")

    def __init__(self, group, ranks: Tuple[int, ...], pos: int,
                 uniform: bool = True):
        self.group, self.ranks, self.pos = group, ranks, pos
        self.uniform = uniform

    @property
    def size(self) -> int:
        return len(self.ranks)

    def order(self, parts):
        """``parts`` of a gather over the process group (in ascending global
        rank) in the group's order."""
        asc = sorted(self.ranks)
        return [parts[asc.index(g)] for g in self.ranks]


def _sub(comm: Communicator, groups: Groups) -> _Sub:
    """This rank's group of ``groups`` (positions in ``comm``), making the
    partition's process groups first (every rank makes the same calls)."""
    if groups is None:
        return _Sub(comm.group, comm.ranks, comm.rank)
    full = _complete_groups(comm, groups)
    part = comm.global_partition(full)
    _comm_mod.process_groups([g for g in part if len(g) > 1])
    me = comm.rank
    gi = next(i for i, g in enumerate(full) if me in g)
    ranks = part[gi]
    group = _comm_mod.process_group(ranks) if len(ranks) > 1 else None
    return _Sub(group, ranks, full[gi].index(me),
                len({len(g) for g in full}) == 1)


def _dist_op(op: str):
    import torch.distributed as dist

    if op not in _REDUCE_OPS:
        raise ValueError(f"unsupported reduction {op!r} (have {_REDUCE_OPS})")
    return {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
            "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]


def _host_staged(group, x: torch.Tensor) -> bool:
    """gloo takes CUDA tensors in all_reduce and broadcast only: the other
    collectives of a gloo group stage a CUDA tensor through the host."""
    import torch.distributed as dist

    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _mean(out: torch.Tensor, p: int) -> torch.Tensor:
    """The replica mean as the JAX package computes it: its ``out / p``
    divides by a constant, which XLA turns into a product with the f32
    reciprocal of p (one ulp off an IEEE division in about a third of f32
    elements at p = 3; exact at a power of two).  A bf16 vector rounds that
    f32 product to bf16; an integer vector gives f32, as ``int / int``
    does there.  A new tensor (:func:`_mean_` writes f32 and bf16 in
    place)."""
    if out.dtype in (torch.float32, torch.bfloat16):
        return _mean_(out.clone(memory_format=torch.contiguous_format), p)
    return out.to(torch.float32) * _recip(p, out.device)


def _recip(p: int, device) -> torch.Tensor:
    """The f32 reciprocal of p, as XLA folds it."""
    return (torch.ones((), dtype=torch.float32) / p).to(device)


_MEAN_CHUNK = 1 << 26


def _mean_(out: torch.Tensor, p: int) -> torch.Tensor:
    """:func:`_mean` of an f32 or bf16 tensor written into it, with an f32
    temporary of at most ``_MEAN_CHUNK`` elements (a bf16 buffer of
    gigabytes would otherwise take twice its size again in f32, twice)."""
    recip = _recip(p, out.device)
    if out.dtype == torch.float32:
        return out.mul_(recip)
    if out.dtype != torch.bfloat16 or not out.is_contiguous():
        raise TypeError("_mean_ takes a contiguous f32 or bf16 tensor")
    flat = out.view(-1)
    for lo in range(0, flat.numel(), _MEAN_CHUNK):
        part = flat[lo:lo + _MEAN_CHUNK]
        part.copy_(part.to(torch.float32) * recip)
    return out


def _mean_div(op: str, out: torch.Tensor, p: int,
              uniform: bool = True) -> torch.Tensor:
    """The mean's divide by the group's size p, as JAX's compiles: where
    every rank's group has size p the divisor is a constant, which XLA
    turns into a product with the f32 reciprocal of p for f32 and bf16
    (:func:`_mean`; one ulp off an IEEE divide in some elements when p is
    not a power of two); groups of several sizes divide."""
    if op != "mean":
        return out
    if uniform and out.dtype in (torch.float32, torch.bfloat16):
        return _mean(out, p)
    return out / torch.tensor(p, dtype=out.dtype, device=out.device)


# Each collective below is written once, as an issue step that returns
# (work, payload, finish): the work of ``torch.distributed`` (None when the
# call was synchronous or needed no communication), the tensor it writes,
# and the epilogue that turns that tensor into the result.  The sync form
# waits the work and finishes at once; the async form hands all three to a
# handle.  A group of one rank makes no call.

def _issue_allreduce(sub: _Sub, x, op, async_op, inplace=False):
    import torch.distributed as dist

    _dist_op(op)
    out = x if inplace else x.clone()
    finish = lambda o: _mean_div(op, o, sub.size, sub.uniform)  # noqa: E731
    if sub.size == 1:
        return None, out, finish
    work = dist.all_reduce(out, op=_dist_op(op), group=sub.group,
                           async_op=async_op)
    return work, out, finish


def _issue_broadcast(sub: _Sub, x, root, async_op):
    import torch.distributed as dist

    out = x.clone()
    if sub.size == 1:
        return None, out, None
    work = dist.broadcast(out, src=sub.ranks[root], group=sub.group,
                          async_op=async_op)
    return work, out, None


def _issue_reduce(sub: _Sub, x, root, op, async_op):
    import torch.distributed as dist

    _dist_op(op)

    def finish(o):
        if sub.pos != root:
            return x.clone()
        return _mean_div(op, o.to(x.device), sub.size, sub.uniform)

    if sub.size == 1:
        return None, x.clone(), finish
    out = x.cpu() if _host_staged(sub.group, x) else x.clone()
    work = dist.reduce(out, dst=sub.ranks[root], op=_dist_op(op),
                       group=sub.group, async_op=async_op)
    return work, out, finish


def _issue_allgather(sub: _Sub, x, async_op):
    import torch.distributed as dist

    if sub.size == 1:
        return None, [x.clone()], lambda ps: torch.stack(ps)
    src = x.cpu() if _host_staged(sub.group, x) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(sub.size)]
    work = dist.all_gather(parts, src, group=sub.group, async_op=async_op)
    return work, parts, lambda ps: torch.stack(sub.order(ps)).to(x.device)


def _issue_sendreceive(comm, x, src, dst, async_op):
    """``dst`` receives ``src``'s tensor (point to point; gloo stages a
    CUDA tensor through the host); every other rank keeps its own."""
    import torch.distributed as dist

    _validate_rooted_groups(comm, None, src)
    _validate_rooted_groups(comm, None, dst)
    me = comm.rank
    if src == dst or me not in (src, dst):
        return None, x.clone(), None
    host = _host_staged(comm.group, x)
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


def _rooted(comm, groups, root) -> _Sub:
    _validate_rooted_groups(comm, groups, root)
    return _sub(comm, groups)


def _gathered(comm, groups) -> _Sub:
    _validate_full_equal_groups(comm, groups, "allgather")
    return _sub(comm, groups)


# ------------------------------------------------------------------ sync API

def allreduce(comm: Communicator, x: torch.Tensor, op: str = "sum",
              groups: Groups = None) -> torch.Tensor:
    """Every rank's tensor reduced by ``op``; a new tensor."""
    return _sync(_issue_allreduce(_sub(comm, groups), x, op, False))


def allreduce_(comm: Communicator, x: torch.Tensor,
               op: str = "sum") -> torch.Tensor:
    """:func:`allreduce` over the whole communicator written into ``x``
    (no copy; the mean as :func:`_mean_` takes it: f32 or bf16): for the
    large flat buffers their callers own.  Returns ``x``."""
    _, out, _ = _issue_allreduce(_sub(comm, None), x, op, False,
                                 inplace=True)
    return _mean_(out, comm.size) if op == "mean" else out


def broadcast(comm: Communicator, x: torch.Tensor, root: int = 0,
              groups: Groups = None) -> torch.Tensor:
    """Position ``root``'s tensor on every rank; a new tensor."""
    return _sync(_issue_broadcast(_rooted(comm, groups, root), x, root,
                                  False))


def reduce(comm: Communicator, x: torch.Tensor, root: int = 0,
           op: str = "sum", groups: Groups = None) -> torch.Tensor:
    """The reduction on position ``root``; every other rank keeps its
    input."""
    return _sync(_issue_reduce(_rooted(comm, groups, root), x, root, op,
                               False))


def allgather(comm: Communicator, x: torch.Tensor,
              groups: Groups = None) -> torch.Tensor:
    """``(g, *s)``: the group's tensors in the group's order, on every
    rank of it."""
    return _sync(_issue_allgather(_gathered(comm, groups), x, False))


def allgatherv(comm: Communicator, x: torch.Tensor,
               groups: Groups = None) -> Tuple[torch.Tensor, np.ndarray]:
    """The allgather of uneven groups: ``(out, counts)``, ``out`` the
    group's tensors ``(gmax, *s)`` in the group's order, zero rows past the
    group's size up to the largest group's; ``counts`` the ``(p,)`` sizes
    of every rank's group (the same on every rank).  Groups must be
    disjoint; a rank in none is a group of its own."""
    if groups is None:
        full = (tuple(range(comm.size)),)
        sub = _sub(comm, None)
    else:
        flat = [r for g in groups for r in g]
        if len(flat) != len(set(flat)):
            raise ValueError(
                f"allgatherv groups must be disjoint (each rank in at most "
                f"one group); got {groups}")
        full = _complete_groups(comm, groups)
        sub = _sub(comm, groups)
    counts = np.zeros((comm.size,), np.int64)
    for g in full:
        for r in g:
            counts[r] = len(g)
    rows = _sync(_issue_allgather(sub, x, False))
    gmax = max(len(g) for g in full)
    if gmax > sub.size:
        pad = rows.new_zeros((gmax - sub.size,) + tuple(rows.shape[1:]))
        rows = torch.cat([rows, pad])
    return rows, counts


def reduce_scatter(comm: Communicator, x: torch.Tensor, op: str = "sum",
                   groups: Groups = None,
                   inplace: bool = False) -> torch.Tensor:
    """Position i's part ``[i n/g, (i+1) n/g)`` of the group's reduction of
    the flat ``(n,)`` vectors (sum or mean).  Reduced with one allreduce,
    since gloo has no reduce-scatter: with ``inplace`` into ``x`` itself
    (contiguous; the caller's buffer, consumed), else into a copy."""
    if x.ndim != 1:
        raise ValueError("reduce_scatter expects this rank's flat (n,) vector")
    if op not in ("sum", "mean"):
        raise ValueError("reduce_scatter supports sum/mean")
    _validate_full_equal_groups(comm, groups, "reduce_scatter")
    sub = _sub(comm, groups)
    g, n = sub.size, x.numel()
    if n % g != 0:
        raise ValueError(f"reduce_scatter data axis {n} not divisible by "
                         f"group size {g}")
    full = _sync(_issue_allreduce(sub, x, "sum", False, inplace))
    part = full[sub.pos * (n // g):(sub.pos + 1) * (n // g)]
    return _mean_div(op, part, g, sub.uniform) if op == "mean" \
        else part.clone()


def sendreceive(comm: Communicator, x: torch.Tensor, src: int,
                dst: int) -> torch.Tensor:
    """Rank ``dst`` gets rank ``src``'s tensor; every other rank keeps its
    own (a new tensor on every rank)."""
    return _sync(_issue_sendreceive(comm, x, src, dst, False))


def alltoall(comm: Communicator, x: torch.Tensor) -> torch.Tensor:
    """Rank r's result: chunk r of every rank's tensor, in rank order, each
    tensor cut into p chunks along dim 0 (which p must divide)."""
    import torch.distributed as dist

    if x.ndim < 1:
        raise ValueError("alltoall expects this rank's (n, ...) tensor")
    if x.shape[0] % comm.size != 0:
        raise ValueError("alltoall needs data axis divisible by "
                         "communicator size")
    if comm.size == 1:
        return x.clone()
    host = _host_staged(comm.group, x)
    src = (x.cpu() if host else x).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=comm.group)
    return out.to(x.device)


def barrier(comm: Communicator) -> None:
    """Rendezvous of the communicator's ranks."""
    import torch.distributed as dist

    dist.barrier(group=comm.group)


# ----------------------------------------------------------------- async API

def allreduce_async(comm: Communicator, x: torch.Tensor, op: str = "sum",
                    groups: Groups = None) -> SynchronizationHandle:
    return _async(_issue_allreduce(_sub(comm, groups), x, op, True))


def broadcast_async(comm: Communicator, x: torch.Tensor, root: int = 0,
                    groups: Groups = None) -> SynchronizationHandle:
    return _async(_issue_broadcast(_rooted(comm, groups, root), x, root,
                                   True))


def reduce_async(comm: Communicator, x: torch.Tensor, root: int = 0,
                 op: str = "sum", groups: Groups = None
                 ) -> SynchronizationHandle:
    return _async(_issue_reduce(_rooted(comm, groups, root), x, root, op,
                                True))


def allgather_async(comm: Communicator, x: torch.Tensor,
                    groups: Groups = None) -> SynchronizationHandle:
    return _async(_issue_allgather(_gathered(comm, groups), x, True))


def sendreceive_async(comm: Communicator, x: torch.Tensor, src: int,
                      dst: int) -> SynchronizationHandle:
    return _async(_issue_sendreceive(comm, x, src, dst, True))


# ------------------------------------------------------------ scalar forms

def _scalar(comm: Communicator, value, dtype) -> torch.Tensor:
    """This rank's value as a one-element tensor where the backend takes
    it: on the current card for NCCL, else on the host."""
    import torch.distributed as dist

    dev = "cuda" if dist.get_backend(comm.group) == "nccl" else "cpu"
    return torch.tensor([value], dtype=dtype, device=dev)


def allreduce_scalar(comm: Communicator, value, op: str = "sum",
                     dtype=torch.float64, groups: Groups = None):
    """This rank's one-element reduction, as a Python number."""
    return allreduce(comm, _scalar(comm, value, dtype), op=op,
                     groups=groups).item()


def broadcast_scalar(comm: Communicator, value, root: int = 0,
                     dtype=torch.float64, groups: Groups = None):
    """Position ``root``'s value, as a Python number."""
    return broadcast(comm, _scalar(comm, value, dtype), root=root,
                     groups=groups).item()


def reduce_scalar(comm: Communicator, value, root: int = 0, op: str = "sum",
                  dtype=torch.float64, groups: Groups = None):
    """The reduction on position ``root``; every other rank gets its own
    value back."""
    return reduce(comm, _scalar(comm, value, dtype), root=root, op=op,
                  groups=groups).item()


def sendreceive_scalar(comm: Communicator, value, src: int, dst: int,
                       dtype=torch.float64):
    """Rank ``dst`` gets rank ``src``'s value; every other rank its own."""
    return sendreceive(comm, _scalar(comm, value, dtype), src=src,
                       dst=dst).item()
