"""Collectives over mesh axes: the TorchMPI collective vocabulary by axis
name, for the model code of the mesh paths.

Counterpart of ``torchmpi_tpu/collectives/innerjit.py``.  There these are
``lax`` primitives inside a ``shard_map`` body, and XLA's own collectives
carry them.  Here every rank runs its own part of the program and calls
them on its own tensors; each names one or more axes of a
:class:`~torchmpi_tpu_torch.parallel.mesh.Mesh` (passed as ``mesh=``, or
the one entered with ``with mesh:``) and runs in this rank's group over
those axes, through ``torch.distributed`` (``collectives/eager.py``; gloo
stages a CUDA tensor through the host, the wire buffer only).  A group of
one rank makes no call.

Differentiable, as their JAX forms are transposed in the mesh bodies:
:func:`ring_shift` (its backward is the reverse shift), :func:`allgather`
(the reduce-scatter), :func:`reduce_scatter` (the all-gather) and
:func:`alltoall` (the inverse exchange).  The others refuse a tensor that
needs a gradient: the tensor-parallel wires that need one have their own
backward (``parallel/tp.py``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from ..parallel.mesh import Mesh, current_mesh
from ..runtime.communicator import Communicator
from . import eager

AxisName = Union[str, Sequence[str]]


def _mesh(mesh: Optional[Mesh]) -> Mesh:
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise RuntimeError("no mesh: pass mesh= or call inside `with mesh:`")
    return mesh


def axis_comm(axis: AxisName, mesh: Optional[Mesh] = None) -> Communicator:
    """This rank's communicator over ``axis``."""
    return _mesh(mesh).comm(axis)


def _no_grad_guard(name: str, x: torch.Tensor) -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError(
            f"innerjit.{name} is not differentiable; use it on a tensor "
            f"that needs no gradient (parallel.tp.block_input/block_output "
            f"are the tensor-parallel wires with a backward)")


def allreduce(x: torch.Tensor, axis: AxisName, op: str = "sum",
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """psum/pmax/pmin/pmean over mesh axes (reference: allreduceTensor);
    the mean multiplies by the f32 reciprocal of the group's size, as XLA
    compiles JAX's ``pmean``."""
    _no_grad_guard("allreduce", x)
    comm = axis_comm(axis, mesh)
    if comm.size == 1:
        eager._dist_op(op)
        return x.clone()
    return eager.allreduce(comm, x, op=op)


def broadcast(x: torch.Tensor, axis: AxisName, root: int = 0,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Position ``root``'s tensor along ``axis`` (reference:
    broadcastTensor)."""
    _no_grad_guard("broadcast", x)
    comm = axis_comm(axis, mesh)
    if comm.size == 1:
        return x.clone()
    return eager.broadcast(comm, x, root=root)


def reduce(x: torch.Tensor, axis: AxisName, root: int = 0, op: str = "sum",
           mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Reduce-to-root; non-roots keep their input (reference:
    reduceTensor)."""
    _no_grad_guard("reduce", x)
    s = allreduce(x, axis, op, mesh=mesh)
    return s if axis_rank(axis, mesh) == root else x.clone()


def _gather_parts(x: torch.Tensor, comm: Communicator) -> List[torch.Tensor]:
    """Every rank's ``x`` in the group's order."""
    if comm.size == 1:
        return [x]
    return list(eager.allgather(comm, x.contiguous()).unbind(0))


def _scatter_sum(x: torch.Tensor, comm: Communicator, dim: int
                 ) -> torch.Tensor:
    """This rank's part (of ``comm.size`` along ``dim``) of the group's sum
    of ``x``."""
    p = comm.size
    if p == 1:
        return x.clone()
    parts = torch.stack(x.chunk(p, dim=dim))       # (p, *part)
    mine = eager.reduce_scatter(comm, parts.reshape(-1), op="sum")
    return mine.view(parts.shape[1:])


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim, tiled):
        ctx.comm, ctx.dim, ctx.tiled = comm, dim, tiled
        parts = _gather_parts(x, comm)
        return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)

    @staticmethod
    def backward(ctx, g):
        if not ctx.tiled:
            part = _scatter_sum(g.movedim(ctx.dim, 0).contiguous(),
                                ctx.comm, 0)
            return part[0], None, None, None
        return _scatter_sum(g.contiguous(), ctx.comm, ctx.dim), None, None, \
            None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return _scatter_sum(x.contiguous(), comm, dim)

    @staticmethod
    def backward(ctx, g):
        return torch.cat(_gather_parts(g, ctx.comm), ctx.dim), None, None


def allgather(x: torch.Tensor, axis: AxisName, concat_axis: int = 0,
              tiled: bool = True, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The group's tensors in order, concatenated along ``concat_axis``
    (``tiled``) or stacked on a new axis there; backward: the
    reduce-scatter of the gradient."""
    comm = axis_comm(axis, mesh)
    dim = concat_axis % (x.dim() + (0 if tiled else 1))
    return _AllGather.apply(x, comm, dim, tiled)


def reduce_scatter(x: torch.Tensor, axis: AxisName, scatter_axis: int = 0,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """This rank's part along ``scatter_axis`` of the group's sum (tiled,
    ``psum_scatter``); backward: the all-gather of the gradient."""
    comm = axis_comm(axis, mesh)
    return _ReduceScatter.apply(x, comm, scatter_axis % x.dim())


def _alltoall(x: torch.Tensor, comm: Communicator, split: int,
              concat: int) -> torch.Tensor:
    p = comm.size
    if p == 1:
        return x.clone()
    if x.shape[split] % p:
        raise ValueError(f"alltoall: dim {split} of size {x.shape[split]} "
                         f"not divisible by {p}")
    send = torch.stack(x.chunk(p, dim=split)).contiguous()   # (p, *chunk)
    recv = eager.alltoall(comm, send)                        # row i from i
    return torch.cat(list(recv.unbind(0)), dim=concat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, split, concat):
        ctx.comm, ctx.split, ctx.concat = comm, split, concat
        return _alltoall(x, comm, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (_alltoall(g.contiguous(), ctx.comm, ctx.concat, ctx.split),
                None, None, None)


def alltoall(x: torch.Tensor, axis: AxisName, split_axis: int,
             concat_axis: int, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Tiled all-to-all: ``x`` cut into p chunks along ``split_axis``,
    chunk j to rank j, the received chunks concatenated along
    ``concat_axis`` in rank order; backward: the inverse exchange."""
    comm = axis_comm(axis, mesh)
    return _AllToAll.apply(x, comm, split_axis % x.dim(),
                           concat_axis % x.dim())


def exchange(sends: Sequence[Tuple[int, torch.Tensor]],
             recvs: Sequence[Tuple[int, torch.Tensor]],
             comm: Communicator) -> List[torch.Tensor]:
    """Point-to-point sends and receives among the positions of ``comm``,
    all issued before any is waited (``batch_isend_irecv``), so that pairs
    of ranks sending to each other cannot block one another.  ``recvs``
    give the source and a tensor of the shape and dtype to receive;
    returns the received tensors on their devices.  gloo stages CUDA
    tensors through the host."""
    import torch.distributed as dist

    group = comm.group
    ops, bufs = [], []
    for dst, t in sends:
        buf = (t.cpu() if eager._host_staged(group, t) else t).contiguous()
        bufs.append(buf)
        ops.append(dist.P2POp(dist.isend, buf, comm.global_rank(dst), group))
    outs = []
    for src, like in recvs:
        host = eager._host_staged(group, like)
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if host else like.device)
        outs.append((buf, like.device))
        ops.append(dist.P2POp(dist.irecv, buf, comm.global_rank(src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [b.to(dev) for b, dev in outs]


def shift_raw(tensors: Sequence[torch.Tensor], comm: Communicator,
              shift: int = 1) -> List[torch.Tensor]:
    """Each tensor to position ``rank + shift`` of ``comm`` and from
    ``rank - shift``, all in one batch of sends and receives (no
    autograd)."""
    p = comm.size
    if shift % p == 0:
        return [t.clone() for t in tensors]
    me = comm.rank
    dst, src = (me + shift) % p, (me - shift) % p
    return exchange([(dst, t) for t in tensors],
                    [(src, t) for t in tensors], comm)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, shift):
        ctx.comm, ctx.shift = comm, shift
        return shift_raw([x], comm, shift)[0]

    @staticmethod
    def backward(ctx, g):
        return shift_raw([g.contiguous()], ctx.comm, -ctx.shift)[0], None, None


def ring_shift(x: torch.Tensor, axis: AxisName, shift: int = 1,
               mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Neighbour exchange around the ring: the tensor of position
    ``rank - shift`` (the primitive behind the reference's chunked ring
    schedule and behind ring attention); backward: the reverse shift."""
    return _RingShift.apply(x, axis_comm(axis, mesh), shift)


def sendreceive(x: torch.Tensor, axis: AxisName, perm,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """ppermute: ``perm`` is (src, dst) pairs of positions along ``axis``;
    a rank that is no pair's destination receives zeros (XLA's
    semantics)."""
    _no_grad_guard("sendreceive", x)
    comm = axis_comm(axis, mesh)
    me = comm.rank
    perm = [(int(s) % comm.size, int(d) % comm.size) for s, d in perm]
    if comm.size == 1:
        return x.clone() if (0, 0) in perm else torch.zeros_like(x)
    sends = [(d, x) for s, d in perm if s == me and d != me]
    srcs = [s for s, d in perm if d == me]
    if len(srcs) > 1:
        raise ValueError(f"sendreceive: position {me} has several sources")
    if srcs and srcs[0] == me:
        got = [x.clone()]
        exchange(sends, [], comm)
    else:
        got = exchange(sends, [(srcs[0], x)] if srcs else [], comm)
    return got[0] if srcs else torch.zeros_like(x)


def axis_rank(axis: AxisName, mesh: Optional[Mesh] = None) -> int:
    return _mesh(mesh).axis_index(axis)


def axis_size(axis: AxisName, mesh: Optional[Mesh] = None) -> int:
    return _mesh(mesh).axis_size(axis)
