"""Collectives of the port: ``eager`` (over ``torch.distributed``), the ring
kernels (``cuda_ring``), the host plane's TCP rings (``hostcomm``), the
``hierarchical`` composition across a split's levels, the ``selector``
between them, and ``gspmd``, the global batch of the engine's GSPMD mode
(the gradients' mean over the ranks and the batch-norm statistics'
``global_batch`` context, which ``models/resnet.py`` reads).

The functions here are the user-facing tensor collectives of the JAX
package's ``collectives/__init__.py`` (``mpi.allreduce`` etc.): each takes
this rank's tensor (or value, for the scalar forms) and resolves the stack's
cursor (level, intra/inter, span) to the world communicator and the groups
it selects (``hierarchical.groups_for_cursor``); ``async_`` holds the
handle-returning forms.
"""

from __future__ import annotations

import torch

from ..runtime import communicator as _comm_mod
from ..runtime.handles import SynchronizationHandle
from . import cuda_ring, eager, gspmd, hierarchical, hostcomm, selector  # noqa: F401
from . import innerjit  # noqa: F401,E402


def _resolved():
    return hierarchical.groups_for_cursor(_comm_mod.stack)


def allreduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    comm, groups = _resolved()
    return eager.allreduce(comm, x, op=op, groups=groups)


def broadcast(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    comm, groups = _resolved()
    return eager.broadcast(comm, x, root=root, groups=groups)


def reduce(x: torch.Tensor, root: int = 0, op: str = "sum") -> torch.Tensor:
    comm, groups = _resolved()
    return eager.reduce(comm, x, root=root, op=op, groups=groups)


def allgather(x: torch.Tensor) -> torch.Tensor:
    comm, groups = _resolved()
    return eager.allgather(comm, x, groups=groups)


def allgatherv(x: torch.Tensor):
    """The allgather of uneven groups: ``(out, counts)``, zero rows past
    the group's size (the tree levels :func:`allgather` refuses)."""
    comm, groups = _resolved()
    return eager.allgatherv(comm, x, groups=groups)


def reduce_scatter(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    comm, groups = _resolved()
    return eager.reduce_scatter(comm, x, op=op, groups=groups)


def sendreceive(x: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    comm, _ = _resolved()
    return eager.sendreceive(comm, x, src=src, dst=dst)


def alltoall(x: torch.Tensor) -> torch.Tensor:
    comm, _ = _resolved()
    return eager.alltoall(comm, x)


def allreduce_scalar(value, op: str = "sum", dtype=None):
    comm, groups = _resolved()
    kw = {} if dtype is None else {"dtype": dtype}
    return eager.allreduce_scalar(comm, value, op=op, groups=groups, **kw)


def broadcast_scalar(value, root: int = 0, dtype=None):
    comm, groups = _resolved()
    kw = {} if dtype is None else {"dtype": dtype}
    return eager.broadcast_scalar(comm, value, root=root, groups=groups, **kw)


def reduce_scalar(value, root: int = 0, op: str = "sum", dtype=None):
    comm, groups = _resolved()
    kw = {} if dtype is None else {"dtype": dtype}
    return eager.reduce_scalar(comm, value, root=root, op=op, groups=groups,
                               **kw)


def sendreceive_scalar(value, src: int, dst: int, dtype=None):
    comm, _ = _resolved()
    kw = {} if dtype is None else {"dtype": dtype}
    return eager.sendreceive_scalar(comm, value, src=src, dst=dst, **kw)


class _AsyncNamespace:
    """``mpi.async_.*``: the same collectives, returning a
    :class:`SynchronizationHandle` whose ``wait()`` gives the result."""

    @staticmethod
    def allreduce(x: torch.Tensor, op: str = "sum") -> SynchronizationHandle:
        comm, groups = _resolved()
        return eager.allreduce_async(comm, x, op=op, groups=groups)

    @staticmethod
    def broadcast(x: torch.Tensor, root: int = 0) -> SynchronizationHandle:
        comm, groups = _resolved()
        return eager.broadcast_async(comm, x, root=root, groups=groups)

    @staticmethod
    def reduce(x: torch.Tensor, root: int = 0,
               op: str = "sum") -> SynchronizationHandle:
        comm, groups = _resolved()
        return eager.reduce_async(comm, x, root=root, op=op, groups=groups)

    @staticmethod
    def allgather(x: torch.Tensor) -> SynchronizationHandle:
        comm, groups = _resolved()
        return eager.allgather_async(comm, x, groups=groups)

    @staticmethod
    def sendreceive(x: torch.Tensor, src: int,
                    dst: int) -> SynchronizationHandle:
        comm, _ = _resolved()
        return eager.sendreceive_async(comm, x, src=src, dst=dst)


async_ = _AsyncNamespace()

__all__ = [
    "allreduce", "broadcast", "reduce", "allgather", "allgatherv",
    "reduce_scatter", "sendreceive", "alltoall", "async_",
    "allreduce_scalar", "broadcast_scalar", "reduce_scalar",
    "sendreceive_scalar", "cuda_ring", "eager", "gspmd", "hierarchical",
    "hostcomm", "selector",
]
