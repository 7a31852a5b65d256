"""Collectives of the port: ``eager`` (over ``torch.distributed``), the ring
kernels (``cuda_ring``) and the ``selector`` between them.

The functions here are the user-facing tensor collectives of the JAX
package's ``collectives/__init__.py`` (``mpi.allreduce`` etc.): each takes
this rank's tensor and runs over the *current* communicator of the stack;
``async_`` holds the handle-returning forms.  A communicator split into
several intra groups (``push_communicator``) and the cursor over its levels
come with the hierarchical collectives (ROADMAP.md slice 3, item 4): until
then a collective over a split communicator raises, as do the v-forms and
the scalar collectives other than ``allreduce_scalar``.
"""

from __future__ import annotations

import torch

from ..runtime import communicator as _comm_mod
from ..runtime.handles import SynchronizationHandle
from . import cuda_ring, eager, selector  # noqa: F401

_LATER = eager._LATER


def _current() -> _comm_mod.Communicator:
    comm = _comm_mod.stack.current()
    if comm.num_groups > 1:
        raise NotImplementedError(
            f"a collective over {comm.describe()}, split into intra groups: "
            f"{_LATER}")
    return comm


def allreduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    return eager.allreduce(_current(), x, op=op)


def broadcast(x: torch.Tensor, root: int = 0) -> torch.Tensor:
    return eager.broadcast(_current(), x, root=root)


def reduce(x: torch.Tensor, root: int = 0, op: str = "sum") -> torch.Tensor:
    return eager.reduce(_current(), x, root=root, op=op)


def allgather(x: torch.Tensor) -> torch.Tensor:
    return eager.allgather(_current(), x)


def reduce_scatter(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    return eager.reduce_scatter(_current(), x, op=op)


def sendreceive(x: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    return eager.sendreceive(_current(), x, src=src, dst=dst)


def allreduce_scalar(value, op: str = "sum", dtype=None):
    kw = {} if dtype is None else {"dtype": dtype}
    return eager.allreduce_scalar(_current(), value, op=op, **kw)


allgatherv = eager.allgatherv
alltoall = eager.alltoall
broadcast_scalar = eager._later("broadcast_scalar")
reduce_scalar = eager._later("reduce_scalar")
sendreceive_scalar = eager._later("sendreceive_scalar")


class _AsyncNamespace:
    """``mpi.async_.*``: the same collectives, returning a
    :class:`SynchronizationHandle` whose ``wait()`` gives the result."""

    @staticmethod
    def allreduce(x: torch.Tensor, op: str = "sum") -> SynchronizationHandle:
        return eager.allreduce_async(_current(), x, op=op)

    @staticmethod
    def broadcast(x: torch.Tensor, root: int = 0) -> SynchronizationHandle:
        return eager.broadcast_async(_current(), x, root=root)

    @staticmethod
    def reduce(x: torch.Tensor, root: int = 0,
               op: str = "sum") -> SynchronizationHandle:
        return eager.reduce_async(_current(), x, root=root, op=op)

    @staticmethod
    def allgather(x: torch.Tensor) -> SynchronizationHandle:
        return eager.allgather_async(_current(), x)

    @staticmethod
    def sendreceive(x: torch.Tensor, src: int,
                    dst: int) -> SynchronizationHandle:
        return eager.sendreceive_async(_current(), x, src=src, dst=dst)


async_ = _AsyncNamespace()

__all__ = [
    "allreduce", "broadcast", "reduce", "allgather", "allgatherv",
    "reduce_scatter", "sendreceive", "alltoall", "async_",
    "allreduce_scalar", "broadcast_scalar", "reduce_scalar",
    "sendreceive_scalar", "cuda_ring", "eager", "selector",
]
