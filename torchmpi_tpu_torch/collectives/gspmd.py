"""The engine's ``compiled`` mode with ``use_pallas_collectives`` off: GSPMD
over the global batch, one process per rank.

In the JAX package this mode is one pjit'd program whose loss function sees
the global batch, so every reduction over the batch axis spans all ranks
and XLA inserts the gradient psums.  Here each rank runs its own rows, and
the two places where the global batch shows are made explicit:

* the gradients: :func:`sync_grads` averages them over the ranks with one
  ``torch.distributed`` allreduce a dtype, over a flat buffer of the leaves
  in tree order (through ``collectives/eager.py``), in place of XLA's fused
  psums; no ring kernel runs on this path;
* batch norm: while :func:`global_batch` is open, ``models/resnet.py``'s
  batch norm averages its per-channel ``(mean, E[x^2])`` pair over the
  ranks with :func:`mean_over_ranks`, whose backward is the same mean of
  the incoming gradient.  With equal rows per rank that is the JAX formula
  over the global batch.

Outside the context (the ring path, the eager modes) batch norm takes this
rank's statistics, as JAX's ``shard_map`` body and its eager loop do.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Iterator, List, Optional

import torch

from . import eager
from ..runtime.communicator import Communicator
from ..utils import tree as _tree

_active = threading.local()


@contextlib.contextmanager
def global_batch(comm: Optional[Communicator]) -> Iterator[None]:
    """Within the block, batch statistics span the ranks of ``comm``
    (nothing changes with ``None`` or one rank)."""
    prev = getattr(_active, "comm", None)
    _active.comm = comm if comm is not None and comm.size > 1 else None
    try:
        yield
    finally:
        _active.comm = prev


def current() -> Optional[Communicator]:
    """The communicator whose ranks' rows form the global batch, or None."""
    return getattr(_active, "comm", None)


class _MeanOverRanks(torch.autograd.Function):
    """The mean of a tensor over the ranks; its gradient is the mean over
    the ranks of the incoming gradient (the sum would give p times it)."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return eager.allreduce(comm, x, op="mean")

    @staticmethod
    def backward(ctx, g):
        return eager.allreduce(ctx.comm, g.contiguous(), op="mean"), None


def mean_over_ranks(x: torch.Tensor, comm: Communicator) -> torch.Tensor:
    """Differentiable mean of ``x`` over the ranks of ``comm``."""
    return _MeanOverRanks.apply(x, comm)


def allreduce_mean_leaves(leaves: List[torch.Tensor],
                          comm: Communicator) -> List[torch.Tensor]:
    """Each leaf averaged over the ranks: one allreduce a dtype over the
    leaves packed flat in order."""
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    for idx in _tree.by_dtype(leaves):
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        eager.allreduce_(comm, flat, op="mean")
        off = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = flat[off:off + n].view(leaves[i].shape)
            off += n
    return out


def sync_grads(grads: Any, comm: Communicator) -> Any:
    """The gradient tree averaged over the ranks (XLA's psums of the
    global-batch gradient)."""
    if comm.size == 1:
        return grads
    leaves, treedef = _tree.flatten(grads)
    return _tree.unflatten(treedef, allreduce_mean_leaves(leaves, comm))
