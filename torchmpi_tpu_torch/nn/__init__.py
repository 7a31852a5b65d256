"""NN-level synchronization: parameters, gradients and the replica check.

Counterpart of ``torchmpi_tpu/nn/__init__.py`` for one process per rank:
each process holds its own replica's tree (nested dicts and lists of
tensors) and every collective resolves through the selector per bucket, so
``use_pallas_collectives`` routes large buckets through the ring kernels.
The asynchronous backward (``nn.async_``) is not ported yet.
"""

from __future__ import annotations

from typing import Any

import torch

from ..runtime import communicator as _comm_mod
from ..utils import tree as _tree
from . import bucketing

__all__ = ["synchronize_parameters", "synchronize_gradients",
           "check_with_allreduce", "bucketing"]


def _comm(comm=None):
    return comm if comm is not None else _comm_mod.stack.current()


def _select(collective: str):
    from ..collectives import selector

    return selector.resolve(collective)


def synchronize_parameters(params: Any, comm=None, average: bool = False,
                           root: int = 0) -> Any:
    """Every replica's parameters made identical: rank ``root``'s values
    (``average=False``) or the mean over replicas, bucketed."""
    c = _comm(comm)
    if average:
        return bucketing.map_bucketed(
            lambda b: _select("allreduce")(c, b, op="mean"), params)
    return bucketing.map_bucketed(
        lambda b: _select("broadcast")(c, b, root=root), params)


def synchronize_gradients(grads: Any, comm=None, average: bool = True) -> Any:
    """Gradients summed (or averaged) over replicas, bucketed."""
    c = _comm(comm)
    op = "mean" if average else "sum"
    return bucketing.map_bucketed(
        lambda b: _select("allreduce")(c, b, op=op), grads)


def _replica_stats(leaf: torch.Tensor) -> torch.Tensor:
    flat = leaf.detach().to(torch.float64).reshape(-1)
    return torch.stack([flat.abs().mean(), flat.var(unbiased=False)])


def check_with_allreduce(params: Any, comm=None, tol: float = 1e-6) -> None:
    """Replica-consistency invariant: every rank's parameters have the same
    abs-mean and variance (in f64) as every other rank's, to a relative
    spread of ``tol``; ``tol=0`` asks for identical statistics.  Raises
    AssertionError naming the first leaf that differs."""
    from ..collectives import eager

    c = _comm(comm)
    leaves = _tree.leaves(params)
    if not leaves:
        return
    mine = torch.stack([_replica_stats(leaf) for leaf in leaves])
    stats = eager.allgather(c, mine).cpu()      # (p, n_leaves, 2)
    for i in range(len(leaves)):
        for col, name in ((0, "abs-mean"), (1, "variance")):
            vals = stats[:, i, col]
            spread = float(vals.max() - vals.min())
            denom = max(float(vals.abs().max()), 1e-30)
            if spread / denom > tol or (tol == 0 and spread != 0):
                raise AssertionError(
                    f"replica divergence on leaf {i}: {name} spread "
                    f"{spread:.3e} (rel {spread / denom:.3e} > {tol:g}); "
                    f"per-rank {name}s: {vals.tolist()}")
