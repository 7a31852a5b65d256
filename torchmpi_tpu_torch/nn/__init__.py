"""NN-level synchronization: parameters, gradients and the replica check.

Counterpart of ``torchmpi_tpu/nn/__init__.py`` for one process per rank:
each process holds its own replica's tree (nested dicts and lists of
tensors) and every collective resolves through the selector per bucket, so
``use_pallas_collectives`` routes large buckets through the ring kernels.
``async_`` dispatches a step's gradient buckets as async allreduces in ready
order and drains them at a barrier or bucket by bucket at the optimizer.
"""

from __future__ import annotations

import time
from typing import Any, Callable, List, Optional

import torch

from ..runtime import communicator as _comm_mod
from ..runtime import config
from ..runtime.handles import SynchronizationHandle, wait_all
from ..utils import tree as _tree
from . import bucketing

__all__ = ["synchronize_parameters", "synchronize_gradients",
           "check_with_allreduce", "async_", "bucketing"]


def _comm(comm=None):
    return comm if comm is not None else _comm_mod.stack.current()


def _select(collective: str, mode: str = "sync", payload=None):
    """The selector's executable for one bucket: with the bucket as the
    payload, a measured ``autotune_mode`` picks a namespace per (op,
    dtype, bytes-bucket) cell; ``off`` resolves every bucket through the
    static table."""
    from ..collectives import selector

    return selector.resolve(collective, mode=mode, payload=payload)


def synchronize_parameters(params: Any, comm=None, average: bool = False,
                           root: int = 0) -> Any:
    """Every replica's parameters made identical: rank ``root``'s values
    (``average=False``) or the mean over replicas, bucketed."""
    c = _comm(comm)
    if average:
        return bucketing.map_bucketed(
            lambda b: _select("allreduce", payload=b)(c, b, op="mean"),
            params)
    return bucketing.map_bucketed(
        lambda b: _select("broadcast", payload=b)(c, b, root=root), params)


def synchronize_gradients(grads: Any, comm=None, average: bool = True) -> Any:
    """Gradients summed (or averaged) over replicas, bucketed."""
    c = _comm(comm)
    op = "mean" if average else "sum"
    return bucketing.map_bucketed(
        lambda b: _select("allreduce", payload=b)(c, b, op=op), grads)


class _AsyncNN:
    """The asynchronous gradient sync (the reference's async backward).

    :meth:`register_async_backward` dispatches a step's gradient buckets as
    async allreduces in ready order and returns a :class:`Registration`;
    :meth:`synchronize_gradients` drains it at a barrier,
    :meth:`drain_at_optimizer` bucket by bucket into the update."""

    class Registration:
        def __init__(self, handles: List[SynchronizationHandle], plan,
                     passthrough: Any = None, dispatch=None):
            self.handles = handles        # aligned with dispatch.order
            self.plan = plan
            self.dispatch = dispatch      # bucketing.DispatchPlan
            self.passthrough = passthrough
            # Seconds the draining thread sat inside handle waits (not the
            # update work between them), written by the drains.
            self.blocked_s = 0.0

        @property
        def skipped(self) -> bool:
            return self.plan is None

    def register_async_backward(self, grads: Any, comm=None,
                                average: bool = True,
                                step: Optional[int] = None) -> "Registration":
        """Dispatch this step's gradient buckets (:func:`bucketing.
        plan_ready_order`) as async allreduces, ready order first, each
        resolved through the selector's async cell with itself as the
        payload.

        With ``step`` given and ``sync_gradient_frequency`` N > 1, only
        every N-th step dispatches; the others pass this rank's gradients
        through unsynchronized."""
        freq = int(config.get("sync_gradient_frequency"))
        if step is not None and freq > 1 and step % freq != 0:
            return self.Registration([], None, passthrough=grads)
        c = _comm(comm)
        op = "mean" if average else "sum"
        dp = bucketing.plan_ready_order(grads)
        buckets = bucketing.flatten(grads, dp.plan)
        handles = [_select("allreduce", mode="async", payload=buckets[bi])(
            c, buckets[bi], op=op) for bi in dp.order]
        return self.Registration(handles, dp.plan, dispatch=dp)

    def synchronize_gradients(self, registration: "Registration") -> Any:
        """Barrier drain: wait every handle and return the synchronized
        gradient tree."""
        if registration.skipped:
            return registration.passthrough
        t0 = time.monotonic_ns()
        outs = wait_all(registration.handles)
        registration.blocked_s = (time.monotonic_ns() - t0) / 1e9
        by_bucket: List[Any] = [None] * len(outs)
        for k, bi in enumerate(registration.dispatch.order):
            by_bucket[bi] = outs[k]
        return bucketing.unflatten(by_bucket, registration.plan)

    def drain_at_optimizer(self, registration: "Registration", params: Any,
                           leaf_update: Callable[[Any, Any], Any]) -> Any:
        """Wait the buckets in dispatch order and apply
        ``leaf_update(param, grad)`` to each bucket's parameters as soon as
        its collective completes, while later buckets stay in flight.  The
        same per-leaf update on the same reduced values as
        :meth:`synchronize_gradients` then a leafwise update, so the
        parameters are identical.  Returns the updated tree."""
        leaves_p, treedef = _tree.flatten(params)
        if registration.skipped:
            leaves_g = _tree.leaves(registration.passthrough)
            return _tree.unflatten(treedef, [
                leaf_update(p, g) for p, g in zip(leaves_p, leaves_g)])
        plan = registration.plan
        out = list(leaves_p)
        blocked_ns = 0
        for k, bi in enumerate(registration.dispatch.order):
            t0 = time.monotonic_ns()
            bucket = registration.handles[k].wait()
            blocked_ns += time.monotonic_ns() - t0
            spec = plan.specs[bi]
            for li, g in zip(spec.leaf_indices,
                             bucketing.unflatten_bucket(bucket, spec)):
                out[li] = leaf_update(leaves_p[li], g)
        registration.blocked_s = blocked_ns / 1e9
        return _tree.unflatten(treedef, out)


async_ = _AsyncNN()


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
