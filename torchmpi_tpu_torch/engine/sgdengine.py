"""AllReduceSGDEngine: the data-parallel training loop, one process per rank.

Counterpart of ``torchmpi_tpu/engine/sgdengine.py``.  Each process holds
its own replica of the parameters (a tree of tensors), takes its own row r
of every rank-major batch ``(p, b, ...)``, computes the loss and gradients
of that shard, syncs the gradients and applies SGD (``p - lr * g``).  Three
modes are ported:

* ``compiled`` with ``use_pallas_collectives`` on: the JAX ring-synced
  step (``ring_synced_grads``).  Every gradient leaf of at least
  ``small_allreduce_size_gpu`` elements rings on its own (flattened, no
  concatenate); the smaller leaves pack into one flat tail bucket per
  dtype, in tree order; each ring is an ``inner_ring_allreduce`` with
  ``mean=True`` and collective id ``CALLER_COLLECTIVE_ID_BASE + n % 8``,
  one after another on one stream, the large leaves first.  Batch norm
  takes this rank's batch statistics, as inside the JAX ``shard_map`` body;
  the loss is the mean over ranks.
* ``eager_sync``: ``nn.synchronize_gradients`` (bucketed, through the
  selector) every step.
* ``eager_async``: ``nn.async_.register_async_backward`` dispatches the
  same buckets as async allreduces in ready order, then
  ``engine_async_drain`` drains them: ``"ready"`` updates each bucket's
  parameters as soon as its collective completes
  (``nn.async_.drain_at_optimizer``), ``"barrier"`` waits them all, then
  updates.  The parameters equal ``eager_sync``'s bit for bit;
  ``state["blocked_s"]`` holds the seconds the step sat in handle waits.

``compiled`` with the knob off is GSPMD over the global batch in JAX, so
batch norm there normalizes with cross-rank statistics; it raises here
until the slice that brings them.  ``optimizer=``, ``zero1`` and
``accum_steps`` raise and name their slice too.

Hooks (``on_start, on_start_epoch, on_sample, on_forward, on_backward,
on_update, on_end_epoch, on_end``) are called with the mutable ``state``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import nn as mpinn
from ..collectives import cuda_ring, eager
from ..runtime import communicator as _comm_mod
from ..runtime import config
from ..utils import tree as _tree
from ..utils.meters import AverageValueMeter

LossFn = Callable[[Any, Tuple[torch.Tensor, torch.Tensor]], torch.Tensor]
Hooks = Dict[str, Callable[[Dict[str, Any]], None]]

MODES = ("compiled", "eager_sync", "eager_async")
DRAINS = ("ready", "barrier")
_LATER = "comes with a later slice (ROADMAP.md slice 3, item 8)"


def sgd_update(params, grads, lr):
    """``p - lr * g`` leaf by leaf; new tensors."""
    with torch.no_grad():
        return _tree.tree_map(lambda p, g: p - lr * g, params, grads)


def value_and_grad(loss_fn: LossFn, params, batch):
    """(loss, grads) of ``loss_fn`` at ``params``: the grads as a tree of
    the params' structure."""
    leaves, treedef = _tree.flatten(params)
    leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
    loss = loss_fn(_tree.unflatten(treedef, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), _tree.unflatten(treedef, list(grads))


def ring_plan(leaves, cutoff: int):
    """The rings of one step over gradient leaves in tree order, as lists
    of leaf indices: every leaf of at least ``cutoff`` elements alone, in
    order, then one tail bucket per dtype of the smaller leaves, in order
    (the JAX engine's ``ring_synced_grads`` rule)."""
    big, small_by_dtype = [], {}
    for i, leaf in enumerate(leaves):
        if leaf.numel() >= cutoff:
            big.append([i])
        else:
            small_by_dtype.setdefault(leaf.dtype, []).append(i)
    return big + list(small_by_dtype.values())


def ring_synced_grads(loss_fn: LossFn, params, batch, comm):
    """This rank's loss and gradients, the gradients ring-allreduced to the
    replica mean and the loss averaged over ranks (the JAX engine's ring
    path, leaf for leaf)."""
    p = comm.size
    loss, grads = value_and_grad(loss_fn, params, batch)
    leaves, treedef = _tree.flatten(grads)
    synced = list(leaves)
    plan = ring_plan(leaves, int(config.get("small_allreduce_size_gpu")))
    for n, idxs in enumerate(plan):
        flat = torch.cat([leaves[i].reshape(-1) for i in idxs]) \
            if len(idxs) > 1 else leaves[idxs[0]].reshape(-1)
        flat = cuda_ring.inner_ring_allreduce(
            flat, p, mean=True,
            collective_id=cuda_ring.CALLER_COLLECTIVE_ID_BASE + n % 8,
            comm=comm)
        off = 0
        for i in idxs:
            sz = leaves[i].numel()
            synced[i] = flat[off:off + sz].view(leaves[i].shape)
            off += sz
    return eager.allreduce(comm, loss, op="mean"), _tree.unflatten(treedef,
                                                                   synced)


class AllReduceSGDEngine:
    """Data-parallel SGD loop; see the module docstring."""

    def __init__(self, loss_fn: LossFn, lr: float = 0.01, optimizer=None,
                 comm=None, mode: str = "compiled",
                 hooks: Optional[Hooks] = None,
                 sync_parameters_on_start: bool = True,
                 check_frequency: int = 0, zero1: bool = False,
                 accum_steps: int = 1):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}")
        if optimizer is not None:
            raise NotImplementedError(f"optimizer= {_LATER}; plain SGD runs")
        if zero1:
            raise NotImplementedError(f"zero1 {_LATER}")
        if accum_steps != 1:
            raise NotImplementedError(f"accum_steps {_LATER}")
        self.loss_fn = loss_fn
        self.lr = lr
        self.optimizer = None
        self._comm = comm
        self.mode = mode
        self.hooks = hooks or {}
        self.sync_parameters_on_start = sync_parameters_on_start
        self.check_frequency = check_frequency

    @property
    def comm(self):
        return self._comm if self._comm is not None else _comm_mod.stack.current()

    def _hook(self, name: str, state: Dict[str, Any]) -> None:
        fn = self.hooks.get(name)
        if fn is not None:
            fn(state)

    def _check_mode(self) -> None:
        if self.mode == "compiled" and not config.get("use_pallas_collectives"):
            raise NotImplementedError(
                "compiled mode with use_pallas_collectives off is GSPMD over "
                "the global batch in the JAX package: batch norm there "
                "normalizes with cross-rank statistics, which come with a "
                "later slice (ROADMAP.md slice 3, item 8); turn "
                "use_pallas_collectives on (per-rank statistics, the ring "
                "path) or use mode='eager_sync'")
        drain = config.get("engine_async_drain")
        if self.mode == "eager_async" and drain not in DRAINS:
            raise ValueError(f"engine_async_drain must be one of {DRAINS}, "
                             f"got {drain!r}")

    @staticmethod
    def _local(batch, rank: int, device: torch.device):
        """This rank's row of a rank-major ``(p, b, ...)`` batch."""
        xb, yb = batch
        x = torch.as_tensor(xb[rank]).to(device, non_blocking=True)
        y = torch.as_tensor(yb[rank]).to(device, torch.long, non_blocking=True)
        return x, y

    def train(self, params: Any, iterator, epochs: int = 1,
              opt_state: Any = None, start_step: int = 0) -> Dict[str, Any]:
        """Run the loop; returns the final state.  ``params``: this rank's
        replica; ``iterator``: rank-major ``(x: (p, b, ...), y: (p, b))``
        batches, each rank taking its row."""
        self._check_mode()
        comm = self.comm
        device = _tree.leaves(params)[0].device
        state: Dict[str, Any] = {
            "params": params, "opt_state": opt_state, "epoch": 0,
            "t": int(start_step), "loss_meter": AverageValueMeter(),
            "engine": self, "training": True, "comm": comm,
        }
        if self.sync_parameters_on_start:
            state["params"] = mpinn.synchronize_parameters(params, comm)
        self._hook("on_start", state)
        for epoch in range(epochs):
            state["epoch"] = epoch
            state["loss_meter"].reset()
            self._hook("on_start_epoch", state)
            for batch in iterator:
                state["sample"] = batch
                self._hook("on_sample", state)
                local = self._local(batch, comm.rank, device)
                self._step(state, local)
                state["t"] += 1
                if (self.check_frequency and self.mode != "compiled"
                        and state["t"] % self.check_frequency == 0):
                    mpinn.check_with_allreduce(state["params"], comm)
                self._hook("on_update", state)
            self._hook("on_end_epoch", state)
        self._hook("on_end", state)
        return state

    def _step(self, state, local) -> None:
        comm = state["comm"]
        if self.mode == "compiled":
            loss, grads = ring_synced_grads(self.loss_fn, state["params"],
                                            local, comm)
            state["loss"] = loss
            self._hook("on_forward", state)
            self._hook("on_backward", state)
        else:
            loss, grads = value_and_grad(self.loss_fn, state["params"], local)
            state["loss"] = eager.allreduce(comm, loss, op="mean")
            self._hook("on_forward", state)
            if self.mode == "eager_async":
                state["loss_meter"].add(state["loss"])
                self._async_sync_and_update(state, grads, comm)
                return
            grads = mpinn.synchronize_gradients(grads, comm)
            self._hook("on_backward", state)
        state["loss_meter"].add(state["loss"])
        state["params"] = sgd_update(state["params"], grads, self.lr)

    def _async_sync_and_update(self, state, grads, comm) -> None:
        """eager_async: dispatch the buckets, then drain them as
        ``engine_async_drain`` says (the JAX engine's branch)."""
        reg = mpinn.async_.register_async_backward(grads, comm,
                                                   step=state["t"])
        self._hook("on_backward", state)
        if config.get("engine_async_drain") == "barrier":
            grads = mpinn.async_.synchronize_gradients(reg)
            state["params"] = sgd_update(state["params"], grads, self.lr)
        else:
            lr = self.lr
            with torch.no_grad():
                state["params"] = mpinn.async_.drain_at_optimizer(
                    reg, state["params"], lambda p, g: p - lr * g)
        state["blocked_s"] = reg.blocked_s

    def test(self, params: Any, iterator, metric_fn: LossFn) -> float:
        """Mean of ``metric_fn`` over the iterator: each rank on its row,
        averaged over ranks per batch."""
        comm = self.comm
        device = _tree.leaves(params)[0].device
        meter = AverageValueMeter()
        with torch.no_grad():
            for batch in iterator:
                val = metric_fn(params, self._local(batch, comm.rank, device))
                meter.add(eager.allreduce(comm, val.float().reshape(1),
                                          op="mean")[0])
        return meter.mean
