"""AllReduceSGDEngine: the data-parallel training loop, one process per rank.

Counterpart of ``torchmpi_tpu/engine/sgdengine.py``.  Each process holds
its own replica of the parameters (a tree of tensors), takes its own row r
of every rank-major batch ``(p, b, ...)``, computes the loss and gradients
of that shard, syncs the gradients and applies SGD (``p - lr * g``) or, in
``compiled`` mode, the ``optimizer`` (an optax-shaped one from
``torchmpi_tpu_torch.optim``: ``update`` then ``p + u``).  Three modes:

* ``compiled`` with ``use_pallas_collectives`` on: the JAX ring-synced
  step (``local_grads`` then ``ring_sync``).  Every gradient leaf of at least
  ``small_allreduce_size_gpu`` elements rings on its own (flattened, no
  concatenate); the smaller leaves pack into one flat tail bucket per
  dtype, in tree order; each ring is an ``inner_ring_allreduce`` with
  ``mean=True`` and collective id ``CALLER_COLLECTIVE_ID_BASE + n % 8``,
  one after another on one stream, the large leaves first.  Batch norm
  takes this rank's batch statistics, as inside the JAX ``shard_map`` body;
  the loss is the mean over ranks.
* ``compiled`` with the knob off: GSPMD over the global batch
  (``collectives/gspmd.py``).  The loss runs inside ``gspmd.global_batch``, so
  batch norm averages its statistics over the ranks, and the gradients are
  averaged with one ``torch.distributed`` allreduce a dtype; no ring
  kernel runs.  JAX's ``engine_update_barrier`` knob, a fence against
  XLA's fusion of the update into the backward, has no counterpart: eager
  PyTorch fuses nothing.
* ``eager_sync``: ``nn.synchronize_gradients`` (bucketed, through the
  selector) every step.
* ``eager_async``: ``nn.async_.register_async_backward`` dispatches the
  same buckets as async allreduces in ready order, then
  ``engine_async_drain`` drains them: ``"ready"`` updates each bucket's
  parameters as soon as its collective completes
  (``nn.async_.drain_at_optimizer``), ``"barrier"`` waits them all, then
  updates.  The parameters equal ``eager_sync``'s bit for bit;
  ``state["blocked_s"]`` holds the seconds the step sat in handle waits.

The eager modes apply plain SGD whatever ``optimizer`` is, as the JAX
engine's do.  Options of ``compiled`` mode, as in JAX:

* ``accum_steps`` A: this rank's batch splits into A equal slices (JAX's
  ``local_grads_of``: a rank's rows are already the device-local cut), the
  gradients accumulate in f32 and the mean over the slices is synced once,
  with one update per batch;
* ``zero1`` (needs an optimizer): the optimizer state is sharded over the
  ranks.  A state leaf whose leading dimension is at least p and divisible
  by p lives as this rank's row block, the rest (the count) replicated; it
  is born so (``init`` runs on the parameters' row blocks).  A step
  reduce-scatters the gradients of those leaves into this rank's block (as
  a mean), allreduces the rest, updates each block with its state and
  all-gathers the updated rows into every rank's parameters: one
  reduce-scatter and one all-gather a dtype, through ``torch.distributed``
  whatever ``use_pallas_collectives`` says (JAX's zero1 ignores the knob),
  and the loss sees the global batch as in GSPMD mode.  A full state given
  to ``train`` (a restore) is cut to this rank's blocks;
  :meth:`AllReduceSGDEngine.full_opt_state` gathers it back, which the
  checkpoint hooks do before a save.

In ``compiled`` mode ``train()`` and ``test()`` read their iterator
through ``data.engine_wrap``, as the JAX engine does: under the default
``data_pipeline="auto"`` a ``DataPipeline`` stages each batch on the device
ahead of the step, and ``"off"`` stages it inside the step; both place it
through ``data.stage_rank_major``, so the values are the same bit for bit.
``sample_array`` gives a hook this rank's batch either way.

Hooks (``on_start, on_start_epoch, on_sample, on_forward, on_backward,
on_update, on_end_epoch, on_end``) are called with the mutable ``state``.

The live feed (``obs/serve.py``), as in JAX: under the
``obs/serve.metrics_feed`` gate every step publishes its time, examples/s,
staged bytes, overlap fraction and phase decomposition
(``tmpi_step_phase_seconds{phase=data_wait|dispatch|collective|optimizer|ps}``)
through ``obs/serve.publish_step``, which beats the ``engine_step`` health
mark; with the gate shut a step only beats the mark.  ``train`` clears the
mark when it returns, so a loop that ended does not read as stalled.

The numerics plane (``obs/numerics.py``), as in JAX: with
``numerics_mode`` ``sentinel`` or ``audit`` a ``compiled`` step computes
``sentinel_stats`` over the synced gradients and the applied update (under
zero1 over the synced row blocks, summed over the ranks) and publishes
them through ``publish_step``; ``"off"`` adds no launch and no host read.
An installed ``numerics_auditor`` (an ``obs.numerics.Auditor`` over a host
ring) is consulted after every step and audits in ``audit`` mode on its
cadence.  Under the feed gate the first ``compiled`` step runs under the
FLOP probe (``numerics.probe_step_flops``), and the later steps publish
``tmpi_step_flops`` and ``tmpi_mfu_estimate`` (``numerics.publish_flops``);
the probed step, slowed by the counter, publishes no MFU.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import nn as mpinn
from .. import optim
from ..collectives import cuda_ring, eager, gspmd
from ..data.pipeline import engine_wrap
from ..data.staging import Staged, stage_rank_major
from ..obs import native as _obs_native
from ..obs import numerics as _numerics
from ..obs import serve as _obs_serve
from ..runtime import communicator as _comm_mod
from ..runtime import config
from ..utils import tree as _tree
from ..utils.meters import AverageValueMeter

LossFn = Callable[[Any, Tuple[torch.Tensor, torch.Tensor]], torch.Tensor]
Hooks = Dict[str, Callable[[Dict[str, Any]], None]]

MODES = ("compiled", "eager_sync", "eager_async")
DRAINS = ("ready", "barrier")


def sgd_update(params, grads, lr):
    """``p - lr * g`` leaf by leaf; new tensors."""
    with torch.no_grad():
        return _tree.tree_map(lambda p, g: p - lr * g, params, grads)


def sample_array(state, rank: Optional[int] = None):
    """This rank's ``(x, y)`` of ``state["sample"]`` whichever way
    ``data_pipeline`` is set: a ``Staged`` payload (the pipeline's) gives
    its tensor, a rank-major host batch its row ``rank`` (default:
    ``state["comm"].rank``).  Accepts the engine ``state`` or a bare
    ``(x, y)`` pair.  (The JAX ``sample_array`` returns the global batch;
    here a rank holds only its own row, so that row is the one layout both
    modes share.)"""
    if isinstance(state, dict):
        sample = state["sample"]
        rank = state["comm"].rank if rank is None else rank
    else:
        sample = state

    def unwrap(a):
        return a.array if isinstance(a, Staged) else a[rank]

    xb, yb = sample
    return unwrap(xb), unwrap(yb)


def value_and_grad(loss_fn: LossFn, params, batch):
    """(loss, grads) of ``loss_fn`` at ``params``: the grads as a tree of
    the params' structure."""
    leaves, treedef = _tree.flatten(params)
    leaves = [leaf.detach().requires_grad_(True) for leaf in leaves]
    loss = loss_fn(_tree.unflatten(treedef, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), _tree.unflatten(treedef, list(grads))


def local_grads(loss_fn: LossFn, params, batch, accum_steps: int = 1,
                replicas: Optional[int] = None):
    """(loss, grads) of this rank's batch; with ``accum_steps`` A > 1 the
    batch splits into A equal slices along its first axis, the slices'
    losses and gradients summed in f32 and divided by A, the gradients
    then cast to their parameter's dtype (JAX's ``accum_scan``).
    ``replicas`` (the GSPMD path) words the divisibility error over the
    global batch, as JAX's ``grads_of`` does."""
    A = accum_steps
    if A == 1:
        return value_and_grad(loss_fn, params, batch)
    x, y = batch
    b = x.shape[0]
    if b % A:
        if replicas is not None:
            raise ValueError(
                f"global batch {b * replicas} must be divisible by "
                f"accum_steps * replicas = {A} * {replicas}")
        raise ValueError(f"per-replica batch {b} must be divisible by "
                         f"accum_steps = {A}")
    xs = x.reshape(A, b // A, *x.shape[1:])
    ys = y.reshape(A, b // A, *y.shape[1:])
    g_acc, l_acc = None, None
    for a in range(A):
        loss, grads = value_and_grad(loss_fn, params, (xs[a], ys[a]))
        g = [t.float() for t in _tree.leaves(grads)]
        g_acc = g if g_acc is None else torch._foreach_add(g_acc, g)
        l_acc = loss.float() if l_acc is None else l_acc + loss.float()
    leaves, treedef = _tree.flatten(params)
    return l_acc / A, _tree.unflatten(treedef, [
        (t / A).to(p.dtype) for t, p in zip(g_acc, leaves)])


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


def ring_sync(loss, grads, comm):
    """This rank's gradients ring-allreduced to the replica mean by
    :func:`ring_plan` and its loss averaged over ranks: after
    :func:`local_grads`, the JAX engine's ring path (``ring_synced_grads``),
    leaf for leaf."""
    p = comm.size
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


class _StepClock:
    """Wall seconds of one step by phase (``obs/alerts.PHASES``): each
    :meth:`mark` charges the time since the last mark to a phase.  Made
    only under the live-feed gate."""

    __slots__ = ("t0", "last", "phases")

    def __init__(self) -> None:
        self.t0 = self.last = time.monotonic_ns()
        self.phases = {"data_wait": 0.0, "dispatch": 0.0, "collective": 0.0,
                       "optimizer": 0.0, "ps": 0.0, "hooks": 0.0}

    def mark(self, phase: str) -> None:
        now = time.monotonic_ns()
        self.phases[phase] += (now - self.last) / 1e9
        self.last = now


def _mark(clock: Optional[_StepClock], phase: str) -> None:
    if clock is not None:
        clock.mark(phase)


# ------------------------------------------------------------------ zero1

def zero1_sharded(shape, p: int) -> bool:
    """The zero1 rule (JAX ``_opt_state_shardings``): a leaf whose leading
    dimension is at least p and divisible by p is sharded by rows."""
    return len(shape) >= 1 and shape[0] >= p and shape[0] % p == 0


def _rows(t: torch.Tensor, rank: int, p: int) -> torch.Tensor:
    n = t.shape[0] // p
    return t[rank * n:(rank + 1) * n]


def _reduce_scatter_rows(comm, leaves, idxs) -> Dict[int, torch.Tensor]:
    """This rank's row block of the ranks' mean of each leaf in ``idxs``:
    one reduce-scatter a dtype over the leaves packed rank-major."""
    p, out = comm.size, {}
    for group in _tree.by_dtype(leaves, idxs):
        packed = torch.cat([leaves[i].reshape(p, -1) for i in group], dim=1)
        mine = eager.reduce_scatter(comm, packed.reshape(-1), op="mean")
        off = 0
        for i in group:
            t = leaves[i]
            n = t.numel() // p
            out[i] = mine[off:off + n].view(t.shape[0] // p, *t.shape[1:])
            off += n
    return out


def _allgather_rows(comm, blocks, idxs) -> Dict[int, torch.Tensor]:
    """Every rank's row block of each leaf in ``idxs`` stacked into the
    whole leaf: one all-gather a dtype over the blocks packed flat."""
    p, out = comm.size, {}
    for group in _tree.by_dtype(blocks, idxs):
        packed = torch.cat([blocks[i].reshape(-1) for i in group])
        every = eager.allgather(comm, packed).reshape(p, -1)
        off = 0
        for i in group:
            b = blocks[i]
            n = b.numel()
            out[i] = every[:, off:off + n].reshape(p * b.shape[0],
                                                   *b.shape[1:])
            off += n
    return out


def _zero1_sentinels(comm, grads, plan, g_mine, updates, p_mine):
    """``numerics.sentinel_stats`` of a zero1 step over the whole tree:
    each leaf's squared norms (gradient, update, parameter) and non-finite
    count, on the synced row block of a sharded leaf (``plan``) and on the
    whole synced leaf otherwise, summed over the ranks in one allreduce
    (a whole leaf counted on rank 0 alone), then folded into the gradient
    buckets as ``sentinel_stats`` folds them."""
    from ..nn import bucketing

    def sq(leaves):
        return torch.stack([t.float().square().sum() for t in leaves])

    n = len(g_mine)
    bad = torch.stack([(t.numel() - torch.isfinite(t).sum()).float()
                       for t in g_mine])
    weight = torch.tensor([1.0 if s or comm.rank == 0 else 0.0
                           for s in plan], device=bad.device)
    per_leaf = torch.cat([sq(g_mine), bad, sq(updates), sq(p_mine)])
    per_leaf = eager.allreduce(comm, per_leaf * weight.repeat(4),
                               op="sum").view(4, n)
    g_sq, bad, u_sq, p_sq = per_leaf
    buckets = bucketing.plan_buckets(grads)
    owner = torch.empty(n, dtype=torch.long)
    for b, spec in enumerate(buckets.specs):
        owner[list(spec.leaf_indices)] = b
    bucket_sq = torch.zeros(len(buckets.specs), device=g_sq.device)
    bucket_sq.index_add_(0, owner.to(g_sq.device), g_sq)
    return {"bucket_grad_norms": bucket_sq.sqrt(),
            "grad_norm": g_sq.sum().sqrt(),
            "nonfinite_count": bad.sum().to(torch.int32),
            "update_ratio": u_sq.sum().sqrt()
            / p_sq.sum().sqrt().clamp_min(1e-12)}


class AllReduceSGDEngine:
    """Data-parallel training loop; see the module docstring."""

    def __init__(self, loss_fn: LossFn, lr: float = 0.01, optimizer=None,
                 comm=None, mode: str = "compiled",
                 hooks: Optional[Hooks] = None,
                 sync_parameters_on_start: bool = True,
                 check_frequency: int = 0, zero1: bool = False,
                 accum_steps: int = 1):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}")
        if zero1 and mode != "compiled":
            raise ValueError("zero1 requires compiled mode")
        if zero1 and optimizer is None:
            raise ValueError(
                "zero1 shards optimizer state; pass an optax optimizer "
                "(plain SGD keeps no state to shard)")
        if accum_steps < 1:
            raise ValueError("accum_steps must be >= 1")
        if accum_steps > 1 and mode != "compiled":
            raise ValueError("accum_steps requires compiled mode")
        self.loss_fn = loss_fn
        self.lr = lr
        self.optimizer = optimizer
        self._comm = comm
        self.mode = mode
        self.hooks = hooks or {}
        self.sync_parameters_on_start = sync_parameters_on_start
        self.check_frequency = check_frequency
        self.zero1 = zero1
        self.accum_steps = accum_steps
        # Elastic resize (runtime/resize.py): an installed
        # ResizeController is consulted once per step at the boundary.
        # DEPARTED ends train() with state["departed"]; COMMITTED ends it
        # with state["resized"] = the new epoch, for the caller to rebuild
        # the engine over the re-formed world.  A transport fault there
        # with an installed ElectionCoordinator (runtime/election.py) runs
        # its on_boundary_fault (a dead leader fails over, as a commit).
        self.resize_controller = None
        self.election_coordinator = None
        # Retune controller (collectives/retune.py): consulted at the same
        # boundary, after the resize one; it never raises or breaks the
        # loop.
        self.retune_controller = None
        # The numerics plane (obs/numerics.py): whether this train() call's
        # compiled steps compute the sentinels, and the optional cross-rank
        # auditor (an Auditor over a host ring) consulted after each step.
        self._sentinels_on = False
        self.numerics_auditor = None
        # The compiled step's FLOPs, probed on its first fed step; a new
        # step (another loss, optimizer, option or numerics mode) probes
        # again, as a JAX recompile does.
        self._step_flops = None
        self._flops_probed = False
        self._probe_key = None

    @property
    def comm(self):
        return self._comm if self._comm is not None else _comm_mod.stack.current()

    def _hook(self, name: str, state: Dict[str, Any]) -> None:
        fn = self.hooks.get(name)
        if fn is not None:
            fn(state)

    def _check_mode(self) -> None:
        drain = config.get("engine_async_drain")
        if self.mode == "eager_async" and drain not in DRAINS:
            raise ValueError(f"engine_async_drain must be one of {DRAINS}, "
                             f"got {drain!r}")

    def _rings(self) -> bool:
        """The compiled step rings its gradients (JAX: the knob, and not
        zero1)."""
        return bool(config.get("use_pallas_collectives")) and not self.zero1

    @staticmethod
    def _local(batch, rank: int, device: torch.device):
        """This rank's ``(x, y)`` on ``device``: a pre-staged pair (the data
        pipeline's) as it is, else this rank's row of a rank-major ``(p,
        b, ...)`` host batch, staged now; labels as int64."""
        xb, yb = batch
        x, _ = stage_rank_major(xb, device, rank)
        y, _ = stage_rank_major(yb, device, rank, dtype=torch.long)
        return x.array, y.array.long()

    # ---------------------------------------------------- optimizer state

    def _zero1_plan(self, params, comm) -> List[bool]:
        """Which parameter leaves (and so which of their optimizer state
        leaves) are sharded; none on one rank."""
        return [comm.size > 1 and zero1_sharded(t.shape, comm.size)
                for t in _tree.leaves(params)]

    def _init_opt_state(self, params, opt_state, comm, device):
        """The optimizer state a compiled ``train`` starts from: created by
        ``optimizer.init`` when not given (under zero1 on this rank's row
        blocks, never whole), else the given one on the parameters'
        device, cut to this rank's blocks under zero1."""
        if self.optimizer is None or self.mode != "compiled":
            return opt_state
        if opt_state is None:
            if not self.zero1:
                return self.optimizer.init(params)
            leaves, treedef = _tree.flatten(params)
            plan = self._zero1_plan(params, comm)
            return self.optimizer.init(_tree.unflatten(treedef, [
                _rows(t, comm.rank, comm.size) if s else t
                for t, s in zip(leaves, plan)]))
        opt_state = _tree.tree_map(lambda t: t.to(device), opt_state)
        if not self.zero1 or comm.size == 1:
            return opt_state
        full = _tree.leaves(self._abstract_opt_state(params))
        given, treedef = _tree.flatten(opt_state)
        p, r = comm.size, comm.rank
        out = []
        for f, g in zip(full, given):
            if zero1_sharded(f.shape, p) and tuple(g.shape) == tuple(f.shape):
                g = _rows(g, r, p).clone()
            elif zero1_sharded(f.shape, p) and g.shape[0] != f.shape[0] // p:
                raise ValueError(f"optimizer state leaf of shape "
                                 f"{tuple(g.shape)} is neither whole "
                                 f"{tuple(f.shape)} nor a row block of it")
            out.append(g)
        return _tree.unflatten(treedef, out)

    def _abstract_opt_state(self, params):
        """The whole optimizer state's leaves on the meta device: shapes
        and dtypes, no memory (JAX's ``eval_shape``)."""
        return self.optimizer.init(_tree.tree_map(
            lambda t: torch.empty_like(t, device="meta"), params))

    def full_opt_state(self, opt_state, params, comm=None):
        """The whole optimizer state on every rank: under zero1 each
        sharded leaf all-gathered from the ranks' row blocks (one
        all-gather a dtype; every rank must call this), else
        ``opt_state`` itself."""
        comm = comm if comm is not None else self.comm
        if not self.zero1 or opt_state is None or comm.size == 1:
            return opt_state
        full = _tree.leaves(self._abstract_opt_state(params))
        blocks, treedef = _tree.flatten(opt_state)
        idxs = [i for i, f in enumerate(full)
                if zero1_sharded(f.shape, comm.size)]
        gathered = _allgather_rows(comm, blocks, idxs)
        return _tree.unflatten(treedef, [gathered.get(i, b)
                                         for i, b in enumerate(blocks)])

    # -------------------------------------------------------------- train

    def train(self, params: Any, iterator, epochs: int = 1,
              opt_state: Any = None, start_step: int = 0) -> Dict[str, Any]:
        """Run the loop; returns the final state.  ``params``: this rank's
        replica; ``iterator``: rank-major ``(x: (p, b, ...), y: (p, b))``
        batches, each rank taking its row.  ``opt_state``: a state to
        resume from (whole, also under zero1); by default
        ``optimizer.init``'s."""
        self._check_mode()
        comm = self.comm
        device = _tree.leaves(params)[0].device
        if self.mode == "compiled":
            self._numerics_mode()
        state: Dict[str, Any] = {
            "params": params, "opt_state": opt_state, "epoch": 0,
            "t": int(start_step), "loss_meter": AverageValueMeter(),
            "engine": self, "training": True, "comm": comm,
        }
        if self.sync_parameters_on_start:
            state["params"] = mpinn.synchronize_parameters(params, comm)
        state["opt_state"] = self._init_opt_state(state["params"], opt_state,
                                                  comm, device)
        if self.mode == "compiled":
            # The input plane: batches arrive staged on the device by a
            # background thread, per the data_pipeline knob ("off" hands
            # the iterator back and each step stages its own batch).
            # state["sample"] then holds (Staged, Staged): hooks read it
            # through sample_array.
            iterator = engine_wrap(iterator, comm, device)
        self._hook("on_start", state)
        try:
            for epoch in range(epochs):
                state["epoch"] = epoch
                state["loss_meter"].reset()
                self._hook("on_start_epoch", state)
                for batch in iterator:
                    state["sample"] = batch
                    self._hook("on_sample", state)
                    self._step(state, batch, comm, device)
                    state["t"] += 1
                    if (self.check_frequency and self.mode != "compiled"
                            and state["t"] % self.check_frequency == 0):
                        mpinn.check_with_allreduce(state["params"], comm)
                    if self.numerics_auditor is not None:
                        self.numerics_auditor.maybe_audit(state["params"],
                                                          state["t"])
                    self._hook("on_update", state)
                    if self.resize_controller is not None and \
                            self._resize_boundary(state):
                        break
                    self._retune_boundary(comm)
                if state.get("departed") or state.get("resized"):
                    break
                self._hook("on_end_epoch", state)
            if not (state.get("departed") or state.get("resized")):
                self._hook("on_end", state)
        finally:
            # A loop that ended must not leave a stale engine_step mark
            # reading as stalled on /healthz.
            _obs_serve.health.clear("engine_step")
        return state

    def _numerics_mode(self) -> None:
        """Read ``numerics_mode`` for a compiled ``train`` call: validate
        it, set whether the steps compute the sentinels, and forget the
        probed FLOPs when the step is another one than the probed."""
        mode = str(config.get("numerics_mode"))
        if mode not in _numerics.MODES:
            raise ValueError(f"numerics_mode must be one of "
                             f"{_numerics.MODES}, got {mode!r}")
        key = (self.loss_fn, self.lr, self.optimizer, self.zero1,
               self.accum_steps, self._rings(), mode)
        if key != self._probe_key:
            self._probe_key = key
            self._step_flops = None
            self._flops_probed = False
        self._sentinels_on = mode in _numerics.SENTINEL_MODES

    def _resize_boundary(self, state) -> bool:
        """The step boundary, the one place membership may change (no
        collective is in flight): True when the loop must end."""
        from ..runtime import resize as _resize_mod
        from ..runtime.failure import TransportFailure

        try:
            out = self.resize_controller.step_boundary()
        except TransportFailure as e:
            if self.election_coordinator is None:
                raise
            out = self.election_coordinator.on_boundary_fault(e)
        if out == _resize_mod.DEPARTED:
            state["departed"] = True
        elif out == _resize_mod.COMMITTED:
            state["resized"] = self.resize_controller.membership.epoch
        return out in (_resize_mod.DEPARTED, _resize_mod.COMMITTED)

    def _retune_boundary(self, comm) -> None:
        """After the resize boundary: the retune controller's consult, and
        under ``autotune_mode="online"`` in a world of several ranks the
        collective point where the ranks agree their production means
        (``autotune.agree_online``), so that every rank moves a
        resolution at the same step."""
        if self.retune_controller is not None:
            self.retune_controller.step_boundary()
        if comm.size > 1 and config.get("autotune_mode") == "online":
            from ..collectives import autotune

            autotune.agree_online(comm)

    def _step(self, state, batch, comm, device) -> None:
        """One step, and the live feed of it (JAX's per-step
        ``publish_step`` call, under the same gate)."""
        clock = _StepClock() if _obs_serve.metrics_feed() else None
        local = self._local(batch, comm.rank, device)
        _mark(clock, "data_wait")
        nstats, probed = None, False
        if self.mode == "compiled":
            if clock is not None and not self._flops_probed:
                # The FLOP probe, once per step function: it counts this
                # real step (there is no cost model to ask instead).
                self._flops_probed = probed = True
                self._step_flops, nstats = _numerics.probe_step_flops(
                    self._compiled_step, (state, local, clock))
            else:
                nstats = self._compiled_step(state, local, clock)
        else:
            self._eager_step(state, local, clock)
        if clock is None:
            _obs_serve.note("engine_step")
            return
        clock.mark("optimizer")
        ph = clock.phases
        # A pre-staged pair carries the pipeline's measured consumer wait
        # (data/device.py): input-blocked time outside this window.
        pipe_wait_s = batch[0].wait_s if isinstance(batch[0], Staged) \
            else 0.0
        step_s = (clock.last - clock.t0) / 1e9 + pipe_wait_s
        ph["data_wait"] += pipe_wait_s
        hooks_s = ph.pop("hooks")
        # Hook time is the user's; as in JAX it is the ps phase when the
        # parameter server is loaded (its traffic goes out from hooks).
        if _obs_native.loaded("ps"):
            ph["ps"] = hooks_s
        blocked_s = ph["data_wait"] + ph["collective"]
        x, y = local
        _obs_serve.publish_step(
            step_s=step_s, examples=int(x.shape[0]),
            staged_bytes=int(x.nbytes) + int(y.nbytes),
            overlap_fraction=1.0 - blocked_s / max(step_s, 1e-12),
            step=state["t"], numerics=nstats, phases=ph)
        if self._step_flops and not probed:
            _numerics.publish_flops(self._step_flops, step_s)

    def _compiled_step(self, state, local, clock=None):
        """One compiled step; returns its sentinel stats (None unless
        ``numerics_mode`` asks for them)."""
        comm = state["comm"]
        params = state["params"]
        A = self.accum_steps
        if self._rings():
            loss, grads = local_grads(self.loss_fn, params, local, A)
            _mark(clock, "dispatch")
            loss, grads = ring_sync(loss, grads, comm)
        else:
            with gspmd.global_batch(comm):
                loss, grads = local_grads(self.loss_fn, params, local, A,
                                          replicas=comm.size)
            _mark(clock, "dispatch")
            loss = eager.allreduce(comm, loss, op="mean")
            if not self.zero1:
                grads = gspmd.sync_grads(grads, comm)
        _mark(clock, "collective")
        state["loss"] = loss
        self._hook("on_forward", state)
        self._hook("on_backward", state)
        _mark(clock, "hooks")
        state["loss_meter"].add(loss)
        if self.zero1:
            state["params"], state["opt_state"], nstats = \
                self._zero1_update(params, grads, state["opt_state"], comm)
            return nstats
        if self.optimizer is not None:
            with torch.no_grad():
                updates, state["opt_state"] = self.optimizer.update(
                    grads, state["opt_state"], params)
            state["params"] = optim.apply_updates(params, updates)
        else:
            state["params"] = sgd_update(params, grads, self.lr)
            updates = None
        if not self._sentinels_on:
            return None
        with torch.no_grad():
            if updates is None:
                updates = _tree.tree_map(lambda q, p: q - p,
                                         state["params"], params)
            return _numerics.sentinel_stats(params, grads, updates)

    def _zero1_update(self, params, grads, opt_state, comm):
        """One zero1 update: the sharded leaves' gradients reduce-scattered
        into this rank's row blocks, the rest allreduced; each block
        updated with its state; the updated rows all-gathered.  Returns
        the new parameters, the state and the sentinel stats (None unless
        asked for)."""
        p, r = comm.size, comm.rank
        leaves, treedef = _tree.flatten(params)
        g = _tree.leaves(grads)
        plan = self._zero1_plan(params, comm)
        sharded = [i for i, s in enumerate(plan) if s]
        whole = [i for i, s in enumerate(plan) if not s]
        g_blocks = _reduce_scatter_rows(comm, g, sharded)
        synced = gspmd.allreduce_mean_leaves([g[i] for i in whole], comm)
        g_mine = [g_blocks[i] if s else g[i] for i, s in enumerate(plan)]
        for i, t in zip(whole, synced):
            g_mine[i] = t
        p_mine = _tree.unflatten(treedef, [
            _rows(t, r, p) if s else t for t, s in zip(leaves, plan)])
        with torch.no_grad():
            updates, opt_state = self.optimizer.update(
                _tree.unflatten(treedef, g_mine), opt_state, p_mine)
        new = _tree.leaves(optim.apply_updates(p_mine, updates))
        nstats = None
        if self._sentinels_on:
            with torch.no_grad():
                nstats = _zero1_sentinels(comm, grads, plan, g_mine,
                                          _tree.leaves(updates),
                                          _tree.leaves(p_mine))
        gathered = _allgather_rows(comm, new, sharded)
        new = [gathered.get(i, t) for i, t in enumerate(new)]
        return _tree.unflatten(treedef, new), opt_state, nstats

    def _eager_step(self, state, local, clock=None) -> None:
        comm = state["comm"]
        loss, grads = value_and_grad(self.loss_fn, state["params"], local)
        state["loss"] = eager.allreduce(comm, loss, op="mean")
        _mark(clock, "dispatch")
        self._hook("on_forward", state)
        _mark(clock, "hooks")
        if self.mode == "eager_async":
            state["loss_meter"].add(state["loss"])
            self._async_sync_and_update(state, grads, comm, clock)
            return
        grads = mpinn.synchronize_gradients(grads, comm)
        _mark(clock, "collective")
        self._hook("on_backward", state)
        _mark(clock, "hooks")
        state["loss_meter"].add(state["loss"])
        state["params"] = sgd_update(state["params"], grads, self.lr)

    def _async_sync_and_update(self, state, grads, comm, clock=None) -> None:
        """eager_async: dispatch the buckets, then drain them as
        ``engine_async_drain`` says (the JAX engine's branch).  For the
        feed, the drain's time in handle waits is ``collective`` and the
        rest of it (the ready-order updates) ``optimizer``."""
        reg = mpinn.async_.register_async_backward(grads, comm,
                                                   step=state["t"])
        _mark(clock, "dispatch")
        self._hook("on_backward", state)
        _mark(clock, "hooks")
        if config.get("engine_async_drain") == "barrier":
            grads = mpinn.async_.synchronize_gradients(reg)
            state["params"] = sgd_update(state["params"], grads, self.lr)
        else:
            lr = self.lr
            with torch.no_grad():
                state["params"] = mpinn.async_.drain_at_optimizer(
                    reg, state["params"], lambda p, g: p - lr * g)
        state["blocked_s"] = reg.blocked_s
        if clock is not None:
            clock.mark("optimizer")
            clock.phases["collective"] += reg.blocked_s
            clock.phases["optimizer"] -= min(reg.blocked_s,
                                             clock.phases["optimizer"])

    def test(self, params: Any, iterator, metric_fn: LossFn) -> float:
        """Mean of ``metric_fn`` over the iterator: each rank on its row,
        averaged over ranks per batch.  In ``compiled`` mode the metric sees
        the global batch, as the JAX engine's jitted metric does (batch
        statistics span the ranks)."""
        comm = self.comm
        device = _tree.leaves(params)[0].device
        meter = AverageValueMeter()
        scope = contextlib.nullcontext()
        if self.mode == "compiled":
            iterator = engine_wrap(iterator, comm, device)
            scope = gspmd.global_batch(comm)
        with torch.no_grad(), scope:
            for batch in iterator:
                val = metric_fn(params, self._local(batch, comm.rank, device))
                meter.add(eager.allreduce(comm, val.float().reshape(1),
                                          op="mean")[0])
        return meter.mean
