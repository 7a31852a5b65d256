"""Parameter-server update-rule drivers: Downpour and EASGD.

Counterpart of ``torchmpi_tpu/parameterserver/update.py``.  The reference
layers three Lua classes over the PS API (reference:
torchmpi/parameterserver/update.lua, downpourupdate.lua, easgdupdate.lua):
a base ``Update`` with a step-scheduled shard/fetch/integrate/send cycle,
``DownpourUpdate`` (accumulate local grads, push with 'add' every
cycle, integrate = copy), and ``EASGDUpdate`` (elastic averaging with a
beta/size coefficient).  The same structure here, over the port's
parameter trees (dicts of tensors, leaves in JAX order).

The PS is CPU-side by design (reference docs/parameterserver.md:1-3): a
parameter on the card is mirrored into a pinned host buffer, kept for the
run, and every crossing is an explicit copy — device to host before a
register or a push, host to device (in place, into the parameter) after an
integration.  Downpour's accumulators live beside the gradients (on the
card for a card model) in f32.

Scheduling mirrors ``Update:update(step)`` (update.lua:77-115):
  * ``init_delay`` steps of pure local SGD before sharding (``__shard``),
  * a fetch every ``update_frequency`` steps, prefetched one cycle ahead so
    the pull overlaps compute (``__fetch`` prefetch-ahead),
  * integrate + send on the following step.

When the sharding and data-parallel communicators differ (``dp=`` given,
the reference's distinct shardingCommunicator / dataparallelCommunicator,
update.lua:83-92), each data-parallel group is one logical PS client: only
the group's DP-rank-0 runs the fetch/integrate/send cycle, and after an
integration the integrated parameters are broadcast over the DP plane
(update.lua:103-112 — allreduce of the needBroadcast flag, then the
broadcast from the DP root), on the port's ``HostCommunicator``.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import torch

from ..utils import tree as _tree
from . import (
    PSTensor,
    init_tensors,
    prefetch_tensors,
    send_tensors,
)
from . import native as _ps_native


class Update:
    """Base step-scheduled PS driver (reference: update.lua:24-115).

    Subclasses override :meth:`_integrate` (fold fetched server state into
    local params) and :meth:`_send` (what to push after integrating).
    ``update(params, grads, step)`` returns the params, which an
    integration overwrites in place.

    ``stats`` counts the cycles' wall time on this process's clock
    (``push_s``, ``pull_s``: seconds spent waiting pushes and pulls;
    ``bytes_pushed``, ``bytes_pulled``; ``cycles``)."""

    def __init__(self, init_delay: int = 1, update_frequency: int = 4,
                 initial: str = "copy", rank: int = 0,
                 fence: Optional[Any] = None, dp: Optional[Any] = None):
        """``rank``/``fence`` govern multi-worker registration: only worker
        rank 0 registers with reset (wiping any stale previous-run shards)
        and seeds values (the reference's rank-0 psInitFun,
        parameterserver/init.lua:138-145).  ``fence`` (a zero-arg
        cross-worker barrier, e.g. ``HostCommunicator.barrier``) orders
        rank 0's reset+seed *before* the other workers' keep-creates.

        ``dp`` composes the PS with synchronous data parallelism: an
        object with ``rank``/``size`` and in-place CPU-tensor
        ``allreduce(t)`` / ``broadcast(t, root)`` — the port's
        :class:`~torchmpi_tpu_torch.collectives.hostcomm.HostCommunicator`
        over this worker's DP group.  When given (and size > 1), only
        DP-rank-0 is a PS client; every group member calls :meth:`update`
        each step and joins the flag-allreduce + post-integration parameter
        broadcast.  ``rank`` then orders registration among the *clients*
        (the group roots); ``fence``, if given, must span every worker of
        the combo."""
        if update_frequency < 1:
            raise ValueError("update_frequency must be >= 1")
        self.init_delay = init_delay
        self.update_frequency = update_frequency
        self.initial = initial
        self.rank = rank
        self.fence = fence
        self.dp = dp
        self.tensors: Optional[List[PSTensor]] = None
        self._prefetched = None
        self._sharded = False
        self._mirrors: Dict[str, List[torch.Tensor]] = {}
        # Combo mode: whether the last update() broadcast integrated
        # parameters over the DP plane (the same on every member).
        self.broadcast_last_step = False
        self.stats = {"cycles": 0, "push_s": 0.0, "pull_s": 0.0,
                      "bytes_pushed": 0, "bytes_pulled": 0}

    # -- subclass hooks --

    def _integrate(self, params, fetched):
        raise NotImplementedError

    def _send(self, params) -> None:
        raise NotImplementedError

    def _on_step(self, params, grads):
        """Per-step local bookkeeping before the PS schedule (e.g. grad
        accumulation); returns params."""
        return params

    # -- host crossing --

    @staticmethod
    def _wire(dtype: torch.dtype) -> torch.dtype:
        """The PS wire dtype of a leaf: dtypes the native engine pushes and
        pulls without widening stay as they are (a bf16 parameter moves 2
        bytes an element), anything else widens to f32."""
        return dtype if dtype in _ps_native._DTYPES else torch.float32

    def _host(self, tensors, key: str, dtype=None) -> List[torch.Tensor]:
        """The tensors as host tensors in their wire dtype (or ``dtype``).
        A CPU tensor of that dtype is passed as it is; anything else is
        copied, explicitly, into this driver's host mirror ``key`` (pinned
        for a card tensor, reused every cycle)."""
        mirrors = self._mirrors.setdefault(key, [])
        out = []
        for i, x in enumerate(tensors):
            x = x.detach()
            dt = dtype or self._wire(x.dtype)
            if x.device.type == "cpu" and x.dtype == dt:
                out.append(x.contiguous())
                continue
            if len(mirrors) <= i:
                mirrors.append(torch.empty(
                    x.shape, dtype=dt,
                    pin_memory=x.device.type == "cuda"))
            mirrors[i].copy_(x)           # a synchronous device-to-host copy
            out.append(mirrors[i])
        return out

    @staticmethod
    @torch.no_grad()
    def _rebuild(tree, leaves):
        """Write host ``leaves`` into the tree's leaves in place (each in
        its own dtype and on its own device: a host-to-device copy for a
        card parameter); returns the tree."""
        for p, v in zip(_tree.leaves(tree), leaves):
            p.copy_(v)
        return tree

    @property
    def _combo(self) -> bool:
        """Distinct sharding vs data-parallel planes (update.lua:86-92)."""
        return self.dp is not None and getattr(self.dp, "size", 1) > 1

    @property
    def _client(self) -> bool:
        """Does this worker talk to the PS?  In combo mode only the DP
        group's rank 0 does (update.lua:89-91)."""
        return not self._combo or self.dp.rank == 0

    def _shard(self, params) -> None:
        """__shard (update.lua:49-55): register params with the PS.
        Rank 0 registers with reset (wiping stale shards) + seed, then
        fences; other clients fence first (so rank 0's reset+seed landed)
        and register with keep-creates.  Non-client DP workers only hold
        their fence slot — they never touch the PS."""
        host = (self._host(_tree.leaves(params), "params")
                if self._client else None)
        if not self._client:
            if self.fence is not None:
                self.fence()
        elif self.rank == 0:
            self.tensors = init_tensors(host, initial=self.initial)
            if self.fence is not None:
                self.fence()
        else:
            if self.fence is not None:
                self.fence()
            self.tensors = init_tensors(host, initial="zero", reset=False)
        self._sharded = True

    def _dp_broadcast_if_needed(self, params, integrated: bool):
        """The combo's step-4 (update.lua:103-112): allreduce the
        needBroadcast flag over the DP plane; when any root integrated this
        step, broadcast the integrated parameters from DP rank 0."""
        flag = torch.tensor([1.0 if integrated else 0.0],
                            dtype=torch.float64)
        self.dp.allreduce(flag)
        self.broadcast_last_step = bool(flag[0] > 0)
        if not self.broadcast_last_step:
            return params
        from ..collectives.hostcomm import _DTYPES as _ring_dtypes

        # Owned host copies (the ring writes in place): leaves travel in
        # their own dtype where the ring moves it, widened to f32 otherwise.
        leaves = []
        for x in _tree.leaves(params):
            dt = x.dtype if x.dtype in _ring_dtypes else torch.float32
            leaves.append(x.detach().to("cpu", dt, copy=True))
        for a in leaves:
            self.dp.broadcast(a, root=0)
        if self.dp.rank == 0:
            # The root's params ARE the broadcast source: keep them.
            return params
        return self._rebuild(params, leaves)

    def update(self, params, grads, step: int):
        """Advance the PS schedule at global step ``step`` (reference:
        Update:update, update.lua:77-115).  In combo mode every DP group
        member must call this each step — the flag allreduce and parameter
        broadcast are collective over the DP plane."""
        if self._client:
            # Non-client DP workers skip per-step bookkeeping: only the DP
            # root sends.
            params = self._on_step(params, grads)
        integrated = False
        if not self._sharded:
            if step >= self.init_delay:
                self._shard(params)
        elif (self._client
              and (step - self.init_delay) % self.update_frequency == 0):
            if self._prefetched is not None:
                params = self._integrate_and_send(params)
                integrated = True
            # __fetch with prefetch-ahead (update.lua:58-65), into the
            # reused host buffers.
            bufs = self._mirrors.setdefault("fetch", [])
            if not bufs:
                bufs.extend(torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=torch.cuda.is_available())
                            for t in self.tensors)
            self._prefetched = prefetch_tensors(self.tensors, outs=bufs)
        if self._combo:
            params = self._dp_broadcast_if_needed(params, integrated)
        return params

    def _integrate_and_send(self, params):
        t0 = time.perf_counter()
        fetched = [h.wait() for h, _ in self._prefetched]
        self.stats["pull_s"] += time.perf_counter() - t0
        self.stats["bytes_pulled"] += sum(f.numel() * f.element_size()
                                          for f in fetched)
        self.stats["cycles"] += 1
        self._prefetched = None
        params = self._integrate(params, fetched)
        self._send(params)
        return params

    def _push(self, deltas: List[torch.Tensor]) -> None:
        """Push host ``deltas`` with the 'add' rule and wait the acks."""
        t0 = time.perf_counter()
        for h in send_tensors(self.tensors, deltas, rule="add"):
            h.wait()
        self.stats["push_s"] += time.perf_counter() - t0
        self.stats["bytes_pushed"] += sum(t.total * t.itemsize
                                          for t in self.tensors)

    def flush(self, params):
        """Final integrate at end of training.  Collective over the DP plane
        in combo mode (every group member must call it)."""
        integrated = False
        if self._prefetched is not None:
            params = self._integrate_and_send(params)
            integrated = True
        if self._combo:
            params = self._dp_broadcast_if_needed(params, integrated)
        return params


class DownpourUpdate(Update):
    """Downpour-SGD (reference: downpourupdate.lua:47-77): gradients
    accumulate locally every step; the accumulated (learning-rate-scaled)
    update is pushed with the 'add' rule every cycle; the fetched server
    value replaces local params (integrate = copy)."""

    def __init__(self, lr: float, **kw):
        super().__init__(**kw)
        self.lr = lr
        self._acc: Optional[List[torch.Tensor]] = None

    @torch.no_grad()
    def _on_step(self, params, grads):
        g = [x.detach() for x in _tree.leaves(grads)]
        if self._acc is None:
            # Accumulators always f32, beside the gradients: many bf16
            # gradients summed in bf16 would lose the small addends.  The
            # f32 delta narrows to the shard dtype once, at send time.
            self._acc = [torch.zeros(x.shape, dtype=torch.float32,
                                     device=x.device) for x in g]
        for a, x in zip(self._acc, g):
            a.add_(x.to(self._wire(x.dtype)).float())
        return params

    def _integrate(self, params, fetched):
        # Server value wins (copy integration).
        return self._rebuild(params, fetched)

    @torch.no_grad()
    def _send(self, params) -> None:
        delta = [a * -self.lr for a in self._acc]
        for a in self._acc:
            a.zero_()
        self._push(self._host(delta, "delta", dtype=torch.float32))


class EASGDUpdate(Update):
    """Elastic-averaging SGD (reference: easgdupdate.lua:57-82): local
    params are pulled toward the center with force alpha = beta/size, and
    the equal-and-opposite elastic difference is pushed to the center with
    'add' — the difference is computed against the *fetched* center, then
    applied locally and remotely."""

    def __init__(self, beta: float = 0.9, size: int = 1, **kw):
        super().__init__(**kw)
        self.alpha = beta / max(size, 1)
        self._delta: Optional[List[torch.Tensor]] = None

    def _integrate(self, params, fetched):
        # Elastic algebra in f32 on the host, whatever the wire dtype:
        # alpha*(p - c) on bf16 operands would quantize the small elastic
        # force to zero.
        local = self._host(_tree.leaves(params), "local",
                           dtype=torch.float32)
        fetched = [c.float() for c in fetched]
        self._delta = [self.alpha * (p - c) for p, c in zip(local, fetched)]
        new_local = [p - d for p, d in zip(local, self._delta)]
        return self._rebuild(params, new_local)

    def _send(self, params) -> None:
        self._push(self._delta)
        self._delta = None
