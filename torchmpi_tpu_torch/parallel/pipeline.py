"""Micro-batch pipeline parallelism over the ``pp`` axis of a mesh.

Counterpart of ``torchmpi_tpu/parallel/pipeline.py`` (BASELINE config 4,
"BlockSequential model-parallel CNN pipelined across TPU chips").  There a
pipeline is one SPMD program: stage parameters stacked on a leading axis
sharded over ``pp``, a ``lax.scan`` over the ticks, a neighbour
``ppermute`` a tick, idle slots computed and masked.  Here each ``pp``
position is one process that holds its own stage's row
(:func:`stage_sharding`) and runs only the ticks on which it has work; the
``ppermute`` becomes a ``torch.distributed`` send and receive between
neighbouring ranks (:func:`~torchmpi_tpu_torch.collectives.innerjit.handoff`:
every message tagged by its tick and direction, every wait bounded), gloo
on one card.

Two schedules, as in JAX:

* GPipe (:func:`make_pipeline_fn`): differentiable.  The forward runs the
  M micro-batches through the M + S - 1 ticks and keeps each micro-batch's
  graph of this rank's stage (the stash of M activations GPipe pays); the
  backward, seeded by the gradient of the output, runs the ticks in
  reverse, each micro-batch's backward seeded by the gradient received
  from stage s + 1 and handing its input gradient to stage s - 1.  JAX
  gets this backward by AD through the scan; one autograd graph spanning
  the sends would leave the order of the hand-offs to the autograd
  engine, which the peers could not match, so each stage differentiates
  its own micro-batch graphs, in the schedule's order.
* 1F1B / PipeDream-flush (:func:`make_1f1b_step`): the schedule of
  :func:`schedule_1f1b` (copied from JAX: its arrays are the contract
  every rank reads), a forward and a backward op per tick at most; each
  forward stashes only the stage input and each backward re-forms the
  stage's forward from it, so the stash never holds more than the
  schedule's ``max_stash + 1`` inputs (checked).

The numpy parts (:func:`schedule_1f1b`, :func:`pipeline_stats`) are
copies of the JAX package's, not imports: the port imports nothing of it.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ..collectives import eager, innerjit
from ..utils import tree as _tree
from .mesh import AXIS_PP, Mesh

StageFn = Callable[[Any, torch.Tensor], torch.Tensor]   # (stage_params, h) -> h


def stack_stage_params(per_stage: list) -> Any:
    """Stack S same-structure stage trees on a new leading axis (the axis
    sharded over pp)."""
    return _tree.tree_map(lambda *xs: torch.stack(xs), *per_stage)


def stage_sharding(mesh: Mesh, params_stacked: Any, axis: str = AXIS_PP
                   ) -> Any:
    """This rank's row of stacked stage parameters: each leaf's ``[i:i+1]``
    at its position ``i`` along ``axis`` (a copy), what JAX's
    ``device_put`` over ``P(axis)`` leaves on one device."""
    i = mesh.coords[axis]
    return _tree.tree_map(lambda a: a[i:i + 1].clone(), params_stacked)


def _check_one_stage_per_device(params_local, S):
    # params_local leaves: (1, ...) — this rank's stage.  A leading dim != 1
    # means the stacked stage count doesn't match the pp axis: squeezing
    # would silently drop stages.
    for leaf in _tree.leaves(params_local):
        if leaf.shape[0] != 1:
            raise ValueError(
                f"stacked stage count {leaf.shape[0] * S} != pp axis size "
                f"{S}; one stage per pipeline device required")
    return _tree.tree_map(lambda a: a[0], params_local)


def _aliases(leaves):
    """Leaves that build this rank's own stage graphs: views of the same
    storage with their own autograd history."""
    return [t.detach().requires_grad_(t.is_floating_point())
            for t in leaves]


def _add_grads(acc, grads):
    """Accumulate gradients into f32 buffers (JAX's stage accumulators are
    f32); a leaf that got none stays."""
    for a, g in zip(acc, grads):
        if g is not None:
            a.add_(g.float())


# ------------------------------------------------------------------- GPipe

class _GPipe(torch.autograd.Function):
    """The GPipe schedule of one rank as one autograd node: ``forward`` runs
    the forward ticks, ``backward`` the backward ticks (see the module's
    docstring)."""

    @staticmethod
    def forward(ctx, pipe, treedef, x, *leaves):
        y, saved = pipe.run_forward(x, treedef, leaves)
        ctx.pipe, ctx.saved, ctx.x_like = pipe, saved, x
        return y

    @staticmethod
    def backward(ctx, dy):
        pipe, saved = ctx.pipe, ctx.saved
        ctx.saved = None
        dx, grads = pipe.run_backward(dy.contiguous(), saved, ctx.x_like,
                                      ctx.needs_input_grad[2])
        return (None, None, dx, *grads)


class _GPipeRunner:
    """One rank's part of :func:`make_pipeline_fn`."""

    def __init__(self, mesh, stage_fn, M, axis, sharded_io):
        self.mesh, self.stage_fn, self.M = mesh, stage_fn, M
        self.S = mesh.shape[axis]
        self.axis, self.sharded_io = axis, sharded_io
        self.T = M + self.S - 1
        # The hand-off ticks of the input and output groups follow the
        # schedule's, so their tags never meet a schedule tick's.
        self.t_in, self.t_out = self.T, self.T + self.S
        self.t_dy, self.t_dx = self.T + 2 * self.S, self.T + 3 * self.S

    def _comm(self):
        return self.mesh.comm(self.axis)

    def _feeds(self, x, comm):
        """Stage 0's M micro-batch inputs: x itself, or every group's shard
        gathered from its owner (each group one hop to stage 0)."""
        S, me = self.S, comm.rank
        if not self.sharded_io:
            return list(x.unbind(0)) if me == 0 else None
        if me != 0:
            innerjit.handoff([(0, x)], [], comm, self.t_in + me)
            return None
        feeds = list(x.unbind(0))
        for g in range(1, S):
            got, = innerjit.handoff([], [(g, x)], comm, self.t_in + g)
            feeds.extend(got.unbind(0))
        return feeds

    def _spread(self, full, like, comm, root, tick0):
        """The last stage's (or stage 0's) (M, ...) result on every rank
        (replicated I/O: a broadcast over pp), or each owner's group of it
        (sharded: one hop a group)."""
        S, me = self.S, comm.rank
        if not self.sharded_io:
            buf = full if me == root else torch.empty(
                (self.M,) + tuple(like.shape[1:]), dtype=like.dtype,
                device=like.device)
            return eager.broadcast(comm, buf.contiguous(), root=root) \
                if S > 1 else buf
        G = self.M // S
        if me == root:
            for j in range(S):
                if j != root:
                    innerjit.handoff([(j, full[j * G:(j + 1) * G])], [],
                                     comm, tick0 + j)
            return full[root * G:(root + 1) * G].clone()
        got, = innerjit.handoff([], [(root, like)], comm, tick0 + me)
        return got

    def run_forward(self, x, treedef, leaves):
        S, M, T = self.S, self.M, self.T
        comm = self._comm()
        s = comm.rank
        params = _aliases(leaves)
        with torch.enable_grad():      # the stage's views carry history
            p_stage = _check_one_stage_per_device(
                _tree.unflatten(treedef, params), S)
        feeds = self._feeds(x, comm)
        like = x[0]
        saved = {"params": params, "graphs": [None] * M}
        outs = [None] * M
        h_recv = None
        for t in range(T):
            m = t - s
            sends, recvs = [], []
            if 0 <= m < M:
                h_in = (feeds[m] if s == 0 else h_recv).detach()
                h_in.requires_grad_(h_in.is_floating_point())
                with torch.enable_grad():
                    out = self.stage_fn(p_stage, h_in)
                saved["graphs"][m] = (h_in, out)
                if s < S - 1:
                    sends.append((s + 1, out.detach()))
                else:
                    outs[m] = out.detach()
            if s > 0 and 0 <= t - (s - 1) < M:
                recvs.append((s - 1, like))
            if sends or recvs:
                got = innerjit.handoff(sends, recvs, comm, t)
                if recvs:
                    h_recv = got[0]
        full = torch.stack(outs) if s == S - 1 else None
        return self._spread(full, x, comm, S - 1, self.t_out), saved

    def _gather_dy(self, dy, comm):
        """The output gradient of every micro-batch on the last stage."""
        S, me = self.S, comm.rank
        if not self.sharded_io:
            return dy
        if me != S - 1:
            innerjit.handoff([(S - 1, dy)], [], comm, self.t_dy + me)
            return None
        parts = []
        for g in range(S):
            if g == me:
                parts.append(dy)
            else:
                got, = innerjit.handoff([], [(g, dy)], comm, self.t_dy + g)
                parts.append(got)
        return torch.cat(parts)

    def run_backward(self, dy, saved, x_like, want_dx):
        S, M, T = self.S, self.M, self.T
        comm = self._comm()
        s = comm.rank
        params, graphs = saved["params"], saved["graphs"]
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in params]
        like = x_like[0]
        dy_full = self._gather_dy(dy, comm)
        dx = (torch.zeros((M,) + tuple(like.shape), dtype=like.dtype,
                          device=like.device) if s == 0 else None)
        g_recv = None
        for t in reversed(range(T)):
            m = t - s
            sends, recvs = [], []
            if 0 <= m < M:
                g = dy_full[m] if s == S - 1 else g_recv
                h_in, out = graphs[m]
                graphs[m] = None
                wrt = [h_in] + params
                got = torch.autograd.grad(out, wrt, g, allow_unused=True)
                _add_grads(acc, got[1:])
                dh = got[0] if got[0] is not None else torch.zeros_like(h_in)
                if s > 0:
                    sends.append((s - 1, dh))
                else:
                    dx[m] = dh
            if s < S - 1 and 0 <= t - (s + 1) < M:
                recvs.append((s + 1, like))
            if sends or recvs:
                got = innerjit.handoff(sends, recvs, comm, t)
                if recvs:
                    g_recv = got[0]
        dx = self._spread(dx, x_like, comm, 0, self.t_dx) if want_dx \
            else None
        return dx, [a.to(p.dtype) for a, p in zip(acc, params)]


def make_pipeline_fn(
    mesh: Mesh,
    stage_fn: StageFn,
    n_microbatches: int,
    axis: str = AXIS_PP,
    sharded_io: Optional[bool] = None,
):
    """Build ``fn(params_local, x) -> y`` running the GPipe schedule over
    ``axis``, differentiable in ``x`` and the parameters.

    ``params_local``: this rank's stage, leaves with a leading dim of 1 (a
    row of :func:`stack_stage_params`, from :func:`stage_sharding`);
    ``stage_fn(p, h)`` maps one micro-batch ``h`` to one of the same shape
    and dtype (GPipe's one carrier).  Replicated I/O (``sharded_io=False``):
    ``x`` is the whole (M, mb, ...) input on every rank and ``y`` the whole
    output, broadcast from the last stage; ``dx`` is broadcast from stage
    0.  ``sharded_io`` (default: on whenever ``M % S == 0`` and S > 1, as
    in JAX): ``x`` and ``y`` are this rank's group of ``M/S`` micro-batches
    (group i at pp position i); stage 0 gathers every group's input by one
    hop a group and the last stage ships each group its outputs, with no
    broadcast.  Every pp rank must call ``fn`` and differentiate through
    its ``y``, since each backward hands off to its neighbours.

    JAX's ``auto_other_axes``, ``manual_axes``, ``param_in_specs`` and
    ``io_batch_axis`` place a GSPMD program; here each rank runs its own
    program on its own shards (a stage writes its own tp sums), so they
    have no counterpart."""
    S = mesh.shape[axis]
    M = n_microbatches
    if sharded_io is None:
        sharded_io = S > 1 and M % S == 0
    if sharded_io and M % S:
        raise ValueError(f"sharded_io needs M % S == 0, got M={M}, S={S}")
    runner = _GPipeRunner(mesh, stage_fn, M, axis, sharded_io)

    def fn(params_local, x):
        leaves, treedef = _tree.flatten(params_local)
        want = M // S if sharded_io else M
        if x.shape[0] != want:
            raise ValueError(f"x has {x.shape[0]} micro-batches, the "
                             f"pipeline takes {want} on this rank")
        return _GPipe.apply(runner, treedef, x, *leaves)

    return fn


# ------------------------------------------------------------------- 1F1B
#
# GPipe (above) runs all M forwards, then all M backwards: every stage
# stashes M micro-batch activations.  1F1B (PipeDream-flush) interleaves —
# each stage starts backwards as soon as the last stage can, capping the
# stash at ~S instead of M.  A static schedule (computed by a tiny Python
# simulator, the same on every rank) says, per (tick, stage), which
# micro-batch to forward and which to backward.


def schedule_1f1b(S: int, M: int, combined: bool = False):
    """Simulate the 1F1B schedule, synchronous hand-off (results usable
    next tick).

    ``combined=False`` (the cond-gated executed body): one op (fwd OR bwd
    of one micro-batch) per stage per tick — the classic alternating
    1F1B, stash <= S+1, T ~= 2M + 2(S-1) ticks.

    ``combined=True`` (the cond-free executed body, which computes BOTH
    slots every tick and masks): up to one fwd AND one bwd per stage per
    tick.  Because an idle slot still costs its compute in that body, the
    policy packs both slots greedily; full throughput under the 1-tick
    hand-off latency needs the in-flight window opened to ``2(S-s)``
    (a micro-batch's bwd returns to stage ``s`` ~``2(S-s)`` ticks after
    its fwd leaves), giving T ~= M + 2S - 1 at a stash bound of
    ``2S - 1`` — still M-independent, the 1F1B point.

    Returns ``(fwd_sched, bwd_sched, max_stash)``: two (T, S) int arrays
    (-1 = idle) and the high-water count of activations any stage holds
    between its forward and backward of a micro-batch — the memory bound
    the schedule exists to cap (vs M for GPipe).
    """
    fwd_ready = [set(range(M)) if s == 0 else set() for s in range(S)]
    bwd_ready = [set() for _ in range(S)]
    fwd_next = [0] * S
    bwd_next = [0] * S
    depth = (lambda s: 2 * (S - s)) if combined else (lambda s: S - s)
    warmup = [min(depth(s), M) for s in range(S)]
    fwd_rows, bwd_rows = [], []
    max_stash = 0
    limit = 4 * (M + S) + 8
    while any(b < M for b in bwd_next):
        if len(fwd_rows) > limit:
            raise RuntimeError(f"1F1B schedule did not converge (S={S}, M={M})")
        f_row, b_row = [-1] * S, [-1] * S
        # Decide from the last stage down so each stage knows whether its
        # downstream fwd-link buffer is being consumed this tick (credit-
        # based flow control: a send needs a free — or freeing — buffer).
        # The upstream bwd link (decided later in the sweep) is gated
        # conservatively on its tick-start state in alternating mode; the
        # combined policy bets one deep on same-tick consumption (the
        # send/consume ordering inside the executed tick permits it) and
        # the effects phase below still hard-asserts the single buffer.
        for s in reversed(range(S)):
            can_f = fwd_next[s] < M and fwd_next[s] in fwd_ready[s]
            if can_f and s + 1 < S and fwd_ready[s + 1]:
                can_f = f_row[s + 1] == next(iter(fwd_ready[s + 1]))
            can_b = bwd_next[s] < M and bwd_next[s] in bwd_ready[s]
            if can_b and s - 1 >= 0 and bwd_ready[s - 1]:
                can_b = combined and len(bwd_ready[s - 1]) == 1
            if combined:
                if can_b:
                    b_row[s] = bwd_next[s]
                inflight = fwd_next[s] + 1 - bwd_next[s] - (b_row[s] >= 0)
                if can_f and inflight <= warmup[s]:
                    f_row[s] = fwd_next[s]
            elif can_b and (fwd_next[s] >= warmup[s] or not can_f):
                b_row[s] = bwd_next[s]
            elif can_f:
                f_row[s] = fwd_next[s]
        # Consumptions free the (single) link buffers before this tick's
        # sends land in them.
        for s in range(S):
            if f_row[s] >= 0 and s > 0:
                fwd_ready[s].discard(f_row[s])
            if b_row[s] >= 0 and s < S - 1:
                bwd_ready[s].discard(b_row[s])
        for s in range(S):
            if f_row[s] >= 0:
                m = f_row[s]
                fwd_next[s] += 1
                if s + 1 < S:
                    # The executed pipeline holds ONE in-flight activation
                    # per neighbour link (a single scan-carry buffer); the
                    # policy must consume before the next send.
                    if fwd_ready[s + 1]:
                        raise RuntimeError(
                            f"1F1B schedule needs >1 fwd buffer at stage "
                            f"{s + 1} (S={S}, M={M})")
                    fwd_ready[s + 1].add(m)
                else:
                    bwd_ready[s].add(m)     # last stage: bwd follows its fwd
            if b_row[s] >= 0:
                m = b_row[s]
                bwd_next[s] += 1
                if s - 1 >= 0:
                    if bwd_ready[s - 1]:
                        raise RuntimeError(
                            f"1F1B schedule needs >1 bwd buffer at stage "
                            f"{s - 1} (S={S}, M={M})")
                    bwd_ready[s - 1].add(m)
        fwd_rows.append(f_row)
        bwd_rows.append(b_row)
        max_stash = max(max_stash,
                        max(fwd_next[s] - bwd_next[s] for s in range(S)))
    return np.asarray(fwd_rows, np.int32), np.asarray(bwd_rows, np.int32), max_stash


def pipeline_stats(S: int, M: int, mode: str = "1f1b") -> dict:
    """Schedule analytics: tick count, bubble fraction (idle stage-ticks /
    total stage-ticks), and per-stage activation stash bound.

    GPipe (this module's AD path): 2(M + S - 1) ticks, stash = M.
    1F1B: measured from the simulated schedule, stash <= S + 1.
    1f1b-combined: the cond-free body's packed schedule, stash <= 2S - 1,
    ticks ~= M + 2S - 1 (every tick pays fwd+bwd compute, so its bubble
    fraction counts both slots: idle slot-ticks / 2T).
    """
    if mode == "gpipe":
        ticks = 2 * (M + S - 1)
        return {"ticks": ticks,
                "bubble_fraction": 1.0 - (2.0 * M) / ticks,
                "max_stash": M}
    if mode not in ("1f1b", "1f1b-combined"):
        raise ValueError(
            f"mode must be 'gpipe', '1f1b' or '1f1b-combined', got {mode!r}")
    fs, bs, stash = schedule_1f1b(S, M, combined=(mode == "1f1b-combined"))
    ticks = fs.shape[0]
    # Alternating: one op-slot per tick (2M useful ops in T slots).
    # Combined: two op-slots per tick (the cond-free body pays both).
    slots = 2 * ticks if mode == "1f1b-combined" else ticks
    return {"ticks": ticks,
            "bubble_fraction": 1.0 - (2.0 * M) / slots,
            "max_stash": stash}


def _wire_sum(leaves, axes, mesh, wire):
    """The sum over ``axes`` of f32 leaves on the ``wire`` dtype (one
    allreduce over a flat buffer; a group of one rank makes no call)."""
    comm = innerjit.axis_comm(axes, mesh)
    if comm.size == 1 or not leaves:
        return leaves
    flat = eager.allreduce_(comm, torch.cat([t.reshape(-1).to(wire)
                                             for t in leaves]))
    out, off = [], 0
    for t in leaves:
        out.append(flat[off:off + t.numel()].view(t.shape).to(t.dtype))
        off += t.numel()
    return out


class OneFOneBStep:
    """One rank's part of :func:`make_1f1b_step`: call it as the JAX
    function is called.  After each call, ``stash_high_water`` is the most
    stage inputs this rank held between their forward and backward (at
    most ``stash_bound``, the schedule's ``max_stash``)."""

    def __init__(self, mesh, stage_fn, loss_fn, M, axis, with_lp, return_dx,
                 combined, io_batch_axis):
        self.mesh, self.stage_fn, self.loss_fn = mesh, stage_fn, loss_fn
        self.M, self.axis, self.S = M, axis, mesh.shape[axis]
        self.with_lp, self.return_dx = with_lp, return_dx
        self.io_batch_axis = io_batch_axis
        self.fsched, self.bsched, self.stash_bound = schedule_1f1b(
            self.S, M, combined=combined)
        self.K = self.stash_bound + 1       # stash slots (m % K is unique)
        self.stash_high_water = 0

    def __call__(self, params_local, *args):
        if self.with_lp:
            loss_params, x, targets = args
        else:
            (x, targets), loss_params = args, None
        S, M = self.S, self.M
        comm = self.mesh.comm(self.axis)
        s = comm.rank
        is_last = s == S - 1
        leaves, treedef = _tree.flatten(params_local)
        params = _aliases(leaves)
        p_stage = _check_one_stage_per_device(
            _tree.unflatten(treedef, params), S)
        lp_leaves, lp_def = _tree.flatten(loss_params)
        lp = _aliases(lp_leaves)
        lp_tree = _tree.unflatten(lp_def, lp)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in params]
        lp_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for p in lp]
        like = x[0]
        dx_buf = (torch.zeros((M,) + tuple(like.shape), dtype=torch.float32,
                              device=like.device) if self.return_dx else None)
        loss_acc = torch.zeros((), dtype=torch.float32, device=like.device)
        stash, seeds = {}, {}
        h_fwd = g_bwd = None
        self.stash_high_water = 0
        for t in range(self.fsched.shape[0]):
            m_f, m_b = int(self.fsched[t, s]), int(self.bsched[t, s])
            sends = []
            if m_f >= 0:
                # ---- forward op: stash the input, run the stage without a
                # graph; the last stage seeds the backward from the loss.
                h_in = x[m_f] if s == 0 else h_fwd
                stash[m_f] = h_in
                if len(stash) > self.K:
                    raise RuntimeError(
                        f"1F1B stash holds {len(stash)} inputs, over the "
                        f"schedule's {self.K} slots")
                with torch.no_grad():
                    h_out = self.stage_fn(p_stage, h_in)
                if is_last:
                    with torch.enable_grad():
                        h_req = h_out.detach().requires_grad_(True)
                        if self.with_lp:
                            loss_m = self.loss_fn(lp_tree, h_req,
                                                  targets[m_f])
                        else:
                            loss_m = self.loss_fn(h_req, targets[m_f])
                        got = torch.autograd.grad(loss_m, [h_req] + lp,
                                                  allow_unused=True)
                    seeds[m_f] = got[0].to(h_out.dtype)
                    _add_grads(lp_acc, got[1:])
                    loss_acc += loss_m.detach().float()
                else:
                    sends.append((s + 1, h_out))
            if m_b >= 0:
                # ---- backward op: re-form the stage's forward from the
                # stashed input and take its vjp.
                h_saved = stash.pop(m_b)
                g_in = seeds.pop(m_b) if is_last else g_bwd
                with torch.enable_grad():
                    h = h_saved.detach().requires_grad_(True)
                    out = self.stage_fn(p_stage, h)
                    got = torch.autograd.grad(out, [h] + params, g_in,
                                              allow_unused=True)
                _add_grads(acc, got[1:])
                dh = got[0] if got[0] is not None else torch.zeros_like(h)
                if s > 0:
                    sends.append((s - 1, dh))
                elif self.return_dx:
                    dx_buf[m_b] = dh.float()
            self.stash_high_water = max(self.stash_high_water, len(stash))
            # ---- neighbour hand-offs: receive what a neighbour sent this
            # tick (the schedule says whether it did).
            recvs = []
            if s > 0 and self.fsched[t, s - 1] >= 0:
                recvs.append((s - 1, like))
            if s < S - 1 and self.bsched[t, s + 1] >= 0:
                recvs.append((s + 1, like))
            if sends or recvs:
                got = innerjit.handoff(sends, recvs, comm, t)
                for (src, _), val in zip(recvs, got):
                    if src < s:
                        h_fwd = val
                    else:
                        g_bwd = val
        return self._reduce(loss_acc, acc, lp_acc, lp_def, dx_buf, treedef)

    def _reduce(self, loss_acc, acc, lp_acc, lp_def, dx_buf, treedef):
        """Mean over micro-batches (and the batch axis); the loss lives on
        the last stage only, so one scalar sum over pp shares it (the
        loss-param gradients and dx live on one stage each and are summed
        over pp the same way, every other stage adding zeros).  The
        gradient sums ride the ``resolve_wire_dtype`` wire; the scalar
        loss stays f32."""
        from . import tp as _tp

        mesh, axis = self.mesh, self.axis
        bsz = mesh.shape[self.io_batch_axis] if self.io_batch_axis else 1
        batch_axes = (self.io_batch_axis,) if bsz > 1 else ()
        denom = self.M * bsz
        wire = _tp.resolve_wire_dtype()
        loss, = _wire_sum([loss_acc], (axis,) + batch_axes, mesh,
                          torch.float32)
        loss = loss / denom
        if batch_axes:
            acc = _wire_sum(acc, batch_axes, mesh, wire)
        # acc has the (1, ...) layout of the stage's row already.
        grads = _tree.unflatten(treedef, [a / denom for a in acc])
        out = [loss, grads]
        if self.with_lp:
            lp_acc = _wire_sum(lp_acc, (axis,) + batch_axes, mesh, wire)
            out.append(_tree.unflatten(lp_def, [a / denom for a in lp_acc]))
        if self.return_dx:
            dx, = _wire_sum([dx_buf], axis, mesh, wire)
            out.append(dx / denom)
        return tuple(out)


def make_1f1b_step(
    mesh: Mesh,
    stage_fn: StageFn,
    loss_fn: Callable[..., torch.Tensor],
    n_microbatches: int,
    axis: str = AXIS_PP,
    loss_params_example: Any = None,
    return_dx: bool = False,
    manual_axes: Optional[Sequence[str]] = None,
    io_batch_axis: Optional[str] = None,
    manual_schedule: str = "combined",
) -> OneFOneBStep:
    """Build a 1F1B training-gradient function.

    Base form: ``fn(params_local, x, targets) -> (mean_loss, grads)`` with
    ``loss_fn(h_last, target_mb) -> scalar``; ``params_local`` is this
    rank's stage (leading dim 1, as :func:`make_pipeline_fn` takes it) and
    ``grads`` its f32 gradients in that layout.  ``x``: (M, mb, ...) this
    rank's micro-batched input and ``targets`` (M, ...), the same on every
    pp rank (stage 0 reads ``x``, the last stage ``targets``).

    * ``loss_params_example`` (any tree; only its presence matters here):
      ``loss_fn`` becomes ``loss_fn(loss_params, h_last, target_mb)``, the
      call ``fn(params_local, loss_params, x, targets)`` and the result
      gains the mean ``d loss / d loss_params`` (accumulated at the last
      stage, summed over pp).
    * ``return_dx=True``: the result ends with ``dx``, (M, mb, ...) f32
      gradients of the pipeline input (accumulated at stage 0, summed over
      pp), what an embedding's scatter-add needs.

    ``manual_axes`` names the extra mesh axes the stage body writes its own
    collectives over (tp, dp): with them the schedule is
    ``manual_schedule``'s — ``"combined"`` (default; JAX's cond-free body,
    T ~= M + 2S - 1 ticks at stash <= 2S - 1) or ``"alternating"`` (one op
    a tick, stash <= S + 1); without them always the alternating one, as in
    JAX.  The predicates depend only on (tick, stage), so every tp/dp peer
    of a stage runs the same ops in the same order and their collectives
    match; where JAX computes an idle slot and masks it, this rank skips
    it, and the numbers are the same.  ``stage_fn``'s backward must be
    right when taken on this rank alone (the Megatron f/g pair carries the
    tp sums).  ``io_batch_axis`` (one of ``manual_axes``): ``x`` and
    ``targets`` are this rank's shard of the batch over it, and the loss,
    the stage gradients and the loss-param gradients are means over it
    too.  JAX's ``auto_other_axes``, ``param_in_specs`` and
    ``loss_param_specs`` place a GSPMD program and have no counterpart."""
    M = n_microbatches
    manual = manual_axes is not None
    if manual_schedule not in ("combined", "alternating"):
        raise ValueError("manual_schedule must be 'combined' or "
                         "'alternating'")
    if io_batch_axis is not None and (
            not manual or io_batch_axis not in manual_axes):
        raise ValueError("io_batch_axis must name one of manual_axes")
    return OneFOneBStep(mesh, stage_fn, loss_fn, M, axis,
                        loss_params_example is not None, return_dx,
                        manual and manual_schedule == "combined",
                        io_batch_axis)


def microbatch(x: torch.Tensor, n_microbatches: int) -> torch.Tensor:
    """(B, d) -> (M, B/M, d)."""
    B = x.shape[0]
    if B % n_microbatches != 0:
        raise ValueError(f"batch {B} not divisible into {n_microbatches} micro-batches")
    return x.reshape(n_microbatches, B // n_microbatches, *x.shape[1:])


def unmicrobatch(y: torch.Tensor) -> torch.Tensor:
    return y.reshape(y.shape[0] * y.shape[1], *y.shape[2:])
