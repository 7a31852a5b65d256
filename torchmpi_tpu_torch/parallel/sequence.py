"""Sequence / context parallelism: ring attention and Ulysses.

Counterpart of ``torchmpi_tpu/parallel/sequence.py``.  Ring attention is
the reference's chunked ring schedule (lib/resources.cpp:588-678,
lib/detail/README.md:1-48) applied to attention: each rank owns a sequence
chunk of K/V and per step computes block attention of its local Q against
the K/V chunk it currently holds, then passes the chunk to its ring
neighbour (``innerjit.ring_shift``).

Three strategies over an ``sp`` mesh axis:

* :func:`ring_flash_attention` — the production path: K/V circulate the
  ring and every per-chunk block runs through the port's flash block ops
  (``ops/flash_attention.py``: the CUDA kernels B4, B5 and B6 on the card,
  their plain versions on the CPU), with the f32 online-softmax state
  carried across ring steps by log-sum-exp combination.  One
  ``torch.autograd.Function`` holds both loops, as one ``custom_vjp`` does
  in JAX;
* :func:`ring_attention` — the same ring schedule with a plain einsum per
  block: exact (f32 end to end), the oracle the flash ring is tested
  against, differentiable through ``ring_shift``;
* :func:`ulysses_attention` — two all-to-alls swap sequence sharding for
  head sharding, ordinary attention runs on full-length sequences for a
  head subset, and they swap back (needs heads % p == 0).

The bodies take this rank's chunk (as a ``shard_map`` body does) and name
the axis of a mesh (``mesh=``, or the one entered with ``with mesh:``);
``make_*`` wrap them into functions of the global arrays, which every rank
passes whole.  Layout: (seq, heads, head_dim) per rank; ``*_batched`` take
a leading batch dimension.

The causal flash ring skips future chunks with a Python branch on this
rank's ``sp`` coordinate, so ranks launch different numbers of kernels;
no collective sits inside a branch, and every rank meets every shift.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..collectives import innerjit
from ..ops.flash_attention import (
    _auto_block as _flash_auto_block,
    flash_bwd_block,
    flash_fwd_block,
)
from .mesh import AXIS_SP, Mesh

NEG_INF = -1e30


def _repeat_heads(x: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    """GQA: kv head g -> heads g*rep .. g*rep+rep-1 (``jnp.repeat``)."""
    return torch.repeat_interleave(x, rep, dim=dim) if rep > 1 else x


def _block_update(q, k, v, o, m, l, mask, scale):
    """One flash-style block accumulation step over a leading batch.

    q: (B, Lq, H, D); k, v: (B, Lk, KV, D) with KV | H — K/V arrive at their
    native head count and are repeated here, block-locally.  The
    accumulators o (B, Lq, H, D), m and l (B, Lq, H) and all softmax
    arithmetic are f32.  ``mask``: (Lq, Lk) bool, True = attend."""
    rep = q.shape[2] // k.shape[2]
    k = _repeat_heads(k, rep, 2)
    v = _repeat_heads(v, rep, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = s.masked_fill(~mask, NEG_INF)
    m_blk = s.amax(dim=-1).transpose(1, 2)              # (B, Lq, H)
    m_new = torch.maximum(m, m_blk)
    p = torch.exp(s - m_new.transpose(1, 2)[..., None])
    p = p.masked_fill(~mask, 0.0)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1).transpose(1, 2)
    o_new = (o * corr[..., None]
             + torch.einsum("bhqk,bkhd->bqhd", p, v.float()))
    return o_new, m_new, l_new


def _ring_einsum(q, k, v, axis, causal, scale, mesh):
    """:func:`ring_attention` over a leading batch: (B, L, H, D)."""
    comm = innerjit.axis_comm(axis, mesh)
    p, me = comm.size, comm.rank
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    dev = q.device
    q_pos = me * Lq + torch.arange(Lq, device=dev)
    o = torch.zeros((B, Lq, H, D), dtype=torch.float32, device=dev)
    m = torch.full((B, Lq, H), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Lq, H), dtype=torch.float32, device=dev)
    kv = torch.stack([k, v])          # one message a step for both chunks
    for i in range(p):
        # The chunk held at step i originated at rank (me - i) mod p.
        src = (me - i) % p
        k_pos = src * Lk + torch.arange(Lk, device=dev)
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]
        else:
            mask = torch.ones((Lq, Lk), dtype=torch.bool, device=dev)
        o, m, l = _block_update(q, kv[0], kv[1], o, m, l, mask, scale)
        if i < p - 1:
            kv = innerjit.ring_shift(kv, axis, 1, mesh=mesh)
    return (o / torch.clamp(l, min=1e-20)[..., None]).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis: str = AXIS_SP, causal: bool = False,
                   scale: Optional[float] = None,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Exact attention over the full (distributed) sequence: this rank's
    q = (L_local, H, D), k, v = (L_local, KV, D) with KV | H (K/V circulate
    at their native head count and are expanded per block).  Output
    (L_local, H, D).  The global sequence is the concatenation of chunks in
    rank order."""
    return _ring_einsum(q[None], k[None], v[None], axis, causal, scale,
                        mesh)[0]


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Plain single-device attention, (L, H, D) layout — the correctness
    reference and the inner kernel for Ulysses.  GQA-native; scores,
    softmax and the output's accumulation in f32 whatever the input
    dtype."""
    L, H, D = q.shape
    rep = H // k.shape[1]
    k = _repeat_heads(k, rep, 1)
    v = _repeat_heads(v, rep, 1)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    s = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.tril(torch.ones((L, k.shape[0]), dtype=torch.bool,
                                     device=q.device))
        s = s.masked_fill(~mask[None], NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,khd->qhd", w, v.float()).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis: str = AXIS_SP, causal: bool = False,
                      scale: Optional[float] = None,
                      local_impl: str = "einsum",
                      mesh: Optional[Mesh] = None) -> torch.Tensor:
    """All-to-all sequence parallelism (Ulysses): this rank's q (L/p, H, D),
    k/v (L/p, KV, D) with KV | H.  The first all-to-all converts to the
    full sequence and a head subset, local attention runs on the full
    length, the second restores sequence sharding.  Needs ``H % p == 0``
    and ``KV % p == 0``.

    ``local_impl``: ``"einsum"`` (exact oracle; materializes the local
    (H/p, L, L) scores) or ``"flash"`` — the flash kernels on the gathered
    full-length sequence."""
    p = innerjit.axis_size(axis, mesh)
    if q.shape[1] % p or k.shape[1] % p:
        raise ValueError(
            f"ulysses_attention needs H % p == 0 and KV % p == 0 to split "
            f"heads over the a2a (got H={q.shape[1]}, KV={k.shape[1]}, "
            f"p={p}); repeat K/V up to a multiple of p first")
    # (L/p, H, D) -> (L, H/p, D): split heads, concat sequence.
    qh = innerjit.alltoall(q, axis, split_axis=1, concat_axis=0, mesh=mesh)
    kh = innerjit.alltoall(k, axis, split_axis=1, concat_axis=0, mesh=mesh)
    vh = innerjit.alltoall(v, axis, split_axis=1, concat_axis=0, mesh=mesh)
    if local_impl == "flash":
        from ..ops.flash_attention import flash_attention

        rep = qh.shape[1] // kh.shape[1]
        oh = flash_attention(qh[None], _repeat_heads(kh, rep, 1)[None],
                             _repeat_heads(vh, rep, 1)[None], causal=causal,
                             scale=scale)[0]
    elif local_impl == "einsum":
        oh = full_attention(qh, kh, vh, causal=causal, scale=scale)
    else:
        raise ValueError("local_impl must be 'einsum' or 'flash'")
    # (L, H/p, D) -> (L/p, H, D).
    return innerjit.alltoall(oh, axis, split_axis=0, concat_axis=1,
                             mesh=mesh)


# ------------------------------------------------- ring x flash composition
#
# The ring schedule with the flash block ops as the per-chunk primitive.
# Forward: each step computes (o_chunk, lse_chunk) for the circulating K/V
# chunk and folds it into the running (o, lse) by exact log-sum-exp
# combination.  Backward: a second ring pass; the *global* lse and
# delta = rowsum(do * o) re-normalize every chunk's probability block
# (FlashAttention-2 identity), so each step's dk/dv contribution is exact
# and accumulates in f32 carriers that ride one hop behind their chunk,
# arriving home after the full lap.
#
# Causal structure: the chunk held at step i originated at rank (me - i)
# mod p, so i == 0 is the local diagonal block (causal mask), i >= 1 is
# either entirely past (me >= i: attend all, no mask) or entirely future
# (me < i: skipped — no kernel runs).  The block ops take contiguous
# (BH, L, D) tensors: every strided view is made contiguous before them.


def _lse_combine(o, lse, o_b, lse_b):
    """Exact combination of two normalized attention partials (f32)."""
    lse_new = torch.logaddexp(lse, lse_b)
    w, w_b = torch.exp(lse - lse_new), torch.exp(lse_b - lse_new)
    return o * w + o_b * w_b, lse_new


def _gsum(g: torch.Tensor, rep: int) -> torch.Tensor:
    """The gradients of the rep expanded heads summed back onto their KV
    head."""
    if rep == 1:
        return g
    return g.reshape(-1, rep, *g.shape[1:]).sum(dim=1)


class _RingFlashCore(torch.autograd.Function):
    """(BH, L, D) ring flash attention.  kbh/vbh are at the native KV head
    count (BKV = BH / rep rows) and circulate at that count; blocks expand
    them transiently."""

    @staticmethod
    def forward(ctx, qbh, kbh, vbh, comm, causal, rep, block_q, block_k,
                scale):
        p, me = comm.size, comm.rank

        def block(k_c, v_c, is_diag):
            return flash_fwd_block(
                qbh, _repeat_heads(k_c, rep, 0), _repeat_heads(v_c, rep, 0),
                causal=causal and is_diag, block_q=block_q, block_k=block_k,
                scale=scale, out_dtype=torch.float32)

        k_cur, v_cur = kbh, vbh
        o = lse = None
        for i in range(p):
            if i:
                k_cur, v_cur = innerjit.shift_raw([k_cur, v_cur], comm)
            if i == 0:
                o, lse = block(k_cur, v_cur, True)
            elif not causal or me >= i:
                o, lse = _lse_combine(o, lse, *block(k_cur, v_cur, False))
        o = o.to(qbh.dtype)
        ctx.save_for_backward(qbh, kbh, vbh, o, lse)
        ctx.opts = (comm, causal, rep, block_q, block_k, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        qbh, kbh, vbh, o, lse = ctx.saved_tensors
        comm, causal, rep, block_q, block_k, scale = ctx.opts
        p, me = comm.size, comm.rank
        do = do.contiguous()
        delta = torch.sum(do.float() * o.float(), dim=-1, keepdim=True)
        dq = torch.zeros(qbh.shape, dtype=torch.float32, device=qbh.device)
        dk = torch.zeros(kbh.shape, dtype=torch.float32, device=kbh.device)
        dv = torch.zeros(vbh.shape, dtype=torch.float32, device=vbh.device)
        k_cur, v_cur = kbh, vbh
        for i in range(p):
            if i == 0 or not causal or me >= i:
                dq_b, dk_b, dv_b = flash_bwd_block(
                    qbh, _repeat_heads(k_cur, rep, 0),
                    _repeat_heads(v_cur, rep, 0), do, lse, delta,
                    causal=causal and i == 0, block_q=block_q,
                    block_k=block_k, scale=scale, out_dtype=torch.float32)
                dq += dq_b
                dk += _gsum(dk_b, rep)
                dv += _gsum(dv_b, rep)
            # dk/dv ride one hop behind their chunk's k/v (accumulate, then
            # move), in the same exchange as the next step's k/v.
            if i < p - 1:
                dk, dv, k_cur, v_cur = innerjit.shift_raw(
                    [dk, dv, k_cur, v_cur], comm)
            else:
                dk, dv = innerjit.shift_raw([dk, dv], comm)
        return (dq.to(qbh.dtype), dk.to(kbh.dtype), dv.to(vbh.dtype),
                None, None, None, None, None, None)


def _bh(x: torch.Tensor) -> torch.Tensor:
    """(B, L, H, D) -> contiguous (B*H, L, D)."""
    B, L, H, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * H, L, D).contiguous()


def _unbh(obh: torch.Tensor, B: int, H: int) -> torch.Tensor:
    BH, L, D = obh.shape
    return obh.reshape(B, H, L, D).permute(0, 2, 1, 3)


def ring_flash_attention_batched(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    axis: str = AXIS_SP, causal: bool = False,
    scale: Optional[float] = None, block_q: Optional[int] = None,
    block_k: Optional[int] = None, mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Ring attention with the flash block ops, batched: q (B, L_local, H,
    D), k/v (B, L_local, KV, D).  Batch folds into the kernels' BH rows
    (one launch and one exchange a step for the whole batch)."""
    B, L, H, D = q.shape
    rep = H // k.shape[2]
    if scale is None:
        scale = float(1.0 / np.sqrt(D))
    bq = _flash_auto_block(L) if block_q is None else block_q
    bk = _flash_auto_block(k.shape[1]) if block_k is None else block_k
    comm = innerjit.axis_comm(axis, mesh)
    obh = _RingFlashCore.apply(_bh(q), _bh(k), _bh(v), comm, causal, rep,
                               bq, bk, scale)
    return _unbh(obh, B, H)


def ring_flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    axis: str = AXIS_SP, causal: bool = False,
    scale: Optional[float] = None, block_q: Optional[int] = None,
    block_k: Optional[int] = None, mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Ring attention with the flash block ops: the contract of
    :func:`ring_attention` — this rank's q (L_local, H, D), k/v (L_local,
    KV, D) — with per-chunk compute streamed through the flash kernels."""
    return ring_flash_attention_batched(
        q[None], k[None], v[None], axis=axis, causal=causal, scale=scale,
        block_q=block_q, block_k=block_k, mesh=mesh)[0]


# -------------------------------------------- zigzag (balanced causal) ring
#
# The contiguous-chunk causal ring is load-imbalanced: rank d computes d+1
# chunk-blocks.  The zigzag layout splits the sequence into 2p chunks and
# gives rank d the PAIR (d, 2p-1-d) — one early, one late — so every rank
# computes the same block area at every ring step:
#   * step 0 (own pair):   qa x ka diag + qb x ka full + qb x kb diag
#   * src < me ("past"):   [qa;qb] x ka   — one full (2Lc x Lc) block
#   * src > me ("future"): qb x [ka;kb]   — one full (Lc x 2Lc) block


def zigzag_indices(L: int, p: int) -> np.ndarray:
    """Row order mapping a contiguous (L, ...) sequence into the zigzag
    layout: rank d's shard is chunks (d, 2p-1-d) of the 2p-chunk split.
    ``x[zigzag_indices(L, p)]`` lays rows rank-contiguously; invert with
    ``np.argsort``."""
    if L % (2 * p):
        raise ValueError(f"L={L} not divisible by 2p={2 * p}")
    Lc = L // (2 * p)
    order: List[int] = []
    for d in range(p):
        order.extend(range(d * Lc, (d + 1) * Lc))
        order.extend(range((2 * p - 1 - d) * Lc, (2 * p - d) * Lc))
    return np.asarray(order)


class _ZigzagCore(torch.autograd.Function):
    """(BH, 2*Lc, D) zigzag ring flash attention (causal).  Rows are the
    rank's (early, late) chunk pair; kbh/vbh at native KV head count."""

    @staticmethod
    def forward(ctx, qbh, kbh, vbh, comm, rep, block_q, block_k, scale):
        p, me = comm.size, comm.rank
        Lc = qbh.shape[1] // 2
        qa, qb = qbh[:, :Lc].contiguous(), qbh[:, Lc:].contiguous()

        def blk(q, k, v, causal):
            return flash_fwd_block(
                q, _repeat_heads(k.contiguous(), rep, 0),
                _repeat_heads(v.contiguous(), rep, 0), causal=causal,
                block_q=block_q, block_k=block_k, scale=scale,
                out_dtype=torch.float32)

        k_cur, v_cur = kbh, vbh
        o = lse = None
        for i in range(p):
            if i:
                k_cur, v_cur = innerjit.shift_raw([k_cur, v_cur], comm)
            ka, va = k_cur[:, :Lc], v_cur[:, :Lc]
            if i == 0:
                o_a, lse_a = blk(qa, ka, va, True)
                o_b1, lse_b1 = blk(qb, ka, va, False)
                o_b2, lse_b2 = blk(qb, k_cur[:, Lc:], v_cur[:, Lc:], True)
                o_b, lse_b = _lse_combine(o_b1, lse_b1, o_b2, lse_b2)
                o = torch.cat([o_a, o_b], dim=1)
                lse = torch.cat([lse_a, lse_b], dim=1)
            elif me >= i:
                # src < me: the whole local pair attends the early half.
                o, lse = _lse_combine(o, lse, *blk(qbh, ka, va, False))
            else:
                # src > me: only the late chunk attends — the full pair.
                o_blk, lse_blk = blk(qb, k_cur, v_cur, False)
                o_pad = torch.cat([torch.zeros_like(o_blk), o_blk], dim=1)
                lse_pad = torch.cat([torch.full_like(lse_blk, NEG_INF),
                                     lse_blk], dim=1)
                o, lse = _lse_combine(o, lse, o_pad, lse_pad)
        o = o.to(qbh.dtype)
        ctx.save_for_backward(qbh, kbh, vbh, o, lse)
        ctx.opts = (comm, rep, block_q, block_k, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        qbh, kbh, vbh, o, lse = ctx.saved_tensors
        comm, rep, block_q, block_k, scale = ctx.opts
        p, me = comm.size, comm.rank
        Lc = qbh.shape[1] // 2
        do = do.contiguous()
        delta = torch.sum(do.float() * o.float(), dim=-1, keepdim=True)
        qa, qb = qbh[:, :Lc].contiguous(), qbh[:, Lc:].contiguous()
        do_a, do_b = do[:, :Lc].contiguous(), do[:, Lc:].contiguous()
        lse_a, lse_b = lse[:, :Lc].contiguous(), lse[:, Lc:].contiguous()
        dl_a, dl_b = delta[:, :Lc].contiguous(), delta[:, Lc:].contiguous()

        def bblk(q, k, v, dob, lseb, deltab, causal):
            dq_b, dk_b, dv_b = flash_bwd_block(
                q, _repeat_heads(k.contiguous(), rep, 0),
                _repeat_heads(v.contiguous(), rep, 0), dob, lseb, deltab,
                causal=causal, block_q=block_q, block_k=block_k,
                scale=scale, out_dtype=torch.float32)
            return dq_b, _gsum(dk_b, rep), _gsum(dv_b, rep)

        dq = torch.zeros(qbh.shape, dtype=torch.float32, device=qbh.device)
        dk = torch.zeros(kbh.shape, dtype=torch.float32, device=kbh.device)
        dv = torch.zeros(vbh.shape, dtype=torch.float32, device=vbh.device)
        k_cur, v_cur = kbh, vbh
        for i in range(p):
            ka, va = k_cur[:, :Lc], v_cur[:, :Lc]
            if i == 0:
                dq_a, dk_a, dv_a = bblk(qa, ka, va, do_a, lse_a, dl_a, True)
                dq_b1, dk_b1, dv_b1 = bblk(qb, ka, va, do_b, lse_b, dl_b,
                                           False)
                dq_b2, dk_b2, dv_b2 = bblk(qb, k_cur[:, Lc:], v_cur[:, Lc:],
                                           do_b, lse_b, dl_b, True)
                dq += torch.cat([dq_a, dq_b1 + dq_b2], dim=1)
                dk += torch.cat([dk_a + dk_b1, dk_b2], dim=1)
                dv += torch.cat([dv_a + dv_b1, dv_b2], dim=1)
            elif me >= i:
                dq_p, dk_p, dv_p = bblk(qbh, ka, va, do, lse, delta, False)
                dq += dq_p
                dk[:, :Lc] += dk_p
                dv[:, :Lc] += dv_p
            else:
                dq_f, dk_f, dv_f = bblk(qb, k_cur, v_cur, do_b, lse_b, dl_b,
                                        False)
                dq[:, Lc:] += dq_f
                dk += dk_f
                dv += dv_f
            # Gradients ride one hop behind their chunk pair — home after
            # p hops.
            if i < p - 1:
                dk, dv, k_cur, v_cur = innerjit.shift_raw(
                    [dk, dv, k_cur, v_cur], comm)
            else:
                dk, dv = innerjit.shift_raw([dk, dv], comm)
        return (dq.to(qbh.dtype), dk.to(kbh.dtype), dv.to(vbh.dtype),
                None, None, None, None, None)


def zigzag_ring_flash_attention_batched(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    axis: str = AXIS_SP, scale: Optional[float] = None,
    block_q: Optional[int] = None, block_k: Optional[int] = None,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Balanced causal ring attention, batched: this rank's q (B, 2*Lc, H,
    D), k/v (B, 2*Lc, KV, D) in the ZIGZAG layout (global chunks (d,
    2p-1-d)); output in the same layout.  Causal only."""
    B, L2, H, D = q.shape
    rep = H // k.shape[2]
    if scale is None:
        scale = float(1.0 / np.sqrt(D))
    comm = innerjit.axis_comm(axis, mesh)
    obh = _ZigzagCore.apply(_bh(q), _bh(k), _bh(v), comm, rep, block_q,
                            block_k, scale)
    return _unbh(obh, B, H)


def zigzag_ring_flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    axis: str = AXIS_SP, scale: Optional[float] = None,
    block_q: Optional[int] = None, block_k: Optional[int] = None,
    mesh: Optional[Mesh] = None,
) -> torch.Tensor:
    """Balanced causal ring attention: this rank's q (2*Lc, H, D), k/v
    (2*Lc, KV, D) in the zigzag layout; output in the same layout."""
    return zigzag_ring_flash_attention_batched(
        q[None], k[None], v[None], axis=axis, scale=scale, block_q=block_q,
        block_k=block_k, mesh=mesh)[0]


# ---------------------------------------------------- global-array wrappers
#
# A function of the global arrays, which every rank holds whole: each rank
# cuts its chunk, runs the body, and the chunks are gathered back.  The
# cut's backward gathers the chunks' gradients and the gather's backward
# takes this rank's chunk of the gradient, so the gradients, like the
# values, are the global ones on every rank.


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        n = x.shape[dim] // comm.size
        return x.narrow(dim, comm.rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        parts = innerjit._gather_parts(g.contiguous(), ctx.comm)
        return torch.cat(parts, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return torch.cat(innerjit._gather_parts(x.contiguous(), comm), dim)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.comm.size
        return g.narrow(ctx.dim, ctx.comm.rank * n, n), None, None


def _global_fn(body, mesh: Mesh, axis: str):
    comm = mesh.comm(axis)

    def fn(q, k, v):
        o = body(*(_Scatter.apply(x, comm, 0) for x in (q, k, v)))
        return _Gather.apply(o, comm, 0)

    return fn


def make_zigzag_ring_attention(mesh: Mesh, axis: str = AXIS_SP):
    """Balanced causal ring over ``mesh``: ``fn(q, k, v) -> o`` on the
    global CONTIGUOUS (L, H, D) arrays — rows are permuted into the zigzag
    layout on the way in and back on the way out.  Training loops should
    use :func:`make_zigzag_layout` instead, which permutes the token ids
    at the data boundary and keeps activations zigzag-resident."""
    p = mesh.shape[axis]

    def body(q, k, v):
        return zigzag_ring_flash_attention(q, k, v, axis=axis, mesh=mesh)

    inner = _global_fn(body, mesh, axis)

    def fn(q, k, v):
        idx = torch.as_tensor(zigzag_indices(q.shape[0], p), device=q.device)
        inv = torch.argsort(idx)
        return inner(q[idx], k[idx], v[idx])[inv]

    return fn


def make_zigzag_layout(mesh: Mesh, axis: str = AXIS_SP):
    """Zigzag-RESIDENT training layout: permute token ids and positions
    into the zigzag row order once at the data boundary, run the network on
    zigzag-resident activations, and call the ring attention directly.

    Returns ``(to_zigzag, from_zigzag, attention)``: ``to_zigzag(x,
    row_axis=0)`` permutes a per-token array into zigzag order (feed
    ``to_zigzag(torch.arange(L))`` as the positions), ``from_zigzag(y,
    row_axis=0)`` is the inverse, and ``attention(q, k, v)`` is the
    balanced causal ring on global zigzag-resident q (L, H, D), k/v (L,
    KV, D)."""
    p = mesh.shape[axis]

    def to_zigzag(x, row_axis: int = 0):
        x = torch.as_tensor(x)
        idx = torch.as_tensor(zigzag_indices(x.shape[row_axis], p),
                              device=x.device)
        return torch.index_select(x, row_axis, idx)

    def from_zigzag(y, row_axis: int = 0):
        y = torch.as_tensor(y)
        inv = torch.as_tensor(np.argsort(zigzag_indices(y.shape[row_axis],
                                                        p)), device=y.device)
        return torch.index_select(y, row_axis, inv)

    attention = _global_fn(
        lambda q, k, v: zigzag_ring_flash_attention(q, k, v, axis=axis,
                                                    mesh=mesh), mesh, axis)
    return to_zigzag, from_zigzag, attention


def make_ring_attention(mesh: Mesh, axis: str = AXIS_SP,
                        causal: bool = False, impl: str = "ring"):
    """Sequence-parallel attention over ``mesh``: ``fn(q, k, v) -> o`` on
    the global (L, H, D) arrays (every rank passes them whole and gets the
    whole output); ``impl`` chooses 'ring_flash' (production), 'ring'
    (einsum blocks — the exact oracle), 'ulysses' or 'ulysses_flash'."""
    kw = dict(axis=axis, causal=causal, mesh=mesh)
    if impl == "ring":
        body = lambda q, k, v: ring_attention(q, k, v, **kw)  # noqa: E731
    elif impl == "ring_flash":
        body = lambda q, k, v: ring_flash_attention(q, k, v, **kw)  # noqa: E731
    elif impl == "ulysses":
        body = lambda q, k, v: ulysses_attention(q, k, v, **kw)  # noqa: E731
    elif impl == "ulysses_flash":
        body = lambda q, k, v: ulysses_attention(  # noqa: E731
            q, k, v, local_impl="flash", **kw)
    else:
        raise ValueError("impl must be 'ring', 'ring_flash', 'ulysses', "
                         "or 'ulysses_flash'")
    return _global_fn(body, mesh, axis)
