"""Flash attention: hand-written CUDA kernels and their plain versions.

Counterpart of ``torchmpi_tpu/ops/flash_attention.py``.  Three kernels, each
with a plain PyTorch version of the same algebra beside it:

- the online-softmax forward (running max, denominator and output
  accumulator in f32 across k tiles, causal fill -1e30, whole k tiles above
  the diagonal skipped): ``csrc/flash_attention_fwd.cu``,
  :func:`_flash_bh_plain`.  It runs on the tensor cores (wgmma, TMA
  staging; the shared helpers are ``csrc/hopper.cuh``): bf16 inputs in one
  product, f32 inputs, split into bf16 hi + lo parts by one launch of
  :mod:`.bf16_split` for q, k and v, in three bf16 products; the source
  names the choice and its numerics;
- the FlashAttention-2 backward in two passes, from the forward's lse and
  delta = rowsum(do * o): dq (``tmpi_flash_bwd_dq``,
  :func:`_flash_bh_bwd_dq_plain`) and dk/dv (``tmpi_flash_bwd_dkv``,
  :func:`_flash_bh_bwd_dkv_plain`), both in ``csrc/flash_attention_bwd.cu``,
  on the tensor cores as the forward: bf16 inputs in one product, f32
  inputs, split by one launch of :mod:`.bf16_split` for q, k, v and do that
  both passes read, in three bf16 products.

The kernels take head size 128 (every Llama geometry the repo names) and
64 (ViT-B/16's), :data:`KERNEL_HEAD_DIMS`: each is a template instance of
every kernel; the plain versions take any head size.

A CPU tensor takes the plain version; a CUDA tensor goes to the kernel or
raises, never falling back.  :func:`flash_attention` is differentiable
through :class:`_FlashCore`, the counterpart of the JAX ``custom_vjp``;
``flash_fwd_block``/``flash_bwd_block`` are plain block ops, as in JAX.

The tile sizes ``block_q``/``block_k`` keep their legality contract
(:func:`_auto_block`, :func:`_resolve_blocks`) so that the same sequence
lengths are accepted in both packages and callers pick the same attention
path; the plain versions tile by them, the kernels tile their own way.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
from torch.utils.flop_counter import FlopCounterMode, \
    register_flop_formula

from .bf16_split import bf16_split

NEG_INF = -1e30
# The head sizes the CUDA kernels are built for: 128, every Llama geometry
# the repo names, and 64, ViT-B/16's (d_model 768 over 12 heads).  Each is
# a template instance of every kernel; any other D raises.
KERNEL_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of each CUDA kernel in this process (the plain versions do not
# count); chip_smoke.py reads them to show the main path went through the
# kernels.
flash_fwd_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0


def _auto_block(L: int, cap: int = 1024) -> int:
    """Default tile size: the whole sequence when L <= cap (a single block
    is always tile-legal), else the largest power-of-two divisor of L up to
    ``cap``.  Low-2-adic long sequences (no >=128 tile divides them) raise
    rather than silently degrading to sliver tiles."""
    if L <= cap:
        return L
    b = cap
    while b > 1 and L % b:
        b //= 2
    if b < 128:
        raise ValueError(
            f"seq len {L} has no power-of-two tile in [128, {cap}]; pad the "
            f"sequence or pass block_q/block_k explicitly")
    return b


def _resolve_blocks(Lq: int, Lk: int, block_q: Optional[int],
                    block_k: Optional[int]):
    """Clamp + validate tile sizes against the actual sequence lengths."""
    block_q = _auto_block(Lq) if block_q is None else min(block_q, Lq)
    block_k = _auto_block(Lk) if block_k is None else min(block_k, Lk)
    if Lq % block_q or Lk % block_k:
        raise ValueError(f"seq lens ({Lq}, {Lk}) not divisible by blocks "
                         f"({block_q}, {block_k})")
    return block_q, block_k


def _block_op_guard(name: str, *ts: torch.Tensor) -> None:
    """The block ops are not differentiable (as in JAX, where they are bare
    ``pallas_call`` s): refuse a call that would need a gradient rather
    than build a graph through the plain version only."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError(
            f"{name} is a non-differentiable block op; call it under "
            f"torch.no_grad(), or use flash_attention for a gradient")


def _block_scores(qb, kb, q_start: int, k_start: int, causal: bool,
                  scale: float):
    """f32 scores of one (q tile, k tile), causal entries filled -1e30."""
    s = torch.einsum("bqd,bkd->bqk", qb, kb) * scale
    if causal:
        rows = q_start + torch.arange(qb.shape[1], device=qb.device)[:, None]
        cols = k_start + torch.arange(kb.shape[1], device=qb.device)[None, :]
        s = torch.where(rows >= cols, s,
                        torch.tensor(NEG_INF, device=qb.device))
    return s


def _flash_bh_plain(qbh, kbh, vbh, *, causal: bool, block_q: int,
                    block_k: int, scale: float, out_dtype):
    """The reference: the kernel's online-softmax algebra in f32 PyTorch,
    tiled by (block_q, block_k) as the TPU kernel's grid is."""
    BH, L, D = qbh.shape
    Lk = kbh.shape[1]
    q = qbh.float()
    k = kbh.float()
    v = vbh.float()
    o = torch.empty((BH, L, D), dtype=out_dtype, device=qbh.device)
    lse = torch.empty((BH, L, 1), dtype=torch.float32, device=qbh.device)
    for q_start in range(0, L, block_q):
        qb = q[:, q_start:q_start + block_q]
        bq = qb.shape[1]
        acc = torch.zeros((BH, bq, D), dtype=torch.float32, device=q.device)
        m = torch.full((BH, bq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((BH, bq), dtype=torch.float32, device=q.device)
        for k_start in range(0, Lk, block_k):
            if causal and q_start + bq - 1 < k_start:
                break                  # every later block is above the diagonal
            kb = k[:, k_start:k_start + block_k]
            vb = v[:, k_start:k_start + block_k]
            s = _block_scores(qb, kb, q_start, k_start, causal, scale)
            m_new = torch.maximum(m, s.amax(dim=2))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=2)
            m = m_new
            acc = acc * corr[..., None] + torch.einsum("bqk,bkd->bqd", p, vb)
        l = torch.clamp(l, min=1e-20)
        o[:, q_start:q_start + bq] = (acc / l[..., None]).to(out_dtype)
        lse[:, q_start:q_start + bq, 0] = m + torch.log(l)
    return o, lse


def _flash_bh_bwd_dq_plain(qbh, kbh, vbh, dobh, lse, delta, *, causal: bool,
                           block_q: int, block_k: int, scale: float,
                           out_dtype):
    """The reference of the dq kernel: the TPU dq pass's algebra in f32
    PyTorch, tiled as its grid is (q tiles, k tiles innermost, whole k tiles
    above the diagonal skipped), dq accumulated per q tile."""
    BH, Lq, D = qbh.shape
    Lk = kbh.shape[1]
    q, k, v, do = qbh.float(), kbh.float(), vbh.float(), dobh.float()
    dq = torch.empty((BH, Lq, D), dtype=out_dtype, device=qbh.device)
    for q_start in range(0, Lq, block_q):
        qb = q[:, q_start:q_start + block_q]
        dob = do[:, q_start:q_start + block_q]
        bq = qb.shape[1]
        lse_b = lse[:, q_start:q_start + bq].float()
        delta_b = delta[:, q_start:q_start + bq].float()
        acc = torch.zeros((BH, bq, D), dtype=torch.float32, device=q.device)
        for k_start in range(0, Lk, block_k):
            if causal and q_start + bq - 1 < k_start:
                break
            kb = k[:, k_start:k_start + block_k]
            vb = v[:, k_start:k_start + block_k]
            p = torch.exp(_block_scores(qb, kb, q_start, k_start, causal,
                                        scale) - lse_b)
            dp = torch.einsum("bqd,bkd->bqk", dob, vb)
            ds = p * (dp - delta_b) * scale
            acc = acc + torch.einsum("bqk,bkd->bqd", ds, kb)
        dq[:, q_start:q_start + bq] = acc.to(out_dtype)
    return dq


def _flash_bh_bwd_dkv_plain(qbh, kbh, vbh, dobh, lse, delta, *,
                            causal: bool, block_q: int, block_k: int,
                            scale: float, out_dtype):
    """The reference of the dk/dv kernel: the TPU dk/dv pass's algebra in
    f32 PyTorch, tiled as its grid is (k tiles, q tiles innermost, q tiles
    wholly above the diagonal skipped), dk and dv accumulated per k tile."""
    BH, Lq, D = qbh.shape
    Lk = kbh.shape[1]
    q, k, v, do = qbh.float(), kbh.float(), vbh.float(), dobh.float()
    dk = torch.empty((BH, Lk, D), dtype=out_dtype, device=qbh.device)
    dv = torch.empty((BH, Lk, D), dtype=out_dtype, device=qbh.device)
    for k_start in range(0, Lk, block_k):
        kb = k[:, k_start:k_start + block_k]
        vb = v[:, k_start:k_start + block_k]
        bk = kb.shape[1]
        dk_acc = torch.zeros((BH, bk, D), dtype=torch.float32, device=q.device)
        dv_acc = torch.zeros((BH, bk, D), dtype=torch.float32, device=q.device)
        for q_start in range(0, Lq, block_q):
            qb = q[:, q_start:q_start + block_q]
            bq = qb.shape[1]
            if causal and q_start + bq - 1 < k_start:
                continue
            dob = do[:, q_start:q_start + bq]
            p = torch.exp(_block_scores(qb, kb, q_start, k_start, causal,
                                        scale)
                          - lse[:, q_start:q_start + bq].float())
            dv_acc = dv_acc + torch.einsum("bqk,bqd->bkd", p, dob)
            dp = torch.einsum("bqd,bkd->bqk", dob, vb)
            ds = p * (dp - delta[:, q_start:q_start + bq].float()) * scale
            dk_acc = dk_acc + torch.einsum("bqk,bqd->bkd", ds, qb)
        dk[:, k_start:k_start + bk] = dk_acc.to(out_dtype)
        dv[:, k_start:k_start + bk] = dv_acc.to(out_dtype)
    return dk, dv


def _check_kernel_inputs(qbh, kbh, vbh, out_dtype) -> None:
    if not (qbh.is_cuda and kbh.is_cuda and vbh.is_cuda):
        raise ValueError("q, k, v must all lie on the same CUDA device")
    if not (qbh.device == kbh.device == vbh.device):
        raise ValueError("q, k, v lie on different devices")
    if not (qbh.dtype == kbh.dtype == vbh.dtype) \
            or qbh.dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {qbh.dtype}, {kbh.dtype}, {vbh.dtype}")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"kernel writes float32 or bfloat16, not {out_dtype}")
    if qbh.dim() != 3 or kbh.dim() != 3 or vbh.dim() != 3:
        raise ValueError("q, k, v must be (BH, L, D)")
    BH, _, D = qbh.shape
    if kbh.shape != vbh.shape or kbh.shape[0] != BH or kbh.shape[2] != D:
        raise ValueError(f"k/v shape {tuple(kbh.shape)}/{tuple(vbh.shape)} "
                         f"does not match q {tuple(qbh.shape)}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take head size "
                         f"{' or '.join(map(str, KERNEL_HEAD_DIMS))}, "
                         f"got {D}")
    if not (1 <= BH <= 65535):
        raise ValueError(f"batch*heads {BH} outside the kernel's grid "
                         f"[1, 65535]")
    if not (qbh.is_contiguous() and kbh.is_contiguous()
            and vbh.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")


def _check_bwd_kernel_inputs(qbh, kbh, vbh, dobh, lse, delta,
                             out_dtype) -> None:
    _check_kernel_inputs(qbh, kbh, vbh, out_dtype)
    if dobh.shape != qbh.shape or dobh.dtype != qbh.dtype \
            or dobh.device != qbh.device or not dobh.is_contiguous():
        raise ValueError(f"do must be a contiguous {qbh.dtype} tensor of q's "
                         f"shape {tuple(qbh.shape)} on {qbh.device}, got "
                         f"{dobh.dtype} {tuple(dobh.shape)} on {dobh.device}")
    row_shape = (qbh.shape[0], qbh.shape[1], 1)
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != row_shape or t.dtype != torch.float32 \
                or t.device != qbh.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor of "
                             f"shape {row_shape} on {qbh.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _check_aligned(kind: str = "bf16", **tensors: torch.Tensor) -> None:
    """The tensor-core kernels stage their bf16 inputs (f32 inputs: their
    bf16 split, read in 16-byte pieces) with TMA and write their outputs
    in vector stores: each must start on a 16-byte boundary.  ``kind``
    names the input type in the message."""
    bad = [name for name, t in tensors.items() if t.data_ptr() % 16]
    if bad:
        raise ValueError(f"the {kind} flash kernels need 16-byte aligned "
                         f"tensors; {', '.join(bad)} is not (a view at an "
                         f"odd offset? pass a .clone())")


def _kernel_entry(symbol: str):
    """A kernel entry of the built library, typed for ctypes: its tensor
    pointers (``tmpi_flash_fwd``: q, k, v, o, lse of
    ``flash_attention_fwd``; ``tmpi_flash_bwd_dq``: q, k, v, do, lse, delta,
    dq and ``tmpi_flash_bwd_dkv``: ... dk, dv of ``flash_attention_bwd``),
    then bh, lq, lk, head_dim, scale, causal, the two dtype codes and the
    stream; it returns the launch's CUDA error code."""
    from .. import _build

    source, n_ptrs = {"tmpi_flash_fwd": ("flash_attention_fwd", 5),
                      "tmpi_flash_bwd_dq": ("flash_attention_bwd", 7),
                      "tmpi_flash_bwd_dkv": ("flash_attention_bwd", 8)}[symbol]
    fn = getattr(_build.load(source), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    return fn


def _launch(symbol: str, ins, outs, *, causal: bool, scale: float,
            feed=None) -> None:
    """Launch ``symbol`` on the current stream of q's device, reading
    ``ins`` (q, k, v first) and writing ``outs``; raises if the launch was
    refused.  ``feed``, where given, holds the buffers the kernel reads in
    place of ``ins`` (f32 inputs as their bf16 split), which still give
    the shapes and the input type's code."""
    qbh, kbh = ins[0], ins[1]
    BH, Lq, D = qbh.shape
    fn = _kernel_entry(symbol)
    with torch.cuda.device(qbh.device):
        stream = torch.cuda.current_stream(qbh.device).cuda_stream
        err = fn(*(t.data_ptr() for t in (*(feed or ins), *outs)), BH, Lq,
                 kbh.shape[1], D, float(scale), int(causal),
                 _DTYPE_CODES[qbh.dtype], _DTYPE_CODES[outs[0].dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")


def _flash_bh_kernel(qbh, kbh, vbh, *, causal: bool, scale: float,
                     out_dtype):
    """The forward (``tmpi_flash_fwd``); f32 inputs go to it as their bf16
    hi + lo split, made by one launch of the split kernel for all three."""
    global flash_fwd_launches
    _check_kernel_inputs(qbh, kbh, vbh, out_dtype)
    BH, L, D = qbh.shape
    o = torch.empty((BH, L, D), dtype=out_dtype, device=qbh.device)
    lse = torch.empty((BH, L, 1), dtype=torch.float32, device=qbh.device)
    f32 = qbh.dtype == torch.float32
    _check_aligned("f32" if f32 else "bf16", q=qbh, k=kbh, v=vbh, o=o)
    feed = bf16_split("flash_attention_fwd", qbh, kbh, vbh) if f32 else None
    _launch("tmpi_flash_fwd", (qbh, kbh, vbh), (o, lse), causal=causal,
            scale=scale, feed=feed)
    flash_fwd_launches += 1
    return o, lse


def _bwd_split(qbh, kbh, vbh, dobh, lse, delta, out_dtype):
    """What the backward kernels read in place of q, k, v and do: for f32
    inputs their bf16 hi + lo buffers, made by one split launch for all
    four, which both passes can share; for bf16 inputs nothing, ``()``.
    Checks the inputs, and their alignment, before any split or launch."""
    _check_bwd_kernel_inputs(qbh, kbh, vbh, dobh, lse, delta, out_dtype)
    f32 = qbh.dtype == torch.float32
    _check_aligned("f32" if f32 else "bf16", q=qbh, k=kbh, v=vbh, do=dobh)
    if not f32:
        return ()
    return tuple(bf16_split("flash_attention_bwd", qbh, kbh, vbh, dobh))


def _flash_bh_bwd_dq_kernel(qbh, kbh, vbh, dobh, lse, delta, *, causal: bool,
                            scale: float, out_dtype, split=None):
    """The dq pass (``tmpi_flash_bwd_dq``).  f32 inputs read ``split``
    (:func:`_bwd_split`'s buffers), or are split here with one launch."""
    global flash_bwd_dq_launches
    if split is None:
        split = _bwd_split(qbh, kbh, vbh, dobh, lse, delta, out_dtype)
    dq = torch.empty(qbh.shape, dtype=out_dtype, device=qbh.device)
    _check_aligned("f32" if split else "bf16", dq=dq)
    _launch("tmpi_flash_bwd_dq", (qbh, kbh, vbh, dobh, lse, delta), (dq,),
            causal=causal, scale=scale,
            feed=(*split, lse, delta) if split else None)
    flash_bwd_dq_launches += 1
    return dq


def _flash_bh_bwd_dkv_kernel(qbh, kbh, vbh, dobh, lse, delta, *,
                             causal: bool, scale: float, out_dtype,
                             split=None):
    """The dk/dv pass (``tmpi_flash_bwd_dkv``); ``split`` as for dq."""
    global flash_bwd_dkv_launches
    if split is None:
        split = _bwd_split(qbh, kbh, vbh, dobh, lse, delta, out_dtype)
    dk = torch.empty(kbh.shape, dtype=out_dtype, device=kbh.device)
    dv = torch.empty(kbh.shape, dtype=out_dtype, device=kbh.device)
    _check_aligned("f32" if split else "bf16", dk=dk, dv=dv)
    _launch("tmpi_flash_bwd_dkv", (qbh, kbh, vbh, dobh, lse, delta),
            (dk, dv), causal=causal, scale=scale,
            feed=(*split, lse, delta) if split else None)
    flash_bwd_dkv_launches += 1
    return dk, dv


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


# ----------------------------------------------------------------- FLOPs

#: multiply-add FLOPs per kept (q, k) pair and head-dim column: the
#: forward's q.k and p.v (4); the dq pass's s, dp and dq (6) and the dk/dv
#: pass's s, dp, dv and dk (8), 14 for the whole backward.
FLOPS_PER_PAIR = {"fwd": 4, "dq": 6, "dkv": 8, "bwd": 14}


def causal_pairs(lq: int, lk: int, causal: bool) -> int:
    """(q, k) pairs a mask keeps: all of them, or those with row >= col
    (``sum(min(lk, i + 1) for i in range(lq))``)."""
    if not causal:
        return lq * lk
    n = min(lq, lk)
    return n * (n + 1) // 2 + (lq - n) * lk


def attention_flops(bh: int, lq: int, lk: int, d: int, causal: bool,
                    part: str) -> float:
    """FLOPs of one attention call over the kept (q, k) pairs, ``part``
    one of :data:`FLOPS_PER_PAIR`: the closed formula that a
    ``FlopCounterMode`` counts for each call of :data:`FLASH_OPS`."""
    return float(FLOPS_PER_PAIR[part]) * bh * causal_pairs(lq, lk, causal) \
        * d


def _flash_bh_impl(qbh, kbh, vbh, causal, block_q, block_k, scale,
                   out_dtype):
    if _on_cpu(qbh, kbh, vbh):
        return _flash_bh_plain(qbh, kbh, vbh, causal=causal, block_q=block_q,
                               block_k=block_k, scale=scale,
                               out_dtype=out_dtype)
    return _flash_bh_kernel(qbh, kbh, vbh, causal=causal, scale=scale,
                            out_dtype=out_dtype)


def _flash_bh_bwd_impl(qbh, kbh, vbh, dobh, lse, delta, causal, block_q,
                       block_k, scale, out_dtype):
    if _on_cpu(qbh, kbh, vbh, dobh, lse, delta):
        kw = dict(causal=causal, block_q=block_q, block_k=block_k,
                  scale=scale)
        dq = _flash_bh_bwd_dq_plain(
            qbh, kbh, vbh, dobh, lse, delta,
            out_dtype=qbh.dtype if out_dtype is None else out_dtype, **kw)
        dk, dv = _flash_bh_bwd_dkv_plain(
            qbh, kbh, vbh, dobh, lse, delta,
            out_dtype=kbh.dtype if out_dtype is None else out_dtype, **kw)
        return dq, dk, dv
    # The kernels take q and k of one dtype, so dq's and dk/dv's agree;
    # f32 inputs are split once, for both passes.
    out_dtype = qbh.dtype if out_dtype is None else out_dtype
    kw = dict(causal=causal, scale=scale, out_dtype=out_dtype,
              split=_bwd_split(qbh, kbh, vbh, dobh, lse, delta, out_dtype))
    dq = _flash_bh_bwd_dq_kernel(qbh, kbh, vbh, dobh, lse, delta, **kw)
    return (dq, *_flash_bh_bwd_dkv_kernel(qbh, kbh, vbh, dobh, lse, delta,
                                          **kw))


# The forward and the whole backward as operators of their own, so that a
# dispatch mode sees each call as one op and not its body: a
# ``FlopCounterMode`` counts them by the closed formula (it cannot see a
# ctypes launch, and must not count the plain version's products beside
# it), and selective checkpointing recomputes them as a whole.
_fwd_op = torch.library.custom_op(
    "torchmpi_tpu_torch::flash_fwd", _flash_bh_impl, mutates_args=(),
    schema="(Tensor qbh, Tensor kbh, Tensor vbh, bool causal, int block_q, "
           "int block_k, float scale, ScalarType out_dtype) "
           "-> (Tensor, Tensor)")
_bwd_op = torch.library.custom_op(
    "torchmpi_tpu_torch::flash_bwd", _flash_bh_bwd_impl, mutates_args=(),
    schema="(Tensor qbh, Tensor kbh, Tensor vbh, Tensor dobh, Tensor lse, "
           "Tensor delta, bool causal, int block_q, int block_k, float scale, "
           "ScalarType? out_dtype) -> (Tensor, Tensor, Tensor)")
FLASH_OPS = (torch.ops.torchmpi_tpu_torch.flash_fwd,
             torch.ops.torchmpi_tpu_torch.flash_bwd)


# Tensors without storage (meta, fake) take the kernel route's checks, so
# that only a CPU tensor ever reaches a plain version, and its shapes.
@_fwd_op.register_fake
def _fwd_fake(qbh, kbh, vbh, causal, block_q, block_k, scale, out_dtype):
    _check_kernel_inputs(qbh, kbh, vbh, out_dtype)
    return (qbh.new_empty(qbh.shape, dtype=out_dtype),
            qbh.new_empty((*qbh.shape[:2], 1), dtype=torch.float32))


@_bwd_op.register_fake
def _bwd_fake(qbh, kbh, vbh, dobh, lse, delta, causal, block_q, block_k,
              scale, out_dtype):
    out_dtype = qbh.dtype if out_dtype is None else out_dtype
    _check_bwd_kernel_inputs(qbh, kbh, vbh, dobh, lse, delta, out_dtype)
    return (qbh.new_empty(qbh.shape, dtype=out_dtype),
            kbh.new_empty(kbh.shape, dtype=out_dtype),
            vbh.new_empty(vbh.shape, dtype=out_dtype))


@register_flop_formula(FLASH_OPS[0])
def _fwd_flops(q_shape, k_shape, v_shape, causal, *args, out_shape=None,
               **kwargs) -> float:
    bh, lq, d = q_shape
    return attention_flops(bh, lq, k_shape[1], d, causal, "fwd")


@register_flop_formula(FLASH_OPS[1])
def _bwd_flops(q_shape, k_shape, v_shape, do_shape, lse_shape, delta_shape,
               causal, *args, out_shape=None, **kwargs) -> float:
    bh, lq, d = q_shape
    return attention_flops(bh, lq, k_shape[1], d, causal, "bwd")


def counted_flops(counter: FlopCounterMode) -> float:
    """The FLOPs ``counter`` counted for flash attention's operators."""
    counts = counter.get_flop_counts().get("Global", {})
    return float(sum(counts.get(op, 0) for op in FLASH_OPS))


def _flash_bh(qbh, kbh, vbh, *, causal: bool, block_q: int, block_k: int,
              scale: Optional[float] = None, out_dtype=None):
    """(BH, L, D) flash attention forward; returns (o, lse (BH, L, 1) f32).

    ``kbh``/``vbh`` may have a different sequence length than ``qbh``.
    ``out_dtype`` overrides the output dtype (default: q's)."""
    if scale is None:
        scale = 1.0 / math.sqrt(qbh.shape[-1])
    return _fwd_op(qbh, kbh, vbh, causal, block_q, block_k, scale,
                   qbh.dtype if out_dtype is None else out_dtype)


def _flash_bh_bwd(qbh, kbh, vbh, dobh, lse, delta, *, causal: bool,
                  block_q: int, block_k: int, scale: Optional[float] = None,
                  out_dtype=None):
    """Backward against an externally supplied (lse, delta), each
    (BH, Lq, 1) f32: returns (dq, dk, dv), dq in q's dtype and dk/dv in k's,
    or all in ``out_dtype``.

    For single-device flash, lse and delta come from this call's own
    forward; a ring caller passes the globally combined lse and the delta of
    the final output, and each call then yields one K/V chunk's exact
    gradient contribution."""
    if scale is None:
        scale = 1.0 / math.sqrt(qbh.shape[-1])
    return _bwd_op(qbh, kbh, vbh, dobh, lse, delta, causal, block_q, block_k,
                   scale, out_dtype)


class _FlashCore(torch.autograd.Function):
    """(BH, L, D) flash attention with its FlashAttention-2 backward: the
    counterpart of the JAX package's ``_flash_core`` custom_vjp.  The
    forward saves q, k, v, o and lse; the backward forms
    delta = rowsum(do * o) in f32 (outside the kernels, as in JAX) and runs
    the dq and dk/dv passes."""

    @staticmethod
    def forward(ctx, qbh, kbh, vbh, causal, block_q, block_k, scale):
        o, lse = _flash_bh(qbh, kbh, vbh, causal=causal, block_q=block_q,
                           block_k=block_k, scale=scale)
        ctx.save_for_backward(qbh, kbh, vbh, o, lse)
        ctx.opts = dict(causal=causal, block_q=block_q, block_k=block_k,
                        scale=scale)
        return o

    @staticmethod
    def backward(ctx, dobh):
        qbh, kbh, vbh, obh, lse = ctx.saved_tensors
        # The permuted (B, L, H, D) gradient arrives strided; the kernels
        # take contiguous (BH, L, D).
        dobh = dobh.contiguous()
        delta = torch.sum(dobh.float() * obh.float(), dim=-1, keepdim=True)
        dq, dk, dv = _flash_bh_bwd(qbh, kbh, vbh, dobh, lse, delta,
                                   **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Blocked attention, (B, L, H, D) layout (GQA: repeat K/V first).

    Differentiable through :class:`_FlashCore`: the backward runs the dq and
    dk/dv kernels and never forms the (L, L) score matrix either.  Sequence
    length must be divisible by the (clamped) block sizes."""
    B, L, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k, v must share (B, L, H, D); repeat GQA KV first")
    block_q = _auto_block(L) if block_q is None else min(block_q, L)
    block_k = _auto_block(L) if block_k is None else min(block_k, L)
    if L % block_q or L % block_k:
        raise ValueError(f"seq len {L} not divisible by blocks "
                         f"({block_q}, {block_k})")

    def bh(x):   # (B, L, H, D) -> (B*H, L, D)
        return x.permute(0, 2, 1, 3).reshape(B * H, L, D).contiguous()

    obh = _FlashCore.apply(bh(q), bh(k), bh(v), causal, block_q, block_k,
                           None if scale is None else float(scale))
    return obh.reshape(B, H, L, D).permute(0, 2, 1, 3)


def flash_fwd_block(qbh, kbh, vbh, *, causal: bool,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    scale: Optional[float] = None, out_dtype=None):
    """One attention block: (BH, Lq, D) Q against a (BH, Lk, D) K/V chunk.
    Returns ``(o, lse)`` with o normalized by this block's own denominator
    and lse = m + log(l) per query row.  Not differentiable."""
    _block_op_guard("flash_fwd_block", qbh, kbh, vbh)
    block_q, block_k = _resolve_blocks(qbh.shape[1], kbh.shape[1],
                                       block_q, block_k)
    return _flash_bh(qbh, kbh, vbh, causal=causal, block_q=block_q,
                     block_k=block_k, scale=scale, out_dtype=out_dtype)


def flash_bwd_block(qbh, kbh, vbh, dobh, lse, delta, *, causal: bool,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    scale: Optional[float] = None, out_dtype=None):
    """Gradient contribution of one K/V chunk given the *global* lse and
    delta = rowsum(do * o_final), each (BH, Lq, 1) f32.  Returns
    (dq, dk, dv) for this chunk.  Not differentiable."""
    _block_op_guard("flash_bwd_block", qbh, kbh, vbh, dobh)
    block_q, block_k = _resolve_blocks(qbh.shape[1], kbh.shape[1],
                                       block_q, block_k)
    return _flash_bh_bwd(qbh, kbh, vbh, dobh, lse, delta, causal=causal,
                         block_q=block_q, block_k=block_k, scale=scale,
                         out_dtype=out_dtype)
