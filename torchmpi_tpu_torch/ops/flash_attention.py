"""Flash attention forward: a hand-written CUDA kernel and its plain version.

Counterpart of ``torchmpi_tpu/ops/flash_attention.py``.  The online-softmax
forward (running max, denominator and output accumulator in f32 across k
tiles, causal fill -1e30, whole k tiles above the diagonal skipped) runs as
``csrc/flash_attention_fwd.cu`` on a CUDA tensor and as
:func:`_flash_bh_plain`, the same algebra in PyTorch, on a CPU tensor.  A
CUDA tensor goes to the kernel or raises; it never falls back.

The tile sizes ``block_q``/``block_k`` keep their legality contract
(:func:`_auto_block`, :func:`_resolve_blocks`) so that the same sequence
lengths are accepted in both packages and callers pick the same attention
path; the plain version tiles by them, the kernel tiles its own way.

Only the forward is ported.  The backward kernels come with the training
slice, so a call that would need a gradient raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

NEG_INF = -1e30
KERNEL_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the CUDA kernel in this process (the plain version does not
# count); chip_smoke.py reads it to show the main path went through the
# kernel.
flash_fwd_launches = 0


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


def _no_grad_guard(*ts: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            "flash attention has no backward yet: its backward kernels come "
            "with the Llama training slice of the port; call it under "
            "torch.no_grad() or use attn='full'")


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
            s = torch.einsum("bqd,bkd->bqk", qb, kb) * scale
            if causal:
                rows = q_start + torch.arange(bq, device=q.device)[:, None]
                cols = k_start + torch.arange(kb.shape[1],
                                              device=q.device)[None, :]
                s = torch.where(rows >= cols, s,
                                torch.tensor(NEG_INF, device=q.device))
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
    if D != KERNEL_HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head size "
                         f"{KERNEL_HEAD_DIM}, got {D}")
    if not (1 <= BH <= 65535):
        raise ValueError(f"batch*heads {BH} outside the kernel's grid "
                         f"[1, 65535]")
    if not (qbh.is_contiguous() and kbh.is_contiguous()
            and vbh.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")


def _kernel_entry():
    """``tmpi_flash_fwd`` of the built library, typed for ctypes: five
    pointers (q, k, v, o, lse), bh, lq, lk, head_dim, scale, causal, the
    two dtype codes and the stream."""
    from .. import _build

    fn = _build.load("flash_attention_fwd").tmpi_flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    return fn


def _flash_bh_kernel(qbh, kbh, vbh, *, causal: bool, scale: float,
                     out_dtype):
    """Launch ``csrc/flash_attention_fwd.cu`` on the current stream."""
    global flash_fwd_launches
    _check_kernel_inputs(qbh, kbh, vbh, out_dtype)
    fn = _kernel_entry()
    BH, L, D = qbh.shape
    Lk = kbh.shape[1]
    with torch.cuda.device(qbh.device):
        o = torch.empty((BH, L, D), dtype=out_dtype, device=qbh.device)
        lse = torch.empty((BH, L, 1), dtype=torch.float32, device=qbh.device)
        stream = torch.cuda.current_stream(qbh.device).cuda_stream
        err = fn(qbh.data_ptr(), kbh.data_ptr(), vbh.data_ptr(),
                 o.data_ptr(), lse.data_ptr(), BH, L, Lk, D, float(scale),
                 int(causal), _DTYPE_CODES[qbh.dtype], _DTYPE_CODES[out_dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    flash_fwd_launches += 1
    return o, lse


def _flash_bh(qbh, kbh, vbh, *, causal: bool, block_q: int, block_k: int,
              scale: Optional[float] = None, out_dtype=None):
    """(BH, L, D) flash attention forward; returns (o, lse (BH, L, 1) f32).

    ``kbh``/``vbh`` may have a different sequence length than ``qbh``.
    ``out_dtype`` overrides the output dtype (default: q's)."""
    D = qbh.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    out_dtype = qbh.dtype if out_dtype is None else out_dtype
    _no_grad_guard(qbh, kbh, vbh)
    if qbh.device.type == "cpu" and kbh.device.type == "cpu" \
            and vbh.device.type == "cpu":
        return _flash_bh_plain(qbh, kbh, vbh, causal=causal, block_q=block_q,
                               block_k=block_k, scale=scale,
                               out_dtype=out_dtype)
    return _flash_bh_kernel(qbh, kbh, vbh, causal=causal, scale=scale,
                            out_dtype=out_dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Blocked attention, (B, L, H, D) layout (GQA: repeat K/V first).

    Sequence length must be divisible by the (clamped) block sizes.
    Forward only: a call that needs a gradient raises."""
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

    obh, _ = _flash_bh(bh(q), bh(k), bh(v), causal=causal, block_q=block_q,
                       block_k=block_k,
                       scale=None if scale is None else float(scale))
    return obh.reshape(B, H, L, D).permute(0, 2, 1, 3)


def flash_fwd_block(qbh, kbh, vbh, *, causal: bool,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    scale: Optional[float] = None, out_dtype=None):
    """One attention block: (BH, Lq, D) Q against a (BH, Lk, D) K/V chunk.
    Returns ``(o, lse)`` with o normalized by this block's own denominator
    and lse = m + log(l) per query row."""
    block_q, block_k = _resolve_blocks(qbh.shape[1], kbh.shape[1],
                                       block_q, block_k)
    return _flash_bh(qbh, kbh, vbh, causal=causal, block_q=block_q,
                     block_k=block_k, scale=scale, out_dtype=out_dtype)
