"""Llama-family decoder-only transformer (RMSNorm, RoPE, SwiGLU, GQA):
dense inference — prefill, KV-cache decode and generation — and training
on one device — forward, next-token loss and an SGD step.

Counterpart of ``torchmpi_tpu/models/llama.py`` for one device.  The
parameters keep the JAX package's tree and layout: a dict with stacked
layer weights (leading ``n_layers`` axis), dense weights ``(d_in, d_out)``
applied as ``x @ w``, ``head`` ``(d_model, vocab)``, norm weights in f32.
:func:`from_jax_params` carries a JAX parameter tree across unchanged.

Attention: ``attn="full"`` (plain causal attention, f32 softmax) or
``attn="flash"`` (``ops/flash_attention.py``: the hand-written CUDA kernels
on the card, forward and backward, their plain versions on the CPU).  The
ring modes and ``mesh=`` need the sequence- and tensor-parallel mesh, which
come with slice 3 of the port; mixture-of-experts layers come later too.

Entry points (:func:`init`, :func:`init_kv_cache`, :func:`make_generate_fn`)
run on the current CUDA device unless the caller passes ``device``; with
no GPU and no device they raise.  Where the JAX package returns a new
cache or new parameters, the port writes them in place and returns them.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from ..utils import tree as _tree
from ._common import DeviceLike, dense_init, generator as _generator, \
    num_params, resolve_device, stack_dense  # noqa: F401

Params = Dict[str, Any]

_NEG_INF = -1e30   # attention mask fill, shared by the prefill and decode paths


@dataclasses.dataclass(frozen=True)
class Config:
    vocab: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 4            # GQA: kv heads <= heads
    d_ff: int = 1408
    max_seq: int = 2048
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    # Mixture-of-experts FFN: the port runs dense configs only
    # (n_experts == 0) until its MoE slice; anything else raises.
    n_experts: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be divisible by n_heads")
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be divisible by n_kv_heads")


def llama3_8b() -> Config:
    """Llama-3-8B geometry."""
    return Config(vocab=128256, d_model=4096, n_layers=32, n_heads=32,
                  n_kv_heads=8, d_ff=14336, max_seq=8192, rope_theta=500000.0)


def tiny(vocab: int = 256, seq: int = 64) -> Config:
    """Test-scale config."""
    return Config(vocab=vocab, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                  d_ff=128, max_seq=seq)


def _dense_only(cfg: Config) -> None:
    if cfg.n_experts:
        raise NotImplementedError(
            "mixture-of-experts layers come with a later slice of the port; "
            "this slice runs dense configs (n_experts=0)")


# ---------------------------------------------------------------------- init

def init(rng: Union[int, torch.Generator], cfg: Config,
         dtype=torch.float32, device: DeviceLike = None) -> Params:
    """Stacked-layer parameter tree (leaves lead with n_layers), drawn from
    ``rng`` (a ``torch.Generator`` on the device, or an int seed).  Same
    distributions as the JAX package, not the same numbers."""
    _dense_only(cfg)
    dev = resolve_device(device)
    gen = _generator(rng, dev)
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads

    def stack(d_in, d_out):
        return stack_dense(gen, cfg.n_layers, d_in, d_out, dtype, dev)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    embed = torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                        dtype=torch.float32, device=dev)
    embed = embed.mul_(0.02).to(dtype)
    return {
        "embed": embed,
        "layers": {
            "attn_norm": ones(cfg.n_layers, cfg.d_model),
            "wq": stack(cfg.d_model, H * hd),
            "wk": stack(cfg.d_model, KV * hd),
            "wv": stack(cfg.d_model, KV * hd),
            "wo": stack(H * hd, cfg.d_model),
            "mlp_norm": ones(cfg.n_layers, cfg.d_model),
            "w_gate": stack(cfg.d_model, cfg.d_ff),
            "w_up": stack(cfg.d_model, cfg.d_ff),
            "w_down": stack(cfg.d_ff, cfg.d_model),
        },
        "norm": ones(cfg.d_model),
        "head": dense_init(gen, cfg.d_model, cfg.vocab, dtype, dev),
    }


def _to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    # np.array copies: the port writes caches in place, and a JAX array's
    # host view is read-only memory that must not be written.
    a = np.array(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bf16: carry the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_jax_params(params: Any, device: DeviceLike = None) -> Params:
    """The JAX package's parameter tree (numpy or JAX array leaves) as the
    port's: the same tree, each leaf the same values, dtype and layout."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _to_tensor(node, dev)

    return conv(params)


# -------------------------------------------------------------------- forward

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    norm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (norm * w).to(x.dtype)


def _rope_angles(positions: torch.Tensor, d: int, theta: float):
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=positions.device) / d))
    angles = positions[:, None].float() * freqs[None, :]      # (P, d/2)
    return torch.cos(angles), torch.sin(angles)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Rotate interleaved channel pairs (0::2, 1::2) — not the half-split
    ``rotate_half`` form — and re-interleave."""
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding; x: (B, L, H, D_head), positions: (L,)."""
    cos, sin = _rope_angles(positions, x.shape[-1], theta)
    return _rotate(x, cos[None, :, None, :], sin[None, :, None, :])


def _repeat_kv(x: torch.Tensor, rep: int) -> torch.Tensor:
    """GQA: repeat each KV head in place along the head axis
    (``jnp.repeat(x, rep, axis=2)``, kv head g -> heads g*rep .. g*rep+rep-1)."""
    return torch.repeat_interleave(x, rep, dim=2)


def _causal_attention(q, k, v, scale):
    """(B, L, H, Dh) x (B, L, KV, Dh): GQA causal attention, f32 scores,
    softmax and output accumulation."""
    B, L, H, Dh = q.shape
    rep = H // k.shape[2]
    k = _repeat_kv(k, rep)
    v = _repeat_kv(v, rep)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    s = s.masked_fill(~mask, _NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)


def _make_attn_impl(cfg: Config, attn: str, mesh: Optional[Any],
                    scale: float) -> Callable:
    """Resolve the attention mode to one callable ``(q, k, v) -> o`` with
    q (B, L, H, hd) and k/v at the native (B, L, KV, hd)."""
    if attn in ("ring", "ring-xla", "ring-zigzag"):
        raise NotImplementedError(
            f"attn={attn!r} needs the sequence-parallel mesh, which comes "
            f"with slice 3 of the port")
    if attn == "flash":
        from ..ops.flash_attention import flash_attention

        rep = cfg.n_heads // cfg.n_kv_heads
        return lambda q, k, v: flash_attention(
            q, _repeat_kv(k, rep), _repeat_kv(v, rep), causal=True)
    if attn == "full":
        return lambda q, k, v: _causal_attention(q, k, v, scale)
    raise ValueError(
        f"attn must be 'full', 'flash', 'ring', 'ring-zigzag', or "
        f"'ring-xla', got {attn!r}")


def _layers(params: Params):
    """Every layer's weights as views of the stacked leaves, made by one
    ``torch.unbind`` per leaf.  Under autograd this matters: the backward
    of an unbind stacks the n layers' gradients once, where the backward of
    each ``leaf[i]`` would write a zero tensor the size of the whole stacked
    leaf and autograd would add n of them (O(n_layers²) bytes; about half
    of an 8B training step on the card)."""
    names = list(params["layers"])
    per_leaf = [torch.unbind(params["layers"][k]) for k in names]
    return [dict(zip(names, views)) for views in zip(*per_leaf)]


def _decoder_layer(cfg: Config, lp: Params, h: torch.Tensor,
                   positions: torch.Tensor, attn_impl: Callable,
                   with_kv: bool = False):
    """One pre-norm decoder block (attention + SwiGLU FFN with residuals).
    Returns ``(h, aux)`` (aux: the MoE load-balance term, 0 for dense);
    with ``with_kv`` also the native-KV-head K/V projections — the cache
    seed for decoding."""
    _dense_only(cfg)
    B, L, _ = h.shape
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    q = rope((x @ lp["wq"]).reshape(B, L, H, hd), positions, cfg.rope_theta)
    k = rope((x @ lp["wk"]).reshape(B, L, KV, hd), positions, cfg.rope_theta)
    v = (x @ lp["wv"]).reshape(B, L, KV, hd)
    o = attn_impl(q, k, v)
    h = h + o.reshape(B, L, H * hd) @ lp["wo"]
    x = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    g = (F.silu(x @ lp["w_gate"]) * (x @ lp["w_up"])) @ lp["w_down"]
    h = h + g
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if with_kv:
        return h, aux, (k, v)
    return h, aux


# ----------------------------------------------------------------- training

def _mesh_slice_3(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} comes with slice 3 of the port (the multi-process training "
        f"path); this slice trains on one device")


def _save_mm_outputs(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of ``aten.mm`` — every
    ``x @ w`` of the layer, which has no batch dimension, as JAX's
    ``dots_with_no_batch_dims_saveable`` keeps — and recompute everything
    else, ``bmm`` and every allocation included (a buffer that a kernel
    writes into must never be served from the cache on recompute)."""
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _wrap_remat(layer: Callable, remat: str) -> Callable:
    """THE remat taxonomy ('none'/'dots'/'full'), as in the JAX package.
    Under ``"dots"`` and ``"full"`` the layer's forward runs again during
    the backward, flash-attention kernel included."""
    if remat == "dots":
        ctx_fn = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                   _save_mm_outputs)
        return lambda *a: ckpt.checkpoint(layer, *a, use_reentrant=False,
                                          context_fn=ctx_fn)
    if remat == "full":
        return lambda *a: ckpt.checkpoint(layer, *a, use_reentrant=False)
    if remat != "none":
        raise ValueError("remat must be 'none', 'dots', or 'full'")
    return layer


def _chunk_nll(head: torch.Tensor, h_c: torch.Tensor,
               t_c: torch.Tensor) -> torch.Tensor:
    """Summed NLL of one (B, C, D) chunk; the caller checkpoints it so the
    backward re-forms its (B, C, V) logits instead of storing them."""
    logits = (h_c @ head).float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, t_c[..., None].long())[..., 0]
    return torch.sum(lse - tgt)


def _nll_from_hidden(head: torch.Tensor, h: torch.Tensor,
                     targets: torch.Tensor, loss_chunk: int) -> torch.Tensor:
    """Mean next-token NLL from final (post-norm) hidden states, dense or
    in sequence chunks of ``loss_chunk`` (each checkpointed, so the live
    f32 logits are capped at (B, C, V) in both passes)."""
    if not loss_chunk:
        logits = (h @ head).float()
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.mean(torch.gather(logp, -1,
                                        targets[..., None].long())[..., 0])
    B, L, _ = h.shape
    C = int(loss_chunk)
    if L % C:
        raise ValueError(f"seq len {L} not divisible by loss_chunk {C}")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for start in range(0, L, C):
        total = total + ckpt.checkpoint(_chunk_nll, head,
                                        h[:, start:start + C],
                                        targets[:, start:start + C],
                                        use_reentrant=False)
    return total / (B * L)


def apply(cfg: Config, params: Params, tokens: torch.Tensor,
          mesh: Optional[Any] = None, attn: str = "full",
          remat: str = "none", return_hidden: bool = False,
          return_aux: bool = False, layer_loop: str = "scan",
          positions: Optional[torch.Tensor] = None):
    """Forward: tokens (B, L) int -> logits (B, L, vocab) f32, or the final
    hidden states (B, L, D) in the compute dtype when ``return_hidden``.
    With ``return_aux`` the result is ``(out, aux)``, aux the layer-mean
    MoE load-balance loss (0 for dense configs).

    ``remat`` is the per-layer rematerialisation policy (:func:`_wrap_remat`).
    ``layer_loop`` is ``"scan"`` or ``"unroll"``: both are one Python loop
    over the layers in eager PyTorch, kept so callers pass the same
    arguments to both packages.  ``mesh=`` and the ring attention modes
    raise: they come with slice 3 of the port."""
    _dense_only(cfg)
    if mesh is not None:
        raise _mesh_slice_3("apply(mesh=...)")
    if layer_loop not in ("scan", "unroll"):
        raise ValueError("layer_loop must be 'scan' or 'unroll'")
    B, L = tokens.shape
    scale = 1.0 / math.sqrt(cfg.head_dim)
    attn_impl = _make_attn_impl(cfg, attn, None, scale)
    if positions is None:
        positions = torch.arange(L, device=tokens.device)
    h = params["embed"][tokens.long()]                    # (B, L, D)

    def layer(h, lp):
        return _decoder_layer(cfg, lp, h, positions, attn_impl)

    layer = _wrap_remat(layer, remat)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for lp in _layers(params):
        h, a = layer(h, lp)
        aux = aux + a
    aux = aux / cfg.n_layers
    h = rms_norm(h, params["norm"], cfg.norm_eps)
    out = h if return_hidden else (h @ params["head"]).float()
    return (out, aux) if return_aux else out


def make_loss_fn(cfg: Config, mesh: Optional[Any] = None, attn: str = "full",
                 remat: str = "none", loss_chunk: int = 0,
                 layer_loop: str = "scan"):
    """Next-token cross-entropy: ``loss_fn(params, (tokens, targets))``,
    targets = tokens shifted by the caller.  ``loss_chunk`` > 0 computes
    the loss in sequence chunks of that size (:func:`_nll_from_hidden`);
    ``L`` must be divisible by it."""
    _dense_only(cfg)
    if mesh is not None:
        raise _mesh_slice_3("make_loss_fn(mesh=...)")

    def loss_fn(params: Params, batch) -> torch.Tensor:
        tokens, targets = batch
        h, _ = apply(cfg, params, tokens, attn=attn, remat=remat,
                     return_hidden=True, return_aux=True,
                     layer_loop=layer_loop)               # (B, L, D)
        return _nll_from_hidden(params["head"], h, targets, loss_chunk)

    return loss_fn


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@torch.no_grad()
def _sgd_update_(p: torch.Tensor, g: torch.Tensor, lr: float) -> None:
    """``p - lr * g.astype(p.dtype)`` as the JAX step computes it, in place:
    the Python ``lr`` is weakly typed there, so it is rounded to p's dtype
    first, and ``lr * g`` and the difference each round once (two roundings
    in bf16, where one fused ``add_(alpha=)`` would drift from JAX's
    trajectory).  ``g`` is consumed."""
    lr_p = float(torch.tensor(lr, dtype=p.dtype))   # lr as p's dtype holds it
    g = g.to(p.dtype)
    g.mul_(lr_p)
    p.sub_(g)


def _needs_mesh(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs the mesh of ROADMAP.md item 12 (slice 3 of the port, "
        f"data and model parallelism); this step trains on one device")


def make_train_step(cfg: Config, mesh: Optional[Any] = None,
                    lr: float = 3e-4, attn: str = "full", optimizer=None,
                    remat: str = "none", loss_chunk: int = 0,
                    zero1: bool = False, opt_state_example=None):
    """One training step on one device:
    ``step(params, opt_state, tokens, targets) -> (params, opt_state, loss)``.

    Without ``optimizer``: plain SGD, ``p - lr * g``.  With one (an
    optax-shaped optimizer of ``torchmpi_tpu_torch.optim``, its state from
    ``optimizer.init(params)``): its update, then ``p + u``, as the JAX
    step does.  Either is applied to the parameters (and the optimizer's
    moments) in place under ``no_grad`` (the JAX step returns new ones and
    donates the old); the returned ``params`` is the same tree.  Every leaf
    is made to require a gradient, and each gradient is freed as soon as
    its leaf is updated.  ``remat``/``loss_chunk`` as in
    :func:`apply`/:func:`make_loss_fn` — pass ``remat="dots"`` and a
    ``loss_chunk`` for 8B-scale configs.  ``opt_state_example`` only
    shapes zero1's sharding in JAX; ``mesh`` and ``zero1`` need the mesh
    of item 12 and raise."""
    if mesh is not None:
        raise _needs_mesh("make_train_step(mesh=...)")
    if zero1:
        raise _needs_mesh("zero1 (optimizer state sharded over dp)")
    loss_fn = make_loss_fn(cfg, attn=attn, remat=remat,
                           loss_chunk=loss_chunk)

    def step(params: Params, opt_state: Any, tokens: torch.Tensor,
             targets: torch.Tensor):
        # The optimizer's state is a tree in JAX order; the SGD step has
        # no state, and keeps the parameters' own order.
        leaves = (_tree.leaves(params) if optimizer is not None
                  else list(_leaves(params)))
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        loss = loss_fn(params, (tokens, targets))
        grads = list(torch.autograd.grad(loss, leaves))
        if optimizer is not None:
            opt_state = optimizer.apply_(leaves, grads, opt_state)
        else:
            for i, p in enumerate(leaves):
                _sgd_update_(p, grads[i], lr)
                grads[i] = None
        return params, opt_state, loss.detach()

    return step


# ---------------------------------------------------------------- inference

def init_kv_cache(cfg: Config, batch: int, max_len: int,
                  dtype=torch.float32, device: DeviceLike = None) -> Params:
    """Per-layer K/V cache at native GQA head count, stacked on the layer
    axis: ``(n_layers, batch, max_len, KV, hd)``."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _grouped_cache_attention(q, ck, cv, mask, scale):
    """Single-position GQA attention against the cache at its native KV
    head count (repeating the cache to H heads would multiply the decode
    step's dominant read by H/KV).  q: (B, H, hd); ck/cv: (B, T, KV, hd);
    mask: (B, T) bool, True = visible.  f32 scores, softmax and output."""
    B, H, hd = q.shape
    KV = ck.shape[2]
    qg = q.reshape(B, KV, H // KV, hd).float()
    s = torch.einsum("bgrd,blgd->bgrl", qg, ck.float()) * scale
    s = s.masked_fill(~mask[:, None, None, :], _NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bgrl,blgd->bgrd", w, cv.float()).reshape(B, H * hd)


@torch.no_grad()
def _decode_step(cfg: Config, params: Params, cache: Params,
                 tokens: torch.Tensor, pos: int):
    """One autoregressive position: tokens (B,) at position ``pos`` ->
    (logits (B, V) f32, cache written in place at ``pos``).

    Attention reads the cache up to and including ``pos`` only: the JAX
    step reads all of it under an ``arange <= pos`` mask, and the masked
    entries weigh exactly 0 there, so the result is the same."""
    _dense_only(cfg)
    pos = int(pos)
    B = tokens.shape[0]
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    scale = 1.0 / math.sqrt(hd)
    dev = tokens.device
    positions = torch.tensor([pos], device=dev)
    visible = torch.ones((B, pos + 1), dtype=torch.bool, device=dev)
    h = params["embed"][tokens.long()]                    # (B, D)
    for i, lp in enumerate(_layers(params)):
        x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        q = rope((x @ lp["wq"]).reshape(B, 1, H, hd), positions,
                 cfg.rope_theta)[:, 0]                    # (B, H, hd)
        k_new = rope((x @ lp["wk"]).reshape(B, 1, KV, hd), positions,
                     cfg.rope_theta)
        v_new = (x @ lp["wv"]).reshape(B, 1, KV, hd)
        ck, cv = cache["k"][i], cache["v"][i]             # (B, max_len, KV, hd)
        ck[:, pos] = k_new[:, 0].to(ck.dtype)
        cv[:, pos] = v_new[:, 0].to(cv.dtype)
        o = _grouped_cache_attention(q, ck[:, :pos + 1], cv[:, :pos + 1],
                                     visible, scale)
        h = h + o.to(h.dtype) @ lp["wo"]
        x = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
        g = F.silu(x @ lp["w_gate"]) * (x @ lp["w_up"])
        h = h + g @ lp["w_down"]
    h = rms_norm(h, params["norm"], cfg.norm_eps)
    return (h @ params["head"]).float(), cache


def _auto_attn(Lp: int) -> str:
    """The prefill ``auto`` rule: full attention below 1024 tokens; from
    1024 on, flash when ``_auto_block`` accepts the length (illegal lengths
    stay on full attention instead of erroring)."""
    if Lp < 1024:
        return "full"
    from ..ops.flash_attention import _auto_block

    try:
        _auto_block(Lp)
    except ValueError:
        return "full"
    return "flash"


@torch.no_grad()
def _prefill(cfg: Config, params: Params, cache: Params,
             prompt: torch.Tensor, attn: str = "auto"):
    """Batched prefill: ONE full forward over the prompt seeding the K/V
    cache (written in place at positions [0, Lp)).  Returns (last-position
    logits (B, V) f32, cache)."""
    B, Lp = prompt.shape
    dev = prompt.device
    positions = torch.arange(Lp, device=dev)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if attn == "auto":
        attn = _auto_attn(Lp)
    attn_impl = _make_attn_impl(cfg, attn, None, scale)
    h = params["embed"][prompt.long()]
    for i, lp in enumerate(_layers(params)):
        h, _, (k, v) = _decoder_layer(cfg, lp, h, positions, attn_impl,
                                      with_kv=True)
        cache["k"][i, :, :Lp] = k.to(cache["k"].dtype)
        cache["v"][i, :, :Lp] = v.to(cache["v"].dtype)
    h = rms_norm(h[:, -1], params["norm"], cfg.norm_eps)
    return (h @ params["head"]).float(), cache


def filter_logits(l: torch.Tensor, top_k: int = 0,
                  top_p: float = 0.0) -> torch.Tensor:
    """The sampler's top-k / top-p filter on f32 logits (B, V): filtered-out
    entries become -1e30.  ``top_k`` keeps the k highest logits (the kth
    value is the threshold); ``top_p`` (nucleus) drops tokens whose
    EXCLUSIVE cumulative mass in descending-probability order already
    reached p, so the top token always survives."""
    neg = torch.tensor(_NEG_INF, dtype=l.dtype, device=l.device)
    if top_k:
        kth = torch.topk(l, top_k, dim=-1).values[..., -1:]
        l = torch.where(l < kth, neg, l)
    if 0.0 < top_p < 1.0:
        sorted_l = torch.sort(l, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        cum_excl = torch.cumsum(probs, dim=-1) - probs
        cut = torch.sum((cum_excl < top_p).to(torch.int64), dim=-1)
        # Threshold = smallest kept (sorted) logit.
        thresh = torch.gather(sorted_l, -1,
                              torch.clamp(cut[..., None] - 1, min=0))
        l = torch.where(l < thresh, neg, l)
    return l


def make_generate_fn(cfg: Config, prompt_len: int, max_new: int,
                     temperature: float = 0.0, top_k: int = 0,
                     top_p: float = 0.0, mesh: Optional[Any] = None,
                     device: DeviceLike = None):
    """Autoregressive generation:
    ``fn(params, prompt (B, prompt_len) int, rng=0) -> (B, max_new) int32``.

    A batched prefill forward (``attn="auto"``: the flash kernel from 1024
    tokens on) seeds the K/V cache in the parameters' dtype, then
    ``max_new - 1`` single-position decode steps.  ``temperature=0`` is
    greedy; otherwise tokens are sampled from softmax(logits / temperature)
    after :func:`filter_logits`, with ``rng`` (a ``torch.Generator`` on the
    device, or an int seed).  ``device`` defaults to the current CUDA
    device; the parameters must live on it."""
    if prompt_len < 1 or max_new < 1:
        raise ValueError("prompt_len and max_new must be >= 1")
    if mesh is not None:
        raise NotImplementedError(
            "distributed generation (mesh=) comes with the tensor-parallel "
            "slice of the port")
    if not 0.0 <= top_p <= 1.0:
        raise ValueError(f"top_p must be in [0, 1], got {top_p}")
    if top_k < 0 or (top_k and top_k > cfg.vocab):
        raise ValueError(f"top_k must be in [0, {cfg.vocab}], got {top_k}")
    if temperature <= 0.0 and (top_k or top_p):
        # Greedy ignores the filters; silently doing so would let a caller
        # believe they sampled.
        raise ValueError("top_k/top_p require temperature > 0 "
                         "(temperature=0 is greedy)")
    _dense_only(cfg)
    dev = resolve_device(device)
    max_len = prompt_len + max_new

    def pick(logits, gen):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        l = filter_logits((logits / temperature).float(), top_k, top_p)
        return torch.multinomial(torch.softmax(l, dim=-1), 1,
                                 generator=gen)[:, 0]

    @torch.no_grad()
    def fn(params: Params, prompt: Any,
           rng: Union[int, torch.Generator] = 0) -> torch.Tensor:
        prompt = torch.as_tensor(prompt, device=dev)
        if prompt.dim() != 2 or prompt.shape[1] != prompt_len:
            raise ValueError(f"prompt has shape {tuple(prompt.shape)}, "
                             f"generate_fn was built for (B, {prompt_len})")
        if params["embed"].device != dev:
            raise ValueError(f"params on {params['embed'].device}, "
                             f"generate_fn was built for {dev}")
        gen = _generator(rng, dev) if temperature > 0.0 else None
        B = prompt.shape[0]
        cache = init_kv_cache(cfg, B, max_len, params["embed"].dtype, dev)
        logits, cache = _prefill(cfg, params, cache, prompt)
        toks = []
        for i in range(max_new - 1):
            tok = pick(logits, gen)
            toks.append(tok)
            logits, cache = _decode_step(cfg, params, cache, tok,
                                         prompt_len + i)
        toks.append(pick(logits, gen))
        return torch.stack(toks, dim=1).to(torch.int32)

    return fn
