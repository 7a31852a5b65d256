"""Llama-family decoder-only transformer (RMSNorm, RoPE, SwiGLU, GQA):
dense inference — prefill, KV-cache decode and generation — and training
on one device — forward, next-token loss and an SGD step.

Counterpart of ``torchmpi_tpu/models/llama.py`` for one device.  The
parameters keep the JAX package's tree and layout: a dict with stacked
layer weights (leading ``n_layers`` axis), dense weights ``(d_in, d_out)``
applied as ``x @ w``, ``head`` ``(d_model, vocab)``, norm weights in f32.
:func:`from_jax_params` carries a JAX parameter tree across unchanged.

Attention: ``attn="full"`` (plain causal attention, f32 softmax),
``attn="flash"`` (``ops/flash_attention.py``: the hand-written CUDA kernels
on the card, forward and backward, their plain versions on the CPU), and
over a mesh's ``sp`` axis the ring modes ``"ring"`` (the flash ring),
``"ring-zigzag"`` (its balanced layout) and ``"ring-xla"`` (the einsum
oracle), from ``parallel/sequence.py``.

The mesh paths (``mesh=`` of :func:`apply`, :func:`make_loss_fn`,
:func:`make_train_step` and :func:`make_generate_fn`, BASELINE config 5's
dp x tp x sp): in JAX one GSPMD program places the parameters by
:func:`param_specs` and XLA inserts the collectives.  Here each rank (one
process) holds its own shards (:func:`shard_params`; :func:`gather_params`
is the inverse) and calls its own collectives, in the manual Megatron form
of the JAX package's ``_decoder_layer_tp_manual(markers=True)`` and
vocab-sharded cross-entropy (``_make_tp_ce_sum``): two tp sums a layer on
the f32 wire, the flash kernels or the sp ring on this rank's heads, the
vocab-sharded loss with its analytic backward.  Every rank passes the
global batch; each takes its dp rows and its sp chunk.  Mixture-of-experts
layers (ROADMAP item 12a) and the ``pp`` axis (item 14) raise.

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

from ..collectives import eager, gspmd, innerjit
from ..parallel import tp as _tp
from ..parallel.mesh import AXIS_DP, AXIS_EP, AXIS_PP, AXIS_SP, AXIS_TP, \
    Mesh, mesh_axis_size
from ..utils import tree as _tree
from ._common import DeviceLike, P, dense_init, gather_by_specs, \
    generator as _generator, mesh_spec as _mesh_spec, num_params, \
    resolve_device, shard_by_specs, stack_dense  # noqa: F401

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
    # (n_experts == 0) until ROADMAP item 12a; anything else raises.
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
            "mixture-of-experts layers come with ROADMAP item 12a of the "
            "port; it runs dense configs (n_experts=0)")


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


# ------------------------------------------------------------------- sharding

def param_specs(cfg: Config) -> Params:
    """PartitionSpec tree: Megatron tp sharding over stacked layers
    (qkv/gate/up column-sharded, o/down row-sharded, the head
    vocab-sharded)."""
    _dense_only(cfg)
    col = P(None, None, AXIS_TP)    # (layers, d_in, sharded d_out)
    row = P(None, AXIS_TP, None)    # (layers, sharded d_in, d_out)
    return {
        "embed": P(None, None),
        "layers": {
            "attn_norm": P(None, None),
            "wq": col, "wk": col, "wv": col, "wo": row,
            "mlp_norm": P(None, None),
            "w_gate": col, "w_up": col, "w_down": row,
        },
        "norm": P(None),
        "head": P(None, AXIS_TP),
    }


def param_shapes(cfg: Config) -> Params:
    """The whole parameter tree's shapes (what :func:`init` makes)."""
    hd, H, KV, n = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "embed": (cfg.vocab, D),
        "layers": {"attn_norm": (n, D), "wq": (n, D, H * hd),
                   "wk": (n, D, KV * hd), "wv": (n, D, KV * hd),
                   "wo": (n, H * hd, D), "mlp_norm": (n, D),
                   "w_gate": (n, D, F_), "w_up": (n, D, F_),
                   "w_down": (n, F_, D)},
        "norm": (D,),
        "head": (D, cfg.vocab),
    }


def shard_params(params: Params, mesh: Mesh, cfg: Config) -> Params:
    """This rank's shard of a whole parameter tree, per :func:`param_specs`
    under the shared axis-dropping rule (``_common.mesh_spec``)."""
    return shard_by_specs(params, mesh, param_specs(cfg))


def gather_params(params: Params, mesh: Mesh, cfg: Config) -> Params:
    """The inverse of :func:`shard_params`: the whole tree on every rank,
    each sharded leaf gathered over tp (every rank of the mesh calls
    it)."""
    return gather_by_specs(params, mesh, param_specs(cfg), param_shapes(cfg))


class _MeshPlan:
    """What a mesh path reads of its mesh: the axis sizes and this rank's
    coordinates, the tp wires (the Megatron f/g pair on the
    ``manual_wire_dtype`` wire) and the cuts of the global batch."""

    def __init__(self, cfg: Config, mesh: Mesh):
        _dense_only(cfg)
        sizes = dict(mesh.shape)
        if sizes.get(AXIS_PP, 1) > 1:
            raise NotImplementedError(
                "the pp axis (pipeline-parallel Llama) comes with ROADMAP "
                "item 14 of the port")
        if sizes.get(AXIS_EP, 1) > 1:
            raise NotImplementedError(
                "the ep axis (expert parallelism) comes with ROADMAP item "
                "12a of the port")
        if mesh.coords is None:
            raise RuntimeError(f"rank {mesh.my_rank} is not in the mesh")
        self.mesh = mesh
        self.dp, self.sp, self.tp = (sizes.get(a, 1)
                                     for a in (AXIS_DP, AXIS_SP, AXIS_TP))
        self.dp_i, self.sp_i, self.tp_i = (mesh.coords.get(a, 0)
                                           for a in (AXIS_DP, AXIS_SP,
                                                     AXIS_TP))
        tp = self.tp
        if tp > 1 and (cfg.n_heads % tp or cfg.n_kv_heads % tp
                       or cfg.d_ff % tp):
            raise ValueError(
                f"tp={tp} must divide n_heads {cfg.n_heads}, n_kv_heads "
                f"{cfg.n_kv_heads} and d_ff {cfg.d_ff}: each rank runs "
                f"whole heads of its own")
        self.wire = _tp.resolve_wire_dtype()
        head = _mesh_spec(param_specs(cfg)["head"], mesh,
                          (cfg.d_model, cfg.vocab))
        self.head_sharded = tp > 1 and head[1] == AXIS_TP
        self.grad_axes = tuple(a for a in (AXIS_DP, AXIS_SP)
                               if sizes.get(a, 1) > 1)

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's dp rows of a global batch."""
        if x.shape[0] % self.dp:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"dp={self.dp}")
        n = x.shape[0] // self.dp
        return x.narrow(0, self.dp_i * n, n)

    def chunk(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's sp chunk of a sequence axis."""
        if x.shape[dim] % self.sp:
            raise ValueError(f"sequence {x.shape[dim]} not divisible by "
                             f"sp={self.sp}")
        n = x.shape[dim] // self.sp
        return x.narrow(dim, self.sp_i * n, n)

    def block_in(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp == 1:
            return x
        return _tp.block_input(x, AXIS_TP, wire_dtype=self.wire,
                               mesh=self.mesh)

    def tp_sum(self, part: torch.Tensor) -> torch.Tensor:
        if self.tp == 1:
            return part
        return _tp.block_output(part, AXIS_TP, wire_dtype=self.wire,
                                mesh=self.mesh)

    def logits(self, h: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
        """f32 logits over the whole vocab: a sharded head's columns
        gathered over tp (in JAX, GSPMD gathers them for the sampler)."""
        logits = (h @ head).float()
        if not self.head_sharded:
            return logits
        return innerjit.allgather(logits, AXIS_TP, concat_axis=-1,
                                  mesh=self.mesh)

    def grad_comm(self):
        """The communicator the gradients are averaged over (dp x sp), or
        None when that is one rank."""
        return self.mesh.comm(self.grad_axes) if self.grad_axes else None


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


def _sp_causal_attention(q, k, v, scale, plan: "_MeshPlan"):
    """Causal attention of this rank's sp chunk of queries against the
    whole sequence: K/V gathered over sp (whose backward reduce-scatters
    their gradients) and the mask by global position, as GSPMD computes
    ``attn="full"`` over an sp-sharded sequence."""
    mesh = plan.mesh
    k = innerjit.allgather(k, AXIS_SP, concat_axis=1, mesh=mesh)
    v = innerjit.allgather(v, AXIS_SP, concat_axis=1, mesh=mesh)
    B, Lq, H, Dh = q.shape
    rep = H // k.shape[2]
    k, v = _repeat_kv(k, rep), _repeat_kv(v, rep)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    q_pos = plan.sp_i * Lq + torch.arange(Lq, device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    s = s.masked_fill(~(q_pos[:, None] >= k_pos[None, :]), _NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)


def _make_attn_impl(cfg: Config, attn: str, mesh: Optional[Mesh],
                    scale: float) -> Callable:
    """Resolve the attention mode to one callable ``(q, k, v) -> o`` with
    q (B, L, H, hd) and k/v at the native (B, L, KV, hd) — on a mesh, this
    rank's heads and its sp chunk of the sequence."""
    from ..parallel import sequence as seq

    if attn in ("ring", "ring-xla", "ring-zigzag"):
        if mesh is None:
            raise ValueError("attn='ring' needs a mesh with an sp axis")
        # K/V enter the ring at their native head count; tp shards the
        # heads (tp over heads x the ring over sp).  'ring' composes the
        # ring with the flash block kernels, 'ring-zigzag' is its balanced
        # layout (make_loss_fn permutes tokens and positions into it),
        # 'ring-xla' the exact einsum-block oracle.
        mesh.comm(AXIS_SP)          # NameError without an sp axis, as JAX
        kw = dict(axis=AXIS_SP, scale=scale, mesh=mesh)
        if attn == "ring":
            return lambda q, k, v: seq.ring_flash_attention_batched(
                q, k, v, causal=True, **kw)
        if attn == "ring-zigzag":
            return lambda q, k, v: seq.zigzag_ring_flash_attention_batched(
                q, k, v, **kw)
        return lambda q, k, v: seq._ring_einsum(q, k, v, AXIS_SP, True,
                                                scale, mesh)
    sp = dict(mesh.shape).get(AXIS_SP, 1) if mesh is not None else 1
    if attn == "flash":
        if sp > 1:
            raise ValueError(
                "attn='flash' over an sp axis: the flash kernels mask "
                "causally within one block of the sequence; use "
                "attn='ring', 'ring-zigzag' or 'ring-xla' (or 'full')")
        from ..ops.flash_attention import flash_attention

        rep = cfg.n_heads // cfg.n_kv_heads
        return lambda q, k, v: flash_attention(
            q, _repeat_kv(k, rep), _repeat_kv(v, rep), causal=True)
    if attn == "full":
        if sp > 1:
            plan = _MeshPlan(cfg, mesh)
            return lambda q, k, v: _sp_causal_attention(q, k, v, scale, plan)
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
                   with_kv: bool = False, tp: Optional[_MeshPlan] = None):
    """One pre-norm decoder block (attention + SwiGLU FFN with residuals).
    Returns ``(h, aux)`` (aux: the MoE load-balance term, 0 for dense);
    with ``with_kv`` also the native-KV-head K/V projections — the cache
    seed for decoding.

    With ``tp`` (a mesh plan) ``lp`` holds this rank's shards and the block
    writes its own Megatron collectives, as the JAX package's
    ``_decoder_layer_tp_manual(markers=True)``: each parallel branch's
    input passes ``block_input`` (a tp sum backward) and its output
    ``block_output`` (a tp sum forward), two sums a layer; attention runs
    on this rank's heads."""
    _dense_only(cfg)
    B, L, _ = h.shape
    hd = cfg.head_dim
    H, KV = lp["wq"].shape[-1] // hd, lp["wk"].shape[-1] // hd
    x = rms_norm(h, lp["attn_norm"], cfg.norm_eps)
    if tp is not None:
        x = tp.block_in(x)
    q = rope((x @ lp["wq"]).reshape(B, L, H, hd), positions, cfg.rope_theta)
    k = rope((x @ lp["wk"]).reshape(B, L, KV, hd), positions, cfg.rope_theta)
    v = (x @ lp["wv"]).reshape(B, L, KV, hd)
    o = attn_impl(q, k, v)
    part = o.reshape(B, L, H * hd) @ lp["wo"]
    h = h + (tp.tp_sum(part) if tp is not None else part)
    x = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
    if tp is not None:
        x = tp.block_in(x)
    part = (F.silu(x @ lp["w_gate"]) * (x @ lp["w_up"])) @ lp["w_down"]
    h = h + (tp.tp_sum(part) if tp is not None else part)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if with_kv:
        return h, aux, (k, v)
    return h, aux


# ----------------------------------------------------------------- training

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


class _TpCE(torch.autograd.Function):
    """Summed next-token CE of one chunk with a VOCAB-SHARDED head: the
    JAX package's ``_make_tp_ce_sum`` (a ``custom_vjp`` there).
    ``head_local`` is this rank's (D, V/tp) columns and ``h`` is
    tp-replicated.  Forward: the row max over tp (pmax), then one sum over
    tp of the exp-sums and the target logit (whose owner alone holds it).
    Backward: the analytic softmax-minus-onehot rule on this rank's
    columns, with ``dh`` summed over tp on the wire dtype.  Only small
    (B, C) terms are saved; the logits are formed again in the backward,
    so ``loss_chunk`` caps the live (B, C, V/tp) f32 logits in both
    passes."""

    @staticmethod
    def forward(ctx, head_local, h, targets, plan):
        Vl = head_local.shape[-1]
        off = plan.tp_i * Vl
        mesh = plan.mesh
        logits = (h @ head_local).float()                    # (B, C, Vl)
        m = innerjit.allreduce(logits.amax(dim=-1), AXIS_TP, op="max",
                               mesh=mesh)                     # (B, C)
        e_sum = torch.exp(logits - m[..., None]).sum(dim=-1)
        tloc = targets.long() - off
        in_shard = (tloc >= 0) & (tloc < Vl)
        tclip = torch.clamp(tloc, 0, Vl - 1)
        tlogit = torch.gather(logits, -1, tclip[..., None])[..., 0]
        tlogit = torch.where(in_shard, tlogit, torch.zeros_like(tlogit))
        s, tlogit = innerjit.allreduce(torch.stack([e_sum, tlogit]),
                                       AXIS_TP, mesh=mesh).unbind(0)
        lse = torch.log(s) + m
        ctx.save_for_backward(head_local, h, s, m, in_shard, tclip)
        ctx.plan = plan
        return torch.sum(lse - tlogit)

    @staticmethod
    def backward(ctx, g):
        head_local, h, s, m, in_shard, tclip = ctx.saved_tensors
        plan = ctx.plan
        logits = (h @ head_local).float()
        p = torch.exp(logits - m[..., None]) / s[..., None]
        sub = torch.where(in_shard, g, torch.zeros_like(g))
        dl = p * g
        dl.scatter_add_(-1, tclip[..., None], -sub[..., None])
        # dh sums over this rank's vocab columns only: the sum over tp
        # completes it (a gradient wire, on the wire dtype).
        dh = innerjit.allreduce((dl @ head_local.t().float()).to(plan.wire),
                                AXIS_TP, mesh=plan.mesh).float()
        dw = torch.einsum("bcd,bcv->dv", h.float(), dl)
        return dw.to(head_local.dtype), dh.to(h.dtype), None, None


def _nll_from_hidden_tp(head_local: torch.Tensor, h: torch.Tensor,
                        targets: torch.Tensor, loss_chunk: int,
                        plan: _MeshPlan) -> torch.Tensor:
    """Mean next-token NLL of this rank's tokens with the head
    vocab-sharded over tp: :func:`_nll_from_hidden`'s chunking contract
    (``loss_chunk`` caps the live (B, C, V/tp) f32 logits; it must divide
    this rank's sequence chunk)."""
    B, L, _ = h.shape
    if not loss_chunk:
        return _TpCE.apply(head_local, h, targets, plan) / (B * L)
    C = int(loss_chunk)
    if L % C:
        raise ValueError(f"seq len {L} not divisible by loss_chunk {C}")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for start in range(0, L, C):
        total = total + _TpCE.apply(head_local, h[:, start:start + C],
                                    targets[:, start:start + C], plan)
    return total / (B * L)


class _GlobalMean(torch.autograd.Function):
    """The mean over the ranks of each rank's mean loss (the global mean:
    every rank holds as many tokens); its gradient flows to this rank's
    own mean alone, and the mean of the ranks' gradients is the global
    one, which :func:`make_train_step` forms."""

    @staticmethod
    def forward(ctx, x, comm):
        return eager.allreduce(comm, x.reshape(1), op="mean").reshape(())

    @staticmethod
    def backward(ctx, g):
        return g, None


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
    arguments to both packages.

    With ``mesh``: ``params`` is this rank's :func:`shard_params` shard,
    ``tokens`` (and ``positions``) the global batch, the same on every
    rank; the result is this rank's block of the output — its dp rows and
    its sp chunk of the sequence, (B/dp, L/sp, ...) — the logits over the
    whole vocab (gathered over tp), the hidden states as they are.
    ``attn='ring-zigzag'`` needs tokens already permuted into the zigzag
    layout and their ``positions``."""
    _dense_only(cfg)
    if layer_loop not in ("scan", "unroll"):
        raise ValueError("layer_loop must be 'scan' or 'unroll'")
    B, L = tokens.shape
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if attn == "ring-zigzag" and positions is None:
        # The zigzag kernels mask as if row blocks sit in the zigzag
        # layout; contiguous rows with default positions would compute a
        # silently wrong (non-causal) pattern.
        raise ValueError(
            "attn='ring-zigzag' needs tokens permuted into the zigzag "
            "layout and the matching ``positions`` "
            "(parallel.sequence.zigzag_indices); use make_loss_fn / "
            "make_train_step, which handle the permutation")
    if positions is None:
        positions = torch.arange(L, device=tokens.device)
    positions = torch.as_tensor(positions, device=tokens.device)
    plan = _MeshPlan(cfg, mesh) if mesh is not None else None
    if plan is not None:
        tokens = plan.chunk(plan.rows(tokens))
        positions = plan.chunk(positions, dim=0)
    attn_impl = _make_attn_impl(cfg, attn, mesh, scale)
    h = params["embed"][tokens.long()]                    # (B, L, D)

    def layer(h, lp):
        return _decoder_layer(cfg, lp, h, positions, attn_impl, tp=plan)

    layer = _wrap_remat(layer, remat)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for lp in _layers(params):
        h, a = layer(h, lp)
        aux = aux + a
    aux = aux / cfg.n_layers
    h = rms_norm(h, params["norm"], cfg.norm_eps)
    if return_hidden:
        out = h
    elif plan is not None:
        out = plan.logits(h, params["head"])
    else:
        out = (h @ params["head"]).float()
    return (out, aux) if return_aux else out


def make_loss_fn(cfg: Config, mesh: Optional[Any] = None, attn: str = "full",
                 remat: str = "none", loss_chunk: int = 0,
                 layer_loop: str = "scan"):
    """Next-token cross-entropy: ``loss_fn(params, (tokens, targets))``,
    targets = tokens shifted by the caller.  ``loss_chunk`` > 0 computes
    the loss in sequence chunks of that size (:func:`_nll_from_hidden`);
    ``L`` must be divisible by it.

    With ``mesh``: ``params`` is this rank's shard and the batch the global
    one, the same on every rank.  The loss is the mean over the global
    tokens, on every rank; its gradient on each rank is that of this
    rank's own tokens' mean (:class:`_GlobalMean`).  A vocab-sharded head
    takes the tp cross-entropy (:class:`_TpCE`), a replicated one (a vocab
    tp does not divide) the plain loss; ``loss_chunk`` must divide this
    rank's sequence chunk.  ``attn='ring-zigzag'`` permutes tokens,
    targets and RoPE positions into the zigzag layout: the mean NLL is
    permutation-invariant, so the loss equals the contiguous layout's."""
    _dense_only(cfg)
    plan = _MeshPlan(cfg, mesh) if mesh is not None else None

    def loss_fn(params: Params, batch) -> torch.Tensor:
        tokens, targets = batch
        tokens, targets = torch.as_tensor(tokens), torch.as_tensor(targets)
        positions = None
        if attn == "ring-zigzag":
            from ..parallel import sequence as seq

            p = mesh_axis_size(mesh, AXIS_SP)
            idx = torch.as_tensor(seq.zigzag_indices(tokens.shape[1], p),
                                  device=tokens.device)
            tokens, targets, positions = tokens[:, idx], targets[:, idx], idx
        h, _ = apply(cfg, params, tokens, mesh=mesh, attn=attn, remat=remat,
                     return_hidden=True, return_aux=True,
                     layer_loop=layer_loop,
                     positions=positions)                 # (B, L, D)
        if plan is None:
            return _nll_from_hidden(params["head"], h, targets, loss_chunk)
        targets = plan.chunk(plan.rows(targets))
        if plan.head_sharded:
            nll = _nll_from_hidden_tp(params["head"], h, targets,
                                      loss_chunk, plan)
        else:
            nll = _nll_from_hidden(params["head"], h, targets, loss_chunk)
        comm = plan.grad_comm()
        return _GlobalMean.apply(nll, comm) if comm is not None else nll

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


def _narrow(t: torch.Tensor, dim: int, i: int, n: int) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size)


class _Zero1:
    """ZeRO-1 over ``dp`` on top of the tp layout, by the JAX package's
    ``_zero1_opt_shardings`` rule: each parameter-shaped optimizer leaf
    keeps its parameter's spec and shards its first still-unsharded axis
    that dp divides (and that is at least dp long) over dp; the other
    leaves (the count) stay whole.  A step reduce-scatters the gradients
    into this rank's blocks (one reduce-scatter a dtype), updates its
    blocks of the parameters with its blocks of the state, and all-gathers
    the updated blocks (one all-gather a dtype)."""

    def __init__(self, cfg: Config, plan: _MeshPlan):
        self.plan = plan
        dp = plan.dp
        self.axis: Dict[tuple, Optional[int]] = {}
        specs = dict(_dict_leaves(param_specs(cfg)))
        for path, shape in _dict_leaves(param_shapes(cfg)):
            spec = _mesh_spec(specs[path], plan.mesh, shape)
            entries = list(spec) + [None] * (len(shape) - len(spec))
            ax = None
            if dp > 1:
                ax = next((i for i, (e, d) in enumerate(zip(entries, shape))
                           if e is None and d % dp == 0 and d >= dp), None)
            self.axis[path] = ax

    def _state_axis(self, path, t, params_by_path):
        """The dp axis of an optimizer leaf: its parameter's (matched by
        path suffix and shape, as JAX matches), else None."""
        for i in range(len(path)):
            hit = params_by_path.get(path[i:])
            if hit is not None and tuple(hit.shape) == tuple(t.shape):
                return self.axis[path[i:]]
        return None

    def param_blocks(self, params):
        """This rank's dp block of each parameter (views)."""
        plan = self.plan
        leaves, treedef = _tree.flatten(params)
        paths = [path for path, _ in _tree.flatten_with_paths(params)]
        return _tree.unflatten(treedef, [
            _narrow(t, self.axis[path], plan.dp_i, plan.dp)
            if self.axis[path] is not None else t
            for path, t in zip(paths, leaves)])

    def blocks(self, opt_state, params):
        """``opt_state`` with each sharded leaf cut to this rank's block
        (leaves already cut stay as they are)."""
        by_path = dict(_tree.flatten_with_paths(params))
        leaves, treedef = _tree.flatten(opt_state)
        out = []
        for (path, t), leaf in zip(_tree.flatten_with_paths(opt_state),
                                   leaves):
            ax = self._state_axis(path, t, by_path)
            if ax is not None:
                leaf = _narrow(leaf, ax, self.plan.dp_i,
                               self.plan.dp).clone()
            out.append(leaf)
        return _tree.unflatten(treedef, out)

    def step(self, optimizer, params, grads, opt_state):
        """One update in place of ``params``; returns the new (blocked)
        optimizer state.  ``grads`` are in ``flatten_with_paths`` order
        and consumed."""
        plan = self.plan
        mesh, dp = plan.mesh, plan.dp
        paths, leaves = zip(*_tree.flatten_with_paths(params))
        axes = [self.axis[path] for path in paths]
        if plan.sp > 1:
            grads = gspmd.allreduce_mean_leaves(grads, mesh.comm(AXIS_SP))
        sharded = [i for i, a in enumerate(axes) if a is not None]
        whole = [i for i, a in enumerate(axes) if a is None]
        g = grads
        if dp > 1:
            dp_comm = mesh.comm(AXIS_DP)
            for idx in _tree.by_dtype(g, sharded):
                # Each sharded leaf with its dp axis first, as (dp, rest).
                shapes = {i: g[i].movedim(axes[i], 0).shape for i in idx}
                packed = torch.cat([g[i].movedim(axes[i], 0).reshape(dp, -1)
                                    for i in idx], dim=1)
                for i in idx:
                    g[i] = None          # the whole gradient is packed
                # The reduce-scatter (mean) of the packed rows, summed in
                # place: this rank's row.
                mine = eager.reduce_scatter(dp_comm, packed.view(-1),
                                            op="mean", inplace=True)
                del packed
                off = 0
                for i in idx:
                    shp = (shapes[i][0] // dp,) + tuple(shapes[i][1:])
                    n = int(np.prod(shp))
                    g[i] = mine[off:off + n].view(shp).movedim(0, axes[i])
                    off += n
            for i, t in zip(whole, gspmd.allreduce_mean_leaves(
                    [g[i] for i in whole], dp_comm)):
                g[i] = t
        p_blocks, treedef = _tree.flatten(self.param_blocks(params))
        opt_state = self.blocks(opt_state, params)
        with torch.no_grad():
            updates, opt_state = optimizer.update(
                _tree.unflatten(treedef, g), opt_state,
                _tree.unflatten(treedef, p_blocks))
            del g
            new = list(torch._foreach_add(p_blocks, _tree.leaves(updates)))
            del updates
            for idx in (_tree.by_dtype(new, sharded) if dp > 1 else []):
                shapes = {i: new[i].movedim(axes[i], 0).shape for i in idx}
                packed = torch.cat([new[i].movedim(axes[i], 0).reshape(-1)
                                    for i in idx])
                every = eager.allgather(mesh.comm(AXIS_DP),
                                        packed).reshape(dp, -1)
                del packed
                off = 0
                for i in idx:
                    n = int(np.prod(shapes[i]))
                    leaves[i].movedim(axes[i], 0).copy_(
                        every[:, off:off + n].reshape(
                            dp * shapes[i][0], *shapes[i][1:]))
                    new[i] = None
                    off += n
                del every
            for p, t in zip(leaves, new):
                if t is not None:
                    p.copy_(t)
        return opt_state


def zero1_param_blocks(params: Params, mesh: Mesh, cfg: Config) -> Params:
    """This rank's dp block of each parameter under ``zero1`` (views):
    ``optimizer.init(zero1_param_blocks(params, mesh, cfg))`` makes the
    sharded optimizer state directly, as JAX's ``jit(optimizer.init,
    out_shardings=...)`` does, without the whole state ever existing."""
    return _Zero1(cfg, _MeshPlan(cfg, mesh)).param_blocks(params)


def _dict_leaves(tree: Params):
    """(path, leaf) of a tree of dicts whose leaves are tuples (shapes,
    specs), in JAX order."""
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        else:
            out.append((path, t))

    walk(tree, ())
    return out


def make_train_step(cfg: Config, mesh: Optional[Mesh] = None,
                    lr: float = 3e-4, attn: str = "full", optimizer=None,
                    remat: str = "none", loss_chunk: int = 0,
                    zero1: bool = False, opt_state_example=None):
    """One training step:
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
    ``loss_chunk`` for 8B-scale configs.

    With ``mesh`` (dp x tp x sp): ``params`` is this rank's
    :func:`shard_params` shard and ``tokens``/``targets`` the global (B, L)
    batch, the same on every rank, as JAX's jit takes it; the step takes
    this rank's dp rows and sp chunk.  The loss is the mean over the
    global tokens, returned on every rank; the gradients are averaged over
    dp x sp with one allreduce a dtype over a flat buffer
    (``gspmd.allreduce_mean_leaves``).  ``zero1=True`` (needs
    ``optimizer`` and, as in JAX, an ``opt_state_example``, which only the
    JAX package reads) shards the optimizer state over dp on top of tp
    (:class:`_Zero1`); the step cuts a whole state it is given to this
    rank's blocks and returns the blocks."""
    if zero1 and (optimizer is None or opt_state_example is None):
        raise ValueError("zero1 needs optimizer and opt_state_example "
                         "(e.g. optimizer.init(params))")
    if zero1 and mesh is None:
        raise ValueError("zero1 shards the optimizer state over a mesh's "
                         "dp axis: pass mesh=")
    loss_fn = make_loss_fn(cfg, mesh=mesh, attn=attn, remat=remat,
                           loss_chunk=loss_chunk)
    plan = _MeshPlan(cfg, mesh) if mesh is not None else None
    z1 = _Zero1(cfg, plan) if zero1 else None

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
        if z1 is not None:
            opt_state = z1.step(optimizer, params, grads, opt_state)
            return params, opt_state, loss.detach()
        comm = plan.grad_comm() if plan is not None else None
        if comm is not None:
            grads = gspmd.allreduce_mean_leaves(grads, comm)
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
                 tokens: torch.Tensor, pos: int,
                 tp: Optional[_MeshPlan] = None):
    """One autoregressive position: tokens (B,) at position ``pos`` ->
    (logits (B, V) f32, cache written in place at ``pos``).

    Attention reads the cache up to and including ``pos`` only: the JAX
    step reads all of it under an ``arange <= pos`` mask, and the masked
    entries weigh exactly 0 there, so the result is the same.  With ``tp``
    the weights and the cache are this rank's shards (its heads), the two
    tp sums of a layer run on the wire dtype and the logits are gathered
    over tp."""
    _dense_only(cfg)
    pos = int(pos)
    B = tokens.shape[0]
    hd = cfg.head_dim
    H = params["layers"]["wq"].shape[-1] // hd
    KV = params["layers"]["wk"].shape[-1] // hd
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
        part = o.to(h.dtype) @ lp["wo"]
        h = h + (tp.tp_sum(part) if tp is not None else part)
        x = rms_norm(h, lp["mlp_norm"], cfg.norm_eps)
        part = (F.silu(x @ lp["w_gate"]) * (x @ lp["w_up"])) @ lp["w_down"]
        h = h + (tp.tp_sum(part) if tp is not None else part)
    h = rms_norm(h, params["norm"], cfg.norm_eps)
    if tp is not None:
        return tp.logits(h, params["head"]), cache
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
             prompt: torch.Tensor, attn: str = "auto",
             tp: Optional[_MeshPlan] = None):
    """Batched prefill: ONE full forward over the prompt seeding the K/V
    cache (written in place at positions [0, Lp)).  Returns (last-position
    logits (B, V) f32, cache).  With ``tp``: this rank's shards and heads,
    as :func:`_decode_step`."""
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
                                      with_kv=True, tp=tp)
        cache["k"][i, :, :Lp] = k.to(cache["k"].dtype)
        cache["v"][i, :, :Lp] = v.to(cache["v"].dtype)
    h = rms_norm(h[:, -1], params["norm"], cfg.norm_eps)
    if tp is not None:
        return tp.logits(h, params["head"]), cache
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
    device; the parameters must live on it.

    **Distributed generation** (``mesh``): pass this rank's
    :func:`shard_params` shard; every rank passes the global prompt and
    gets the global (B, max_new) tokens.  Weights stay in their Megatron
    layout, the batch is split over dp, the K/V cache is sharded over
    dp x tp (tp on its KV-head axis, as the column-sharded wk/wv make
    it), and the logits are gathered over tp before the sampler.  Every tp
    rank must pick the same token: pass the same ``rng`` seed on every
    rank (one generator for a rank's rows, so sampled rows differ from a
    one-device run's; greedy ones do not)."""
    if prompt_len < 1 or max_new < 1:
        raise ValueError("prompt_len and max_new must be >= 1")
    if mesh is not None and cfg.n_kv_heads % dict(mesh.shape).get(AXIS_TP, 1):
        raise ValueError(
            f"tp={dict(mesh.shape).get(AXIS_TP)} must divide n_kv_heads "
            f"{cfg.n_kv_heads} (the cache shards on the KV-head axis)")
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
    plan = _MeshPlan(cfg, mesh) if mesh is not None else None

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
        if plan is not None:
            prompt = plan.rows(prompt)
        B = prompt.shape[0]
        # This rank's KV heads: all of them, or its tp shard's.
        kv = params["layers"]["wk"].shape[-1] // cfg.head_dim
        shape = (cfg.n_layers, B, max_len, kv, cfg.head_dim)
        dt = params["embed"].dtype
        cache = {"k": torch.zeros(shape, dtype=dt, device=dev),
                 "v": torch.zeros(shape, dtype=dt, device=dev)}
        logits, cache = _prefill(cfg, params, cache, prompt, tp=plan)
        toks = []
        for i in range(max_new - 1):
            tok = pick(logits, gen)
            toks.append(tok)
            logits, cache = _decode_step(cfg, params, cache, tok,
                                         prompt_len + i, tp=plan)
        toks.append(pick(logits, gen))
        out = torch.stack(toks, dim=1).to(torch.int32)
        if plan is not None and plan.dp > 1:
            out = innerjit.allgather(out, AXIS_DP, mesh=plan.mesh)
        return out

    return fn
