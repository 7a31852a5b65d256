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
global batch; each takes its dp rows and its sp chunk.

The pipeline over the mesh's ``pp`` axis (BASELINE config 4 applied to the
transformer): :func:`make_pp_train_step` (GPipe) and
:func:`make_1f1b_train_step` (1F1B) cut the stacked layers into S
contiguous stages of V = n_layers / S; each rank holds its stage's rows
(:func:`shard_params_pp`, tp-sharded within the stage) and runs the
schedules of ``parallel/pipeline.py`` over its own stage program
(:func:`_make_pp_stage_fn`: V decoder layers with this rank's Megatron
sums and its heads' flash kernels).

Mixture-of-experts FFN (``Config(n_experts=E, expert_top_k=k)``,
Mixtral-style — :func:`mixtral_8x7b`): GShard dispatch/combine einsums over
routing groups (:func:`_moe_ffn`, routed by ``parallel/moe.py``'s
:func:`~torchmpi_tpu_torch.parallel.moe.route_topk`), the Switch
load-balance aux loss through the layers, dropless decode routing.  On a
mesh the expert weights shard over ``ep`` (and their ``d_ff`` over
``tp``); the batch shards over dp only, as in JAX, so every ep rank routes
the same tokens, computes its own experts' buckets, and the combine's
partial sums meet in one sum over ep x tp (the Megatron f/g pair).

Entry points (:func:`init`, :func:`init_kv_cache`, :func:`make_generate_fn`)
run on the current CUDA device unless the caller passes ``device``; with
no GPU and no device they raise.  Where the JAX package returns a new
cache or new parameters, the port writes them in place and returns them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from ..collectives import eager, gspmd, innerjit
from ..parallel import tp as _tp
from ..parallel import moe as _moe
from ..parallel.mesh import AXIS_DP, AXIS_EP, AXIS_PP, AXIS_SP, AXIS_TP, \
    Mesh, mesh_axis_size
from ..utils import tree as _tree
from ._common import DeviceLike, P, dense_init, gather_by_specs, \
    generator as _generator, mesh_spec as _mesh_spec, num_params, \
    resolve_device, shard_by_specs, stack_dense  # noqa: F401
from ._common import GlobalMean as _GlobalMean, from_jax_params, \
    layer_views as _layers, wrap_remat as _wrap_remat  # noqa: F401

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
    # Mixture-of-experts FFN (0 = dense SwiGLU).  With n_experts > 0 every
    # layer's FFN becomes `n_experts` SwiGLU experts routed top-k
    # (Mixtral-style), expert weights sharded over the `ep` mesh axis.
    n_experts: int = 0
    expert_top_k: int = 2
    capacity_factor: float = 1.25  # per-expert slots = cf * k * G / E
    moe_aux_coef: float = 0.01     # load-balance aux-loss weight
    moe_group_size: int = 512      # tokens per routing group (GShard groups)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def __post_init__(self):
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be divisible by n_heads")
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be divisible by n_kv_heads")
        if self.n_experts:
            if not 1 <= self.expert_top_k <= self.n_experts:
                raise ValueError("expert_top_k must be in [1, n_experts]")
            if not self.capacity_factor > 0:
                raise ValueError("capacity_factor must be > 0")


def llama3_8b() -> Config:
    """Llama-3-8B geometry."""
    return Config(vocab=128256, d_model=4096, n_layers=32, n_heads=32,
                  n_kv_heads=8, d_ff=14336, max_seq=8192, rope_theta=500000.0)


def mixtral_8x7b() -> Config:
    """Mixtral-8x7B geometry: 8 SwiGLU experts per layer, top-2 routed."""
    return Config(vocab=32000, d_model=4096, n_layers=32, n_heads=32,
                  n_kv_heads=8, d_ff=14336, max_seq=8192, rope_theta=1e6,
                  n_experts=8, expert_top_k=2)


def tiny(vocab: int = 256, seq: int = 64) -> Config:
    """Test-scale config."""
    return Config(vocab=vocab, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                  d_ff=128, max_seq=seq)


def moe_tiny(vocab: int = 256, seq: int = 64, n_experts: int = 4,
             k: int = 2) -> Config:
    """Test-scale MoE config."""
    return Config(vocab=vocab, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                  d_ff=128, max_seq=seq, n_experts=n_experts, expert_top_k=k)


# ---------------------------------------------------------------------- init

def init(rng: Union[int, torch.Generator], cfg: Config,
         dtype=torch.float32, device: DeviceLike = None) -> Params:
    """Stacked-layer parameter tree (leaves lead with n_layers), drawn from
    ``rng`` (a ``torch.Generator`` on the device, or an int seed).  Same
    distributions as the JAX package, not the same numbers."""
    dev = resolve_device(device)
    gen = _generator(rng, dev)
    hd, H, KV = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads

    def stack(d_in, d_out):
        return stack_dense(gen, cfg.n_layers, d_in, d_out, dtype, dev)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=dev)

    def stack_experts(d_in, d_out):
        # (n_layers, E, d_in, d_out), fan-in scaled like dense_init; drawn
        # one layer at a time so that no f32 copy of a whole bf16 leaf
        # (tens of GB at Mixtral width) is ever made.
        w = torch.empty((cfg.n_layers, cfg.n_experts, d_in, d_out),
                        dtype=dtype, device=dev)
        for i in range(cfg.n_layers):
            w[i] = (normal(cfg.n_experts, d_in, d_out)
                    * math.sqrt(1.0 / d_in)).to(dtype)
        return w

    embed = normal(cfg.vocab, cfg.d_model).mul_(0.02).to(dtype)
    attn = {"wq": stack(cfg.d_model, H * hd),
            "wk": stack(cfg.d_model, KV * hd),
            "wv": stack(cfg.d_model, KV * hd),
            "wo": stack(H * hd, cfg.d_model)}
    if cfg.n_experts:
        ffn = {
            "router": (normal(cfg.n_layers, cfg.d_model, cfg.n_experts)
                       * 0.02).to(dtype),
            "w_gate": stack_experts(cfg.d_model, cfg.d_ff),
            "w_up": stack_experts(cfg.d_model, cfg.d_ff),
            "w_down": stack_experts(cfg.d_ff, cfg.d_model),
        }
    else:
        ffn = {
            "w_gate": stack(cfg.d_model, cfg.d_ff),
            "w_up": stack(cfg.d_model, cfg.d_ff),
            "w_down": stack(cfg.d_ff, cfg.d_model),
        }
    return {
        "embed": embed,
        "layers": {
            "attn_norm": ones(cfg.n_layers, cfg.d_model),
            **attn,
            "mlp_norm": ones(cfg.n_layers, cfg.d_model),
            **ffn,
        },
        "norm": ones(cfg.d_model),
        "head": dense_init(gen, cfg.d_model, cfg.vocab, dtype, dev),
    }


# ------------------------------------------------------------------- sharding

def param_specs(cfg: Config) -> Params:
    """PartitionSpec tree: Megatron tp sharding over stacked layers
    (qkv/gate/up column-sharded, o/down row-sharded, the head
    vocab-sharded); MoE expert weights additionally shard their expert axis
    over ``ep``."""
    col = P(None, None, AXIS_TP)    # (layers, d_in, sharded d_out)
    row = P(None, AXIS_TP, None)    # (layers, sharded d_in, d_out)
    if cfg.n_experts:
        ffn = {
            "router": P(None, None, None),
            "w_gate": P(None, AXIS_EP, None, AXIS_TP),
            "w_up": P(None, AXIS_EP, None, AXIS_TP),
            "w_down": P(None, AXIS_EP, AXIS_TP, None),
        }
    else:
        ffn = {"w_gate": col, "w_up": col, "w_down": row}
    return {
        "embed": P(None, None),
        "layers": {
            "attn_norm": P(None, None),
            "wq": col, "wk": col, "wv": col, "wo": row,
            "mlp_norm": P(None, None),
            **ffn,
        },
        "norm": P(None),
        "head": P(None, AXIS_TP),
    }


def param_shapes(cfg: Config) -> Params:
    """The whole parameter tree's shapes (what :func:`init` makes)."""
    hd, H, KV, n = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    if E:
        ffn = {"router": (n, D, E), "w_gate": (n, E, D, F_),
               "w_up": (n, E, D, F_), "w_down": (n, E, F_, D)}
    else:
        ffn = {"w_gate": (n, D, F_), "w_up": (n, D, F_),
               "w_down": (n, F_, D)}
    return {
        "embed": (cfg.vocab, D),
        "layers": {"attn_norm": (n, D), "wq": (n, D, H * hd),
                   "wk": (n, D, KV * hd), "wv": (n, D, KV * hd),
                   "wo": (n, H * hd, D), "mlp_norm": (n, D), **ffn},
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
    ``manual_wire_dtype`` wire), the MoE FFN's wires over ep x tp and the
    cuts of the global batch.  Outside the pipeline steps a ``pp`` axis
    only replicates, as an axis that no spec names does in JAX."""

    def __init__(self, cfg: Config, mesh: Mesh):
        sizes = dict(mesh.shape)
        if mesh.coords is None:
            raise RuntimeError(f"rank {mesh.my_rank} is not in the mesh")
        self.mesh = mesh
        self.dp, self.pp, self.ep, self.sp, self.tp = (
            sizes.get(a, 1)
            for a in (AXIS_DP, AXIS_PP, AXIS_EP, AXIS_SP, AXIS_TP))
        self.dp_i, self.pp_i, self.ep_i, self.sp_i, self.tp_i = (
            mesh.coords.get(a, 0)
            for a in (AXIS_DP, AXIS_PP, AXIS_EP, AXIS_SP, AXIS_TP))
        tp = self.tp
        if tp > 1 and (cfg.n_heads % tp or cfg.n_kv_heads % tp
                       or cfg.d_ff % tp):
            raise ValueError(
                f"tp={tp} must divide n_heads {cfg.n_heads}, n_kv_heads "
                f"{cfg.n_kv_heads} and d_ff {cfg.d_ff}: each rank runs "
                f"whole heads of its own")
        if cfg.n_experts and cfg.n_experts % self.ep:
            raise ValueError(f"ep={self.ep} must divide n_experts "
                             f"{cfg.n_experts}")
        # The axes an FFN's partial sums meet over: the experts' ep and
        # their d_ff's tp (a dense FFN is replicated over ep).
        self.ffn_axes = tuple(a for a in ((AXIS_EP, AXIS_TP) if cfg.n_experts
                                          else (AXIS_TP,))
                              if sizes.get(a, 1) > 1)
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

    def ffn_in(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron ``f`` over the FFN's axes (ep x tp for experts)."""
        if not self.ffn_axes:
            return x
        return _tp.block_input(x, self.ffn_axes, wire_dtype=self.wire,
                               mesh=self.mesh)

    def ffn_sum(self, part: torch.Tensor) -> torch.Tensor:
        """Megatron ``g`` over the FFN's axes: the experts' partial sums."""
        if not self.ffn_axes:
            return part
        return _tp.block_output(part, self.ffn_axes, wire_dtype=self.wire,
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


def _moe_group(cfg: Config, n_tokens: int) -> int:
    """Routing-group size: largest divisor of ``n_tokens`` at most
    ``cfg.moe_group_size``.  When only sliver divisors exist below the
    target (e.g. ``n_tokens = 2 * prime``), groups of ~2 tokens would
    collapse capacity to ~1 and reduce the aux statistic to noise, so fall
    UP to the smallest divisor above the target instead: token counts the
    caller cannot control (prime prompt lengths, odd decode batches) must
    never fail."""
    target = min(n_tokens, cfg.moe_group_size)
    g = target
    while n_tokens % g:
        g -= 1
    floor = min(n_tokens, max(16, cfg.moe_group_size // 8))
    if g >= floor:
        return g
    for d in range(target + 1, n_tokens + 1):
        if n_tokens % d == 0:      # n_tokens divides itself: always found
            if d > 8 * cfg.moe_group_size:
                import logging

                logging.getLogger(__name__).warning(
                    "moe routing group %d is %.0fx the configured %d "
                    "(n_tokens=%d has no mid-sized divisor); dispatch "
                    "memory grows with the group — pad the token count "
                    "if this is the training path", d,
                    d / cfg.moe_group_size, cfg.moe_group_size, n_tokens)
            return d
    return n_tokens  # unreachable


def _moe_capacity(cfg: Config, group: int) -> int:
    """Static per-expert slot count for one routing group.  Top-k experts
    are distinct, so an expert's worst-case load is ``group`` (one unit per
    token), not ``k * group``."""
    k, E = cfg.expert_top_k, cfg.n_experts
    cap = int(math.ceil(cfg.capacity_factor * k * group / E))
    return max(1, min(cap, group))


def _moe_ffn(cfg: Config, lp: Params, x: torch.Tensor,
             dropless: bool = False, plan: Optional[_MeshPlan] = None):
    """Mixture-of-experts SwiGLU FFN on normed input x (B, L, D) ->
    ``(out (B, L, D), aux-loss scalar f32)``.

    GShard-style dense dispatch/combine over fixed-size **routing groups**
    of ~``cfg.moe_group_size`` tokens, each routed independently with
    capacity ``C = cf * k * G / E`` slots per expert: the dispatch tensor
    is (G·k, E, C) per group, and the layer is three batched GEMMs plus
    routing.  Routing is ``parallel.moe.route_topk``: top-k with
    choice-major capacity priority, weights renormalized over the chosen k
    for k > 1, the raw gate prob for k = 1.  A unit past capacity is
    dropped (contributes 0).  ``dropless=True`` sets C = G — the decode
    path's guarantee that routing never depends on bucket pressure.  The
    aux loss is the Switch/GShard load-balance term ``E * sum_e
    mean_prob_e * primary_fraction_e`` (1 at perfect balance), averaged
    over groups.

    With ``plan`` (a mesh): ``x`` is this rank's block, ``lp`` its shards
    (``E / ep`` experts, their ``d_ff / tp`` columns).  The groups are cut
    from the GLOBAL tokens, as JAX's program cuts them: when this rank's
    tokens are not whole groups, ``x`` is first gathered over dp (and sp)
    and the rank routes every token, keeping its own block of the output.
    Every ep x tp rank routes the same tokens (the router is replicated);
    each computes its experts' buckets, the expert input and the combine
    weights pass ``block_input`` and the partial outputs ``block_output``
    over ep x tp.  The aux term is then this rank's groups' mean (the mean
    over dp x sp is the global one) or, gathered, the global one."""
    B, L, D = x.shape
    E, k = cfg.n_experts, cfg.expert_top_k
    gathered = False
    if dropless or plan is None:
        G = _moe_group(cfg, B * L)     # dropless: every token on its own
    else:
        G = _moe_group(cfg, B * plan.dp * L * plan.sp)
        whole = (L % G == 0) if plan.sp > 1 else ((B * L) % G == 0)
        if not whole:
            mesh = plan.mesh
            if plan.sp > 1:
                x = innerjit.allgather(x, AXIS_SP, concat_axis=1, mesh=mesh)
            if plan.dp > 1:
                x = innerjit.allgather(x, AXIS_DP, concat_axis=0, mesh=mesh)
            gathered = True
    Bx, Lx = x.shape[:2]
    C = G if dropless else _moe_capacity(cfg, G)
    xg = x.reshape(Bx * Lx // G, G, D)

    logits = xg.float() @ lp["router"].float()                  # (nG, G, E)
    probs = torch.softmax(logits, dim=-1)
    # ONE routing definition for both MoE forms (parallel/moe.py).
    sel_f, w_f, onehot, slot = _moe.route_topk(probs, k, k > 1)
    me = probs.mean(dim=1)
    ce = F.one_hot(sel_f[:, :G], E).float().mean(dim=1)
    aux = (E * (me * ce).sum(dim=-1)).mean()

    if plan is not None and plan.ep > 1:
        E_l = E // plan.ep
        onehot = onehot.narrow(-1, plan.ep_i * E_l, E_l)
        slot = slot.narrow(-1, plan.ep_i * E_l, E_l)
    # one_hot(slot, C) drops units whose queue position >= C.
    dispatch = ((slot[..., None] == torch.arange(C, device=x.device))
                & (onehot[..., None] == 1)).to(x.dtype)     # (nG, kG, E_l, C)
    xin = xg
    if plan is not None:
        xin, w_f = plan.ffn_in(xg), plan.ffn_in(w_f)
    xk = xin.repeat(1, k, 1)                                    # (nG, kG, D)
    buckets = torch.einsum("gtec,gtd->gecd", dispatch, xk)  # (nG, E_l, C, D)
    hb = (F.silu(torch.einsum("gecd,edf->gecf", buckets, lp["w_gate"]))
          * torch.einsum("gecd,edf->gecf", buckets, lp["w_up"]))
    out_b = torch.einsum("gecf,efd->gecd", hb, lp["w_down"])
    combine = dispatch * w_f[..., None, None].to(x.dtype)
    yk = torch.einsum("gtec,gecd->gtd", combine, out_b)         # (nG, kG, D)
    y = yk.reshape(-1, k, G, D).sum(dim=1).reshape(Bx, Lx, D)
    if plan is not None:
        y = plan.ffn_sum(y)
        if gathered:
            y = plan.chunk(plan.rows(y))
    return y, aux


def _decoder_layer(cfg: Config, lp: Params, h: torch.Tensor,
                   positions: torch.Tensor, attn_impl: Callable,
                   with_kv: bool = False, tp: Optional[_MeshPlan] = None):
    """One pre-norm decoder block (attention + SwiGLU-or-MoE FFN with
    residuals).  Returns ``(h, aux)`` (aux: the MoE load-balance term, 0
    for dense); with ``with_kv`` also the native-KV-head K/V projections —
    the cache seed for decoding.

    With ``tp`` (a mesh plan) ``lp`` holds this rank's shards and the block
    writes its own Megatron collectives, as the JAX package's
    ``_decoder_layer_tp_manual(markers=True)``: each parallel branch's
    input passes ``block_input`` (a tp sum backward) and its output
    ``block_output`` (a tp sum forward), two sums a layer; attention runs
    on this rank's heads.  An MoE FFN writes its own (:func:`_moe_ffn`)."""
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
    if cfg.n_experts:
        g, aux = _moe_ffn(cfg, lp, x, plan=tp)
        h = h + g
    else:
        if tp is not None:
            x = tp.block_in(x)
        part = (F.silu(x @ lp["w_gate"]) * (x @ lp["w_up"])) @ lp["w_down"]
        h = h + (tp.tp_sum(part) if tp is not None else part)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if with_kv:
        return h, aux, (k, v)
    return h, aux


# ----------------------------------------------------------------- training

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
    layout and their ``positions``.  An MoE config's aux on a mesh is this
    rank's share (:func:`_moe_ffn`)."""
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
    permutation-invariant, so the loss equals the contiguous layout's.
    An MoE config adds ``cfg.moe_aux_coef * aux``, as JAX's loss does."""
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
        h, aux = apply(cfg, params, tokens, mesh=mesh, attn=attn,
                       remat=remat, return_hidden=True, return_aux=True,
                       layer_loop=layer_loop,
                       positions=positions)               # (B, L, D)
        if plan is None:
            nll = _nll_from_hidden(params["head"], h, targets, loss_chunk)
            if cfg.n_experts:
                nll = nll + cfg.moe_aux_coef * aux
            return nll
        targets = plan.chunk(plan.rows(targets))
        if plan.head_sharded:
            nll = _nll_from_hidden_tp(params["head"], h, targets,
                                      loss_chunk, plan)
        else:
            nll = _nll_from_hidden(params["head"], h, targets, loss_chunk)
        if cfg.n_experts:
            nll = nll + cfg.moe_aux_coef * aux
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
    the updated blocks (one all-gather a dtype).  ``specs`` is the layout
    the parameters rest in (default :func:`param_specs`; the pipeline steps
    pass :func:`param_specs_pp`, as JAX's ``_zero1_opt_shardings`` takes
    them)."""

    def __init__(self, cfg: Config, plan: _MeshPlan, specs=None):
        self.plan = plan
        dp = plan.dp
        self.axis: Dict[tuple, Optional[int]] = {}
        specs = dict(_dict_leaves(specs or param_specs(cfg)))
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
    return _make_step(loss_fn, plan, optimizer, lr, z1)


def _make_step(loss_fn: Callable, plan: Optional[_MeshPlan], optimizer,
               lr: float, z1: Optional[_Zero1]):
    """The body :func:`make_train_step` and :func:`make_pp_train_step`
    share: the gradients of ``loss_fn(params, (tokens, targets))``,
    averaged over the plan's dp x sp (or through zero1), and the update in
    place."""

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


# ------------------------------------------------------------- pipeline (pp)

def param_specs_pp(cfg: Config) -> Params:
    """PartitionSpec tree for the pipeline steps: stacked layer leaves'
    leading (n_layers) axis shards over ``pp`` — contiguous rows land on
    contiguous stages — while the within-layer dims keep
    :func:`param_specs`' Megatron tp layout.  Embed/norm stay replicated;
    the head keeps its tp column sharding."""
    base = param_specs(cfg)
    layers = {k: P(AXIS_PP, *tuple(sp)[1:]) for k, sp in
              base["layers"].items()}
    return {"embed": base["embed"], "layers": layers,
            "norm": base["norm"], "head": base["head"]}


def shard_params_pp(params: Params, mesh: Mesh,
                    cfg: Optional[Config] = None) -> Params:
    """This rank's shard of a whole tree for the pipeline steps: its
    stage's layer rows ``[s V, (s + 1) V)`` (and, with ``cfg`` given, its
    tp shards within them and of the head, per :func:`param_specs_pp` — the
    3-D layout); embed and norm whole."""
    if cfg is not None:
        return shard_by_specs(params, mesh, param_specs_pp(cfg))
    layers = {k: P(AXIS_PP) for k in params["layers"]}
    specs = {"embed": P(), "layers": layers, "norm": P(), "head": P()}
    return shard_by_specs(params, mesh, specs)


def gather_params_pp(params: Params, mesh: Mesh, cfg: Config) -> Params:
    """The inverse of :func:`shard_params_pp` (with ``cfg``): the whole tree
    on every rank, the layers gathered over pp and the tp shards over tp
    (every rank of the mesh calls it)."""
    return gather_by_specs(params, mesh, param_specs_pp(cfg),
                           param_shapes(cfg))


def _make_pp_stage_fn(cfg: Config, attn_impl: Callable, remat: str,
                      plan: _MeshPlan) -> Callable:
    """One pipeline stage: ``stage_fn(lp_stage, h)`` runs the V decoder
    layers of ``lp_stage`` (leaves with a leading V) over a (mb, L, D)
    carrier, each under the remat policy (:func:`_wrap_remat`).  It is the
    JAX package's ``_make_pp_stage_fn`` and ``_make_pp_stage_fn_tp_manual``
    at once: :func:`_decoder_layer` with the plan writes this rank's two
    Megatron sums a layer through the f/g pair (JAX's
    ``_decoder_layer_tp_manual(markers=True)``), whose backward is right
    on this rank alone, as both schedules need; without a tp axis the pair
    makes no call."""
    tp = plan if plan.tp > 1 else None

    def layer(h, lp, positions):
        return _decoder_layer(cfg, lp, h, positions, attn_impl, tp=tp)[0]

    layer = _wrap_remat(layer, remat)

    def stage_fn(lp_stage, h):
        positions = torch.arange(h.shape[1], device=h.device)
        for lp in _layers({"layers": lp_stage}):
            h = layer(h, lp, positions)
        return h

    return stage_fn


def _pp_validate(cfg: Config, mesh: Mesh, attn: str, stage_tp: str,
                 vocab: bool = False) -> int:
    """The JAX package's checks of both pipeline steps, in its order;
    returns the stage count S."""
    if cfg.n_experts:
        # The GPipe carrier is a single (mb, L, D) tensor; threading the MoE
        # aux loss through the stage boundary needs an augmented carrier.
        # Train MoE configs with the dp x tp x ep step (make_train_step).
        raise NotImplementedError("pipeline step does not support MoE configs")
    S = mesh.shape[AXIS_PP]
    sizes = dict(mesh.shape)
    if cfg.n_layers % S:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by pp={S}")
    if attn not in ("full", "flash"):
        raise ValueError("pp step supports attn='full'|'flash'")
    if sizes.get(AXIS_SP, 1) > 1:
        raise ValueError("the pp steps do not compose with an sp axis (the "
                         "ring and the stage carrier conflict)")
    if stage_tp == "manual":
        tp = sizes.get(AXIS_TP, 1)
        if AXIS_TP not in mesh.axis_names:
            raise ValueError("stage_tp='manual' needs a tp mesh axis")
        if attn != "flash":
            raise ValueError("stage_tp='manual' runs the flash kernels on "
                             "the local head shard; pass attn='flash'")
        if vocab:
            if (cfg.n_heads % tp or cfg.n_kv_heads % tp or cfg.d_ff % tp
                    or cfg.d_model % tp or cfg.vocab % tp):
                raise ValueError(f"tp={tp} must divide n_heads/n_kv_heads/"
                                 f"d_ff/d_model/vocab")
        elif (cfg.n_heads % tp or cfg.n_kv_heads % tp or cfg.d_ff % tp
              or cfg.d_model % tp):
            raise ValueError(
                f"tp={tp} must divide n_heads/n_kv_heads/d_ff/d_model")
    elif stage_tp != "auto":
        raise ValueError("stage_tp must be 'auto' or 'manual'")
    return S


def _pp_rows(plan: _MeshPlan, x: torch.Tensor, M: int) -> torch.Tensor:
    """The global (B, ...) batch as M micro-batches of this rank's dp rows:
    (M, B / (M dp), ...), micro-batch m being global rows ``[m B/M, (m+1)
    B/M)`` cut over dp, as JAX shards the (M, mb) form over (pp, dp)."""
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} micro-batches")
    xm = x.reshape(M, B // M, *x.shape[1:])
    if xm.shape[1] % plan.dp:
        raise ValueError(f"micro-batch {xm.shape[1]} not divisible by "
                         f"dp={plan.dp}")
    n = xm.shape[1] // plan.dp
    return xm.narrow(1, plan.dp_i * n, n)


def _staged(layers: Params) -> Params:
    """This rank's (V, ...) layer rows as the pipeline's stage row (1, V,
    ...), views."""
    return {k: v.unsqueeze(0) for k, v in layers.items()}


def make_pp_train_step(cfg: Config, mesh: Mesh, n_microbatches: int,
                       lr: float = 3e-4, attn: str = "full",
                       remat: str = "none", loss_chunk: int = 0,
                       optimizer=None, opt_state_example=None,
                       zero1: bool = False, stage_tp: str = "auto"):
    """Pipeline-parallel training step: the stacked decoder layers become
    GPipe stages over the mesh's ``pp`` axis (``parallel/pipeline.py``
    ``make_pipeline_fn``), composed with ``dp`` and ``tp``.

    Every rank passes the global (B, L) batch; ``params`` is this rank's
    :func:`shard_params_pp` shard (its stage's V layers, tp-sharded).
    Micro-batch m is global rows ``[m B/M, (m+1) B/M)``, cut over dp.  The
    embedding runs on every rank (stage 0 feeds it to the pipeline); the
    last stage's outputs are broadcast over pp and every pp rank runs the
    final norm and the loss head on them (the head vocab-sharded over tp
    through :class:`_TpCE`), so the embed, norm and head gradients come out
    the same on every pp rank — the embedding's from stage 0's input
    gradient, broadcast back — and those leaves stay equal there with no
    sum over pp.  JAX's default shards the pipeline I/O over pp instead and
    sums the head's gradient over pp: here that sum would move the (D,
    vocab) head through the host on one card.  The gradients are then
    averaged over dp, as :func:`make_train_step` averages them.

    ``stage_tp``: ``"manual"`` (needs ``attn="flash"`` and a tp axis) runs
    the hand-sharded stage, flash on this rank's heads.  The port has no
    GSPMD, so on a tp mesh ``"auto"`` runs the same hand-sharded stage
    with the given ``attn`` (full or flash); without tp both are the plain
    stage.  JAX's validation errors otherwise.  ``zero1=True`` (needs
    ``optimizer`` and ``opt_state_example``) shards the optimizer state
    over dp on top of the pp x tp layout (:class:`_Zero1` over
    :func:`param_specs_pp`).

    Returns ``(step, V)``.  Without ``optimizer``: ``step(params, tokens,
    targets) -> (params, loss)`` (SGD at ``lr``).  With one:
    ``step(params, opt_state, tokens, targets) -> (params, opt_state,
    loss)``.  The update is in place, as :func:`make_train_step`'s."""
    from ..parallel import pipeline as _pp

    S = _pp_validate(cfg, mesh, attn, stage_tp)
    if zero1 and (optimizer is None or opt_state_example is None):
        raise ValueError("zero1 needs optimizer and opt_state_example")
    V = cfg.n_layers // S
    M = n_microbatches
    plan = _MeshPlan(cfg, mesh)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    stage_fn = _make_pp_stage_fn(cfg, _make_attn_impl(cfg, attn, None, scale),
                                 remat, plan)
    pipe = _pp.make_pipeline_fn(mesh, stage_fn, M, sharded_io=False)

    def loss_fn(params: Params, batch) -> torch.Tensor:
        tokens, targets = (torch.as_tensor(t) for t in batch)
        tok = _pp_rows(plan, tokens, M)                 # (M, mb, L)
        h = params["embed"][tok.long()]                 # (M, mb, L, D)
        h = pipe(_staged(params["layers"]), h)
        h = h.reshape(-1, *h.shape[2:])
        h = rms_norm(h, params["norm"], cfg.norm_eps)
        tgt = _pp_rows(plan, targets, M).reshape(h.shape[:2])
        if plan.head_sharded:
            nll = _nll_from_hidden_tp(params["head"], h, tgt, loss_chunk,
                                      plan)
        else:
            nll = _nll_from_hidden(params["head"], h, tgt, loss_chunk)
        comm = plan.grad_comm()
        return _GlobalMean.apply(nll, comm) if comm is not None else nll

    z1 = _Zero1(cfg, plan, specs=param_specs_pp(cfg)) if zero1 else None
    step4 = _make_step(loss_fn, plan, optimizer, lr, z1)
    if optimizer is not None:
        return step4, V

    def step(params: Params, tokens: torch.Tensor, targets: torch.Tensor):
        params, _, loss = step4(params, None, tokens, targets)
        return params, loss

    return step, V


def make_1f1b_train_step(cfg: Config, mesh: Mesh, n_microbatches: int,
                         lr: float = 3e-4, attn: str = "full",
                         remat: str = "none", loss_chunk: int = 0,
                         stage_tp: str = "auto",
                         manual_schedule: str = "combined"):
    """Pipeline-parallel training on the **1F1B / PipeDream-flush**
    schedule (``parallel/pipeline.py`` ``make_1f1b_step``): the same stage
    split and stage program as :func:`make_pp_train_step`, with the stash
    capped at ~S micro-batch inputs instead of GPipe's M.

    The whole model trains: the stage gradients come from the scheduled
    backward ops, the final norm's and the head's accumulate at the last
    stage (the loss parameters; the head vocab-sharded over tp through
    :class:`_TpCE`) and are summed over pp, and the embedding's is a
    scatter-add of the pipeline-input gradients ``dx`` over the global
    batch's tokens (``index_put_`` with ``accumulate=True``, the
    deterministic form of ``index_add_``, so every rank adds in one order
    and the embedding stays equal on every rank; over dp, ``dx`` is
    gathered first).  Returns ``(step, V)``; ``step(params, tokens,
    targets) -> (params, loss)`` (SGD at ``lr``, in place), ``params`` as
    from :func:`shard_params_pp` with ``cfg``, the global batch on every
    rank.

    ``stage_tp='manual'`` (needs ``attn='flash'`` and a tp axis) runs the
    hand-sharded stage on ``manual_schedule``'s ticks: ``"combined"``
    (default; T ~= M + 2S - 1 ticks, stash <= 2S - 1) or ``"alternating"``
    (stash <= S + 1).  ``'auto'`` runs the same stage with the given
    ``attn`` on the alternating schedule, JAX's auto path, and refuses
    ``manual_schedule``."""
    from ..parallel import pipeline as _pp

    S = _pp_validate(cfg, mesh, attn, stage_tp, vocab=True)
    if stage_tp == "auto" and manual_schedule != "combined":
        # The auto path always runs the alternating schedule; silently
        # accepting the knob would let a caller believe they selected a
        # schedule they did not get.
        raise ValueError("manual_schedule applies to stage_tp='manual' "
                         "only (the auto path is always cond-gated)")
    V = cfg.n_layers // S
    M = n_microbatches
    plan = _MeshPlan(cfg, mesh)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    stage_fn = _make_pp_stage_fn(cfg, _make_attn_impl(cfg, attn, None, scale),
                                 remat, plan)

    def loss_fn(lp, h, tgt):
        h = rms_norm(h, lp["norm"], cfg.norm_eps)
        if plan.head_sharded:
            return _nll_from_hidden_tp(lp["head"], h, tgt, loss_chunk, plan)
        return _nll_from_hidden(lp["head"], h, tgt, loss_chunk)

    manual = tuple(a for a in (AXIS_TP, AXIS_DP) if a in mesh.axis_names)
    io_batch = AXIS_DP if plan.dp > 1 else None
    pipe = _pp.make_1f1b_step(
        mesh, stage_fn, loss_fn, M, loss_params_example={"norm": None,
                                                         "head": None},
        return_dx=True, manual_axes=manual or None, io_batch_axis=io_batch,
        manual_schedule=manual_schedule if stage_tp == "manual"
        else "alternating")

    def step(params: Params, tokens: torch.Tensor, targets: torch.Tensor):
        tokens, targets = torch.as_tensor(tokens), torch.as_tensor(targets)
        B, L = tokens.shape
        tok = _pp_rows(plan, tokens, M)
        with torch.no_grad():
            h = params["embed"][tok.long()]
        lp = {"norm": params["norm"], "head": params["head"]}
        loss, g_staged, g_lp, dx = pipe(
            _staged(params["layers"]), lp, h, _pp_rows(plan, targets, M))
        if plan.dp > 1:
            # The global batch's dx (M, B/M, L, D), micro-batch rows in
            # order, for the global tokens.
            dx = innerjit.allgather(dx, AXIS_DP, concat_axis=1,
                                    mesh=plan.mesh)
        d_embed = torch.zeros(params["embed"].shape, dtype=torch.float32,
                              device=dx.device)
        d_embed.index_put_((tokens.reshape(-1).long(),),
                           dx.reshape(B * L, -1), accumulate=True)
        del dx
        grads = {"embed": d_embed,
                 "layers": {k: g_staged[k][0] for k in params["layers"]},
                 "norm": g_lp["norm"], "head": g_lp["head"]}
        grads = {k: grads[k] for k in params}       # the params' order
        for p, g in zip(_leaves(params), _leaves(grads)):
            _sgd_update_(p, g, lr)
        return params, loss

    step.pipe = pipe            # its stash_high_water, after each step
    return step, V


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
    over tp.  An MoE FFN routes dropless (capacity = tokens a group)."""
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
        if cfg.n_experts:
            # Dropless at decode: capacity = tokens a group covers the
            # worst case (top-k experts are distinct, so an expert gets at
            # most one unit per token).
            g, _ = _moe_ffn(cfg, lp, x[:, None, :], dropless=True, plan=tp)
            h = h + g[:, 0]
            continue
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
