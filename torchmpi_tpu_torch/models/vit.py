"""Vision Transformer (ViT): the port's second transformer family.

Counterpart of ``torchmpi_tpu/models/vit.py``.  Architecture (Dosovitskiy
et al.): patchify by reshape (a stride-P PxP convolution is a matmul over
flattened patches), learned position embeddings, optional register tokens
(Darcet et al.) appended after the patches, pre-LN encoder blocks (MHA +
tanh-GELU MLP), a global average pool over the patch tokens, a linear head.

The parameters keep the JAX package's tree and layout: stacked layer leaves
lead with ``n_layers``, dense weights are ``(d_in, d_out)`` applied as
``x @ w``, the fused ``wqkv`` is ``(n_layers, D, 3D)`` read as
``(..., 3, H, hd)``, and the layer-norm scales and biases are f32 whatever
the other leaves' dtype.  :func:`from_jax_params` carries a JAX parameter
tree across unchanged.

Attention: ``attn="full"`` (einsums accumulating in f32, f32 softmax) or
``attn="flash"``: ``ops/flash_attention.py`` non-causally on (B, N, H, hd),
the hand-written kernels B4 (forward) and B5/B6 (backward) on the card at
head size 64 (ViT-B/16), their plain versions on the CPU.

The mesh path (``mesh=`` of :func:`apply` and :func:`make_loss_fn`): in JAX
one GSPMD program places the parameters by :func:`param_specs` and XLA
inserts the collectives.  Here each rank holds its own shards
(:func:`shard_params`; :func:`gather_params` is the inverse) and runs the
Megatron layer by hand, as Llama's mesh path does: ``block_input`` before
each parallel branch, ``block_output`` (a tp sum) after it, attention on
this rank's heads, the head column-sharded and its logits gathered over tp.
Every rank passes the global batch and gets its dp rows.

Entry points (:func:`init`, :func:`from_jax_params`) run on the current
CUDA device unless the caller passes ``device``; with no GPU and no device
they raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Union

import torch
import torch.nn.functional as F

from ..parallel import tp as _tp
from ..parallel.mesh import AXIS_DP, AXIS_TP, Mesh
from ._common import DeviceLike, GlobalMean, P, dense_init, \
    from_jax_params, gather_by_specs, generator as _generator, \
    layer_views, mesh_spec as _mesh_spec, num_params, resolve_device, \
    shard_by_specs, stack_dense, wrap_remat  # noqa: F401

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Config:
    image: int = 224
    patch: int = 16
    in_channels: int = 3
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    n_classes: int = 1000
    norm_eps: float = 1e-6
    # Learned register tokens appended to the patch sequence and left out
    # of the pooled representation; 196 patches + 60 registers = 256
    # tokens, the sequence ViT-B/16's flash path runs at.
    n_registers: int = 0

    @property
    def n_patches(self) -> int:
        return (self.image // self.patch) ** 2

    @property
    def seq_len(self) -> int:
        return self.n_patches + self.n_registers

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    def __post_init__(self):
        assert self.image % self.patch == 0
        assert self.d_model % self.n_heads == 0


def vit_b16(n_registers: int = 0) -> Config:
    """ViT-Base/16 geometry (86M parameters, head size 64).
    ``n_registers=60`` rounds the sequence to 256."""
    return Config(n_registers=n_registers)


def tiny(image: int = 32, patch: int = 8, n_classes: int = 10) -> Config:
    """Test-scale config."""
    return Config(image=image, patch=patch, d_model=64, n_layers=2,
                  n_heads=4, d_ff=128, n_classes=n_classes)


def init(rng: Union[int, torch.Generator], cfg: Config,
         dtype=torch.float32, device: DeviceLike = None) -> Params:
    """Stacked-layer parameter tree (layer leaves lead with n_layers), drawn
    from ``rng`` (a ``torch.Generator`` on the device, or an int seed).
    Same distributions as the JAX package, not the same numbers.  The
    layer-norm scales and biases are f32, every other leaf ``dtype``."""
    dev = resolve_device(device)
    gen = _generator(rng, dev)
    patch_dim = cfg.patch * cfg.patch * cfg.in_channels
    D, F_, L = cfg.d_model, cfg.d_ff, cfg.n_layers

    def stack(d_in, d_out):
        return stack_dense(gen, L, d_in, d_out, dtype, dev)

    def f32(fill, *shape):
        return torch.full(shape, fill, dtype=torch.float32, device=dev)

    def normal(*shape):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev) * 0.02).to(dtype)

    params = {
        "patch_embed": dense_init(gen, patch_dim, D, dtype, dev),
        "pos_embed": normal(cfg.n_patches, D),
        "layers": {
            "ln1_scale": f32(1.0, L, D),
            "ln1_bias": f32(0.0, L, D),
            "wqkv": stack(D, 3 * D),
            "wo": stack(D, D),
            "ln2_scale": f32(1.0, L, D),
            "ln2_bias": f32(0.0, L, D),
            "w_up": stack(D, F_),
            "w_down": stack(F_, D),
        },
        "ln_scale": f32(1.0, D),
        "ln_bias": f32(0.0, D),
        "head": dense_init(gen, D, cfg.n_classes, dtype, dev),
    }
    if cfg.n_registers:
        params["registers"] = normal(cfg.n_registers, D)
    return params


# ------------------------------------------------------------------- sharding

def param_specs(cfg: Config) -> Params:
    """Megatron tp: qkv/up column-sharded, o/down row-sharded, the head
    column-sharded (over its classes), the rest replicated.

    ``wqkv`` is one fused (L, D, 3D) leaf read as (..., 3, H, hd), so a
    contiguous split of its columns would hand rank 0 all of q and part of
    k.  Its ``tp`` entry therefore means: sharded by heads within each of
    q, k and v (:func:`shard_params` views it as (L, D, 3, H, hd) and
    splits H), which matches ``wo``'s row split (its rows are the heads'
    outputs, head-major).  A dimension that tp does not divide stays
    replicated, as ``_common.shard_by_specs`` does."""
    col = P(None, None, AXIS_TP)
    row = P(None, AXIS_TP, None)
    specs = {
        "patch_embed": P(None, None),
        "pos_embed": P(None, None),
        "layers": {
            "ln1_scale": P(None, None), "ln1_bias": P(None, None),
            "wqkv": col, "wo": row,
            "ln2_scale": P(None, None), "ln2_bias": P(None, None),
            "w_up": col, "w_down": row,
        },
        "ln_scale": P(None), "ln_bias": P(None),
        "head": P(None, AXIS_TP),
    }
    if cfg.n_registers:
        specs["registers"] = P(None, None)
    return specs


def param_shapes(cfg: Config) -> Params:
    """The whole parameter tree's shapes (what :func:`init` makes)."""
    D, F_, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    shapes = {
        "patch_embed": (cfg.patch * cfg.patch * cfg.in_channels, D),
        "pos_embed": (cfg.n_patches, D),
        "layers": {"ln1_scale": (L, D), "ln1_bias": (L, D),
                   "wqkv": (L, D, 3 * D), "wo": (L, D, D),
                   "ln2_scale": (L, D), "ln2_bias": (L, D),
                   "w_up": (L, D, F_), "w_down": (L, F_, D)},
        "ln_scale": (D,), "ln_bias": (D,),
        "head": (D, cfg.n_classes),
    }
    if cfg.n_registers:
        shapes["registers"] = (cfg.n_registers, D)
    return shapes


# wqkv as (L, D, 3, H, hd): its tp entry moves to the head axis.
_QKV_SPEC = P(None, None, None, AXIS_TP, None)


def _qkv_heads(w: torch.Tensor, cfg: Config) -> torch.Tensor:
    L, D, _ = w.shape
    return w.reshape(L, D, 3, -1, cfg.head_dim)


def shard_params(params: Params, mesh: Mesh, cfg: Config) -> Params:
    """This rank's shard of a whole parameter tree, per :func:`param_specs`
    under the shared axis-dropping rule (``_common.mesh_spec``), ``wqkv``
    by heads within each of q, k and v."""
    specs = param_specs(cfg)
    wqkv = params["layers"]["wqkv"]
    specs["layers"]["wqkv"] = _QKV_SPEC
    layers = dict(params["layers"], wqkv=_qkv_heads(wqkv, cfg))
    out = shard_by_specs(dict(params, layers=layers), mesh, specs)
    w = out["layers"]["wqkv"]
    out["layers"]["wqkv"] = w.reshape(*w.shape[:2], -1)
    return out


def gather_params(params: Params, mesh: Mesh, cfg: Config) -> Params:
    """The inverse of :func:`shard_params`: the whole tree on every rank,
    each sharded leaf gathered over tp (every rank of the mesh calls
    it)."""
    specs, shapes = param_specs(cfg), param_shapes(cfg)
    L, D = cfg.n_layers, cfg.d_model
    specs["layers"]["wqkv"] = _QKV_SPEC
    shapes["layers"]["wqkv"] = (L, D, 3, cfg.n_heads, cfg.head_dim)
    wqkv = params["layers"]["wqkv"]
    layers = dict(params["layers"], wqkv=_qkv_heads(wqkv, cfg))
    out = gather_by_specs(dict(params, layers=layers), mesh, specs, shapes)
    out["layers"]["wqkv"] = out["layers"]["wqkv"].reshape(L, D, 3 * D)
    return out


class _MeshPlan:
    """What the mesh path reads of its mesh: the dp rows of the global
    batch, the tp wires (the Megatron f/g pair on the ``manual_wire_dtype``
    wire) and the head's logits gathered over tp.  Axes other than dp and
    tp only replicate, as an axis that no spec names does in JAX."""

    def __init__(self, cfg: Config, mesh: Mesh):
        if mesh.coords is None:
            raise RuntimeError(f"rank {mesh.my_rank} is not in the mesh")
        sizes = dict(mesh.shape)
        self.mesh = mesh
        self.dp, self.tp = sizes.get(AXIS_DP, 1), sizes.get(AXIS_TP, 1)
        self.dp_i = mesh.coords.get(AXIS_DP, 0)
        self.wire = _tp.resolve_wire_dtype()
        head = _mesh_spec(param_specs(cfg)["head"], mesh,
                          (cfg.d_model, cfg.n_classes))
        self.head_sharded = self.tp > 1 and head[1] == AXIS_TP
        self.grad_comm = mesh.comm(AXIS_DP) if self.dp > 1 else None

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's dp rows of a global batch."""
        if x.shape[0] % self.dp:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"dp={self.dp}")
        n = x.shape[0] // self.dp
        return x.narrow(0, self.dp_i * n, n)

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
        """f32 logits over every class: a column-sharded head's partial
        logits gathered over tp (:class:`_GatherClasses`); ``h``, which
        every tp rank holds whole, passes ``block_input`` so that its
        gradient sums the ranks' columns' parts."""
        if not self.head_sharded:
            return (h @ head).float()
        part = (self.block_in(h) @ head).float()
        return _GatherClasses.apply(part, self)


class _GatherClasses(torch.autograd.Function):
    """The tp ranks' class columns gathered into whole logits; backward:
    this rank's columns of the gradient.  Every tp rank computes the same
    loss from the same gathered logits, so the gradient is already whole
    on each, and its own slice is its columns' share (where the
    reduce-scatter of ``innerjit.allgather``'s backward would add the tp
    ranks' equal copies)."""

    @staticmethod
    def forward(ctx, part, plan):
        from ..collectives import innerjit

        ctx.n, ctx.i = part.shape[-1], plan.mesh.coords[AXIS_TP]
        return innerjit.allgather(part, AXIS_TP, concat_axis=-1,
                                  mesh=plan.mesh)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.i * ctx.n, ctx.n), None


# -------------------------------------------------------------------- forward

def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    """In f32 with the biased variance, then cast back to x's dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def _attention(q, k, v, scale: float, flash: bool) -> torch.Tensor:
    """(B, N, H, hd) bidirectional attention; f32 softmax."""
    if flash:
        from ..ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=False)
    # f32 accumulation of the bf16 products, as JAX's
    # preferred_element_type=f32 einsums.
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float()).to(q.dtype)


def patchify(cfg: Config, x: torch.Tensor) -> torch.Tensor:
    """NHWC images -> (B, n_patches, patch*patch*C) rows (pure reshape)."""
    B, Hh, Ww, C = x.shape
    Pp = cfg.patch
    g = Hh // Pp
    x = x.reshape(B, g, Pp, g, Pp, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, g * g, Pp * Pp * C)


def apply(cfg: Config, params: Params, x: torch.Tensor, attn: str = "full",
          remat: str = "none", layer_loop: str = "unroll",
          mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Forward: NHWC images -> (B, n_classes) f32 logits.  ``attn='flash'``
    runs the flash kernels non-causally.  ``remat`` is the per-layer
    rematerialisation policy ('none' | 'dots' | 'full',
    ``_common.wrap_remat``).  ``layer_loop`` is ``"unroll"`` or ``"scan"``:
    both are one Python loop over the layers in eager PyTorch, kept so
    callers pass the same arguments to both packages.

    With ``mesh``: ``params`` is this rank's :func:`shard_params` shard and
    ``x`` the global batch, the same on every rank; the result is this
    rank's dp rows of the logits, over every class (gathered over tp)."""
    if attn not in ("full", "flash"):
        raise ValueError("attn must be 'full' or 'flash'")
    if layer_loop not in ("unroll", "scan"):
        raise ValueError("layer_loop must be 'unroll' or 'scan'")
    plan = _MeshPlan(cfg, mesh) if mesh is not None else None
    if plan is not None:
        x = plan.rows(x)
    B = x.shape[0]
    hd = cfg.head_dim
    scale = 1.0 / math.sqrt(hd)

    h = patchify(cfg, x).to(params["patch_embed"].dtype)
    h = h @ params["patch_embed"] + params["pos_embed"]   # (B, Np, D)
    n_patch = h.shape[1]
    if cfg.n_registers:
        regs = params["registers"][None].expand(
            B, cfg.n_registers, cfg.d_model).to(h.dtype)
        h = torch.cat([h, regs], dim=1)                    # (B, Np+R, D)
    N = h.shape[1]

    def layer(h, lp):
        z = _layer_norm(h, lp["ln1_scale"], lp["ln1_bias"], cfg.norm_eps)
        if plan is not None:
            z = plan.block_in(z)
        qkv = (z @ lp["wqkv"]).reshape(B, N, 3, -1, hd)    # this rank's heads
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        o = _attention(q, k, v, scale, flash=(attn == "flash"))
        part = o.reshape(B, N, -1) @ lp["wo"]
        h = h + (plan.tp_sum(part) if plan is not None else part)
        z = _layer_norm(h, lp["ln2_scale"], lp["ln2_bias"], cfg.norm_eps)
        if plan is not None:
            z = plan.block_in(z)
        part = F.gelu(z @ lp["w_up"], approximate="tanh") @ lp["w_down"]
        return h + (plan.tp_sum(part) if plan is not None else part)

    layer = wrap_remat(layer, remat)
    for lp in layer_views(params):
        h = layer(h, lp)
    h = _layer_norm(h, params["ln_scale"], params["ln_bias"], cfg.norm_eps)
    # The mean over the PATCH tokens only, accumulated in f32 (jnp.mean's
    # rule for bf16) and rounded once to h's dtype.
    h = h[:, :n_patch].float().mean(dim=1).to(h.dtype)
    if plan is not None:
        return plan.logits(h, params["head"])
    return (h @ params["head"]).float()


def make_loss_fn(cfg: Config, attn: str = "full", remat: str = "none",
                 layer_loop: str = "unroll", mesh: Optional[Mesh] = None):
    """Softmax cross-entropy ``loss_fn(params, (images, labels))``: the
    engine's contract (drop into ``AllReduceSGDEngine``).

    With ``mesh``: ``params`` is this rank's shard and the batch the global
    one, the same on every rank.  The loss is the mean over the global
    batch, on every rank; its gradient on each rank is that of its own dp
    rows' mean (``_common.GlobalMean``), so the mean over dp of the ranks'
    gradients is the global one."""
    plan = _MeshPlan(cfg, mesh) if mesh is not None else None

    def loss_fn(params: Params, batch) -> torch.Tensor:
        x, y = batch
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        logits = apply(cfg, params, x, attn=attn, remat=remat,
                       layer_loop=layer_loop, mesh=mesh)
        if plan is not None:
            y = plan.rows(y)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.mean(torch.gather(logp, -1,
                                       y.long()[:, None])[:, 0])
        if plan is not None and plan.grad_comm is not None:
            return GlobalMean.apply(nll, plan.grad_comm)
        return nll

    return loss_fn
