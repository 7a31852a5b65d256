"""Expert parallelism: a mixture-of-experts layer dispatched over an ``ep``
mesh axis.

Counterpart of ``torchmpi_tpu/parallel/moe.py``:

* experts are sharded over ``ep`` (each rank owns ``E / ep`` expert MLPs,
  stacked on a leading axis);
* tokens are routed top-k by a learned gate (k=1 switch-style with the raw
  gate prob as weight; k>1 GShard-style with renormalized weights and
  primary routes served before secondary ones), then moved to their
  experts' ranks with :func:`~torchmpi_tpu_torch.collectives.innerjit
  .alltoall` using **capacity buckets**: each (rank, expert) pair gets a
  fixed-size slot buffer (a token whose every choice is dropped passes
  through unchanged);
* expert compute is one batched GEMM over the local buckets, then the
  inverse all-to-all returns outputs to the tokens' home ranks.

Where JAX runs the body under ``shard_map``, here every rank calls the
layer on its own token shard and its own experts (:func:`shard_experts`),
as ``parallel/sequence.py``'s bodies are called.  The two all-to-alls are
differentiable (the backward is the inverse exchange), so the gradient of
each rank's experts collects every rank's tokens.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F

from ..collectives import innerjit
from ..models._common import P, generator as _generator, resolve_device, \
    shard_by_specs
from .mesh import AXIS_EP, Mesh

Params = dict


def init_experts(rng: Union[int, torch.Generator], n_experts: int,
                 d_model: int, d_ff: int, dtype=torch.float32,
                 device=None) -> Params:
    """Gate + stacked expert MLPs (leading axis = expert, sharded on ep).
    Same distributions as the JAX package, not the same numbers."""
    dev = resolve_device(device)
    gen = _generator(rng, dev)

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=dev)

    return {
        "gate": (normal(d_model, n_experts) * 0.02).to(dtype),
        "w_in": (normal(n_experts, d_model, d_ff)
                 * math.sqrt(2.0 / d_model)).to(dtype),
        "w_out": (normal(n_experts, d_ff, d_model)
                  * math.sqrt(1.0 / d_ff)).to(dtype),
    }


def moe_specs() -> Params:
    return {"gate": P(), "w_in": P(AXIS_EP, None, None),
            "w_out": P(AXIS_EP, None, None)}


def shard_experts(params: Params, mesh: Mesh) -> Params:
    """This rank's shard: the gate whole, its ``E / ep`` experts."""
    return shard_by_specs(params, mesh, moe_specs())


def route_topk(probs: torch.Tensor, k: int, renormalize: bool):
    """The shared GShard routing step both MoE forms build on (this
    module's all-to-all dispatch and ``models.llama._moe_ffn``'s einsum
    dispatch — one definition so dispatch priority and the renormalization
    guard cannot drift apart): top-k selection, optional weight
    renormalization over the chosen k (1e-9 guard), CHOICE-MAJOR flatten —
    all primary routes before any secondary route, so they win the
    capacity queue — and each routed unit's exclusive-cumsum position in
    its expert's queue.

    ``probs``: (..., T, E) gate probabilities (leading axes: independent
    routing groups).  Returns ``(expert_f, weight_f, onehot, pos_excl)``,
    each leading (after the group axes) with k*T in choice-major order;
    ``pos_excl[u, e]`` counts earlier units routed to expert e (meaningful
    where ``onehot[u, e] == 1``)."""
    T, E = probs.shape[-2:]
    lead = probs.shape[:-2]
    weight, expert = torch.topk(probs, k, dim=-1)                # (..., T, k)
    if renormalize:
        weight = weight / torch.clamp(weight.sum(dim=-1, keepdim=True),
                                      min=1e-9)
    expert_f = expert.transpose(-1, -2).reshape(*lead, k * T)
    weight_f = weight.transpose(-1, -2).reshape(*lead, k * T)
    onehot = F.one_hot(expert_f, E).to(torch.int32)              # (..., kT, E)
    pos_excl = torch.cumsum(onehot, dim=-2, dtype=torch.int32) - onehot
    return expert_f, weight_f, onehot, pos_excl


def _moe_body(x, gate_w, w_in, w_out, *, n_experts: int, capacity: int,
              axis: str, k: int, renormalize: bool, mesh: Optional[Mesh]):
    """Per-rank body.  x: (T_local, D); w_in/w_out: (E_local, D, F) /
    (E_local, F, D).

    Top-``k`` routing: each token dispatches to its k highest-gate experts
    (k=1 = switch-style with the raw gate prob as weight; k>1 = GShard-style
    with weights renormalized over the chosen k).  Every (token, choice)
    pair is an independent routed unit sharing the per-expert capacity
    budget; a token whose every choice is dropped passes through
    unchanged."""
    T, D = x.shape
    E_local = w_in.shape[0]
    p = innerjit.axis_size(axis, mesh)

    # --- route: the shared top-k / choice-major / capacity-queue step ---
    logits = x.float() @ gate_w.float()                           # (T, E)
    probs = torch.softmax(logits, dim=-1)
    expert, weight, onehot, pos_excl = route_topk(probs, k, renormalize)
    xu = x.repeat(k, 1)                                           # (k*T, D)

    # --- bucket units per expert with fixed capacity ---
    pos = torch.gather(pos_excl, 1, expert[:, None])[:, 0]
    keep = pos < capacity
    # slot buffers: (E, C, D); dropped units add zeros to slot 0.
    slot_idx = expert * capacity + torch.where(keep, pos, 0)
    src = torch.where(keep[:, None], xu, torch.zeros_like(xu))
    buckets = torch.zeros((n_experts * capacity, D), dtype=x.dtype,
                          device=x.device).index_add(0, slot_idx, src)

    # --- all_to_all: rank j gets, from every source rank i, the buckets
    # destined for j's local experts.  Leading axis E = p * E_local in
    # global-expert order; the tiled exchange splits it and stacks the
    # received pieces in source order: recv[i] = rank i's buckets for my
    # experts.
    buckets = buckets.reshape(p, E_local * capacity, D)
    recv = innerjit.alltoall(buckets, axis, split_axis=0, concat_axis=0,
                             mesh=mesh)
    recv = recv.reshape(p, E_local, capacity, D)
    recv = recv.movedim(0, 1).reshape(E_local, p * capacity, D)

    # --- expert compute: batched GEMM over local experts (JAX's gelu is
    # the tanh approximation) ---
    h = F.gelu(torch.einsum("ecd,edf->ecf", recv, w_in), approximate="tanh")
    out = torch.einsum("ecf,efd->ecd", h, w_out)         # (E_local, pC, D)

    # --- inverse all_to_all: return outputs to token-home ranks ---
    out = out.reshape(E_local, p, capacity, D)
    out = out.movedim(1, 0).reshape(p, E_local * capacity, D)
    back = innerjit.alltoall(out, axis, split_axis=0, concat_axis=0,
                             mesh=mesh)
    back = back.reshape(n_experts * capacity, D)

    # --- un-bucket: gather each unit's slot, combine weighted choices ---
    yu = back[slot_idx]                                           # (k*T, D)
    yu = torch.where(keep[:, None], yu * weight[:, None].to(yu.dtype),
                     torch.zeros_like(yu))
    y = yu.reshape(k, T, D).sum(dim=0)
    any_kept = keep.reshape(k, T).any(dim=0)
    return torch.where(any_kept[:, None], y, x)


def make_moe_layer(mesh: Mesh, n_experts: int, capacity: int,
                   axis: str = AXIS_EP, k: int = 1,
                   renormalize: Optional[bool] = None):
    """MoE layer over ``mesh``: ``fn(params, x)`` with this rank's
    :func:`shard_experts` shard and this rank's token shard x (T_local, D)
    (token-parallel in, token-parallel out).

    ``n_experts`` must be divisible by the ep axis size; ``capacity`` is the
    per-(rank, expert) routed-unit budget; ``k`` experts per token (top-1
    switch by default, top-2 GShard with ``renormalize`` defaulting to True
    for k > 1, raw-prob weighting for k = 1)."""
    ep = mesh.shape[axis]
    if n_experts % ep != 0:
        raise ValueError(f"n_experts {n_experts} not divisible by ep={ep}")
    if capacity < 1:
        raise ValueError("capacity must be >= 1")
    if not 1 <= k <= n_experts:
        raise ValueError(f"k must be in [1, {n_experts}], got {k}")
    if renormalize is None:
        renormalize = k > 1

    def fn(params: Params, x: torch.Tensor) -> torch.Tensor:
        return _moe_body(x, params["gate"], params["w_in"], params["w_out"],
                         n_experts=n_experts, capacity=capacity, axis=axis,
                         k=k, renormalize=renormalize, mesh=mesh)

    return fn
