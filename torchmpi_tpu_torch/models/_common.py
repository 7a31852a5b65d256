"""Shared model helpers: device resolution, init primitives, parameter
counting, the per-layer remat policy, the stacked layers' views, the global
mean of a loss over ranks and placement by partition specs."""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Optional, Union

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    current CUDA device.  With no GPU and no explicit device this raises:
    the port never carries on quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def generator(rng: Union[int, torch.Generator],
              device: torch.device) -> Optional[torch.Generator]:
    """``rng`` as a ``torch.Generator`` on ``device``: an int seeds a new
    one; a generator must already live on the device's type.  On the
    ``meta`` device (shapes only, nothing drawn) there is none: None."""
    if device.type == "meta":
        return None
    if isinstance(rng, torch.Generator):
        if rng.device.type != device.type:
            raise ValueError(f"generator on {rng.device}, tensors on {device}")
        return rng
    return torch.Generator(device=device).manual_seed(int(rng))


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device: torch.device,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fan-in-scaled dense weight (1/sqrt(d_in)), drawn in f32, stored in
    ``dtype`` (into ``out`` when given)."""
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    w.mul_(math.sqrt(1.0 / d_in))
    if out is None:
        return w.to(dtype)
    out.copy_(w)
    return out


def stack_dense(gen: torch.Generator, n: int, d_in: int, d_out: int, dtype,
                device: torch.device) -> torch.Tensor:
    """(n, d_in, d_out) stack of independently initialized dense weights,
    filled slice by slice so the f32 draw never exists for all n at once."""
    out = torch.empty((n, d_in, d_out), dtype=dtype, device=device)
    for i in range(n):
        dense_init(gen, d_in, d_out, dtype, device, out=out[i])
    return out


def _to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    # np.array copies: the port writes caches in place, and a JAX array's
    # host view is read-only memory that must not be written.
    a = np.array(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes' bf16: carry the bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_jax_params(params: Any, device: DeviceLike = None) -> Any:
    """The JAX package's parameter tree (numpy or JAX array leaves) as the
    port's: the same tree, each leaf the same values, dtype and layout."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _to_tensor(node, dev)

    return conv(params)


def num_params(params: Any) -> int:
    """Total element count of a (nested dict) parameter tree."""
    if isinstance(params, dict):
        return sum(num_params(v) for v in params.values())
    return int(params.numel())


def layer_views(params: Any) -> list:
    """Every layer's weights as views of the stacked leaves of
    ``params["layers"]``, made by one ``torch.unbind`` per leaf.  Under
    autograd this matters: the backward of an unbind stacks the n layers'
    gradients once, where the backward of each ``leaf[i]`` would write a
    zero tensor the size of the whole stacked leaf and autograd would add n
    of them (O(n_layers²) bytes; about half of an 8B Llama training step on
    the card)."""
    names = list(params["layers"])
    per_leaf = [torch.unbind(params["layers"][k]) for k in names]
    return [dict(zip(names, views)) for views in zip(*per_leaf)]


def save_mm_outputs(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of ``aten.mm`` — every
    ``x @ w`` of the layer, which has no batch dimension, as JAX's
    ``dots_with_no_batch_dims_saveable`` keeps — and recompute everything
    else, ``bmm`` and every allocation included (a buffer that a kernel
    writes into must never be served from the cache on recompute)."""
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def wrap_remat(layer: Callable, remat: str) -> Callable:
    """THE remat taxonomy ('none'/'dots'/'full'), as in the JAX package.
    Under ``"dots"`` and ``"full"`` the layer's forward runs again during
    the backward, flash-attention kernel included."""
    if remat == "dots":
        ctx_fn = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                   save_mm_outputs)
        return lambda *a: ckpt.checkpoint(layer, *a, use_reentrant=False,
                                          context_fn=ctx_fn)
    if remat == "full":
        return lambda *a: ckpt.checkpoint(layer, *a, use_reentrant=False)
    if remat != "none":
        raise ValueError("remat must be 'none', 'dots', or 'full'")
    return layer


class GlobalMean(torch.autograd.Function):
    """The mean over ``comm``'s ranks of each rank's mean loss (the global
    mean: every rank holds as many examples); its gradient flows to this
    rank's own mean alone, and the mean of the ranks' gradients is the
    global one, which the caller forms."""

    @staticmethod
    def forward(ctx, x, comm):
        from ..collectives import eager

        return eager.allreduce(comm, x.reshape(1), op="mean").reshape(())

    @staticmethod
    def backward(ctx, g):
        return g, None


# ------------------------------------------------------------ mesh placement

class P(tuple):
    """A partition spec: one mesh axis name (or None, replicated) per
    dimension, as JAX's ``PartitionSpec(*entries)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


def mesh_spec(spec: P, mesh, shape=None) -> P:
    """THE axis-dropping rule, shared by every placement site: drop spec
    axes the mesh lacks; with ``shape`` also drop axes whose dimension the
    mesh axis size does not divide (e.g. a 10-class head over tp=4 stays
    replicated instead of erroring)."""
    sizes = dict(mesh.shape)

    def keep(i, ax):
        if ax not in sizes:
            return None
        if shape is not None and shape[i] % sizes[ax] != 0:
            return None
        return ax

    return P(*[keep(i, ax) for i, ax in enumerate(spec)])


def _spec_tree(params: Any, specs: Any, fn):
    if isinstance(params, dict):
        return {k: _spec_tree(params[k], specs[k], fn) for k in params}
    return fn(params, specs)


def shard_by_specs(params: Any, mesh, specs: Any) -> Any:
    """This rank's shard of each leaf of a full tree, per its spec under
    the shared :func:`mesh_spec` rule (shape-aware): the counterpart of
    placing the leaf with ``device_put``.  Each shard is a copy, so the
    full leaf can be freed."""

    def place(a: torch.Tensor, spec) -> torch.Tensor:
        spec = mesh_spec(spec, mesh, tuple(a.shape))
        for dim, ax in enumerate(spec):
            if ax is not None:
                n = a.shape[dim] // mesh.shape[ax]
                a = a.narrow(dim, mesh.coords[ax] * n, n)
        return a.clone()

    return _spec_tree(params, specs, place)


def gather_by_specs(params: Any, mesh, specs: Any,
                    full_shapes: Any) -> Any:
    """The inverse of :func:`shard_by_specs`: every leaf of this rank's
    shard tree gathered whole over the axes its spec shards it on
    (``full_shapes``: the whole tree's shapes, which decide the rule).
    Collective: every rank of the mesh calls it, in the same order."""
    from ..collectives import innerjit

    def gather(a: torch.Tensor, pair) -> torch.Tensor:
        spec, shape = pair
        spec = mesh_spec(spec, mesh, tuple(shape))
        with torch.no_grad():
            for dim, ax in enumerate(spec):
                if ax is not None:
                    a = innerjit.allgather(a, ax, concat_axis=dim, mesh=mesh)
        return a

    pairs = _spec_tree(specs, full_shapes, lambda s, sh: (s, sh)) \
        if isinstance(specs, dict) else (specs, full_shapes)
    return _spec_tree(params, pairs, gather)
