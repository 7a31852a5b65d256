"""Shared model helpers: device resolution, init primitives, parameter
counting."""

from __future__ import annotations

import math
from typing import Any, Optional, Union

import torch

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
              device: torch.device) -> torch.Generator:
    """``rng`` as a ``torch.Generator`` on ``device``: an int seeds a new
    one; a generator must already live on the device's type."""
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


def num_params(params: Any) -> int:
    """Total element count of a (nested dict) parameter tree."""
    if isinstance(params, dict):
        return sum(num_params(v) for v in params.values())
    return int(params.numel())


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
