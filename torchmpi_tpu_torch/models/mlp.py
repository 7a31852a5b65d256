"""MNIST MLP — the reference's smallest end-to-end model (its MNIST
example's 'mlp' network).

Counterpart of ``torchmpi_tpu/models/mlp.py``: plain functions on a dict of
tensors ``{"w0", "b0", "w1", ...}``.  The weights keep the JAX ``(in,
out)`` layout, so :func:`from_jax_params` copies and a checkpoint of either
package restores in the other.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ._common import DeviceLike, generator, resolve_device

Params = Dict[str, Any]


def init(rng: Union[int, torch.Generator], in_dim: int = 784,
         hidden: Sequence[int] = (1024, 1024), n_classes: int = 10,
         dtype=torch.float32, device: DeviceLike = None) -> Params:
    """Weights ``(d_in, d_out)`` drawn N(0, 2 / d_in), biases zero, from a
    seed or ``torch.Generator`` (the draws differ from JAX's: compare
    through :func:`from_jax_params`)."""
    dev = resolve_device(device)
    gen = generator(rng, dev)
    dims = [in_dim, *hidden, n_classes]
    params: Params = {}
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                        device=dev)
        params[f"w{i}"] = (w * math.sqrt(2.0 / d_in)).to(dtype)
        params[f"b{i}"] = torch.zeros((d_out,), dtype=dtype, device=dev)
    return params


def from_jax_params(params: Params, device: DeviceLike = None) -> Params:
    """A JAX parameter tree (numpy or jax arrays, f32) as tensors on
    ``device``, leaf for leaf in the same layout."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v)).to(dev)
            for k, v in params.items()}


def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Forward: flatten, then (Linear, ReLU)*, then Linear logits."""
    n_layers = len(params) // 2
    h = x.reshape(x.shape[0], -1)
    for i in range(n_layers):
        h = h @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            h = F.relu(h)
    return h


def _nll(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(1, y.long()[:, None]).mean()


def loss_fn(params: Params, batch: Tuple[torch.Tensor, torch.Tensor]
            ) -> torch.Tensor:
    """Mean softmax cross-entropy."""
    x, y = batch
    return _nll(apply(params, x), y)


def accuracy(params: Params, batch: Tuple[torch.Tensor, torch.Tensor]
             ) -> torch.Tensor:
    x, y = batch
    return (apply(params, x).argmax(-1) == y).float().mean()
