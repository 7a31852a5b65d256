"""MNIST convnet — the reference's 'cnn' network: two convolution and pool
blocks, then an MLP head.

Counterpart of ``torchmpi_tpu/models/cnn.py``, with :mod:`.mlp`'s contract.
The parameters keep the JAX layouts: HWIO convolution weights and a ``w3``
of ``(7*7*2*width, hidden)`` over an **NHWC** flatten of the last pool, so
:func:`from_jax_params` copies and a checkpoint of either package restores
in the other.  The convolutions are ``F.conv2d`` (cuDNN on the card), as in
JAX they are ``lax.conv_general_dilated``, not a hand-written kernel.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple, Union

import torch
import torch.nn.functional as F

from ._common import DeviceLike, generator, resolve_device
from .mlp import _nll, from_jax_params  # noqa: F401

Params = Dict[str, Any]


def init(rng: Union[int, torch.Generator], image: int = 28,
         channels: int = 1, n_classes: int = 10, width: int = 32,
         hidden: int = 256, dtype=torch.float32,
         device: DeviceLike = None) -> Params:
    """He-scaled convolutions and ``w3``, ``w4`` scaled by sqrt(1 /
    hidden), biases zero (the draws differ from JAX's: compare through
    :func:`from_jax_params`)."""
    dev = resolve_device(device)
    gen = generator(rng, dev)

    def normal(shape, fan_in, gain=2.0):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
        return (w * math.sqrt(gain / fan_in)).to(dtype)

    flat = (image // 4) * (image // 4) * width * 2
    zeros = lambda n: torch.zeros((n,), dtype=dtype, device=dev)  # noqa: E731
    return {
        "conv1": normal((5, 5, channels, width), 25 * channels),
        "b1": zeros(width),
        "conv2": normal((5, 5, width, width * 2), 25 * width),
        "b2": zeros(width * 2),
        "w3": normal((flat, hidden), flat), "b3": zeros(hidden),
        "w4": normal((hidden, n_classes), hidden, gain=1.0),
        "b4": zeros(n_classes),
    }


def _conv_relu_pool(h: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """5x5 SAME convolution (NCHW activations, HWIO weight), bias, ReLU,
    2x2/2 max pool (VALID)."""
    h = F.conv2d(h, w.permute(3, 2, 0, 1), padding=2)
    return F.max_pool2d(F.relu(h + b[:, None, None]), 2, 2)


def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W) or (B, H, W, C), NHWC -> logits (B, n_classes)."""
    if x.ndim == 3:
        x = x[..., None]
    h = _conv_relu_pool(x.permute(0, 3, 1, 2), params["conv1"], params["b1"])
    h = _conv_relu_pool(h, params["conv2"], params["b2"])
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # NHWC flatten
    h = F.relu(h @ params["w3"] + params["b3"])
    return h @ params["w4"] + params["b4"]


def loss_fn(params: Params, batch: Tuple[torch.Tensor, torch.Tensor]
            ) -> torch.Tensor:
    """Mean softmax cross-entropy."""
    x, y = batch
    return _nll(apply(params, x), y)


def accuracy(params: Params, batch: Tuple[torch.Tensor, torch.Tensor]
             ) -> torch.Tensor:
    x, y = batch
    return (apply(params, x).argmax(-1) == y).float().mean()
