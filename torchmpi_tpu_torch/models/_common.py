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
