"""One tile of the tensor-core flash-attention forward's two products, alone.

    from torchmpi_tpu_torch.tools.flash_tile_probe import tile_probe
    s, o = tile_probe(q, k, v)

``s = q @ k.T`` and ``o = s.bfloat16() @ v``, both f32 (64, 128), for bf16
q (64, 128), k and v (128, 128) on the card, through the same TMA maps,
swizzled layouts and wgmma calls as the forward kernel
(``tools/csrc/flash_tile_probe.cu`` compiles the forward's source into its
own library).  A wrong descriptor or swizzle then shows up on its own, not
as a plausible-looking attention error.  It is not a launch of the forward:
``flash_fwd_launches`` does not move.  Needs a GPU.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from ..ops.flash_attention import KERNEL_HEAD_DIM, _check_aligned

PROBE_SRC = Path(__file__).resolve().parent / "csrc"


def tile_probe(q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(s, o)`` of one 64 x 128 x 128 tile (see the module's text)."""
    from .. import _build

    shapes = {"q": (64, KERNEL_HEAD_DIM), "k": (128, KERNEL_HEAD_DIM),
              "v": (128, KERNEL_HEAD_DIM)}
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype != torch.bfloat16 \
                or tuple(t.shape) != shapes[name] or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous bf16 CUDA tensor "
                             f"of shape {shapes[name]}")
    _check_aligned(q=q, k=k, v=v)
    s = torch.empty((64, KERNEL_HEAD_DIM), dtype=torch.float32,
                    device=q.device)
    o = torch.empty_like(s)
    fn = _build.load("flash_tile_probe", PROBE_SRC).tmpi_flash_tile_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(t.data_ptr() for t in (q, k, v, s, o)), stream)
    if err != 0:
        raise RuntimeError(f"tmpi_flash_tile_probe launch failed: CUDA error "
                           f"{err}")
    return s, o
