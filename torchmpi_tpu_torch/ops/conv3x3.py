"""3x3 stride-1 "same" convolution: a hand-written CUDA kernel and its plain
version.

Counterpart of ``benchmarks/pallas_conv_bench.py``'s ``pallas_conv3x3``
(kernel ``_conv_kernel``): x ``(N, H, W, C)`` NHWC, w ``(3, 3, C, Cout)``
HWIO, out ``(N, H, W, Cout)`` in x's dtype, computed as nine shifted-window
``(N*H*W, C) @ (C, Cout)`` products with both operands widened to f32, an
f32 sum and one cast on store.

* The kernel (``csrc/conv3x3.cu``, ``tmpi_conv3x3``) is an implicit GEMM
  that reads the one-pixel halo as zeros itself, so nothing is padded
  before it and no patch matrix reaches device memory, on the tensor cores
  (wgmma, cp.async staging; helpers in ``csrc/hopper.cuh``): bf16 in one
  product, f32, split into bf16 hi + lo parts by one launch of
  :mod:`.bf16_split` for x and w, in three bf16 products (an f32 output).
  It takes any C and Cout and tiles its own way;
  ``bn`` and ``bc`` keep the JAX function's contract (they must divide N
  and Cout) and nothing else.
* :func:`conv3x3_plain` is the same algebra in torch ops: pad, nine f32
  products, cast.

A CPU tensor takes the plain version; a CUDA tensor goes to the kernel or
raises, never falling back.  The op is forward-only, as the TPU kernel is:
asking it for a gradient raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .bf16_split import bf16_split

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the CUDA kernel in this process (the plain version does not
# count); chip_smoke.py reads it.
conv3x3_launches = 0


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The reference: pad by one pixel, nine ``(N*H*W, C) @ (C, Cout)``
    products in f32, cast to x's dtype."""
    N, H, W, C = x.shape
    cout = w.shape[-1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    wf = w.reshape(9, C, cout).float()
    acc = torch.zeros((N * H * W, cout), dtype=torch.float32, device=x.device)
    for di in range(3):
        for dj in range(3):
            win = xp[:, di:di + H, dj:dj + W, :].reshape(N * H * W, C)
            acc += win.float() @ wf[di * 3 + dj]
    return acc.reshape(N, H, W, cout).to(x.dtype)


def _check_kernel_inputs(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"the conv3x3 kernel takes x and w on one CUDA "
                         f"device, got {x.device} and {w.device}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"the conv3x3 kernel takes float32 or bfloat16 x and "
                        f"w of one dtype, got {x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous (NHWC and HWIO)")


def _conv3x3_kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``tmpi_conv3x3`` on the current stream of x's device; f32 x and w
    go to it as their bf16 hi + lo split, made by one launch of the split
    kernel for both."""
    global conv3x3_launches
    from .. import _build

    _check_kernel_inputs(x, w)
    N, H, W, C = x.shape
    cout = w.shape[-1]
    out = torch.empty((N, H, W, cout), dtype=x.dtype, device=x.device)
    xk, wk = bf16_split("conv3x3", x, w) if x.dtype == torch.float32 \
        else (x, w)
    fn = _build.load("conv3x3").tmpi_conv3x3
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(xk.data_ptr(), wk.data_ptr(), out.data_ptr(), N, H, W, C,
                 cout, _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"tmpi_conv3x3 launch failed: CUDA error {err}")
    conv3x3_launches += 1
    return out


def conv3x3(x: torch.Tensor, w: torch.Tensor, bn: int = 8,
            bc: int = 256) -> torch.Tensor:
    """x ``(N, H, W, C)``, w ``(3, 3, C, Cout)`` -> ``(N, H, W, Cout)``; 3x3
    stride 1, "same" padding.  ``bn`` must divide N and ``bc`` Cout, as in
    the JAX function.  Not differentiable."""
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3,
                                                              x.shape[3]):
        raise ValueError(f"x must be (N, H, W, C) and w (3, 3, C, Cout), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    N, cout = x.shape[0], w.shape[-1]
    if N % bn or cout % bc:
        raise ValueError(f"bn={bn} must divide N={N}, bc={bc} Cout={cout}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("conv3x3 is forward-only, like the TPU kernel it "
                           "ports; call it under torch.no_grad()")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv3x3_plain(x, w)
    return _conv3x3_kernel(x, w)
