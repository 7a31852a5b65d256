"""f32 tensors as bf16 hi + lo pairs: the form in which the tensor-core
kernels take f32 inputs.

``hi = bf16(x)`` and ``lo = bf16(x - hi)`` (round to nearest even both
times; ``x - hi`` is exact in f32), stored as one ``(2, *x.shape)`` bf16
buffer, hi first.  The flash forward (B4), the flash backward (B5, B6) and
the 3x3 convolution (B7) form each f32 product from these as three bf16
products (``A_hi B_hi + A_hi B_lo + A_lo B_hi``); ``csrc/bf16_split.cuh``
says why that form.

* The kernel (``tmpi_bf16_split`` in ``csrc/bf16_split.cuh``, which the
  flash forward's and backward's and the convolution's sources include, so
  each library exports it) splits up to four tensors in one launch.
* :func:`bf16_split_plain` is the same arithmetic in torch ops.

A CPU tensor takes the plain version; a CUDA tensor goes to the kernel or
raises, never falling back.
"""

from __future__ import annotations

import ctypes

import torch

MAX_OPERANDS = 4

# Launches of the split kernel in this process (the plain version does not
# count); chip_smoke.py reads it.
bf16_split_launches = 0


def bf16_split_plain(x: torch.Tensor) -> torch.Tensor:
    """The reference: ``(2, *x.shape)`` bf16, ``bf16(x)`` then
    ``bf16(x - bf16(x))``."""
    hi = x.to(torch.bfloat16)
    return torch.stack((hi, (x - hi.float()).to(torch.bfloat16)))


def _check_kernel_inputs(xs) -> None:
    if not 1 <= len(xs) <= MAX_OPERANDS:
        raise ValueError(f"the split kernel takes 1 to {MAX_OPERANDS} "
                         f"tensors, got {len(xs)}")
    for x in xs:
        if x.device.type != "cuda" or x.device != xs[0].device:
            raise ValueError(f"the split kernel takes tensors on one CUDA "
                             f"device, got {[str(t.device) for t in xs]}")
        if x.dtype != torch.float32 or not x.is_contiguous() \
                or x.numel() == 0:
            raise ValueError(f"the split kernel takes non-empty contiguous "
                             f"float32 tensors, got {x.dtype} "
                             f"{tuple(x.shape)}")


def _split_kernel(library: str, xs):
    """One launch of ``tmpi_bf16_split`` from kernel library ``library`` on
    the current stream of the tensors' device."""
    global bf16_split_launches
    from .. import _build

    _check_kernel_inputs(xs)
    outs = [torch.empty((2, *x.shape), dtype=torch.bfloat16, device=x.device)
            for x in xs]
    fn = _build.load(library).tmpi_bf16_split
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong] * MAX_OPERANDS + [ctypes.c_int,
                                                        ctypes.c_void_p]
    args = []
    for j in range(MAX_OPERANDS):
        if j < len(xs):
            args += [xs[j].data_ptr(), outs[j].data_ptr(), xs[j].numel()]
        else:
            args += [None, None, 0]
    with torch.cuda.device(xs[0].device):
        stream = torch.cuda.current_stream(xs[0].device).cuda_stream
        err = fn(*args, len(xs), stream)
    if err != 0:
        raise RuntimeError(f"tmpi_bf16_split launch failed: CUDA error {err}")
    bf16_split_launches += 1
    return outs


def bf16_split(library: str, *xs: torch.Tensor):
    """Each of ``xs`` (f32) as its ``(2, *x.shape)`` bf16 hi + lo buffer.
    CUDA tensors: one launch of the split kernel that ``library`` (the
    kernel source that consumes the buffers) exports, for all of them."""
    if all(x.device.type == "cpu" for x in xs):
        return [bf16_split_plain(x) for x in xs]
    return _split_kernel(library, xs)
