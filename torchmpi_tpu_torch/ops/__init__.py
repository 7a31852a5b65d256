"""Kernels of the port with their plain PyTorch versions."""

from .flash_attention import flash_attention, flash_fwd_block  # noqa: F401
