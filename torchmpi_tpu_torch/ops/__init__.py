"""Kernels of the port with their plain PyTorch versions."""

from .conv3x3 import conv3x3, conv3x3_plain  # noqa: F401
from .flash_attention import flash_attention, flash_bwd_block, \
    flash_fwd_block  # noqa: F401
