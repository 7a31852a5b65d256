"""Collectives of the port: ``eager`` (over ``torch.distributed``), the ring
kernels (``cuda_ring``) and the ``selector`` between them."""

from . import cuda_ring, eager, selector  # noqa: F401
