"""Utilities of the port: tree flattening in JAX order (``tree``), meters
(``meters``), MNIST, real and synthetic, and the sharded batch iterator
(``data``), the rank-prefixed logger (``logging``) and checkpoints on the
JAX package's disk layout (``checkpoint``)."""

from . import checkpoint, data, logging, meters, tree  # noqa: F401
