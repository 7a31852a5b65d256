"""Utilities of the port: tree flattening in JAX order, meters, synthetic
data."""

from . import data, meters, tree  # noqa: F401
