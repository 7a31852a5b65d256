"""Observability of the port: span tracer and event journal."""

from . import journal, tracer  # noqa: F401
