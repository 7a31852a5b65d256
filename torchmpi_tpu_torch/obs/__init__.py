"""Observability of the port: span tracer, event journal, the native
trace rings (``native``) and the flight recorder (``flight``)."""

from . import journal, tracer  # noqa: F401
