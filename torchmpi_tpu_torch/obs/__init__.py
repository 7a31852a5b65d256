"""Observability of the port: span tracer (``tracer``), event journal
(``journal``), the native trace rings (``native``), the flight recorder
(``flight``), the metrics registry (``metrics``), the live endpoint and
health state machine (``serve``), trace export (``export``), clock
alignment (``clocksync``), obsdumps and the straggler detector
(``aggregate``), the metrics history (``history``) and the alert plane
(``alerts``)."""

from . import journal, metrics, tracer  # noqa: F401
from .metrics import registry  # noqa: F401
