"""Runtime of the port: the knob registry (``config``)."""

from . import config  # noqa: F401
