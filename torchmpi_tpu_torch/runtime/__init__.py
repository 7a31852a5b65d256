"""Runtime of the port: the knob registry (``config``), communicators and
the process lifecycle."""

from . import communicator, config, lifecycle  # noqa: F401
