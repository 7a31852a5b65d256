"""The data-parallel training engine (``sgdengine``)."""

from .sgdengine import AllReduceSGDEngine, sgd_update  # noqa: F401
