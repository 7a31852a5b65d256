"""The data-parallel training engine (``sgdengine``)."""

from .sgdengine import AllReduceSGDEngine, sample_array, sgd_update  # noqa: F401
