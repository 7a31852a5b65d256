"""Models of the port: dense Llama inference (``llama``)."""

from . import llama  # noqa: F401
