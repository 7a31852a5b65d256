"""Models of the port: dense Llama (``llama``) and ResNet (``resnet``)."""

from . import llama, resnet  # noqa: F401
