"""Models of the port: dense Llama (``llama``), ResNet (``resnet``) and the
MNIST MLP and convnet (``mlp``, ``cnn``)."""

from . import cnn, llama, mlp, resnet  # noqa: F401
