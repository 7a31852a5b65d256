"""Models of the port: dense Llama (``llama``), ResNet (``resnet``), the
Vision Transformer (``vit``) and the MNIST MLP and convnet (``mlp``,
``cnn``)."""

from . import cnn, llama, mlp, resnet, vit  # noqa: F401
