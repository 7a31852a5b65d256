"""The port's native host plane: its copies of the JAX package's C++
sources and the helper that compiles them (``build.py``)."""
