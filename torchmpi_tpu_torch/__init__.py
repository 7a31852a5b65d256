"""torchmpi_tpu_torch — the PyTorch and CUDA port of ``torchmpi_tpu``.

A package beside the JAX one, ported slice by slice; the JAX package stays
the reference each ported module is tested against.  This slice carries
Llama inference and the serving engine on one NVIDIA GPU:

- ``models.llama`` — dense Llama prefill, KV-cache decode and generation;
- ``ops.flash_attention`` — the flash-attention forward, a CUDA kernel for
  Hopper (``ops/csrc/flash_attention_fwd.cu``) with its plain PyTorch
  version beside it;
- ``serving`` — the continuous-batching engine and its KV block pool;
- ``runtime.config``, ``obs.tracer``, ``obs.journal`` — the knobs, spans
  and journal those modules read.

Entry points run on the current CUDA device unless the caller passes
``device="cpu"``; the kernels build with ``nvcc`` at first use
(``_build.py``).  Nothing here imports JAX.
"""

__version__ = "0.1.0"

from . import models, obs, ops, runtime, serving  # noqa: F401,E402
