"""torchmpi_tpu_torch — the PyTorch and CUDA port of ``torchmpi_tpu``.

A package beside the JAX one, ported slice by slice; the JAX package stays
the reference each ported module is tested against.  Three slices are
ported: Llama inference and the serving engine, Llama training on one NVIDIA
GPU, and data-parallel ResNet training across processes:

- ``models.llama`` — dense Llama prefill, KV-cache decode and generation;
  the forward, loss and SGD training step;
- ``ops.flash_attention`` — flash attention and its backward, CUDA kernels
  for Hopper (``ops/csrc/flash_attention_{fwd,bwd}.cu``) with their plain
  PyTorch versions beside them;
- ``serving`` — the continuous-batching engine and its KV block pool;
- ``runtime.config``, ``obs.tracer``, ``obs.journal`` — the knobs, spans
  and journal those modules read;
- ``models.resnet``, ``engine`` (``AllReduceSGDEngine``), ``nn`` (parameter
  and gradient sync, bucketing), ``collectives`` (``eager`` over
  ``torch.distributed``, the ring kernels of ``cuda_ring``, the
  ``selector``), ``runtime.communicator`` and ``runtime.lifecycle`` (one
  process per rank), ``utils`` (tree order, meters, synthetic data);
- ``examples.train_llama`` and ``examples.train_resnet`` — the training
  entry points (``python -m torchmpi_tpu_torch.examples.train_resnet
  --nproc 2``).

Entry points run on the current CUDA device unless the caller passes
``device="cpu"``; the kernels build with ``nvcc`` at first use
(``_build.py``).  Nothing here imports JAX.
"""

__version__ = "0.1.0"

from . import (collectives, engine, models, nn, obs, ops,  # noqa: F401,E402
               runtime, serving, utils)
