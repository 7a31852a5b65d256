"""torchmpi_tpu_torch — the PyTorch and CUDA port of ``torchmpi_tpu``.

A package beside the JAX one, ported slice by slice; the JAX package stays
the reference each ported module is tested against.  Ported so far: Llama
inference and the serving engine, Llama training on one NVIDIA GPU, and
data-parallel training across processes (ResNet, and the MNIST MLP of the
reference's flagship example):

- ``models.llama`` — dense Llama prefill, KV-cache decode and generation;
  the forward, loss and SGD training step;
- ``ops.flash_attention`` — flash attention and its backward, CUDA kernels
  for Hopper (``ops/csrc/flash_attention_{fwd,bwd}.cu``) with their plain
  PyTorch versions beside them;
- ``serving`` — the continuous-batching engine and its KV block pool;
- ``runtime.config``, ``obs.tracer``, ``obs.journal`` — the knobs, spans
  and journal those modules read;
- ``models.resnet``, ``models.mlp``, ``models.cnn``, ``engine``
  (``AllReduceSGDEngine``), ``nn`` (parameter and gradient sync,
  bucketing), ``collectives`` (``eager`` over ``torch.distributed``, the
  ring kernels of ``cuda_ring``, the host plane's TCP rings of
  ``hostcomm``, the ``hierarchical`` composition, the ``selector``),
  ``runtime.communicator`` (the split levels and the cursor) and
  ``runtime.lifecycle`` (one process per rank);
- ``data`` — the input data plane: a host stage, a device stage that
  copies each batch through pinned memory on a side CUDA stream, and
  ``DataPipeline``, which the engine's compiled mode reads through;
- ``utils`` — tree order, meters, MNIST (real and synthetic), logging and
  checkpoints (the JAX package's on-disk layout);
- ``examples.train_llama``, ``examples.train_resnet`` and
  ``examples.mnist_allreduce`` — the training entry points
  (``python -m torchmpi_tpu_torch.examples.mnist_allreduce --nproc 2``).

The top level is the reference's ``mpi`` table, as in the JAX package::

    import torchmpi_tpu_torch as mpi
    mpi.start()                      # one process per rank
    x = mpi.allreduce(x)             # over the current communicator
    mpi.stop()

``rank()`` and ``size()`` count processes, one per rank.  The communicator
stack and its cursor are JAX's: ``push_communicator(keys)`` splits the
current level, ``set_communicator(level, type)`` and
``set_collective_span(begin, end)`` move the cursor every collective
resolves, and ``collective_availability()`` prints the selector's table.
The host plane is ``collectives.hostcomm`` (TCP rings over CPU tensors).

Entry points run on the current CUDA device unless the caller passes
``device="cpu"``; the kernels build with ``nvcc`` at first use
(``_build.py``).  Nothing here imports JAX.
"""

from .version import __version__  # noqa: F401

from . import (collectives, data, engine, models, nn, obs,  # noqa: F401,E402
               ops, parallel, runtime, serving, utils)
from .collectives import (  # noqa: F401,E402
    allgather,
    allgatherv,
    allreduce,
    allreduce_scalar,
    alltoall,
    async_,
    broadcast,
    broadcast_scalar,
    reduce,
    reduce_scalar,
    reduce_scatter,
    sendreceive,
    sendreceive_scalar,
)
from .runtime import config  # noqa: F401,E402
from .runtime.communicator import (Communicator,  # noqa: F401,E402
                                   CommunicatorGuard, CommunicatorType, stack)
from .runtime.handles import SynchronizationHandle, sync_all  # noqa: F401,E402
from .runtime.handles import wait as sync_handle  # noqa: F401,E402
from .runtime.handles import wait_all as sync_handles  # noqa: F401,E402
from .runtime.lifecycle import (  # noqa: F401,E402
    barrier,
    communicator_names,
    hostname,
    need_inter_node_collectives,
    process_count,
    process_rank,
    rank,
    size,
    start,
    started,
    stop,
)
from .collectives.selector import (  # noqa: F401,E402
    availability as collective_availability)


def push_communicator(keys, name=None):
    """Split the current communicator by per-rank key; returns the new
    level (reference: torchmpi_push_communicator)."""
    return stack.push(keys, name=name)


def set_communicator(level, type=CommunicatorType.INTRA):  # noqa: A002
    """Move the (level, intra/inter) cursor."""
    stack.set_communicator(level, type)


def set_collective_span(begin, end):
    """Bound hierarchical collectives to levels [begin, end)."""
    stack.set_collective_span(begin, end)


def num_nodes_in_communicator():
    """Distinct hosts in the current communicator."""
    return stack.current().num_nodes()
