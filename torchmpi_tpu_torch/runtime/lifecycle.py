"""Start and stop the port's runtime: one process per rank over
``torch.distributed``.

Counterpart of ``torchmpi_tpu/runtime/lifecycle.py``.  :func:`start` joins
(or adopts) the default process group from the usual environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``, as ``torchrun`` sets them; a process with
none of them is a world of one), binds the device and pushes the world
communicator.

The device is ``cuda:LOCAL_RANK % device_count``.  Without a GPU,
:func:`start` raises unless the caller asks for the CPU with
``device="cpu"``.  The backend is NCCL only when every rank of the host has
a card of its own; ranks that share a card (NCCL refuses two ranks on one
device) and CPU worlds use gloo.  The port's ring collectives do not go
through the backend at all: it carries the setup exchange, the small
messages and the scalar collectives.

After the world communicator, :func:`start` splits the world by host
(``_init_per_node_communicators``, the JAX package's): the hostnames are
gathered over the world group, and on more than one host a level keyed by
hostname is pushed and the collective span widened over both levels.  On
one machine nothing is pushed.
"""

from __future__ import annotations

import os
import socket
import threading
from typing import Optional, Tuple, Union

import torch

from . import communicator as _comm_mod
from .communicator import Communicator, stack

_lock = threading.Lock()
_started = False
_owns_group = False
_device: Optional[torch.device] = None
_hostname: Optional[str] = None
_hostnames: Optional[Tuple[str, ...]] = None
_need_inter_node = False


def started() -> bool:
    return _started


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    return default if raw in (None, "") else int(raw)


def choose_backend(device: torch.device, local_world: int) -> str:
    """NCCL when every rank of the host has a CUDA card of its own, else
    gloo."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def hostname() -> str:
    """This host's name, read once."""
    global _hostname
    if _hostname is None:
        _hostname = socket.gethostname()
    return _hostname


def hostnames() -> Optional[Tuple[str, ...]]:
    """Every world rank's hostname, gathered by :func:`start` (``None``
    before it)."""
    return _hostnames


def start(device: Union[str, torch.device, None] = None) -> torch.device:
    """Join the process group, bind this rank's device, push the world
    communicator and split it by host; returns the device.
    ``device="cpu"`` runs on the CPU (gloo); otherwise a GPU is required.
    The split mode is read from the ``use_tree_communicators`` and
    ``use_cartesian_communicators`` knobs."""
    global _started, _owns_group, _device, _hostnames
    import torch.distributed as dist

    with _lock:
        if _started:
            raise RuntimeError("start() called twice without stop()")
        if device is not None and torch.device(device).type == "cpu":
            dev = torch.device("cpu")
        else:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device is available; pass "
                                   "device='cpu' to run on the CPU")
            dev = (torch.device(device) if device is not None else
                   torch.device("cuda", _env_int("LOCAL_RANK", 0)
                                % torch.cuda.device_count()))
            torch.cuda.set_device(dev)
        world = _env_int("WORLD_SIZE", 1)
        if not dist.is_initialized():
            be = choose_backend(dev, _env_int("LOCAL_WORLD_SIZE", world))
            if "MASTER_ADDR" in os.environ:
                dist.init_process_group(be, init_method="env://",
                                        rank=_env_int("RANK", 0),
                                        world_size=world)
            else:
                if world != 1:
                    raise RuntimeError(f"WORLD_SIZE={world} without "
                                       f"MASTER_ADDR/MASTER_PORT")
                dist.init_process_group(be, store=dist.HashStore(), rank=0,
                                        world_size=1)
            _owns_group = True
        world_comm = Communicator(range(dist.get_world_size()),
                                  my_rank=dist.get_rank())
        stack.reset(world_comm)
        names = [None] * world_comm.size
        dist.all_gather_object(names, hostname())
        _hostnames = tuple(names)
        _init_per_node_communicators(world_comm)
        from ..collectives import selector

        selector.configure()
        _started = True
        _device = dev
        return dev


def _init_per_node_communicators(world: Communicator) -> None:
    """Split the world by host into two levels and widen the collective
    span over both, so hierarchical collectives run within each host, then
    across hosts.  On one host nothing is pushed."""
    global _need_inter_node
    if world.num_nodes() <= 1:
        _need_inter_node = False
        return
    level = stack.push([_hostnames[r] for r in world.ranks],
                       name=f"host({hostname()})")
    stack.set_collective_span(0, level + 1)
    _need_inter_node = stack.at(level).num_groups > 1


def need_inter_node_collectives() -> bool:
    """Whether a communicator level crosses hosts."""
    return _need_inter_node


def communicator_names() -> str:
    """The communicator stack, one level a line."""
    return stack.names()


def stop() -> None:
    """Free the ring collectives' staging memory, drop the communicator
    stack and leave the process group if :func:`start` joined it."""
    global _started, _owns_group, _device, _hostnames, _need_inter_node
    import torch.distributed as dist

    from ..collectives import cuda_ring

    with _lock:
        if not _started:
            return
        cuda_ring.release_all()
        stack.clear()
        _comm_mod.clear_groups()
        _hostnames = None
        _need_inter_node = False
        if _owns_group and dist.is_initialized():
            dist.destroy_process_group()
        _owns_group = False
        _started = False
        _device = None


def device() -> torch.device:
    """The device :func:`start` bound this rank to."""
    if _device is None:
        raise RuntimeError("the runtime is not started; call start() first")
    return _device


def rank() -> int:
    """This process's rank in the world."""
    return stack.world().rank


def size() -> int:
    """The world's size in ranks, one process each.  (The JAX package's
    ``size()`` counts devices, which one controller process drives many
    of; here a rank is a process with one device, so the two counts are
    one.)"""
    return stack.world().size


def process_rank() -> int:
    """This process's index in the world: :func:`rank`, since every rank
    is a process of its own."""
    return rank()


def process_count() -> int:
    """The number of processes in the world: :func:`size`."""
    return size()


def barrier() -> None:
    """Barrier over the current communicator."""
    from ..collectives import eager

    eager.barrier(_comm_mod.stack.current())
