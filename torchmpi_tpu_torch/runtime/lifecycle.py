"""Start and stop the port's runtime: one process per rank over
``torch.distributed``.

Counterpart of ``torchmpi_tpu/runtime/lifecycle.py``.  :func:`start` joins
(or adopts) the default process group from the usual environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``/``MASTER_PORT``, as ``torchrun`` sets them; a process with
none of them is a world of one), binds the device and pushes the world
communicator.

A re-formed world (elastic recovery, a resize commit) is started with an
explicit ``rank``, ``world_size`` and ``init_method``: a fresh rendezvous
(``file://`` on a filesystem every member sees, or ``tcp://``) that names
no dead process's store.  ``stop(peers_lost=True)`` tears a world down
that lost a rank: the ring states are taken down locally
(``cuda_ring.release_local``), with no barrier that would wait on the
dead; the fresh world's start frees their blocks after its first
collective (the hostname exchange), when no survivor is left inside the
old world's calls.

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

The observability planes follow the runtime, as in JAX, each gated by
its knob and off by default: :func:`start` clears the drain flag, starts
the live endpoint (``obs/serve.maybe_start``, ``obs_http``), stamps the
journal's rank and starts the metrics-history sampler
(``obs/history.maybe_start``, ``history_enabled``, which arms the alert
plane); :func:`stop` sets the drain flag first, stops the sampler, writes
the shutdown obsdump (``obs_dump_dir``) and closes the endpoint last.
"""

from __future__ import annotations

import datetime
import gc
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
_rank = 0


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


def start(device: Union[str, torch.device, None] = None, *,
          rank: Optional[int] = None, world_size: Optional[int] = None,
          init_method: Optional[str] = None,
          timeout_s: Optional[float] = None) -> torch.device:
    """Join the process group, bind this rank's device, push the world
    communicator and split it by host; returns the device.
    ``device="cpu"`` runs on the CPU (gloo); otherwise a GPU is required.
    The split mode is read from the ``use_tree_communicators`` and
    ``use_cartesian_communicators`` knobs.

    ``rank``, ``world_size`` and ``init_method`` (all three together)
    join a fresh world instead of the environment's: the re-form of an
    elastic recovery or of a resize commit.  ``timeout_s`` bounds every
    operation of the new group (a wait on a lost peer then raises instead
    of hanging for the backend's default half hour)."""
    global _started, _owns_group, _device, _hostnames, _rank
    import torch.distributed as dist

    explicit = (rank, world_size, init_method)
    if any(v is not None for v in explicit) and None in explicit:
        raise ValueError("rank, world_size and init_method go together")
    kw = ({} if timeout_s is None
          else {"timeout": datetime.timedelta(seconds=timeout_s)})

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
        world = _env_int("WORLD_SIZE", 1) if world_size is None \
            else world_size
        if init_method is not None and dist.is_initialized():
            raise RuntimeError("a fresh world needs the old one torn down "
                               "first (stop())")
        if not dist.is_initialized():
            # The ranks of this host share its cards as at the first
            # start, a re-form included: a shared card is gloo.
            be = choose_backend(dev, _env_int("LOCAL_WORLD_SIZE", world))
            if init_method is not None:
                dist.init_process_group(be, init_method=init_method,
                                        rank=rank, world_size=world, **kw)
            elif "MASTER_ADDR" in os.environ:
                dist.init_process_group(be, init_method="env://",
                                        rank=_env_int("RANK", 0),
                                        world_size=world, **kw)
            else:
                if world != 1:
                    raise RuntimeError(f"WORLD_SIZE={world} without "
                                       f"MASTER_ADDR/MASTER_PORT")
                dist.init_process_group(be, store=dist.HashStore(), rank=0,
                                        world_size=1, **kw)
            _owns_group = True
        world_comm = Communicator(range(dist.get_world_size()),
                                  my_rank=dist.get_rank())
        stack.reset(world_comm)
        names = [None] * world_comm.size
        dist.all_gather_object(names, hostname())
        _hostnames = tuple(names)
        # Every member has reached this start, so no survivor of an old
        # world is still inside its calls: free the ring blocks that
        # stop(peers_lost=True) kept for them.
        from ..collectives import cuda_ring

        cuda_ring.free_retired()
        _init_per_node_communicators(world_comm)
        from ..collectives import selector

        selector.configure()
        _started = True
        _device = dev
        _rank = world_comm.rank
    _start_obs(_rank)
    return dev


def _start_obs(rank: int) -> None:
    """The live endpoint and the history sampler, each knob-gated (off =
    one config read).  A fresh world is not draining, whatever an earlier
    stop() left behind."""
    from ..obs import history as _obs_history
    from ..obs import journal as _obs_journal
    from ..obs import serve as _obs_serve

    _obs_serve.health.set_draining(False)
    _obs_serve.maybe_start(rank=rank)
    _obs_journal.set_rank(rank)
    _obs_history.maybe_start(rank=rank)


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


def stop(peers_lost: bool = False) -> None:
    """Free the ring collectives' staging memory, tear down the
    parameter-server client (when this process used one), drop the
    communicator stack and leave the process group if :func:`start`
    joined it.

    The ring states are freed together with every rank (a collective over
    the world) unless ``peers_lost``: a world that lost a rank frees them
    locally, meeting no peer."""
    global _started, _owns_group, _device, _hostnames, _need_inter_node
    import sys

    import torch.distributed as dist

    from ..collectives import cuda_ring

    with _lock:
        if not _started:
            return
        # /healthz reads "leaving on purpose", not "wedged", for the
        # duration of the teardown.
        from ..obs import serve as _obs_serve

        _obs_serve.health.set_draining(True)
        if peers_lost:
            cuda_ring.release_local()
        else:
            cuda_ring.release_all()
        ps = sys.modules.get("torchmpi_tpu_torch.parameterserver")
        if ps is not None:
            ps.shutdown()
        stack.clear()
        _comm_mod.clear_groups()
        _hostnames = None
        _need_inter_node = False
        if _owns_group and dist.is_initialized():
            dist.destroy_process_group()
            if peers_lost:
                # The group closes its connections when its last reference
                # goes: the survivors still blocked on this rank then fail
                # at once instead of at the backend's timeout.
                gc.collect()
        _owns_group = False
        _started = False
        _device = None
    _stop_obs()


def _stop_obs() -> None:
    """The history sampler stops first (its final persist covers the
    teardown), then the shutdown obsdump, then the endpoint, last, so a
    poller can watch the teardown.  Best-effort: a failed dump must not
    turn a clean stop into a crash."""
    from ..obs import aggregate as _obs_aggregate
    from ..obs import history as _obs_history
    from ..obs import native as _obs_native
    from ..obs import serve as _obs_serve

    try:
        _obs_history.stop()
    except Exception:  # noqa: BLE001
        pass
    dump_dir = _obs_native.cluster_config()["dump_dir"]
    if dump_dir:
        try:
            _obs_aggregate.write_obsdump(dump_dir, rank=_rank)
        except Exception:  # noqa: BLE001
            from ..utils.logging import get_logger

            get_logger("torchmpi_tpu_torch.lifecycle").exception(
                "shutdown obsdump to %s failed (suppressed)", dump_dir)
    try:
        _obs_serve.stop()
    except Exception:  # noqa: BLE001
        pass


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
