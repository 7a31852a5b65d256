"""Named parallelism meshes: dp / pp / ep / sp / tp axes over the ranks.

Counterpart of ``torchmpi_tpu/parallel/mesh.py``.  There a mesh is a
``jax.sharding.Mesh`` of devices under one controller; here it lays the
ranks of a communicator (one process each) out on the named axes, in the
same canonical order, slowest-varying (dp, across hosts) first and
fastest-varying (tp, within a host) last, row-major as JAX lays out
devices.  Each rank holds its own coordinates and, for any tuple of axes,
the :class:`~torchmpi_tpu_torch.runtime.communicator.Communicator` of the
ranks that differ from it only along those axes: the group a collective
over those axes runs in (``collectives/innerjit.py``).

``torch.distributed.new_group`` is collective over the whole world, so
:func:`make_mesh` makes the process group of every such group, for every
subset of the axes of size > 1, on every rank and in one order
(``runtime/communicator.py:process_groups``).  A mesh is also a context
manager: inside ``with mesh:`` the axis-name collectives find it without
being passed it, as JAX's find the axes of the enclosing ``shard_map``.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from ..runtime import communicator as _comm_mod
from ..runtime.communicator import Communicator

# Canonical axis names, in slowest (across hosts) -> fastest (within a
# host) order.
AXIS_DP = "dp"    # data parallel (replicas)
AXIS_PP = "pp"    # pipeline stages
AXIS_EP = "ep"    # expert parallel
AXIS_SP = "sp"    # sequence/context parallel
AXIS_TP = "tp"    # tensor/model parallel
AXIS_ORDER = (AXIS_DP, AXIS_PP, AXIS_EP, AXIS_SP, AXIS_TP)

Axes = Union[str, Sequence[str]]

_ambient = threading.local()


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _world_started() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


class Mesh:
    """The ranks of a communicator laid out on named axes.

    ``axis_names`` and ``shape`` (axis -> size, in order) as JAX's mesh has
    them; ``ranks`` the ``torch.distributed`` rank at every coordinate;
    ``coords`` this rank's coordinate on each axis (``None`` when this
    process is not in the mesh)."""

    def __init__(self, ranks: np.ndarray, axis_names: Tuple[str, ...],
                 my_rank: Optional[int]):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.ranks.shape))
        self.my_rank = my_rank
        self.coords: Optional[Dict[str, int]] = None
        if my_rank is not None:
            where = np.argwhere(self.ranks == my_rank)
            if len(where):
                self.coords = dict(zip(self.axis_names,
                                       (int(c) for c in where[0])))
        self._comms: Dict[Tuple[str, ...], Communicator] = {}

    def _check(self, axes: Tuple[str, ...]) -> None:
        for a in axes:
            if a not in self.shape:
                raise NameError(f"unbound axis name: {a}")

    def group_ranks(self, axes: Axes, coords: Dict[str, int]
                    ) -> Tuple[int, ...]:
        """The global ranks that share ``coords`` off ``axes``, row-major
        over ``axes`` in the order given."""
        axes = _axes(axes)
        self._check(axes)
        index = []
        for a in self.axis_names:
            index.append(slice(None) if a in axes else coords[a])
        sub = self.ranks[tuple(index)]
        kept = [a for a in self.axis_names if a in axes]
        sub = np.transpose(sub, [kept.index(a) for a in axes])
        return tuple(int(r) for r in sub.reshape(-1))

    def partition(self, axes: Axes) -> Tuple[Tuple[int, ...], ...]:
        """Every group of ranks that differ only along ``axes``."""
        axes = _axes(axes)
        self._check(axes)
        rest = [a for a in self.axis_names if a not in axes]
        out = []
        for c in itertools.product(*(range(self.shape[a]) for a in rest)):
            out.append(self.group_ranks(axes, dict(zip(rest, c))))
        return tuple(out)

    def comm(self, axes: Axes) -> Communicator:
        """This rank's communicator over ``axes`` (a name or a tuple of
        names; its positions run row-major over them in that order)."""
        axes = _axes(axes)
        if axes not in self._comms:
            self._check(axes)
            if self.coords is None:
                raise RuntimeError(f"rank {self.my_rank} is not in this mesh")
            self._comms[axes] = Communicator(
                self.group_ranks(axes, self.coords),
                name=f"mesh({','.join(axes)})", my_rank=self.my_rank)
        return self._comms[axes]

    def axis_size(self, axes: Axes) -> int:
        axes = _axes(axes)
        self._check(axes)
        return int(np.prod([self.shape[a] for a in axes]))

    def axis_index(self, axes: Axes) -> int:
        """This rank's position along ``axes`` (row-major over them)."""
        axes = _axes(axes)
        self._check(axes)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def make_process_groups(self) -> None:
        """Make the process groups of every subset of the axes of size > 1,
        subsets and groups in one order (every rank of the world calls
        this at once)."""
        names = [a for a in self.axis_names if self.shape[a] > 1]
        for n in range(1, len(names) + 1):
            for axes in itertools.combinations(names, n):
                _comm_mod.process_groups(self.partition(axes))

    def __enter__(self) -> "Mesh":
        stack = getattr(_ambient, "stack", None)
        if stack is None:
            stack = _ambient.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ambient.stack.pop()

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.my_rank})"


def current_mesh() -> Optional[Mesh]:
    """The innermost mesh entered with ``with mesh:``, or None."""
    stack = getattr(_ambient, "stack", None)
    return stack[-1] if stack else None


def make_mesh(axes: Dict[str, int], comm: Optional[Communicator] = None
              ) -> Mesh:
    """Build a mesh with the given axis sizes over the ranks of ``comm``
    (default: the started world).

    ``axes`` maps axis name -> size; names are laid out in canonical
    slowest->fastest order (unknown names keep their dict order, after the
    known ones).  A size of -1 on exactly one axis means "everything left".
    In a started world of more than one rank every rank must call this at
    the same point: it makes the mesh's process groups."""
    if comm is None:
        comm = _comm_mod.stack.world()
    n = comm.size
    names = sorted(
        axes.keys(),
        key=lambda a: AXIS_ORDER.index(a) if a in AXIS_ORDER else len(AXIS_ORDER),
    )
    sizes = [axes[a] for a in names]
    wild = [i for i, s in enumerate(sizes) if s == -1]
    if len(wild) > 1:
        raise ValueError("at most one axis may be -1")
    if wild:
        known = int(np.prod([s for s in sizes if s != -1])) or 1
        if n % known != 0:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[wild[0]] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"axis sizes {dict(zip(names, sizes))} do not multiply "
                         f"to {n} devices")
    my_rank = comm._my_rank
    if my_rank is None and _world_started():
        import torch.distributed as dist

        my_rank = dist.get_rank()
    if my_rank is None and n == 1:
        my_rank = comm.ranks[0]
    mesh = Mesh(np.asarray(comm.ranks).reshape(sizes), tuple(names), my_rank)
    if _world_started():
        mesh.make_process_groups()
    return mesh


def data_parallel_mesh(comm: Optional[Communicator] = None) -> Mesh:
    return make_mesh({AXIS_DP: -1}, comm=comm)


def mesh_axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis]


def validate_hosts_on_slow_axes(mesh: Mesh) -> bool:
    """True when no fast (model) axis crosses hosts — the layout that keeps
    tp/sp collectives within a host.  Every axis after the first (slowest)
    is checked: moving along it with all other coordinates fixed must stay
    on one host.  The hosts are the ones ``lifecycle.start`` gathered over
    the world; before it (or on one host) this is trivially true."""
    from ..runtime import lifecycle

    names = lifecycle.hostnames()
    ranks = mesh.ranks
    if names is None or ranks.ndim <= 1 \
            or len({names[r] for r in ranks.flat}) == 1:
        return True
    for i in range(1, ranks.ndim):
        rows = np.moveaxis(ranks, i, -1).reshape(-1, ranks.shape[i])
        for row in rows:
            if len(row) > 1 and len({names[r] for r in row}) > 1:
                return False
    return True
