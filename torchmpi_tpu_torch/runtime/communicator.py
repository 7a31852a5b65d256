"""Hierarchical communicators over the ranks of a ``torch.distributed`` world.

Counterpart of ``torchmpi_tpu/runtime/communicator.py``.  A rank is a
process; a communicator is an ordered list of global ranks split into intra
groups by a per-rank string key: ranks sort by (key, rank) and equal keys
form a group.  A level is *cartesian* when its groups are all the same size
(and ``use_cartesian_communicators`` is on, ``use_tree_communicators``
off): then one inter group links the ranks at each intra position across
the groups.  Otherwise it is a *tree*: one inter group, of the groups'
roots (each group's first rank).  The tables are the JAX package's, rank for
rank.

The stack holds the levels and the cursor the collectives read: the level,
its intra or inter side, and the span of levels a hierarchical collective
covers (``collectives/hierarchical.py:groups_for_cursor``).

Process groups.  ``torch.distributed.new_group`` is collective over the
whole world: every process must call it, in the same order, even for a
group it is not in.  So the groups of a partition are made together, in
the partition's order, by :func:`process_groups`, which every rank calls
at the same point: a pushed level makes its intra groups, its inter groups
and its roots group at once, on every rank; a partition a collective is
given (``groups=``) is made at its first call, which every rank makes.
Each set of ranks gets one process group, cached until :func:`clear_groups`.
"""

from __future__ import annotations

import enum
import threading
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

from . import config

MAX_KEY_LEN = 1024

Partition = Tuple[Tuple[int, ...], ...]


class CommunicatorType(enum.Enum):
    """Which side of a level's intra/inter pair the collectives address."""

    INTRA = "intra"
    INTER = "inter"


# One process group per set of global ranks, in creation order.
_groups: Dict[Tuple[int, ...], Any] = {}
_groups_lock = threading.Lock()


def process_groups(partition: Sequence[Sequence[int]]) -> None:
    """Make the process group of every group of global ranks in
    ``partition`` that has none yet, in order.  Every process of the world
    must make the same calls in the same order (``new_group`` is collective
    over the world)."""
    import torch.distributed as dist

    with _groups_lock:
        world = tuple(range(dist.get_world_size()))
        for g in partition:
            key = tuple(sorted(g))
            if key not in _groups:
                _groups[key] = None if key == world else dist.new_group(
                    list(key))


def process_group(ranks: Sequence[int]):
    """The process group of a set of global ranks made by
    :func:`process_groups` (``None``, the default group, for the world)."""
    key = tuple(sorted(ranks))
    with _groups_lock:
        if key not in _groups:
            raise KeyError(f"no process group was made for ranks {key}")
        return _groups[key]


def clear_groups() -> None:
    """Forget every process group (the world's teardown destroys them)."""
    with _groups_lock:
        _groups.clear()


class Communicator:
    """One level of the hierarchy: an ordered list of global ranks split
    into intra groups by key, and the inter groups across them.

    ``group_ranks``, ``inter_group_ranks`` and ``root_ranks`` hold
    positions in ``ranks`` (the world's ranks at every level a stack
    pushes).  ``host_ring``, when a caller attaches a
    :class:`~torchmpi_tpu_torch.collectives.hostcomm.HostCommunicator`, is
    the ring the selector's host column runs on."""

    def __init__(self, ranks: Sequence[int], keys: Optional[Sequence[str]] = None,
                 name: str = "global", parent: Optional["Communicator"] = None,
                 my_rank: Optional[int] = None):
        if len(ranks) == 0:
            raise ValueError("communicator needs at least one rank")
        self.ranks: Tuple[int, ...] = tuple(int(r) for r in ranks)
        self.name = name
        self.parent = parent
        self._my_rank = my_rank
        self.host_ring = None
        if keys is None:
            keys = [""] * len(self.ranks)
        if len(keys) != len(self.ranks):
            raise ValueError("one key per rank required")
        for k in keys:
            if len(k) >= MAX_KEY_LEN:
                raise ValueError(f"communicator key too long (>= {MAX_KEY_LEN})")
        self.keys = tuple(keys)

        order = sorted(range(len(self.ranks)), key=lambda r: (keys[r], r))
        groups: List[List[int]] = []
        current_key: Optional[str] = None
        for r in order:
            if keys[r] != current_key:
                groups.append([])
                current_key = keys[r]
            groups[-1].append(r)
        self.group_ranks: Partition = tuple(tuple(g) for g in groups)

        sizes = {len(g) for g in groups}
        self.cartesian: bool = (
            len(sizes) == 1
            and bool(config.get("use_cartesian_communicators"))
            and not config.get("use_tree_communicators"))
        if self.cartesian:
            self.inter_group_ranks: Partition = tuple(
                tuple(g[i] for g in self.group_ranks)
                for i in range(len(self.group_ranks[0])))
        else:
            self.inter_group_ranks = (tuple(g[0] for g in self.group_ranks),)
        self.root_ranks: Tuple[int, ...] = tuple(g[0] for g in self.group_ranks)

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def num_groups(self) -> int:
        return len(self.group_ranks)

    @property
    def rank(self) -> int:
        """This process's position in the communicator."""
        me = self._my_rank
        if me is None:
            import torch.distributed as dist

            me = dist.get_rank()
        try:
            return self.ranks.index(me)
        except ValueError:
            raise RuntimeError(f"process rank {me} is not in {self.describe()}")

    def global_rank(self, r: int) -> int:
        """The ``torch.distributed`` rank of communicator position ``r``."""
        return self.ranks[r]

    def group_of_rank(self, rank: int) -> int:
        for gi, g in enumerate(self.group_ranks):
            if rank in g:
                return gi
        raise ValueError(f"rank {rank} not in communicator")

    def intra_rank_of(self, rank: int) -> int:
        """The position of ``rank`` in its intra group."""
        return self.group_ranks[self.group_of_rank(rank)].index(rank)

    def global_partition(self, groups: Sequence[Sequence[int]]) -> Partition:
        """``groups`` of positions as groups of global ranks."""
        return tuple(tuple(self.ranks[r] for r in g) for g in groups)

    def make_process_groups(self) -> None:
        """Make this level's intra groups, inter groups and roots group of
        two or more ranks, in that order (every process of the world calls
        this at once)."""
        for part in (self.group_ranks, self.inter_group_ranks,
                     (self.root_ranks,)):
            process_groups([g for g in self.global_partition(part)
                            if len(g) > 1])

    @property
    def group(self):
        """The process group of this communicator's ranks (``None``, the
        default group, when they are the whole world).  Made at first use,
        which every process of the world must reach in the same order."""
        process_groups((self.ranks,))
        return process_group(self.ranks)

    def num_nodes(self) -> int:
        """Distinct hosts among the ranks: the hostnames ``start()``
        gathered over the world (one host before a world is started)."""
        from . import lifecycle

        names = lifecycle.hostnames()
        if names is None:
            return 1
        return len({names[r] for r in self.ranks})

    def describe(self) -> str:
        return (f"Communicator<{self.name}, size={self.size}, "
                f"{'cartesian' if self.cartesian else 'tree'}, "
                f"groups={[len(g) for g in self.group_ranks]}>")

    def __repr__(self) -> str:
        return self.describe()


class CommunicatorStack:
    """The process's communicator stack and its cursor.

    ``push(keys)`` splits the top communicator's groups further;
    ``set_communicator`` moves the (level, intra/inter) cursor;
    ``set_collective_span`` bounds the levels a hierarchical collective
    covers; ``current()`` is the level at the cursor."""

    def __init__(self) -> None:
        self._stack: List[Communicator] = []
        self._level = 0
        self._type = CommunicatorType.INTRA
        self._span: Tuple[int, int] = (0, 1)
        self._lock = threading.RLock()

    def reset(self, world: Communicator) -> None:
        with self._lock:
            self._stack = [world]
            self._level = 0
            self._type = CommunicatorType.INTRA
            self._span = (0, 1)

    def clear(self) -> None:
        with self._lock:
            self._stack = []
            self._level = 0
            self._span = (0, 1)

    @property
    def depth(self) -> int:
        return len(self._stack)

    @property
    def level(self) -> int:
        return self._level

    @property
    def type(self) -> CommunicatorType:
        return self._type

    @property
    def span(self) -> Tuple[int, int]:
        return self._span

    def push(self, keys: Union[Sequence[str], Callable[[int], Union[str, int]]],
             name: Optional[str] = None) -> int:
        """Split the top communicator by per-rank keys (each rank's key is
        prefixed by its parent group, so a child refines its parent);
        returns the new level, which the cursor and the span move to.

        In-flight async work is waited first: the split is collective and
        must not interleave with it.  In a started world of more than one
        rank, the level's process groups are made here, on every rank."""
        from . import handles

        handles.sync_all()
        with self._lock:
            if not self._stack:
                raise RuntimeError("communicator stack empty; call start() first")
            parent = self._stack[-1]
            if callable(keys):
                keys = [str(keys(r)) for r in range(parent.size)]
            else:
                keys = [str(k) for k in keys]
            if len(keys) != parent.size:
                raise ValueError("one key per rank required")
            keys = [f"{parent.group_of_rank(r):06d}|{keys[r]}"
                    for r in range(parent.size)]
            comm = Communicator(parent.ranks, keys,
                                name=name or f"level{len(self._stack)}",
                                parent=parent, my_rank=parent._my_rank)
            if _world_started():
                comm.make_process_groups()
            self._stack.append(comm)
            self._level = len(self._stack) - 1
            self._span = (self._level, self._level + 1)
            return self._level

    def set_communicator(self, level: int,
                         type: CommunicatorType = CommunicatorType.INTRA,  # noqa: A002
                         ) -> None:
        """Move the (level, intra/inter) cursor; the span becomes that
        level alone."""
        with self._lock:
            if not 0 <= level < len(self._stack):
                raise IndexError(f"communicator level {level} out of range "
                                 f"[0, {len(self._stack)})")
            self._level = level
            self._type = type
            self._span = (level, level + 1)

    def set_collective_span(self, begin: int, end: int) -> None:
        """Bound hierarchical collectives to levels [begin, end); the
        cursor moves to ``begin``."""
        with self._lock:
            if not 0 <= begin < end <= len(self._stack):
                raise IndexError(f"bad collective span [{begin}, {end}) for "
                                 f"depth {len(self._stack)}")
            self._span = (begin, end)
            self._level = begin

    def current(self) -> Communicator:
        with self._lock:
            if not self._stack:
                raise RuntimeError("communicator stack empty; call start() first")
            return self._stack[self._level]

    def at(self, level: int) -> Communicator:
        return self._stack[level]

    def world(self) -> Communicator:
        if not self._stack:
            raise RuntimeError("communicator stack empty; call start() first")
        return self._stack[0]

    def names(self) -> str:
        """The stack, one level a line, the cursor's level marked."""
        return "\n".join(
            f"{'*' if lvl == self._level else ' '}[{lvl}] {c.describe()}"
            for lvl, c in enumerate(self._stack))


class CommunicatorGuard:
    """Switch the cursor to a level for a ``with`` block, and back after."""

    def __init__(self, stack: CommunicatorStack, level: int,
                 type: CommunicatorType = CommunicatorType.INTRA):  # noqa: A002
        self._stack = stack
        self._level = level
        self._type = type
        self._saved: Optional[Tuple[int, CommunicatorType, Tuple[int, int]]] = None

    def __enter__(self) -> "CommunicatorGuard":
        self._saved = (self._stack.level, self._stack.type, self._stack.span)
        self._stack.set_communicator(self._level, self._type)
        return self

    def __exit__(self, *exc) -> None:
        level, type_, span = self._saved  # type: ignore[misc]
        self._stack.set_communicator(level, type_)
        self._stack.set_collective_span(*span)


def _world_started() -> bool:
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


# The process-global stack.
stack = CommunicatorStack()
