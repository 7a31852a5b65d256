"""Hierarchical communicators over the ranks of a ``torch.distributed`` world.

Counterpart of ``torchmpi_tpu/runtime/communicator.py``.  A rank is a
process; a communicator is an ordered list of global ranks split into intra
groups by a per-rank string key: ranks sort by (key, rank) and equal keys
form a group.  The split tables are the JAX package's, rank for rank.  The
cartesian and tree forms of the split (its inter groups) come with the
slice that ports the hierarchical collectives, which read them.

The process group a collective runs over is made lazily, on first use: the
world's is the default group; a sub-communicator's comes from
``torch.distributed.new_group``, which every process of the world must call
in the same order, so every process must touch a sub-communicator's
``group`` in the same order too.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence, Tuple, Union

MAX_KEY_LEN = 1024


class Communicator:
    """One level of the hierarchy: an ordered list of global ranks split
    into intra groups by key."""

    def __init__(self, ranks: Sequence[int], keys: Optional[Sequence[str]] = None,
                 name: str = "global", parent: Optional["Communicator"] = None,
                 my_rank: Optional[int] = None):
        if len(ranks) == 0:
            raise ValueError("communicator needs at least one rank")
        self.ranks: Tuple[int, ...] = tuple(int(r) for r in ranks)
        self.name = name
        self.parent = parent
        self._my_rank = my_rank
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
        self.group_ranks: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(g) for g in groups)
        self._group = None
        self._group_made = False

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

    @property
    def group(self):
        """The process group of this communicator's ranks (``None``, the
        default group, when they are the whole world)."""
        if not self._group_made:
            import torch.distributed as dist

            if self.ranks != tuple(range(dist.get_world_size())):
                self._group = dist.new_group(list(self.ranks))
            self._group_made = True
        return self._group

    def describe(self) -> str:
        return (f"Communicator<{self.name}, size={self.size}, "
                f"groups={[len(g) for g in self.group_ranks]}>")

    def __repr__(self) -> str:
        return self.describe()


class CommunicatorStack:
    """The process's communicator stack: ``push(keys)`` splits the top
    communicator's groups further; ``current()`` is the level collectives
    address by default."""

    def __init__(self) -> None:
        self._stack: List[Communicator] = []
        self._level = 0
        self._lock = threading.RLock()

    def reset(self, world: Communicator) -> None:
        with self._lock:
            self._stack = [world]
            self._level = 0

    def clear(self) -> None:
        with self._lock:
            self._stack = []
            self._level = 0

    def push(self, keys: Union[Sequence[str], Callable[[int], Union[str, int]]],
             name: Optional[str] = None) -> int:
        """Split the top communicator by per-rank keys (each rank's key is
        prefixed by its parent group, so a child refines its parent);
        returns the new level."""
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
            self._stack.append(comm)
            self._level = len(self._stack) - 1
            return self._level

    def current(self) -> Communicator:
        with self._lock:
            if not self._stack:
                raise RuntimeError("communicator stack empty; call start() first")
            return self._stack[self._level]

    def world(self) -> Communicator:
        if not self._stack:
            raise RuntimeError("communicator stack empty; call start() first")
        return self._stack[0]


# The process-global stack.
stack = CommunicatorStack()
