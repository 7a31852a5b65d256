"""Hierarchical composition: the stack's cursor and span as groups, and the
tree collectives over uneven groups.

Counterpart of ``torchmpi_tpu/collectives/hierarchical.py``.  Every level
of the stack partitions the world's ranks (a push refines its parent), so a
collective always runs over the world communicator, with groups choosing
who meets whom:

* :func:`groups_for_cursor` resolves (level, intra/inter, span) to groups
  of the world: a span over several levels is the full collective within
  each of its first level's groups; one level is its intra groups, or its
  inter groups on the inter side; a level of one group is the world, with
  no groups.
* The tree forms run JAX's steps over the intra groups and the group roots
  (:func:`allreduce_tree`: reduce within each group, allreduce over the
  roots, broadcast within each group; :func:`broadcast_tree` and
  :func:`reduce_tree`: two steps).  Where JAX masks a psum over every rank,
  here only the members of a step's group call: a rank outside it is a
  group of its own and makes no call.
* The ``*_hierarchical`` dispatchers pick the tree when the hierarchy knob
  is on and the level has groups (and, for allreduce, is not cartesian),
  the flat collective otherwise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..runtime import config
from ..runtime.communicator import (Communicator, CommunicatorStack,
                                    CommunicatorType)
from . import eager

Groups = Optional[Tuple[Tuple[int, ...], ...]]


def groups_for_cursor(stack: CommunicatorStack) -> Tuple[Communicator, Groups]:
    """The world communicator and the groups the stack's cursor selects."""
    b, e = stack.span
    world = stack.world()
    comm = stack.at(b)
    if e - b == 1 and stack.type == CommunicatorType.INTER:
        return world, comm.inter_group_ranks
    return world, comm.group_ranks if comm.num_groups > 1 else None


def _tree_tables(comm: Communicator, root: Optional[int] = None):
    """The tree collectives' groups: the intra partition, and the group
    roots (with ``root`` when one is given) as one sorted group."""
    inter = set(comm.root_ranks)
    if root is not None:
        eager._validate_rooted_groups(comm, None, root)
        inter.add(int(root))
    return comm.group_ranks, tuple(sorted(inter))


def allreduce_tree(comm: Communicator, x: torch.Tensor,
                   op: str = "sum") -> torch.Tensor:
    """Three steps over uneven groups: reduce within each intra group to
    its root, allreduce over the group roots, broadcast from each root to
    its group.  Mean divides the sum by the communicator's size at the
    end."""
    if op not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unsupported reduction {op!r}")
    intra, roots = _tree_tables(comm)
    base = "sum" if op == "mean" else op
    s = eager.reduce(comm, x, root=0, op=base, groups=intra)
    t = eager.allreduce(comm, s, op=base, groups=(roots,))
    out = eager.broadcast(comm, t, root=0, groups=intra)
    return eager._mean_div(op, out, comm.size)


def broadcast_tree(comm: Communicator, x: torch.Tensor,
                   root: int = 0) -> torch.Tensor:
    """Two steps: ``root`` (a position in ``comm``, not necessarily a group
    root) to every group root, then each group root to its group."""
    intra, inter = _tree_tables(comm, root)
    t = eager.broadcast(comm, x, root=inter.index(root), groups=(inter,))
    return eager.broadcast(comm, t, root=0, groups=intra)


def reduce_tree(comm: Communicator, x: torch.Tensor, root: int = 0,
                op: str = "sum") -> torch.Tensor:
    """Two steps, the broadcast's dual: reduce within each group to its
    root, then the group sums to ``root`` over the roots (a ``root`` that
    is no group root adds nothing of its own there).  Every other rank
    keeps its input.  ``op`` sum or mean (mean: over the communicator's
    size); the dispatcher takes max and min flat."""
    if op not in ("sum", "mean"):
        raise ValueError("reduce_tree supports op='sum'/'mean'")
    intra, inter = _tree_tables(comm, root)
    me = comm.rank
    s = eager.reduce(comm, x, root=0, groups=intra)
    if me == root and me not in comm.root_ranks:
        s = torch.zeros_like(s)
    t = eager.reduce(comm, s, root=inter.index(root), groups=(inter,))
    if me != root:
        return x.clone()
    return eager._mean_div(op, t, comm.size)


def broadcast_hierarchical(comm: Communicator, x: torch.Tensor,
                           root: int = 0) -> torch.Tensor:
    """The tree broadcast when the hierarchy knob is on and the level has
    groups; the flat broadcast otherwise."""
    if not config.get("use_hierarchical_collectives") or comm.num_groups <= 1:
        return eager.broadcast(comm, x, root=root)
    return broadcast_tree(comm, x, root=root)


def reduce_hierarchical(comm: Communicator, x: torch.Tensor, root: int = 0,
                        op: str = "sum") -> torch.Tensor:
    """The tree reduce for sum and mean under the hierarchy knob on a level
    with groups; the flat reduce otherwise (max and min always)."""
    if (not config.get("use_hierarchical_collectives")
            or comm.num_groups <= 1 or op not in ("sum", "mean")):
        return eager.reduce(comm, x, root=root, op=op)
    return reduce_tree(comm, x, root=root, op=op)


def allreduce_hierarchical(comm: Communicator, x: torch.Tensor,
                           op: str = "sum") -> torch.Tensor:
    """The communicator-wide allreduce: the tree's three steps on a tree
    level under the hierarchy knob; the flat allreduce with the knob off,
    on a level of one group, or on a cartesian level (whose two steps the
    backend's own collective composes)."""
    if (not config.get("use_hierarchical_collectives")
            or comm.num_groups <= 1 or comm.cartesian):
        return eager.allreduce(comm, x, op=op)
    return allreduce_tree(comm, x, op=op)
