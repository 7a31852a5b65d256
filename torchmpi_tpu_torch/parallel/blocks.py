"""BlockSequential: partition a sequential model into <=N contiguous
parameter blocks.

Counterpart of ``torchmpi_tpu/parallel/blocks.py``.  The reference repacks
an ``nn.Sequential`` into blocks of contiguous flattened parameters and
walks them one at a time in backward (``backwardStep``) so per-block
gradient collectives overlap the remaining backward compute (reference:
torchmpi/BlockSequential.lua:29-151, nn.lua:162-183).  What the block
structure contributes here, as in JAX, is (a) the bucketing boundary for
eager/async gradient sync, (b) the stage boundary for pipeline
parallelism (``pipeline.py`` consumes these partitions), and (c) the same
zeroGrad/updateParameters-over-blocks API surface.  A layer is an
``(init, apply)`` pair of functions: ``init(generator) -> params`` (a tree
of tensors drawn from a ``torch.Generator`` on its device),
``apply(params, x) -> y``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch

from ..models._common import DeviceLike, generator as _generator, \
    resolve_device
from ..utils import tree as _tree

Layer = Tuple[Callable, Callable]  # (init(gen) -> params, apply(params, x) -> y)


def partition_contiguous(sizes: Sequence[int], max_blocks: int) -> List[Tuple[int, int]]:
    """Split ``len(sizes)`` items into <= max_blocks contiguous runs balanced
    by total size (the reference's byte-balanced contiguous packing,
    BlockSequential.lua:54-84).  Returns [start, end) index pairs.

    Greedy by target fill: close a block once adding the next item would
    exceed the ideal per-block share, while leaving at least one item for
    each remaining block.
    """
    n = len(sizes)
    if n == 0:
        return []
    max_blocks = max(1, min(max_blocks, n))
    total = sum(sizes)
    target = total / max_blocks
    bounds: List[Tuple[int, int]] = []
    start, acc = 0, 0
    for i, s in enumerate(sizes):
        acc += s
        remaining_items = n - (i + 1)
        remaining_blocks = max_blocks - len(bounds) - 1
        if (acc >= target and remaining_blocks > 0) or remaining_items == remaining_blocks > 0:
            bounds.append((start, i + 1))
            start, acc = i + 1, 0
    bounds.append((start, n))
    return bounds


class BlockSequential:
    """A sequential stack of functional layers grouped into parameter blocks.

    ``layers`` is a list of (init, apply) pairs.  ``init`` returns the
    per-layer params list; :meth:`blocks` views it as <=N blocks;
    :meth:`flatten_block` produces the contiguous flat vector the reference's
    getParameters-based packing yields.
    """

    def __init__(self, layers: Sequence[Layer], max_blocks: int = 1):
        self.layers = list(layers)
        self.max_blocks = max_blocks
        self._bounds: Optional[List[Tuple[int, int]]] = None

    # ------------------------------------------------------------ lifecycle

    def init(self, rng: Union[int, torch.Generator],
             device: DeviceLike = None) -> List[Any]:
        """Each layer's ``init`` in turn on one ``torch.Generator`` (an int
        seeds one on ``device``: the current CUDA device unless the caller
        names another; with no GPU and no device this raises).  A layer
        draws its tensors on the generator's device."""
        gen = rng if isinstance(rng, torch.Generator) else _generator(
            rng, resolve_device(device))
        params = [init(gen) for init, _ in self.layers]
        sizes = [sum(int(l.numel()) for l in _tree.leaves(p)) for p in params]
        self._bounds = partition_contiguous(sizes, self.max_blocks)
        return params

    def apply(self, params: Sequence[Any], x: torch.Tensor) -> torch.Tensor:
        for (_, apply), p in zip(self.layers, params):
            x = apply(p, x)
        return x

    # ------------------------------------------------------------ block view

    @property
    def bounds(self) -> List[Tuple[int, int]]:
        if self._bounds is None:
            raise RuntimeError("call init() first")
        return self._bounds

    @property
    def num_blocks(self) -> int:
        return len(self.bounds)

    def blocks(self, tree_list: Sequence[Any]) -> List[List[Any]]:
        """Group a per-layer list (params or grads) into the block runs."""
        return [list(tree_list[a:b]) for a, b in self.bounds]

    def flatten_block(self, tree_list: Sequence[Any], i: int) -> torch.Tensor:
        """Contiguous flat vector of block i (reference: the flattened
        parameter storage per block)."""
        a, b = self.bounds[i]
        leaves = [l.reshape(-1) for p in tree_list[a:b]
                  for l in _tree.leaves(p)]
        return torch.cat(leaves) if leaves else torch.zeros((0,))

    def unflatten_block(self, tree_list: Sequence[Any], i: int,
                        flat: torch.Tensor) -> List[Any]:
        """Inverse of flatten_block: write a flat vector back into block i's
        structure; returns the new per-layer params for that block."""
        a, b = self.bounds[i]
        out = []
        off = 0
        for p in tree_list[a:b]:
            leaves, treedef = _tree.flatten(p)
            new_leaves = []
            for l in leaves:
                n = int(l.numel())
                new_leaves.append(flat[off:off + n].reshape(l.shape).to(l.dtype))
                off += n
            out.append(_tree.unflatten(treedef, new_leaves))
        return out

    # -------------------------------------------- reference API equivalents

    def zero_grad(self, grads: Sequence[Any]) -> List[Any]:
        """zeroGradParameters over blocks (BlockSequential.lua:154-160)."""
        return [_tree.tree_map(torch.zeros_like, g) for g in grads]

    def update_parameters(self, params: Sequence[Any], grads: Sequence[Any],
                          lr: float) -> List[Any]:
        """updateParameters over blocks (BlockSequential.lua:162-171)."""
        return [_tree.tree_map(lambda p, g: p - lr * g, p, g)
                for p, g in zip(params, grads)]

    def backward_step(self, loss_fn: Callable, params: Sequence[Any], *args):
        """Per-block gradients in last->first order, the reference's
        backwardStep walk (BlockSequential.lua:114-151): yields
        (block_index, grads_for_block) so callers can launch per-block async
        gradient sync while earlier blocks' results are consumed.  As in
        JAX, the whole gradient is one backward (here one
        ``torch.autograd.grad``); the generator keeps the reference's API
        shape.
        """
        params = list(params)
        leaves, treedef = _tree.flatten(params)
        leaves = [l.detach().requires_grad_(True) for l in leaves]
        loss = loss_fn(_tree.unflatten(treedef, leaves), *args)
        grads = _tree.unflatten(treedef, list(torch.autograd.grad(loss, leaves)))
        for i in reversed(range(self.num_blocks)):
            a, b = self.bounds[i]
            yield i, grads[a:b]
