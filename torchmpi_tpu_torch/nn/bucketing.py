"""Gradient bucketing: fuse many small tensors into few flat buffers.

Counterpart of ``torchmpi_tpu/nn/bucketing.py``: leaves group by dtype, in
tree order (``utils.tree``: sorted dict keys), into buckets of at most
``gradient_bucket_bytes``; a leaf larger than that gets a bucket of its
own.  The bucket tables are the JAX package's.  Here the leaves are one
rank's tensors, so a bucket is a flat ``(total,)`` vector.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Sequence, Tuple

import torch

from ..runtime import config
from ..utils import tree as _tree


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Layout of one flat bucket: which leaves, their shapes and extents."""

    leaf_indices: Tuple[int, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    dtype: Any

    @property
    def total(self) -> int:
        return int(sum(self.sizes))


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Bucketing plan of a tree's structure."""

    treedef: Any
    specs: Tuple[BucketSpec, ...]


def plan_buckets(tree: Any, bucket_bytes: int | None = None) -> BucketPlan:
    """Group leaves (by dtype, in tree order) into buckets of at most
    ``bucket_bytes``; a single oversized leaf gets its own bucket."""
    if bucket_bytes is None:
        bucket_bytes = int(config.get("gradient_bucket_bytes"))
    leaves, treedef = _tree.flatten(tree)
    specs: List[BucketSpec] = []
    cur: List[Tuple[int, Tuple[int, ...], int]] = []
    cur_bytes, cur_dtype = 0, None

    def flush():
        if cur:
            specs.append(BucketSpec(tuple(i for i, _, _ in cur),
                                    tuple(s for _, s, _ in cur),
                                    tuple(n for _, _, n in cur), cur_dtype))

    for i, leaf in enumerate(leaves):
        shape = tuple(leaf.shape)
        size = int(leaf.numel())
        nbytes = size * leaf.element_size()
        if cur_dtype is not None and (leaf.dtype != cur_dtype
                                      or cur_bytes + nbytes > bucket_bytes):
            flush()
            cur, cur_bytes = [], 0
        cur.append((i, shape, size))
        cur_bytes += nbytes
        cur_dtype = leaf.dtype
    flush()
    return BucketPlan(treedef, tuple(specs))


def flatten(tree: Any, plan: BucketPlan) -> List[torch.Tensor]:
    """Pack leaves into flat ``(total,)`` buckets."""
    leaves = _tree.leaves(tree)
    return [torch.cat([leaves[i].reshape(-1) for i in spec.leaf_indices])
            for spec in plan.specs]


def unflatten_bucket(bucket: torch.Tensor,
                     spec: BucketSpec) -> List[torch.Tensor]:
    """One bucket back into its leaves (views of the bucket)."""
    out, offset = [], 0
    for shape, size in zip(spec.shapes, spec.sizes):
        out.append(bucket[offset:offset + size].view(shape))
        offset += size
    return out


def unflatten(buckets: Sequence[torch.Tensor], plan: BucketPlan) -> Any:
    """Invert :func:`flatten` back into the original tree."""
    n_leaves = sum(len(s.leaf_indices) for s in plan.specs)
    leaves: List[Any] = [None] * n_leaves
    for bucket, spec in zip(buckets, plan.specs):
        for li, leaf in zip(spec.leaf_indices, unflatten_bucket(bucket, spec)):
            leaves[li] = leaf
    return _tree.unflatten(plan.treedef, leaves)


def map_bucketed(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any,
                 bucket_bytes: int | None = None) -> Any:
    """Apply ``fn`` (e.g. an allreduce) to each bucket of ``tree`` and
    restore the structure."""
    plan = plan_buckets(tree, bucket_bytes)
    return unflatten([fn(b) for b in flatten(tree, plan)], plan)
