"""Synthetic data and the sharded batch iterator.

Counterpart of ``torchmpi_tpu/utils/data.py``'s ``Dataset``,
``synthetic_mnist`` (the same numpy stream, bit for bit) and
``ShardedIterator`` (rank-major ``(p, b, ...)`` batches, the same shuffle).
Each process takes its own row r of every batch (the engine does).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Dataset:
    x: np.ndarray  # (N, ...) float32
    y: np.ndarray  # (N,) int32


def synthetic_mnist(n: int = 8192, seed: int = 0, n_classes: int = 10,
                    image_shape: Tuple[int, ...] = (28, 28),
                    noise: float = 0.35,
                    center_seed: Optional[int] = None) -> Dataset:
    """Balanced Gaussian class blobs in pixel space, clipped to [0, 1]: a
    learnable stand-in for an image set at any image shape.
    ``center_seed`` draws the class centres from their own stream, so two
    calls with different ``seed`` form a train/test pair."""
    rng = np.random.RandomState(seed)
    d = int(np.prod(image_shape))
    crng = rng if center_seed is None else np.random.RandomState(center_seed)
    centers = crng.rand(n_classes, d).astype(np.float32)
    y = np.arange(n, dtype=np.int32) % n_classes
    rng.shuffle(y)
    x = centers[y] + noise * rng.randn(n, d).astype(np.float32)
    x = np.clip(x, 0.0, 1.0).reshape(n, *image_shape)
    return Dataset(x=x, y=y)


class ShardedIterator:
    """Epoch iterator of rank-major batches ``(p, per_rank_bs, ...)``: each
    rank's row is a disjoint shard of the global batch; the shuffle seed is
    the same on every rank, so all agree on the partition."""

    def __init__(self, dataset: Dataset, global_batch: int, num_shards: int,
                 seed: int = 0, shuffle: bool = True, drop_last: bool = True):
        if global_batch % num_shards != 0:
            raise ValueError(f"global batch {global_batch} not divisible by "
                             f"{num_shards} shards")
        self.ds = dataset
        self.global_batch = global_batch
        self.num_shards = num_shards
        self.per_shard = global_batch // num_shards
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.ds.x)
        full = n // self.global_batch
        if self.drop_last:
            return full
        tail = ((n - full * self.global_batch) // self.num_shards) * self.num_shards
        return full + (1 if tail > 0 else 0)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.ds.x)
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        self.epoch += 1
        for start in range(0, n - self.global_batch + 1, self.global_batch):
            b = idx[start:start + self.global_batch]
            yield (self.ds.x[b].reshape(self.num_shards, self.per_shard,
                                        *self.ds.x.shape[1:]),
                   self.ds.y[b].reshape(self.num_shards, self.per_shard))
        if not self.drop_last:
            done = (n // self.global_batch) * self.global_batch
            tail = ((n - done) // self.num_shards) * self.num_shards
            if tail > 0:
                b = idx[done:done + tail]
                per = tail // self.num_shards
                yield (self.ds.x[b].reshape(self.num_shards, per,
                                            *self.ds.x.shape[1:]),
                       self.ds.y[b].reshape(self.num_shards, per))

