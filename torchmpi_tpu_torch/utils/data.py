"""Datasets and the sharded batch iterator.

Counterpart of ``torchmpi_tpu/utils/data.py``: ``Dataset``,
``synthetic_mnist`` (the same numpy stream, bit for bit), real MNIST
(:func:`real_mnist`, :func:`load_mnist`: the same cache directory,
``TORCHMPI_TPU_DATA`` variable, IDX parser, fallback policy and provenance
string) and ``ShardedIterator`` (rank-major ``(p, b, ...)`` batches, the
same shuffle).  Each process takes its own row r of every batch (the engine
does).
"""

from __future__ import annotations

import dataclasses
import gzip
import logging
import os
import struct
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


# ------------------------------------------------------------- real MNIST
# The reference's CI trains the real set.  These load the IDX files from a
# local cache, downloading once from the public mirrors when a caller asks
# for the real set and the cache is cold; load_mnist(prefer="synthetic")
# never touches the network.

_MNIST_FILES = {
    "train": ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"),
    "test": ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz"),
}
_MNIST_MIRRORS = (
    "https://storage.googleapis.com/cvdf-datasets/mnist/",
    "https://ossci-datasets.s3.amazonaws.com/mnist/",
)


def mnist_cache_dir() -> str:
    """``TORCHMPI_TPU_DATA``, else ``~/.cache/torchmpi_tpu/mnist`` (the JAX
    package's cache, shared)."""
    return os.environ.get(
        "TORCHMPI_TPU_DATA",
        os.path.join(os.path.expanduser("~"), ".cache", "torchmpi_tpu",
                     "mnist"))


def _read_idx(path: str) -> np.ndarray:
    """Parse one gzipped IDX file (big-endian magic, dims, raw bytes)."""
    with gzip.open(path, "rb") as f:
        _, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if dtype_code != 0x08:  # unsigned byte, the only MNIST dtype
            raise ValueError(f"{path}: unsupported IDX dtype {dtype_code:#x}")
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), np.uint8)
    if data.size != int(np.prod(dims)):
        raise ValueError(f"{path}: truncated IDX payload")
    return data.reshape(dims)


def real_mnist(split: str = "train", cache_dir: Optional[str] = None,
               download: bool = True, timeout: float = 20.0) -> Dataset:
    """The MNIST ``split`` ('train': 60k, 'test': 10k) as float32 images in
    [0, 1] and int32 labels, from ``cache_dir`` (default
    :func:`mnist_cache_dir`); a missing file is downloaded once when
    ``download``.  Raises ``RuntimeError`` when the data is unavailable."""
    import urllib.request

    if split not in _MNIST_FILES:
        raise ValueError(f"split must be 'train' or 'test', got {split!r}")
    cache = cache_dir or mnist_cache_dir()
    os.makedirs(cache, exist_ok=True)
    paths = []
    for fname in _MNIST_FILES[split]:
        path = os.path.join(cache, fname)
        if not os.path.exists(path):
            if not download:
                raise RuntimeError(f"MNIST file missing: {path}")
            last = None
            for mirror in _MNIST_MIRRORS:
                try:
                    tmp = f"{path}.{os.getpid()}.tmp"
                    with urllib.request.urlopen(mirror + fname,
                                                timeout=timeout) as r, \
                            open(tmp, "wb") as out:
                        out.write(r.read())
                    os.replace(tmp, path)
                    last = None
                    break
                except Exception as e:  # noqa: BLE001 - try the next mirror
                    last = e
            if last is not None:
                raise RuntimeError(
                    f"could not download {fname} (offline?): {last}")
        paths.append(path)
    images = _read_idx(paths[0]).astype(np.float32) / 255.0
    labels = _read_idx(paths[1]).astype(np.int32)
    if images.shape[0] != labels.shape[0]:
        raise ValueError("MNIST images/labels length mismatch")
    return Dataset(x=images, y=labels)


def load_mnist(split: str = "train", prefer: str = "auto",
               n_synthetic: int = 8192, limit: int = 0) -> Tuple[Dataset, str]:
    """Dataset and provenance, ``'real'`` or ``'synthetic'``.

    ``prefer='auto'`` tries the real set (cached or downloadable) and falls
    back to :func:`synthetic_mnist` (train seed 0, test seed 1, the class
    centres of seed 0); ``'real'`` raises when it is unavailable;
    ``'synthetic'`` skips the attempt.  ``limit`` > 0 caps the examples."""
    if prefer not in ("auto", "real", "synthetic"):
        raise ValueError(f"prefer must be auto|real|synthetic, got {prefer!r}")
    ds = src = None
    if prefer != "synthetic":
        try:
            ds, src = real_mnist(split), "real"
        except (RuntimeError, OSError) as e:
            if prefer == "real":
                raise
            logging.getLogger(__name__).info(
                "real MNIST unavailable (%s); using synthetic", e)
    if ds is None:
        seed = 0 if split == "train" else 1
        ds, src = synthetic_mnist(n=n_synthetic, seed=seed,
                                  center_seed=0), "synthetic"
    if limit < 0:
        raise ValueError(f"limit must be >= 0, got {limit}")
    if limit:
        ds = Dataset(x=ds.x[:limit], y=ds.y[:limit])
    return ds, src


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



class _Skipping:
    """An epoch iterable whose first pass skips its first ``skip``
    batches."""

    def __init__(self, it, skip: int):
        self.it = it
        self.skip = skip

    def __len__(self):
        return len(self.it)

    def __iter__(self):
        skip, self.skip = self.skip, 0
        for i, batch in enumerate(self.it):
            if i >= skip:
                yield batch


def resume_at(it: ShardedIterator, step: int):
    """``(iterable, done_epochs)``: ``it`` continued at global step
    ``step`` of a run that started at step 0, for a run resumed from a
    checkpoint.  The epochs already done are skipped (the shuffle of epoch
    e is seeded ``seed + e``), and so are the batches of the resumed epoch
    already trained on; train ``epochs - done_epochs`` more epochs."""
    done_epochs, skip = divmod(int(step), len(it))
    it.epoch = done_epochs
    return (_Skipping(it, skip) if skip else it), done_epochs
