"""The port's meters and synthetic data (``torchmpi_tpu_torch/utils``)
against the JAX package's: the same numbers, exactly (both sides run the
same numpy and f64 host arithmetic)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torchmpi_tpu_torch.utils import data as tdata
from torchmpi_tpu_torch.utils import meters as tmeters


def test_average_value_meter_matches_jax():
    import jax.numpy as jnp

    from torchmpi_tpu.utils import meters as jmeters

    vals = np.random.RandomState(0).randn(40).astype(np.float32) + 2.0
    tm, jm = tmeters.AverageValueMeter(), jmeters.AverageValueMeter()
    for i, v in enumerate(vals):
        if i % 2:       # device scalars, folded at read time
            tm.add(torch.tensor(v), n=1 + i % 3)
            jm.add(jnp.asarray(v), n=1 + i % 3)
        else:
            tm.add(float(v), n=1 + i % 3)
            jm.add(float(v), n=1 + i % 3)
    assert tm.n == jm.n
    assert tm.value() == jm.value()
    tm.reset()
    assert np.isnan(tm.mean)


@pytest.mark.parametrize("topk", [(1,), (1, 3)])
def test_class_error_meter_matches_jax(topk):
    from torchmpi_tpu.utils import meters as jmeters

    rng = np.random.RandomState(len(topk))
    tm, jm = tmeters.ClassErrorMeter(topk), jmeters.ClassErrorMeter(topk)
    for _ in range(3):
        logits = rng.randn(16, 10).astype(np.float32)
        y = rng.randint(0, 10, size=16)
        tm.add(torch.from_numpy(logits), torch.from_numpy(y))
        jm.add(logits, y)
    for k in topk:
        assert tm.value(k) == jm.value(k)


@pytest.mark.parametrize("shape,classes,center_seed",
                         [((28, 28), 10, None), ((9, 9, 3), 7, 5)])
def test_synthetic_mnist_is_the_same_stream(shape, classes, center_seed):
    from torchmpi_tpu.utils import data as jdata

    a = tdata.synthetic_mnist(n=50, seed=4, n_classes=classes,
                              image_shape=shape, center_seed=center_seed)
    b = jdata.synthetic_mnist(n=50, seed=4, n_classes=classes,
                              image_shape=shape, center_seed=center_seed)
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_sharded_iterator_yields_the_same_batches(shuffle, drop_last):
    from torchmpi_tpu.utils import data as jdata

    ds = tdata.synthetic_mnist(n=45, seed=1, image_shape=(4, 4))
    jds = jdata.Dataset(x=ds.x, y=ds.y)
    t = tdata.ShardedIterator(ds, global_batch=8, num_shards=2, seed=3,
                              shuffle=shuffle, drop_last=drop_last)
    j = jdata.ShardedIterator(jds, global_batch=8, num_shards=2, seed=3,
                              shuffle=shuffle, drop_last=drop_last)
    assert len(t) == len(j)
    for _ in range(2):          # two epochs: the shuffle advances alike
        tb, jb = list(t), list(j)
        assert len(tb) == len(jb)
        for (tx, ty), (jx, jy) in zip(tb, jb):
            np.testing.assert_array_equal(tx, np.asarray(jx))
            np.testing.assert_array_equal(ty, np.asarray(jy))


# ------------------------------------------------------------- real MNIST
# Tiny gzipped IDX files written to tmp_path stand in for the real set: no
# test here reaches the network (every load finds its files, or asks for
# the synthetic set).

def _write_idx(path, arr, dtype_code=0x08, truncate=0):
    import gzip
    import struct

    payload = arr.astype(np.uint8).tobytes()
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, dtype_code, arr.ndim))
        f.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        f.write(payload[:len(payload) - truncate])


def _fake_mnist(cache, n=(12, 5)):
    rng = np.random.RandomState(0)
    for split, count in zip(("train", "test"), n):
        img, lab = tdata._MNIST_FILES[split]
        _write_idx(cache / img, rng.randint(0, 256, (count, 28, 28)))
        _write_idx(cache / lab, rng.randint(0, 10, (count,)))


def test_read_idx_and_real_mnist_match_jax(tmp_path):
    from torchmpi_tpu.utils import data as jdata

    _fake_mnist(tmp_path)
    for split in ("train", "test"):
        for fname in tdata._MNIST_FILES[split]:
            np.testing.assert_array_equal(
                tdata._read_idx(str(tmp_path / fname)),
                jdata._read_idx(str(tmp_path / fname)))
        a = tdata.real_mnist(split, cache_dir=str(tmp_path), download=False)
        b = jdata.real_mnist(split, cache_dir=str(tmp_path), download=False)
        assert a.x.dtype == b.x.dtype == np.float32
        assert a.y.dtype == b.y.dtype == np.int32
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)


@pytest.mark.parametrize("fault,match", [("truncate", "truncated IDX"),
                                         ("dtype", "unsupported IDX dtype")])
def test_read_idx_errors_match_jax(tmp_path, fault, match):
    from torchmpi_tpu.utils import data as jdata

    path = str(tmp_path / "bad.gz")
    arr = np.arange(24).reshape(2, 3, 4)
    if fault == "truncate":
        _write_idx(path, arr, truncate=5)
    else:
        _write_idx(path, arr, dtype_code=0x0D)
    for mod in (tdata, jdata):
        with pytest.raises(ValueError, match=match):
            mod._read_idx(path)


def test_real_mnist_without_its_files_raises(tmp_path):
    with pytest.raises(RuntimeError, match="missing"):
        tdata.real_mnist("train", cache_dir=str(tmp_path), download=False)
    with pytest.raises(ValueError, match="split"):
        tdata.real_mnist("valid", cache_dir=str(tmp_path), download=False)


def test_load_mnist_policy_matches_jax(tmp_path, monkeypatch):
    from torchmpi_tpu.utils import data as jdata

    monkeypatch.setenv("TORCHMPI_TPU_DATA", str(tmp_path))
    assert tdata.mnist_cache_dir() == jdata.mnist_cache_dir() == str(tmp_path)
    _fake_mnist(tmp_path)
    for split, prefer, limit in [("train", "auto", 0), ("test", "real", 3),
                                 ("train", "synthetic", 100),
                                 ("test", "synthetic", 0)]:
        a, src_a = tdata.load_mnist(split, prefer=prefer, limit=limit)
        b, src_b = jdata.load_mnist(split, prefer=prefer, limit=limit)
        assert src_a == src_b == ("synthetic" if prefer == "synthetic"
                                  else "real")
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)
    with pytest.raises(ValueError, match="prefer"):
        tdata.load_mnist(prefer="maybe")
    with pytest.raises(ValueError, match="limit"):
        tdata.load_mnist(prefer="synthetic", limit=-1)


def test_resume_at_continues_the_epochs():
    ds = tdata.synthetic_mnist(n=48, image_shape=(2,))

    def batches(it, epochs):
        return [y.tolist() for _ in range(epochs) for _, y in it]

    whole = batches(tdata.ShardedIterator(ds, 8, 2, seed=4), 3)
    for step in (0, 4, 6, 13):
        it, done = tdata.resume_at(tdata.ShardedIterator(ds, 8, 2, seed=4),
                                   step)
        assert done == step // 6
        assert batches(it, 3 - done) == whole[step:]


@pytest.mark.parametrize("walk", ["flatten", "unflatten", "tree_map",
                                  "flatten_with_paths"])
def test_tree_walks_leave_no_cycle_holding_the_leaves(walk):
    """The tree walks free their leaves when the caller drops them, with
    the garbage collector off: a recursive closure would be a reference
    cycle keeping every leaf alive until the collector runs (an Adam train
    step at Llama-3-8B width left 48 GB on the card that way)."""
    import gc
    import weakref

    from torchmpi_tpu_torch.utils import tree as ttree

    gc.collect()
    gc.disable()
    try:
        leaf = torch.ones(3)
        ref = weakref.ref(leaf)
        tree = {"a": [leaf, None, (torch.zeros(1),)], "b": {"c": 1.0}}
        if walk == "flatten":
            out = ttree.flatten(tree)
        elif walk == "unflatten":
            lv, td = ttree.flatten(tree)
            out = ttree.unflatten(td, lv)
        elif walk == "tree_map":
            out = ttree.tree_map(lambda x: x, tree)
        else:
            out = ttree.flatten_with_paths(tree)
        assert out
        del leaf, tree, out
        if walk == "unflatten":
            del lv, td
        assert ref() is None
    finally:
        gc.enable()
