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
