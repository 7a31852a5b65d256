"""The port's ``AllReduceSGDEngine`` against the JAX package's.

Reference: the JAX engine in ``compiled`` mode with
``use_pallas_collectives`` on, on a 2-device sub-mesh of the virtual CPU
mesh (its ring kernels in interpret mode), ResNet-18 at width 0.125 on
33x33 images, 4 images per rank, lr 0.1, 3 steps.  The port runs the same
3 steps in two processes over gloo (one pool of 2 spawned ranks for the
module), from the same converted parameters and the same batches, in
``compiled`` mode (the ring path) and in ``eager_sync`` mode.  The
small-message cutoff is 16,384 elements in both, so four leaves ring on
their own and the rest pack into the tail bucket: 5 rings a step.

Tolerance: both sides compute the forward and backward in f32 with other
summation orders (XLA's and PyTorch's convolutions); at p = 2 the ring sums
a + b alike in any order.  Each step's loss must agree within 1e-4
relative and every final parameter within 1e-4 of the largest magnitude
of its leaf, after three updates.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torchmpi_tpu_torch.runtime import config as tconfig

DEPTH, WIDTH, IMAGE, PER_RANK, STEPS, LR, CUTOFF = 18, 0.125, 33, 4, 3, 0.1, 16384
RTOL = 1e-4


def _dataset():
    from torchmpi_tpu_torch.utils.data import synthetic_mnist

    return synthetic_mnist(n=2 * PER_RANK * STEPS, n_classes=10, seed=3,
                           image_shape=(IMAGE, IMAGE, 3))


@pytest.fixture(scope="module")
def reference():
    """The JAX engine's losses per step and final parameters."""
    import jax

    import torchmpi_tpu as mpi
    from torchmpi_tpu.engine import AllReduceSGDEngine
    from torchmpi_tpu.models import resnet as jr
    from torchmpi_tpu.runtime import config as jconfig
    from torchmpi_tpu.utils import data as jdata

    if mpi.started():
        mpi.stop()
    jconfig.reset(use_pallas_collectives=True, small_allreduce_size_gpu=CUTOFF)
    mpi.start(with_tpu=False, devices=jax.devices()[:2])
    try:
        cfg = jr.config(depth=DEPTH, n_classes=10, width_multiplier=WIDTH)
        params, _ = jr.init(jax.random.PRNGKey(5), cfg)
        init = jax.tree.map(np.asarray, params)
        ds = jdata.synthetic_mnist(n=2 * PER_RANK * STEPS, n_classes=10,
                                   seed=3, image_shape=(IMAGE, IMAGE, 3))
        it = jdata.ShardedIterator(ds, global_batch=2 * PER_RANK,
                                   num_shards=2, shuffle=False)
        losses = []
        eng = AllReduceSGDEngine(
            jr.make_loss_fn(cfg), lr=LR, comm=mpi.stack.world(),
            mode="compiled",
            hooks={"on_update": lambda s: losses.append(float(s["loss"]))})
        state = eng.train(params, it, epochs=1)
        leaves = jax.tree.leaves(state["params"])
        n_rings = (sum(leaf.size >= CUTOFF for leaf in leaves)
                   + len({leaf.dtype for leaf in leaves if leaf.size < CUTOFF}))
        return {"init": init, "losses": losses, "x": ds.x,
                "params": jax.tree.map(np.asarray, state["params"]),
                "n_rings": n_rings}
    finally:
        mpi.stop()
        jconfig.reset()


def _setup_cpu():
    from torchmpi_tpu_torch.runtime import lifecycle

    lifecycle.start(device="cpu")


def _engine_job(mode, init, rings_on):
    """One rank's 3 steps; returns losses, final leaves, rings per step and
    the kernel launch count."""
    from torchmpi_tpu_torch.collectives import cuda_ring
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import resnet as tr
    from torchmpi_tpu_torch.utils import tree as ttree
    from torchmpi_tpu_torch.utils.data import ShardedIterator

    tconfig.reset(use_pallas_collectives=rings_on,
                  small_allreduce_size_gpu=CUTOFF)
    calls = [0]
    ring = cuda_ring.inner_ring_allreduce

    def counted(*args, **kwargs):
        calls[0] += 1
        return ring(*args, **kwargs)

    cuda_ring.inner_ring_allreduce = counted
    try:
        cfg = tr.config(depth=DEPTH, n_classes=10, width_multiplier=WIDTH)
        params = tr.from_jax_params(init, device="cpu")
        it = ShardedIterator(_dataset(), global_batch=2 * PER_RANK,
                             num_shards=2, shuffle=False)
        losses, per_step = [], []

        def on_update(state):
            losses.append(float(state["loss"]))
            per_step.append(calls[0])
            calls[0] = 0

        eng = AllReduceSGDEngine(tr.make_loss_fn(cfg), lr=LR, mode=mode,
                                 hooks={"on_update": on_update})
        state = eng.train(params, it, epochs=1)
        leaves = [leaf.numpy() for leaf in ttree.leaves(state["params"])]
        return {"losses": losses, "leaves": leaves, "rings": per_step,
                "launches": cuda_ring.ring_allreduce_launches}
    finally:
        cuda_ring.inner_ring_allreduce = ring
        tconfig.reset()


@pytest.fixture(scope="module")
def pool():
    from torchmpi_tpu_torch.runtime import launch

    pl = launch.Pool(2, setup=_setup_cpu)
    yield pl
    pl.close()


def _check_against(reference, res):
    import jax

    np.testing.assert_allclose(res["losses"], reference["losses"], rtol=RTOL)
    want = jax.tree.leaves(reference["params"])
    assert len(want) == len(res["leaves"])
    for w, g in zip(want, res["leaves"]):
        w = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w
        scale = max(float(np.abs(w).max()), 1e-12)
        assert float(np.abs(g - w).max()) / scale <= RTOL


@pytest.mark.parametrize("mode,rings_on", [("compiled", True),
                                           ("eager_sync", False)])
def test_three_steps_match_the_jax_ring_engine(reference, pool, mode,
                                               rings_on):
    res = pool.run(_engine_job, mode, reference["init"], rings_on)
    for r in res:
        _check_against(reference, r)
    # Replicas stay identical, bit for bit.
    for a, b in zip(res[0]["leaves"], res[1]["leaves"]):
        np.testing.assert_array_equal(a, b)
    # The CPU form rings the same leaves as the JAX step and launches no
    # kernel.
    want = [reference["n_rings"]] * STEPS if mode == "compiled" else [0] * STEPS
    assert res[0]["rings"] == want
    assert res[0]["launches"] == 0


def test_same_batches_as_jax(reference):
    np.testing.assert_array_equal(_dataset().x, reference["x"])


def test_compiled_without_rings_raises_for_batch_norm():
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine

    tconfig.reset(use_pallas_collectives=False)
    try:
        eng = AllReduceSGDEngine(lambda p, b: None, mode="compiled")
        with pytest.raises(NotImplementedError, match="cross-rank statistics"):
            eng.train({"w": torch.zeros(2)}, [])
    finally:
        tconfig.reset()


@pytest.mark.parametrize("kwargs", [{"mode": "eager_async"},
                                    {"optimizer": object()}, {"zero1": True},
                                    {"accum_steps": 2}])
def test_later_slice_options_raise(kwargs):
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine

    with pytest.raises(NotImplementedError, match="later slice"):
        AllReduceSGDEngine(lambda p, b: None, **kwargs)


def test_sgd_update_is_p_minus_lr_g():
    from torchmpi_tpu_torch.engine import sgd_update

    p = {"a": torch.tensor([1.0, 2.0]), "b": [torch.tensor([3.0])]}
    g = {"a": torch.tensor([0.5, -1.0]), "b": [torch.tensor([2.0])]}
    out = sgd_update(p, g, 0.5)
    assert out["a"].tolist() == [0.75, 2.5] and out["b"][0].tolist() == [2.0]
