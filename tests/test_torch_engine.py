"""The port's ``AllReduceSGDEngine`` against the JAX package's.

Reference: the JAX engine in ``compiled`` mode with
``use_pallas_collectives`` on, on a 2-device sub-mesh of the virtual CPU
mesh (its ring kernels in interpret mode), ResNet-18 at width 0.125 on
33x33 images, 4 images per rank, lr 0.1, 3 steps.  The port runs the same
3 steps in two processes over gloo (one pool of 2 spawned ranks for the
module), from the same converted parameters and the same batches, in
``compiled`` mode (the ring path), in ``eager_sync`` mode and in
``eager_async`` mode with both drains (``"ready"``, ``"barrier"``), the
last also with the ring knob on.  The small-message cutoff is 16,384
elements in both, so in ``compiled`` mode four leaves ring on their own and
the rest pack into the tail bucket: 5 rings a step; the eager modes sync
one 32 MB bucket a step, through the ring when the knob is on.
``eager_async`` must equal ``eager_sync`` (same knob) bit for bit: the same
buckets are reduced by the same collective, only the host's order of
dispatch and wait differs.

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

    # Two intra-op threads a rank: the tier-1 run shares the host's cores
    # with other test workers.
    torch.set_num_threads(2)
    lifecycle.start(device="cpu")


def _engine_job(mode, init, rings_on, drain="ready"):
    """One rank's 3 steps; returns losses, final leaves, rings per step,
    the buckets of a step, the blocked seconds of each step (eager_async)
    and the kernel launch count."""
    from torchmpi_tpu_torch.collectives import cuda_ring
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import resnet as tr
    from torchmpi_tpu_torch.utils import tree as ttree
    from torchmpi_tpu_torch.utils.data import ShardedIterator

    from torchmpi_tpu_torch.nn import bucketing

    tconfig.reset(use_pallas_collectives=rings_on,
                  small_allreduce_size_gpu=CUTOFF, engine_async_drain=drain)
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
        losses, per_step, blocked = [], [], []

        def on_update(state):
            losses.append(float(state["loss"]))
            per_step.append(calls[0])
            blocked.append(state.get("blocked_s"))
            calls[0] = 0

        eng = AllReduceSGDEngine(tr.make_loss_fn(cfg), lr=LR, mode=mode,
                                 hooks={"on_update": on_update})
        state = eng.train(params, it, epochs=1)
        leaves = [leaf.numpy() for leaf in ttree.leaves(state["params"])]
        specs = bucketing.plan_ready_order(state["params"]).plan.specs
        return {"losses": losses, "leaves": leaves, "rings": per_step,
                "ring_buckets": sum(sp.total > CUTOFF for sp in specs),
                "blocked_s": blocked,
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


@pytest.fixture(scope="module")
def runs(reference, pool):
    """Each (mode, ring knob, drain)'s per-rank results, run once for the
    module."""
    done = {}

    def get(mode, rings_on, drain="ready"):
        key = (mode, rings_on, drain)
        if key not in done:
            done[key] = pool.run(_engine_job, mode, reference["init"],
                                 rings_on, drain)
        return done[key]

    return get


ENGINE_CASES = [("compiled", True, "ready"), ("eager_sync", False, "ready"),
                ("eager_async", False, "ready"),
                ("eager_async", False, "barrier"),
                ("eager_async", True, "ready")]


@pytest.mark.parametrize("mode,rings_on,drain", ENGINE_CASES,
                         ids=["compiled", "eager_sync", "eager_async-ready",
                              "eager_async-barrier", "eager_async-rings"])
def test_three_steps_match_the_jax_ring_engine(reference, runs, mode,
                                               rings_on, drain):
    res = runs(mode, rings_on, drain)
    for r in res:
        _check_against(reference, r)
    # Replicas stay identical, bit for bit.
    for a, b in zip(res[0]["leaves"], res[1]["leaves"]):
        np.testing.assert_array_equal(a, b)
    # The CPU form rings the same leaves as the JAX step (compiled) or each
    # bucket above the cutoff (the eager modes with the knob on), and
    # launches no kernel.
    if mode == "compiled":
        want = [reference["n_rings"]] * STEPS
    else:
        want = [res[0]["ring_buckets"] if rings_on else 0] * STEPS
    assert res[0]["rings"] == want and (mode == "compiled" or not rings_on
                                        or want[0] >= 1)
    assert res[0]["launches"] == 0
    if mode == "eager_async":
        assert all(b is not None and b >= 0 for b in res[0]["blocked_s"])


@pytest.mark.parametrize("rings_on,drain", [(False, "ready"),
                                            (False, "barrier"),
                                            (True, "ready")])
def test_eager_async_equals_eager_sync_bit_for_bit(runs, rings_on, drain):
    sync = runs("eager_sync", rings_on)
    got = runs("eager_async", rings_on, drain)
    for s_rank, a_rank in zip(sync, got):
        assert s_rank["losses"] == a_rank["losses"]
        for a, b in zip(s_rank["leaves"], a_rank["leaves"]):
            np.testing.assert_array_equal(a, b)


def test_unknown_async_drain_raises():
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine

    tconfig.reset(engine_async_drain="later")
    try:
        eng = AllReduceSGDEngine(lambda p, b: None, mode="eager_async")
        with pytest.raises(ValueError, match="engine_async_drain"):
            eng.train({"w": torch.zeros(2)}, [])
    finally:
        tconfig.reset()


def test_same_batches_as_jax(reference):
    np.testing.assert_array_equal(_dataset().x, reference["x"])


def test_compiled_without_rings_raises_for_batch_norm():
    """Compiled mode with the knob off was refused until cross-rank batch
    norm was ported; it is now GSPMD over the global batch and no longer
    raises (``tests/test_torch_engine_options.py`` holds it against the
    JAX GSPMD step)."""
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine

    tconfig.reset(use_pallas_collectives=False)
    try:
        eng = AllReduceSGDEngine(lambda p, b: None, mode="compiled")
        eng._check_mode()
        assert not eng._rings()
    finally:
        tconfig.reset()


@pytest.mark.parametrize("kwargs", [{"optimizer": object()}, {"zero1": True},
                                    {"accum_steps": 2}])
def test_later_slice_options_raise(kwargs):
    """The options that raised ``NotImplementedError`` until the engine's
    options were ported now construct as in JAX; zero1 without an
    optimizer raises JAX's ``ValueError``."""
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine

    if "zero1" in kwargs:
        with pytest.raises(ValueError, match="optax optimizer"):
            AllReduceSGDEngine(lambda p, b: None, **kwargs)
        return
    eng = AllReduceSGDEngine(lambda p, b: None, **kwargs)
    for key, value in kwargs.items():
        assert getattr(eng, key) is value


def test_sync_frequency_skip_passes_local_grads():
    from torchmpi_tpu_torch import nn as tnn

    tconfig.reset(sync_gradient_frequency=4)
    try:
        grads = {"a": torch.tensor([1.0, -2.0]), "b": [torch.tensor([4.0])]}
        params = {"a": torch.zeros(2), "b": [torch.ones(1)]}
        reg = tnn.async_.register_async_backward(grads, comm=None, step=1)
        assert reg.skipped and reg.handles == []
        assert tnn.async_.synchronize_gradients(reg) is grads
        out = tnn.async_.drain_at_optimizer(reg, params,
                                            lambda p, g: p - 0.5 * g)
        assert out["a"].tolist() == [-0.5, 1.0] and out["b"][0].tolist() == [
            -1.0]
    finally:
        tconfig.reset()


def test_sgd_update_is_p_minus_lr_g():
    from torchmpi_tpu_torch.engine import sgd_update

    p = {"a": torch.tensor([1.0, 2.0]), "b": [torch.tensor([3.0])]}
    g = {"a": torch.tensor([0.5, -1.0]), "b": [torch.tensor([2.0])]}
    out = sgd_update(p, g, 0.5)
    assert out["a"].tolist() == [0.75, 2.5] and out["b"][0].tolist() == [2.0]
