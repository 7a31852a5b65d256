"""The engine's options in the port against the JAX package's engine:
``optimizer=`` (Adam), ``accum_steps``, ``zero1`` and ``compiled`` mode with
``use_pallas_collectives`` off (GSPMD over the global batch, with
cross-rank batch norm), the ResNet example's global-batch statistics, and
zero1 checkpoints.

Reference: the JAX engine in ``compiled`` mode on a p-device sub-mesh of
the virtual CPU mesh (its ring kernels in interpret mode where the knob is
on), from the same converted parameters and batches.  The port runs the
same steps in one spawned gloo pool of 2 ranks for the file, and one of 4
for zero1, where the sharding rule differs (the MLP's ``(10,)`` bias is
replicated at p = 4).

* The MNIST MLP at hidden (64, 32), 8 examples per rank, 5 steps of
  ``optax.adam(1e-2)`` against ``optim.adam(1e-2)``, with the small-message
  cutoff at 2,048 elements (3 rings a step on the ring path).  Tolerance:
  losses rtol 1e-5; parameters rtol 1e-5 with an absolute floor of 1e-3 of
  the learning rate.  Both sides sum f32 products in other orders (XLA and
  PyTorch), and Adam divides each element's update by that element's own
  gradient scale: an element whose gradient nearly cancels carries its
  relative summation error into its update at full size, up to lr times
  that error a step (measured: 1.8e-4 of lr in one element of w0 after 5
  steps, the rest below 1e-5 relative).  ``tests/test_torch_optim.py`` holds the update alone, on the same
  gradients, at 1e-6.
* ``accum_steps=4`` against JAX's, at the same tolerance, and against the
  port's own unaccumulated run at JAX's test tolerance (rtol 2e-4, atol
  2e-5, ``tests/test_nn_engine.py``).
* zero1 against JAX's zero1 and the port's replicated Adam (rtol 2e-5,
  atol 2e-6, JAX's test tolerance), its moments' row blocks, and the
  state gathered back equal to JAX's.  The moments are EMAs of the
  gradients and their squares, so they carry the same per-element
  summation differences: rtol 1e-4 with an absolute floor of 1e-4 of each
  leaf's largest magnitude.
* ResNet-18 at width 0.125 on 33x33 images, 4 per rank, 3 SGD steps at lr
  0.1 in GSPMD mode, against the JAX GSPMD step: losses and parameters
  within 1e-4 (``tests/test_torch_engine.py``'s tolerance); the gradient of
  one step against ``jax.grad`` over the global batch; ``update_stats``
  with ``comm`` against JAX's on the global batch, every rank bit for bit
  equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

HIDDEN, PER_RANK, STEPS, LR, CUTOFF = (64, 32), 8, 5, 1e-2, 2048
RTOL = 1e-5
ADAM_ATOL = 1e-3 * LR
STATE_ATOL = 1e-4
ACCUM_RTOL, ACCUM_ATOL = 2e-4, 2e-5          # JAX test_nn_engine.py
ZERO1_RTOL, ZERO1_ATOL = 2e-5, 2e-6          # JAX test_nn_engine.py
DEPTH, WIDTH, IMAGE, RN_PER_RANK, RN_STEPS, RN_LR = 18, 0.125, 33, 4, 3, 0.1
RN_RTOL = 1e-4


# ------------------------------------------------------------------ pools

def _setup():
    """A rank of a pool: the process group is up, and the runtime adopts
    it (so a job may stop and start the runtime, as the example does)."""
    import os

    import torch.distributed as dist

    from torchmpi_tpu_torch.runtime import lifecycle

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    lifecycle.start(device="cpu")


@pytest.fixture(scope="module")
def pool():
    from torchmpi_tpu_torch.runtime import launch

    pl = launch.Pool(2, setup=_setup)
    yield pl
    pl.close()


@pytest.fixture(scope="module")
def pool4():
    from torchmpi_tpu_torch.runtime import launch

    pl = launch.Pool(4, setup=_setup)
    yield pl
    pl.close()


def _pool(p, pool, pool4):
    return pool if p == 2 else pool4


# --------------------------------------------------------------- the MLP

def _mlp_dataset(p):
    from torchmpi_tpu_torch.utils.data import synthetic_mnist

    return synthetic_mnist(n=p * PER_RANK * STEPS, seed=5)


@pytest.fixture(scope="module")
def mlp_init():
    import jax

    from torchmpi_tpu.models import mlp as jmlp

    return jax.tree.map(np.asarray,
                        jmlp.init(jax.random.PRNGKey(0), hidden=HIDDEN))


def _jax_mlp(init, p, rings, accum=1, zero1=False):
    """The JAX engine's losses, parameters and (whole) Adam state."""
    import jax
    import jax.numpy as jnp
    import optax

    import torchmpi_tpu as mpi
    from torchmpi_tpu.engine import AllReduceSGDEngine
    from torchmpi_tpu.models import mlp as jmlp
    from torchmpi_tpu.runtime import config as jconfig
    from torchmpi_tpu.utils import data as jdata

    if mpi.started():
        mpi.stop()
    jconfig.reset(use_pallas_collectives=rings,
                  small_allreduce_size_gpu=CUTOFF)
    mpi.start(with_tpu=False, devices=jax.devices()[:p])
    try:
        ds = jdata.synthetic_mnist(n=p * PER_RANK * STEPS, seed=5)
        it = jdata.ShardedIterator(ds, global_batch=p * PER_RANK,
                                   num_shards=p, shuffle=False)
        losses = []
        eng = AllReduceSGDEngine(
            jmlp.loss_fn, optimizer=optax.adam(LR), comm=mpi.stack.world(),
            mode="compiled", accum_steps=accum, zero1=zero1,
            hooks={"on_update": lambda s: losses.append(float(s["loss"]))})
        st = eng.train(jax.tree.map(jnp.asarray, init), it)
        return {"losses": losses,
                "params": jax.tree.map(np.asarray, st["params"]),
                "opt_state": [np.asarray(x) for x in
                              jax.tree.leaves(st["opt_state"])]}
    finally:
        mpi.stop()
        jconfig.reset()


@pytest.fixture(scope="module")
def jax_runs(mlp_init):
    done = {}

    def get(p, rings, accum=1, zero1=False):
        key = (p, rings, accum, zero1)
        if key not in done:
            done[key] = _jax_mlp(mlp_init, p, rings, accum, zero1)
        return done[key]

    return get


def _mlp_job(init, rings, accum, zero1, optimizer="adam"):
    """One rank's 5 steps: losses, parameters, the state's leaf shapes and
    the whole state gathered back, rings a step."""
    from torchmpi_tpu_torch import optim
    from torchmpi_tpu_torch.collectives import cuda_ring
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import mlp
    from torchmpi_tpu_torch.runtime import config
    from torchmpi_tpu_torch.utils import tree
    from torchmpi_tpu_torch.utils.data import ShardedIterator

    import torch.distributed as dist

    p = dist.get_world_size()
    config.reset(use_pallas_collectives=rings,
                 small_allreduce_size_gpu=CUTOFF)
    calls = [0]
    ring = cuda_ring.inner_ring_allreduce

    def counted(*args, **kwargs):
        calls[0] += 1
        return ring(*args, **kwargs)

    cuda_ring.inner_ring_allreduce = counted
    try:
        losses, rings_per_step = [], []

        def on_update(state):
            losses.append(float(state["loss"]))
            rings_per_step.append(calls[0])
            calls[0] = 0

        opt = optim.adam(LR) if optimizer == "adam" else None
        eng = AllReduceSGDEngine(mlp.loss_fn, optimizer=opt, mode="compiled",
                                 accum_steps=accum, zero1=zero1,
                                 hooks={"on_update": on_update})
        it = ShardedIterator(_mlp_dataset(p), global_batch=p * PER_RANK,
                             num_shards=p, shuffle=False)
        st = eng.train(mlp.from_jax_params(init, device="cpu"), it)
        full = eng.full_opt_state(st["opt_state"], st["params"])
        return {"losses": losses, "rings": rings_per_step,
                "params": {k: v.numpy() for k, v in st["params"].items()},
                "state_shapes": [tuple(t.shape)
                                 for t in tree.leaves(st["opt_state"])],
                "full_state": [t.numpy() for t in tree.leaves(full)]}
    finally:
        cuda_ring.inner_ring_allreduce = ring
        config.reset()


@pytest.fixture(scope="module")
def port_runs(mlp_init, pool, pool4):
    done = {}

    def get(p, rings, accum=1, zero1=False):
        key = (p, rings, accum, zero1)
        if key not in done:
            done[key] = _pool(p, pool, pool4).run(_mlp_job, mlp_init, rings,
                                                  accum, zero1)
        return done[key]

    return get


def _close_params(got, want, rtol, atol_frac=None, atol=None):
    for k, w in want.items():
        a = atol if atol is not None else atol_frac * float(np.abs(w).max())
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=a, err_msg=k)


def _replicas_equal(res):
    for r in res[1:]:
        for k, v in res[0]["params"].items():
            np.testing.assert_array_equal(r["params"][k], v)


@pytest.mark.parametrize("rings", [True, False], ids=["rings", "gspmd"])
def test_adam_matches_jax(jax_runs, port_runs, rings):
    want, res = jax_runs(2, rings), port_runs(2, rings)
    for r in res:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=RTOL)
        _close_params(r["params"], want["params"], RTOL, atol=ADAM_ATOL)
    _replicas_equal(res)
    assert res[0]["rings"] == [3 if rings else 0] * STEPS
    for got, w in zip(res[0]["full_state"], want["opt_state"]):
        np.testing.assert_allclose(got, w, rtol=1e-4,
                                   atol=STATE_ATOL * float(np.abs(w).max()))


@pytest.mark.parametrize("rings", [True, False], ids=["rings", "gspmd"])
def test_accum_steps_matches_jax(jax_runs, port_runs, rings):
    want, res = jax_runs(2, rings, accum=4), port_runs(2, rings, accum=4)
    for r in res:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=RTOL)
        _close_params(r["params"], want["params"], RTOL, atol=ADAM_ATOL)
    _replicas_equal(res)
    assert res[0]["rings"] == [3 if rings else 0] * STEPS


@pytest.mark.parametrize("rings", [True, False], ids=["rings", "gspmd"])
def test_accum_steps_equals_one_step_per_batch(port_runs, rings):
    one, four = port_runs(2, rings), port_runs(2, rings, accum=4)
    _close_params(four[0]["params"], one[0]["params"], ACCUM_RTOL,
                  atol=ACCUM_ATOL)


@pytest.mark.parametrize("p", [2, 4])
def test_zero1_matches_jax_and_replicated_adam(jax_runs, port_runs, p):
    want, res = jax_runs(p, False, zero1=True), port_runs(p, False,
                                                          zero1=True)
    repl = port_runs(p, False)
    for r in res:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=RTOL)
        _close_params(r["params"], want["params"], RTOL, atol=ADAM_ATOL)
        _close_params(r["params"], repl[0]["params"], ZERO1_RTOL,
                      atol=ZERO1_ATOL)
    _replicas_equal(res)
    assert res[0]["rings"] == [0] * STEPS
    # The gathered state is the whole state, on every rank alike.
    for r in res:
        for got, w, mine in zip(r["full_state"], want["opt_state"],
                                res[0]["full_state"]):
            assert got.shape == w.shape
            np.testing.assert_allclose(got, w, rtol=1e-4,
                                       atol=STATE_ATOL * float(
                                           np.abs(w).max()))
            np.testing.assert_array_equal(got, mine)


@pytest.mark.parametrize("p", [2, 4])
def test_zero1_moments_hold_a_row_block(port_runs, p):
    """Each rank's moments hold 1/p of a leaf whose leading dimension p
    divides (and is at least p); the count and the rest are whole."""
    res = port_runs(p, False, zero1=True)
    whole = port_runs(p, False)[0]["state_shapes"]
    for r in res:
        for got, full in zip(r["state_shapes"], whole):
            if len(full) >= 1 and full[0] >= p and full[0] % p == 0:
                assert got == (full[0] // p, *full[1:])
            else:
                assert got == full
    # At p = 4 the (10,) bias of the last layer stays whole, at 2 it splits.
    sizes = dict(zip(whole, res[0]["state_shapes"]))
    assert sizes[(10,)] == ((10,) if p == 4 else (5,))


@pytest.mark.parametrize("kwargs,match", [
    ({"mode": "eager_sync", "zero1": True}, "compiled"),
    ({"zero1": True}, "optax optimizer"),
    ({"accum_steps": 0}, "accum_steps"),
    ({"mode": "eager_async", "accum_steps": 2}, "compiled"),
    ({"mode": "bogus"}, "mode"),
])
def test_constructor_raises_as_jax_does(kwargs, match):
    from torchmpi_tpu.engine import AllReduceSGDEngine as JaxEngine

    from torchmpi_tpu_torch.engine import AllReduceSGDEngine

    with pytest.raises(ValueError, match=match) as jax_err:
        JaxEngine(lambda p, b: None, **kwargs)
    with pytest.raises(ValueError, match=match) as port_err:
        AllReduceSGDEngine(lambda p, b: None, **kwargs)
    assert str(port_err.value) == str(jax_err.value)


def _uneven_accum_job(rings):
    from torchmpi_tpu_torch import optim
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import mlp
    from torchmpi_tpu_torch.runtime import config
    from torchmpi_tpu_torch.utils.data import ShardedIterator

    config.reset(use_pallas_collectives=rings)
    try:
        it = ShardedIterator(_mlp_dataset(2), global_batch=12, num_shards=2,
                             shuffle=False)
        eng = AllReduceSGDEngine(mlp.loss_fn, optimizer=optim.adam(LR),
                                 accum_steps=4)
        try:
            eng.train(mlp.init(0, hidden=HIDDEN, device="cpu"), it)
        except ValueError as e:
            return str(e)
        return None
    finally:
        config.reset()


@pytest.mark.parametrize("rings,msg", [
    (True, "per-replica batch 6 must be divisible by accum_steps = 4"),
    (False, "global batch 12 must be divisible by accum_steps * replicas "
            "= 4 * 2")])
def test_accum_steps_batch_must_divide(pool, rings, msg):
    assert pool.run(_uneven_accum_job, rings) == [msg, msg]


# ------------------------------------------------------------ the ResNet

def _rn_dataset():
    from torchmpi_tpu_torch.utils.data import synthetic_mnist

    return synthetic_mnist(n=2 * RN_PER_RANK * RN_STEPS, n_classes=10,
                           seed=3, image_shape=(IMAGE, IMAGE, 3))


@pytest.fixture(scope="module")
def rn_reference():
    """The JAX engine's GSPMD run (knob off), the gradient of the global
    batch of step 1 and ``update_stats`` on it."""
    import jax
    import jax.numpy as jnp

    import torchmpi_tpu as mpi
    from torchmpi_tpu.engine import AllReduceSGDEngine
    from torchmpi_tpu.models import resnet as jr
    from torchmpi_tpu.runtime import config as jconfig
    from torchmpi_tpu.utils import data as jdata

    if mpi.started():
        mpi.stop()
    jconfig.reset(use_pallas_collectives=False)
    mpi.start(with_tpu=False, devices=jax.devices()[:2])
    try:
        cfg = jr.config(depth=DEPTH, n_classes=10, width_multiplier=WIDTH)
        params, bn_state = jr.init(jax.random.PRNGKey(5), cfg)
        init = jax.tree.map(np.asarray, params)
        ds = jdata.synthetic_mnist(n=2 * RN_PER_RANK * RN_STEPS,
                                   n_classes=10, seed=3,
                                   image_shape=(IMAGE, IMAGE, 3))
        x0 = ds.x[:2 * RN_PER_RANK]
        y0 = ds.y[:2 * RN_PER_RANK]
        loss0, grads0 = jax.value_and_grad(jr.make_loss_fn(cfg))(
            params, (jnp.asarray(x0), jnp.asarray(y0)))
        stats = jr.make_update_stats_fn(cfg)(params, bn_state,
                                             jnp.asarray(x0))
        it = jdata.ShardedIterator(ds, global_batch=2 * RN_PER_RANK,
                                   num_shards=2, shuffle=False)
        losses = []
        eng = AllReduceSGDEngine(
            jr.make_loss_fn(cfg), lr=RN_LR, comm=mpi.stack.world(),
            mode="compiled",
            hooks={"on_update": lambda s: losses.append(float(s["loss"]))})
        st = eng.train(params, it, epochs=1)
        return {"init": init, "state": jax.tree.map(np.asarray, bn_state),
                "losses": losses,
                "params": jax.tree.leaves(jax.tree.map(np.asarray,
                                                       st["params"])),
                "loss0": float(loss0),
                "grads0": jax.tree.leaves(jax.tree.map(np.asarray, grads0)),
                "stats": jax.tree.leaves(jax.tree.map(np.asarray, stats))}
    finally:
        mpi.stop()
        jconfig.reset()


def _rn_job(init, jax_state):
    """One rank's GSPMD steps, the synced gradient of step 1's global
    batch, and ``update_stats`` over it with and without ``comm``."""
    from torchmpi_tpu_torch.collectives import cuda_ring
    from torchmpi_tpu_torch.collectives import gspmd
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.engine.sgdengine import value_and_grad
    from torchmpi_tpu_torch.models import resnet as tr
    from torchmpi_tpu_torch.runtime import config
    from torchmpi_tpu_torch.runtime.communicator import stack
    from torchmpi_tpu_torch.utils import tree
    from torchmpi_tpu_torch.utils.data import ShardedIterator

    config.reset(use_pallas_collectives=False)
    try:
        comm = stack.current()
        r = comm.rank
        cfg = tr.config(depth=DEPTH, n_classes=10, width_multiplier=WIDTH)
        params = tr.from_jax_params(init, device="cpu")
        bn_state = tr.from_jax_state(jax_state, device="cpu")
        ds = _rn_dataset()
        x = torch.from_numpy(ds.x[r * RN_PER_RANK:(r + 1) * RN_PER_RANK])
        y = torch.from_numpy(ds.y[r * RN_PER_RANK:(r + 1) * RN_PER_RANK])
        with gspmd.global_batch(comm):
            loss0, g = value_and_grad(tr.make_loss_fn(cfg), params,
                                      (x, y.long()))
        grads0 = gspmd.sync_grads(g, comm)
        loss0 = float(gspmd.mean_over_ranks(loss0, comm))
        stats = tr.make_update_stats_fn(cfg, comm=comm)(params, bn_state, x)
        own = tr.make_update_stats_fn(cfg)(params, bn_state, x)

        launched = cuda_ring.ring_allreduce_launches
        losses = []
        eng = AllReduceSGDEngine(
            tr.make_loss_fn(cfg), lr=RN_LR, mode="compiled",
            hooks={"on_update": lambda s: losses.append(float(s["loss"]))})
        it = ShardedIterator(ds, global_batch=2 * RN_PER_RANK, num_shards=2,
                             shuffle=False)
        st = eng.train(params, it, epochs=1)
        return {"losses": losses,
                "params": [t.numpy() for t in tree.leaves(st["params"])],
                "loss0": loss0,
                "grads0": [t.numpy() for t in tree.leaves(grads0)],
                "stats": [t.numpy() for t in tree.leaves(stats)],
                "own_stats": [t.numpy() for t in tree.leaves(own)],
                "ring_launches": cuda_ring.ring_allreduce_launches - launched}
    finally:
        config.reset()


@pytest.fixture(scope="module")
def rn_runs(rn_reference, pool):
    return pool.run(_rn_job, rn_reference["init"], rn_reference["state"])


def _rn_close(got, want, what):
    want = want.transpose(3, 2, 0, 1) if want.ndim == 4 else want
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max()) / scale
    assert err <= RN_RTOL, f"{what}: relative error {err:.3g}"


def test_resnet_gspmd_steps_match_jax(rn_reference, rn_runs):
    for r in rn_runs:
        np.testing.assert_allclose(r["losses"], rn_reference["losses"],
                                   rtol=RN_RTOL)
        for i, (g, w) in enumerate(zip(r["params"], rn_reference["params"])):
            _rn_close(g, w, f"leaf {i}")
        assert r["ring_launches"] == 0
    for a, b in zip(rn_runs[0]["params"], rn_runs[1]["params"]):
        np.testing.assert_array_equal(a, b)


def test_gspmd_gradient_is_the_global_batch_gradient(rn_reference, rn_runs):
    """The backward of the cross-rank BN mean is the ranks' mean of the
    incoming gradient: the synced gradient is JAX's of the global batch
    (a sum in place of the mean would give p times the BN part)."""
    for r in rn_runs:
        assert abs(r["loss0"] - rn_reference["loss0"]) <= (
            RN_RTOL * abs(rn_reference["loss0"]))
        scale = max(float(np.abs(w).max()) for w in rn_reference["grads0"])
        for i, (g, w) in enumerate(zip(r["grads0"], rn_reference["grads0"])):
            w = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w
            err = float(np.abs(g - w).max()) / scale
            assert err <= RN_RTOL, f"grad {i}: {err:.3g}"


def test_update_stats_with_comm_folds_the_global_batch(rn_reference,
                                                        rn_runs):
    """The repaired fold: every rank's running statistics are JAX's
    ``update_stats`` over the global batch, and equal bit for bit across
    the ranks; this rank's rows alone give other statistics on each rank
    (the fold before the repair)."""
    for r in rn_runs:
        for i, (g, w) in enumerate(zip(r["stats"], rn_reference["stats"])):
            scale = max(float(np.abs(w).max()), 1e-12)
            assert float(np.abs(g - w).max()) / scale <= RN_RTOL, i
    for a, b in zip(rn_runs[0]["stats"], rn_runs[1]["stats"]):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in
               zip(rn_runs[0]["own_stats"], rn_runs[1]["own_stats"]))


def _gradcheck_job():
    """gradcheck in f64 of batch norm's statistics through the cross-rank
    mean over a communicator of this rank alone (p = 1)."""
    import torch.distributed as dist

    from torchmpi_tpu_torch.collectives import gspmd
    from torchmpi_tpu_torch.runtime.communicator import Communicator

    groups = [dist.new_group([q]) for q in range(dist.get_world_size())]
    me = dist.get_rank()
    alone = Communicator([me], my_rank=me)
    alone._group, alone._group_made = groups[me], True
    x = torch.randn(3, 4, 2, 2, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(me),
                    requires_grad=True)

    def stats(x):
        mean = x.mean(dim=(0, 2, 3))
        msq = (x * x).mean(dim=(0, 2, 3))
        mean, msq = gspmd.mean_over_ranks(torch.stack([mean, msq]),
                                          alone).unbind(0)
        return mean, torch.clamp(msq - mean * mean, min=0.0)

    return torch.autograd.gradcheck(stats, (x,))


def test_cross_rank_mean_gradcheck_at_p1(pool):
    assert pool.run(_gradcheck_job) == [True, True]


# ------------------------------------------------------- the ResNet example

def _resnet_example_job(rings):
    from torchmpi_tpu_torch.examples import train_resnet
    from torchmpi_tpu_torch.runtime import config, lifecycle

    config.reset(use_pallas_collectives=rings)
    lifecycle.stop()                    # the example starts its own
    try:
        return train_resnet.run(train_resnet.parse_args(
            ["--device", "cpu", "--depth", "18", "--width", "0.125",
             "--image", "16", "--batch", "4", "--steps", "3",
             "--stats-every", "1"]))
    finally:
        lifecycle.start(device="cpu")
        config.reset()


@pytest.mark.parametrize("rings", [False, True], ids=["gspmd", "rings"])
def test_resnet_example_ranks_share_their_running_statistics(pool, rings):
    """The example's default compiled run is GSPMD; in either form its
    stats hook folds the global batch, so both ranks end with the same
    running statistics (and so the same evaluation)."""
    res = pool.run(_resnet_example_job, rings)
    assert all(r["steps"] == 3 and np.isfinite(r["loss"]) for r in res)
    for a, b in zip(res[0]["bn_stats"], res[1]["bn_stats"]):
        np.testing.assert_array_equal(a, b)
    assert res[0]["accuracy"] == res[1]["accuracy"]


# ------------------------------------------------------- zero1 checkpoints

def _ckpt_job(ckpt_dir, save_zero1, resume_zero1):
    """4 steps under ``save_zero1`` saving at step 2 (the hooks gather the
    state), then steps 3-4 resumed from that save under ``resume_zero1``,
    beside the continuous run."""
    import torch.distributed as dist

    from torchmpi_tpu_torch import optim
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import mlp
    from torchmpi_tpu_torch.utils import checkpoint as ckpt
    from torchmpi_tpu_torch.utils import tree
    from torchmpi_tpu_torch.utils.data import ShardedIterator, resume_at

    def it():
        return ShardedIterator(_mlp_dataset(2), global_batch=2 * PER_RANK,
                               num_shards=2, shuffle=False)

    def engine(zero1, hooks=None):
        return AllReduceSGDEngine(mlp.loss_fn, optimizer=optim.adam(LR),
                                  zero1=zero1, hooks=hooks or {})

    def fresh():
        return mlp.init(0, hidden=HIDDEN, device="cpu")

    cont = engine(save_zero1).train(fresh(), it())
    mgr = ckpt.CheckpointManager(ckpt_dir, save_interval=2)
    hooks = ckpt.checkpoint_hooks(mgr)
    saver = hooks["on_update"]

    def on_update(state):
        saver(state)
        if state["t"] == 2:
            raise _Stop()

    try:
        engine(save_zero1, {"on_update": on_update}).train(fresh(), it())
    except _Stop:
        pass
    dist.barrier()
    params = fresh()
    template = optim.adam(LR).init(params)          # whole, on the host
    params, opt_state, t0 = ckpt.resume_or_init(mgr, params, template)
    source, _ = resume_at(it(), t0)
    eng = engine(resume_zero1)
    st = eng.train(params, source, opt_state=opt_state, start_step=t0)
    full = eng.full_opt_state(st["opt_state"], st["params"])
    cont_full = tree.leaves(cont["engine"].full_opt_state(
        cont["opt_state"], cont["params"]))
    return {"t0": t0,
            "params_equal": all(torch.equal(st["params"][k], v)
                                for k, v in cont["params"].items()),
            "state_equal": all(torch.equal(a, b) for a, b in
                               zip(tree.leaves(full), cont_full)),
            "max_param_diff": max(float((st["params"][k] - v).abs().max())
                                  for k, v in cont["params"].items())}


class _Stop(Exception):
    pass


@pytest.mark.parametrize("save_zero1,resume_zero1", [
    (True, True), (True, False), (False, True)],
    ids=["zero1-to-zero1", "zero1-to-replicated", "replicated-to-zero1"])
def test_zero1_checkpoint_resumes(pool, tmp_path, save_zero1, resume_zero1):
    """The hooks save the whole state under zero1, so a checkpoint restores
    with zero1 or without it; under zero1 the resumed run equals the
    continuous one bit for bit.  Across the two forms, the parameters
    agree within zero1's tolerance against replicated Adam."""
    res = pool.run(_ckpt_job, str(tmp_path), save_zero1, resume_zero1)
    for r in res:
        assert r["t0"] == 2
        if save_zero1 == resume_zero1:
            assert r["params_equal"] and r["state_equal"]
        else:
            assert r["max_param_diff"] <= ZERO1_ATOL
