"""The port's input data plane (``torchmpi_tpu_torch/data``) against the
JAX package's: the counterparts of ``tests/test_data_pipeline.py`` at small
sizes, on the CPU.

The host stage is the JAX module's algebra: batch order with and without
workers, exceptions at their slot, abandonment that releases the threads,
bounded memory.  The device stage yields this rank's row of each
rank-major batch (the JAX stage's shard of that rank), with ``wait_s`` and
the staged bytes, and holds at most depth + 2 batches.  ``engine_wrap``
follows the ``data_pipeline`` knob.  The engine's compiled mode gives the
same losses and parameters bit for bit with the pipeline on and off, for
the MLP and for a small ResNet (the ring path), on 2 gloo ranks; the MLP's
losses also equal the JAX engine's through its pipeline to rtol 1e-5 (f32
products in other orders).  Every test that waits on a thread bounds the
wait: a hang fails the test.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from torchmpi_tpu_torch.data import (DataPipeline, DeviceStage, HostStage,
                                     Staged, engine_wrap, stage_rank_major)
from torchmpi_tpu_torch.data.staging import HostScratchPool
from torchmpi_tpu_torch.runtime import config as tconfig
from torchmpi_tpu_torch.utils.data import (Dataset, ShardedIterator,
                                           synthetic_mnist)

CPU = torch.device("cpu")
WAIT_S = 30.0


def _ds(n=128, d=4):
    return Dataset(x=np.arange(n * d, dtype=np.float32).reshape(n, d),
                   y=np.arange(n, dtype=np.int32))


def _batches(n_batches=6, p=4, b=2, d=4, delay_s=0.0):
    rng = np.random.RandomState(0)
    out = [(rng.randn(p, b, d).astype(np.float32),
            rng.randint(0, 4, (p, b)).astype(np.int32))
           for _ in range(n_batches)]
    if delay_s == 0.0:
        return out

    def gen():
        for xb, yb in out:
            time.sleep(delay_s)
            yield xb, yb
    return gen()


def _bounded(fn, timeout_s=WAIT_S):
    """``fn()`` on a thread, joined within ``timeout_s``: a hang fails the
    test instead of stalling the suite.  Returns what ``fn`` returned."""
    box = {}

    def body():
        try:
            box["out"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["err"] = e

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(timeout_s)
    assert not t.is_alive(), f"no result within {timeout_s} s"
    if "err" in box:
        raise box["err"]
    return box["out"]


def _settle(predicate, tries=50, dt=0.1) -> bool:
    for _ in range(tries):
        if predicate():
            return True
        time.sleep(dt)
    return predicate()


# ---------------------------------------------------------------- host stage


def test_host_stage_order_single_producer():
    src = ShardedIterator(_ds(), global_batch=16, num_shards=4, seed=7)
    plain = [(x.copy(), y.copy()) for x, y in src]
    src2 = ShardedIterator(_ds(), global_batch=16, num_shards=4, seed=7)
    staged = _bounded(lambda: list(HostStage(src2, depth=3)))
    assert len(staged) == len(plain)
    for (xa, ya), (xb, yb) in zip(plain, staged):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


def test_host_stage_order_with_worker_pool():
    items = list(range(40))

    def slowish(i):
        time.sleep(0.001 * ((i * 7) % 5))   # later items may finish first
        return i * 10

    got = _bounded(lambda: list(HostStage(items, depth=2, workers=4,
                                          transform=slowish)))
    assert got == [i * 10 for i in items]


def test_host_stage_worker_exception_surfaces_at_its_slot():
    def boom(i):
        if i == 5:
            raise RuntimeError("transform failed on 5")
        return i

    got = []

    def consume():
        for v in HostStage(list(range(10)), depth=2, workers=3,
                           transform=boom):
            got.append(v)

    with pytest.raises(RuntimeError, match="failed on 5"):
        _bounded(consume)
    assert got == [0, 1, 2, 3, 4]


def test_host_stage_source_exception_propagates():
    def src():
        yield (1, 2)
        raise ValueError("loader died")

    with pytest.raises(ValueError, match="loader died"):
        _bounded(lambda: list(HostStage(src(), depth=2)))


@pytest.mark.parametrize("stage", ["host", "device"])
def test_abandonment_releases_threads_without_close(stage):
    before = threading.active_count()
    src = _batches(100)
    it = iter(HostStage(src, depth=2) if stage == "host"
              else DeviceStage(src, CPU, rank=0, depth=2))
    _bounded(lambda: next(it))
    del it                       # no close(): __del__ must stop it
    assert _settle(lambda: threading.active_count() <= before), \
        "producer thread leaked after abandonment"


@pytest.mark.parametrize("workers,bound", [(0, 3 + 2), (2, 3 + 2 + 2)])
def test_slow_consumer_memory_bounded(workers, bound):
    # depth queued, + workers in flight, + one in the producer's (or
    # reader's) hand, + the one consumed.
    produced = []

    def src():
        for i in range(100):
            produced.append(i)
            yield i

    it = iter(HostStage(src(), depth=3, workers=workers,
                        transform=(lambda v: v) if workers else None))
    assert _bounded(lambda: next(it)) == 0
    time.sleep(0.5)              # the consumer stalls; so must the producer
    assert len(produced) <= bound
    it.close()


# -------------------------------------------------------------- device stage


def test_device_stage_yields_this_ranks_rows_with_wait():
    batches = _batches(4)
    for rank in (0, 3):
        stage = DeviceStage(batches, CPU, rank=rank, depth=2)
        got = _bounded(lambda: list(stage))
        assert len(got) == 4
        for (sx, sy), (xb, yb) in zip(got, batches):
            assert isinstance(sx, Staged) and isinstance(sy, Staged)
            assert sx.wait_s >= 0.0
            np.testing.assert_array_equal(sx.array.numpy(), xb[rank])
            np.testing.assert_array_equal(sy.array.numpy(), yb[rank])
            assert sy.array.dtype == torch.long
        snap = stage.stats.snapshot()
        assert snap["batches"] == 4
        assert snap["staged_bytes"] == 4 * (2 * 4 * 4 + 2 * 8)
        assert 0.0 <= snap["overlap_fraction"] <= 1.0


def test_device_stage_matches_jax_shard_of_the_rank():
    # The JAX stage shards the global (p*b, ...) batch over the mesh's
    # rank axis: rank r's shard is this stage's row r.
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from torchmpi_tpu.data import staging as jstaging

    xb, _ = _batches(1)[0]
    p = xb.shape[0]
    mesh = Mesh(np.array(jax.devices()[:p]), ("r",))
    want = jstaging.stage_rank_major(
        xb, NamedSharding(mesh, PartitionSpec("r"))).array
    shards = {s.device: np.asarray(s.data) for s in want.addressable_shards}
    for r in range(p):
        got, event = stage_rank_major(xb, CPU, r)
        assert event is None
        np.testing.assert_array_equal(got.array.numpy(),
                                      shards[mesh.devices[r]])
    assert stage_rank_major(got, CPU, 0)[0] is got   # Staged passes


def test_device_stage_cast_and_wait_under_a_slow_source():
    stage = DeviceStage(_batches(3, delay_s=0.2), CPU, rank=1, depth=2,
                        cast=torch.float64)
    got = _bounded(lambda: list(stage))
    assert all(sx.array.dtype == torch.float64 for sx, _ in got)
    assert stage.stats.wait_s >= 0.3        # the consumer waited on it


def test_device_stage_prefetch_depth_bounds_inflight():
    produced = []

    def src():
        for xb, yb in _batches(50):
            produced.append(1)
            yield xb, yb

    it = iter(DeviceStage(src(), CPU, rank=0, depth=2))
    _bounded(lambda: next(it))
    time.sleep(0.5)
    # depth queued + 1 in the producer's hand + 1 consumed (+1 pulled).
    assert len(produced) <= 2 + 2 + 1
    it.close()


def test_device_stage_producer_exception_propagates():
    def src():
        yield _batches(1)[0]
        raise ValueError("stager died")

    with pytest.raises(ValueError, match="stager died"):
        _bounded(lambda: list(DeviceStage(src(), CPU, rank=0)))


class _Event:
    def __init__(self, done):
        self.done = done

    def query(self):
        return self.done


def test_scratch_pool_reuses_a_buffer_only_once_its_copy_completed(
        monkeypatch):
    pool = HostScratchPool(capacity=2)
    buf = torch.zeros(2, 3)
    event = _Event(False)
    pool.track(buf, event)
    fresh = []

    def pinned(shape, dtype=None, pin_memory=False):
        assert pin_memory
        fresh.append(torch.zeros(shape, dtype=dtype))
        return fresh[-1]

    monkeypatch.setattr(torch, "empty", pinned)
    assert pool.take((2, 3), torch.float32) is fresh[0]   # in flight: new
    event.done = True
    assert pool.take((2, 3), torch.float32) is buf        # done: reused
    assert pool.take((2, 3), torch.float64) is fresh[1]   # other dtype
    assert (pool.hits, pool.misses) == (1, 2)


def test_pipeline_keeps_buffer_reuse_off_on_the_cpu():
    tconfig.reset(data_reuse_host_buffers=True)
    try:
        pipe = DataPipeline(_batches(2), device=CPU, comm=_Comm(0))
        assert not pipe.device.reuse_host_buffers
    finally:
        tconfig.reset()


class _Comm:
    def __init__(self, rank):
        self.rank = rank


@pytest.mark.parametrize("workers", [0, 2])
def test_pipeline_batches_bit_identical_to_direct_iteration(workers):
    src = ShardedIterator(_ds(), global_batch=16, num_shards=4, seed=3)
    plain = [(x.copy(), y.copy()) for x, y in src]
    src2 = ShardedIterator(_ds(), global_batch=16, num_shards=4, seed=3)
    kw = {"transform": lambda b: b, "workers": workers} if workers else {}
    pipe = DataPipeline(src2, comm=_Comm(2), device=CPU, **kw)
    assert len(pipe) == len(plain)
    got = _bounded(lambda: list(pipe))
    for (sx, sy), (xb, yb) in zip(got, plain):
        np.testing.assert_array_equal(sx.array.numpy(), xb[2])
        np.testing.assert_array_equal(sy.array.numpy(), yb[2])
    assert pipe.stats.batches == len(plain)
    # Re-iterable: the next pass is the next epoch's shuffle.
    again = _bounded(lambda: list(pipe))
    assert len(again) == len(plain)


def test_pipeline_workers_without_transform_raise():
    with pytest.raises(ValueError, match="requires a transform"):
        DataPipeline(_batches(2), comm=_Comm(0), device=CPU, workers=2)


# ------------------------------------------------------------ engine_wrap


@pytest.mark.parametrize("mode", ["off", "on", "auto"])
def test_engine_wrap_follows_the_knob(mode):
    tconfig.reset(data_pipeline=mode)
    try:
        raw = _batches(2)
        out = engine_wrap(raw, _Comm(0), CPU)
        assert (out is raw) == (mode == "off")
        if mode != "off":
            assert isinstance(out, DataPipeline)
            assert engine_wrap(out, _Comm(0), CPU) is out    # wrapped once
        staged = [(Staged(torch.zeros(2)), Staged(torch.zeros(2)))]
        assert (engine_wrap(staged, _Comm(0), CPU) is staged) == (
            mode != "on")
    finally:
        tconfig.reset()


def test_engine_wrap_bad_mode_raises():
    tconfig.reset(data_pipeline="sometimes")
    try:
        with pytest.raises(ValueError, match="data_pipeline"):
            engine_wrap(_batches(1), _Comm(0), CPU)
    finally:
        tconfig.reset()


def test_sample_array_unwraps_both_forms():
    from torchmpi_tpu_torch.engine import sample_array

    xb, yb = _batches(1)[0]
    raw = sample_array((xb, yb), rank=2)
    np.testing.assert_array_equal(raw[0], xb[2])
    staged = (Staged(torch.from_numpy(xb[2])), Staged(torch.from_numpy(yb[2])))
    state = {"sample": staged, "comm": _Comm(2)}
    assert sample_array(state)[0] is staged[0].array


# --------------------------------------------- the engine through the plane

MLP_HIDDEN, MLP_IN, LR = (32,), 16, 0.2


def _mlp_data():
    return synthetic_mnist(n=256, image_shape=(MLP_IN,), n_classes=4)


def _setup_cpu():
    from torchmpi_tpu_torch.runtime import lifecycle

    torch.set_num_threads(2)
    lifecycle.start(device="cpu")


def _train_job(model, pipeline, init=None):
    """One rank's compiled-mode run with the pipeline knob set: per-step
    losses, final leaves, the held-out accuracy and what state["sample"]
    held."""
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import mlp, resnet
    from torchmpi_tpu_torch.utils import tree as ttree

    tconfig.reset(data_pipeline=pipeline, use_pallas_collectives=True,
                  small_allreduce_size_gpu=256)
    try:
        if model == "mlp":
            ds = _mlp_data()
            params = mlp.from_jax_params(init, device="cpu")
            loss_fn, metric, batch = mlp.loss_fn, mlp.accuracy, 64
        else:
            cfg = resnet.config(depth=18, n_classes=4, width_multiplier=0.125)
            ds = synthetic_mnist(n=32, image_shape=(16, 16, 3), n_classes=4,
                                 seed=2)
            params, _ = resnet.init(1, cfg, device="cpu")
            loss_fn, batch = resnet.make_loss_fn(cfg), 8
            metric = resnet.make_accuracy_fn(cfg)
        it = ShardedIterator(ds, global_batch=batch, num_shards=2, seed=11)
        losses, samples = [], []

        def on_update(s):
            losses.append(float(s["loss"]))
            samples.append(type(s["sample"][0]).__name__)

        eng = AllReduceSGDEngine(loss_fn, lr=LR, mode="compiled",
                                 hooks={"on_update": on_update})
        state = eng.train(params, it, epochs=2)
        acc = eng.test(state["params"], ShardedIterator(
            ds, global_batch=batch, num_shards=2, shuffle=False), metric)
        return {"losses": losses, "accuracy": acc, "samples": samples,
                "leaves": [x.numpy() for x in ttree.leaves(state["params"])]}
    finally:
        tconfig.reset()


@pytest.fixture(scope="module")
def pool():
    from torchmpi_tpu_torch.runtime import launch

    pl = launch.Pool(2, setup=_setup_cpu)
    yield pl
    pl.close()


@pytest.fixture(scope="module")
def mlp_init():
    import jax

    from torchmpi_tpu.models import mlp as jmlp

    return jax.tree.map(np.asarray, jmlp.init(
        jax.random.PRNGKey(0), in_dim=MLP_IN, hidden=MLP_HIDDEN,
        n_classes=4))


@pytest.mark.parametrize("model", ["mlp", "resnet"])
def test_engine_pipeline_on_equals_off_bit_for_bit(pool, mlp_init, model):
    off = pool.run(_train_job, model, "off", mlp_init)
    on = pool.run(_train_job, model, "on", mlp_init)
    for a, b in zip(off, on):
        assert a["losses"] == b["losses"]
        assert a["accuracy"] == b["accuracy"]
        for x, y in zip(a["leaves"], b["leaves"]):
            np.testing.assert_array_equal(x, y)
    assert set(off[0]["samples"]) == {"ndarray"}
    assert set(on[0]["samples"]) == {"Staged"}
    if model == "mlp":
        assert off[0]["losses"][-1] < off[0]["losses"][0]


def test_engine_through_the_pipeline_matches_the_jax_engine(pool, mlp_init):
    import jax

    import torchmpi_tpu as mpi
    from torchmpi_tpu.engine import AllReduceSGDEngine
    from torchmpi_tpu.models import mlp as jmlp
    from torchmpi_tpu.runtime import config as jconfig
    from torchmpi_tpu.utils import data as jdata

    got = pool.run(_train_job, "mlp", "on", mlp_init)
    if mpi.started():
        mpi.stop()
    jconfig.reset(data_pipeline="on")
    mpi.start(with_tpu=False, devices=jax.devices()[:2])
    try:
        losses = []
        ds = jdata.synthetic_mnist(n=256, image_shape=(MLP_IN,), n_classes=4)
        eng = AllReduceSGDEngine(
            jmlp.loss_fn, lr=LR, comm=mpi.stack.world(), mode="compiled",
            hooks={"on_update": lambda s: losses.append(float(s["loss"]))})
        eng.train(jax.tree.map(jax.numpy.asarray, mlp_init),
                  jdata.ShardedIterator(ds, global_batch=64, num_shards=2,
                                        seed=11), epochs=2)
    finally:
        mpi.stop()
        jconfig.reset()
    np.testing.assert_allclose(got[0]["losses"], losses, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("reuse", [False, True])
def test_device_stage_on_the_card(reuse):
    # Pinned buffers, a side stream and an event per batch: the rows arrive
    # on the card equal to the host's, labels as int64, the pool reusing
    # only buffers whose copy completed; the consumer's stream reads them
    # without a host synchronisation in between.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the side-stream copy has no CPU "
                    "mode")
    dev = torch.device("cuda", torch.cuda.current_device())
    batches = _batches(12, p=2, b=256, d=784)
    stage = DeviceStage(batches, dev, rank=1, depth=2,
                        reuse_host_buffers=reuse)
    sums = []
    for sx, sy in _bounded(lambda: list(stage)):
        assert sx.array.is_cuda and sy.array.dtype == torch.long
        sums.append((sx.array.double().sum(), sy.array.sum()))
    torch.cuda.synchronize()
    for (xs, ys), (xb, yb) in zip(sums, batches):
        assert float(xs) == pytest.approx(float(xb[1].astype(np.float64)
                                                .sum()), rel=1e-12)
        assert int(ys) == int(yb[1].sum())
    assert stage.stats.batches == 12
