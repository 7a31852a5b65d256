"""Config 1 of the port: the MNIST MLP under ``AllReduceSGDEngine``, the
example ``python -m torchmpi_tpu_torch.examples.mnist_allreduce`` and the
top-level ``import torchmpi_tpu_torch as mpi`` surface, on 2 gloo ranks
(one spawned pool for the file, 2 intra-op threads a rank).

* The engine: 5 SGD steps of the MLP at hidden (64, 32), from the JAX
  ``init`` parameters converted with ``from_jax_params``, in ``compiled``
  (through the data pipeline and the rings' CPU form: with the cutoff at
  2,048 elements, w0 and w1 ring alone and the other four leaves in one
  tail bucket, 3 rings a step, as at full width), ``eager_sync`` and
  ``eager_async``.  Losses and final parameters are held against the JAX
  algebra: ``jax.value_and_grad(mlp.loss_fn)`` on each rank's shard, the
  two gradients averaged, ``p - lr * g``.  Tolerance rtol 1e-5 with an
  absolute floor of 1e-6 of each leaf's largest magnitude: f32 products of
  at most 784 terms, summed in other orders by XLA and PyTorch.
* A run resumed from the checkpoint of step 3 equals the continuous run
  bit for bit, mid-epoch; so does the example resumed at an epoch boundary.
* The example end to end with ``--device cpu --data synthetic --limit 2048
  --epochs 2`` in every mode (the ring knob on outside ``eager_sync``), and
  compiled with the knob off, the JAX example's default (GSPMD, no ring):
  the lines of the JAX example, the loss falling, ``data=synthetic`` and,
  in the eager modes, the replica check.
* The examples of slice 16 at a small ``--limit``, converging by the JAX
  package's bar (``tests/test_examples.py`` ``_assert_converged``: the
  loss down by 0.2, accuracy above 30%): ``mnist_modelparallel`` on the 2
  ranks (tp 2, the ranks' losses equal); ``mnist_parameterserver`` in
  this process with 4 shard servers, Downpour and EASGD, whose shards end
  equal, bit for bit, to a replay of every vector pushed;
  ``mnist_parameterserver_easgd_dataparallel``'s workers on the 2 ranks
  as one DP group (the replicas checked after every integration); and
  ``train_llama --moe-experts 4 --ep 2``.
* The surface: every ported name, the collectives over the current
  communicator (a split one too), and the names that raised
  ``NotImplementedError`` naming item 4 until the hierarchical
  collectives came, which now raise what the JAX package's raise with no
  world started.
"""

from __future__ import annotations

import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torchmpi_tpu_torch as mpi

ROOT = Path(__file__).resolve().parents[1]
HIDDEN, PER_RANK, STEPS, LR, CUTOFF = (64, 32), 8, 5, 0.1, 2048
RTOL = 1e-5


def _setup():
    """A rank of the pool: the process group is up (lifecycle.start adopts
    it, so every job may start and stop the runtime)."""
    import torch.distributed as dist

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))


@pytest.fixture(scope="module")
def pool():
    from torchmpi_tpu_torch.runtime import launch

    pl = launch.Pool(2, setup=_setup)
    yield pl
    pl.close()


def _dataset():
    from torchmpi_tpu_torch.utils.data import synthetic_mnist

    return synthetic_mnist(n=2 * PER_RANK * STEPS, seed=5)


@pytest.fixture(scope="module")
def init():
    import jax

    from torchmpi_tpu.models import mlp as jmlp

    return jax.tree.map(np.asarray,
                        jmlp.init(jax.random.PRNGKey(0), hidden=HIDDEN))


@pytest.fixture(scope="module")
def reference(init):
    """The JAX algebra of the data-parallel step: per-step losses and the
    final parameters."""
    import jax

    from torchmpi_tpu.models import mlp as jmlp

    ds = _dataset()
    params = dict(init)
    vg = jax.jit(jax.value_and_grad(jmlp.loss_fn))
    losses = []
    for s in range(STEPS):
        outs = [vg(params, (ds.x[(2 * s + r) * PER_RANK:
                                 (2 * s + r + 1) * PER_RANK],
                            ds.y[(2 * s + r) * PER_RANK:
                                 (2 * s + r + 1) * PER_RANK]))
                for r in range(2)]
        losses.append((float(outs[0][0]) + float(outs[1][0])) / 2)
        params = {k: params[k] - LR * (outs[0][1][k] + outs[1][1][k]) / 2
                  for k in params}
    return {"losses": losses,
            "params": {k: np.asarray(v) for k, v in params.items()}}


def _engine(mode, hooks=None):
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import mlp

    return AllReduceSGDEngine(mlp.loss_fn, lr=LR, mode=mode,
                              hooks=hooks or {}, check_frequency=2)


def _iterator():
    from torchmpi_tpu_torch.utils.data import ShardedIterator

    return ShardedIterator(_dataset(), global_batch=2 * PER_RANK,
                           num_shards=2, shuffle=False)


def _steps_job(mode, init):
    """One rank's 5 steps: losses, final parameters, rings a step."""
    from torchmpi_tpu_torch.collectives import cuda_ring
    from torchmpi_tpu_torch.models import mlp

    mpi.config.reset(use_pallas_collectives=mode != "eager_sync",
                     small_allreduce_size_gpu=CUTOFF)
    calls = [0]
    ring = cuda_ring.inner_ring_allreduce

    def counted(*args, **kwargs):
        calls[0] += 1
        return ring(*args, **kwargs)

    cuda_ring.inner_ring_allreduce = counted
    mpi.start(device="cpu")
    try:
        losses, rings = [], []

        def on_update(state):
            losses.append(float(state["loss"]))
            rings.append(calls[0])
            calls[0] = 0

        state = _engine(mode, {"on_update": on_update}).train(
            mlp.from_jax_params(init, device="cpu"), _iterator())
        return {"losses": losses, "rings": rings,
                "params": {k: v.numpy() for k, v in state["params"].items()}}
    finally:
        mpi.stop()
        cuda_ring.inner_ring_allreduce = ring
        mpi.config.reset()


@pytest.mark.parametrize("mode", ["compiled", "eager_sync", "eager_async"])
def test_five_steps_match_the_jax_algebra(pool, init, reference, mode):
    res = pool.run(_steps_job, mode, init)
    for r in res:
        np.testing.assert_allclose(r["losses"], reference["losses"],
                                   rtol=RTOL)
        for k, want in reference["params"].items():
            atol = 1e-6 * float(np.abs(want).max())
            np.testing.assert_allclose(r["params"][k], want, rtol=RTOL,
                                       atol=atol)
    for k in init:
        np.testing.assert_array_equal(res[0]["params"][k],
                                      res[1]["params"][k])
    # compiled: w0 and w1 alone, then the tail; eager_async: its one
    # bucket (1,863,690 elements at full width) through the ring.
    want = {"compiled": 3, "eager_sync": 0, "eager_async": 1}[mode]
    assert res[0]["rings"] == [want] * STEPS


def _resume_job(init, ckpt_dir):
    """Steps 1-3 with a checkpoint at 3, then a fresh engine resumed from
    it for steps 4-5, beside the continuous run (compiled mode)."""
    from torchmpi_tpu_torch.models import mlp
    from torchmpi_tpu_torch.utils import checkpoint as ckpt
    from torchmpi_tpu_torch.utils.data import ShardedIterator, resume_at

    mpi.config.reset(use_pallas_collectives=True,
                     small_allreduce_size_gpu=CUTOFF)
    mpi.start(device="cpu")
    try:
        def fresh():
            return mlp.from_jax_params(init, device="cpu")

        def it():
            return ShardedIterator(_dataset(), global_batch=2 * PER_RANK,
                                   num_shards=2, seed=9)

        def run(params, source, epochs, start, hooks, stop_at=None):
            losses = []
            hooks = dict(hooks)
            after = hooks.get("on_update")

            def on_update(state):
                losses.append(float(state["loss"]))
                if after is not None:
                    after(state)
                if state["t"] == stop_at:
                    raise _Stop(state)

            hooks["on_update"] = on_update
            try:
                st = _engine("compiled", hooks).train(
                    params, source, epochs=epochs, start_step=start)
            except _Stop as e:
                st = e.state
            return losses, st["params"]

        cont_losses, cont = run(fresh(), it(), 2, 0, {})
        mgr = ckpt.CheckpointManager(ckpt_dir, save_interval=3)
        first, _ = run(fresh(), it(), 2, 0, ckpt.checkpoint_hooks(mgr),
                       stop_at=3)
        mpi.barrier()                   # rank 0 has written step 3
        params, _, t0 = ckpt.resume_or_init(
            mgr, {k: torch.zeros_like(v) for k, v in fresh().items()})
        source, done = resume_at(it(), t0)
        rest, resumed = run(params, source, 2 - done, t0, {})
        return {"t0": t0, "done": done, "continuous": cont_losses,
                "resumed": first + rest,
                "equal": all(torch.equal(cont[k], resumed[k]) for k in cont)}
    finally:
        mpi.stop()
        mpi.config.reset()


class _Stop(Exception):
    def __init__(self, state):
        super().__init__("stop")
        self.state = state


def test_resume_after_step_3_equals_the_continuous_run(pool, init, tmp_path):
    res = pool.run(_resume_job, init, str(tmp_path))
    for r in res:
        assert (r["t0"], r["done"]) == (3, 0)
        assert len(r["continuous"]) == 2 * STEPS
        assert r["resumed"] == r["continuous"]
        assert r["equal"]


def _example_job(argv, rings):
    """The example's run() in this rank with ``use_pallas_collectives`` set
    to ``rings`` (the example follows the knob, as the JAX one does), its
    standard output captured and its ring calls counted."""
    from torchmpi_tpu_torch.collectives import cuda_ring
    from torchmpi_tpu_torch.examples import mnist_allreduce

    mpi.config.reset(use_pallas_collectives=rings)
    calls = [0]
    ring = cuda_ring.inner_ring_allreduce

    def counted(*args, **kwargs):
        calls[0] += 1
        return ring(*args, **kwargs)

    cuda_ring.inner_ring_allreduce = counted
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = mnist_allreduce.run(mnist_allreduce.parse_args(argv))
    finally:
        cuda_ring.inner_ring_allreduce = ring
        mpi.config.reset()
    out["stdout"] = buf.getvalue()
    out["rings"] = calls[0]
    out["params"] = {k: v.numpy() for k, v in out["params"].items()}
    return out


def _example_argv(mode, epochs=2, *extra):
    return ["--device", "cpu", "--data", "synthetic", "--limit", "2048",
            "--epochs", str(epochs), "--mode", mode, *extra]


def _check_lines(text, mode, epochs=2):
    lines = text.splitlines()
    assert any("data=synthetic" in ln and f"mode={mode}" in ln
               for ln in lines), text
    losses = [float(ln.split("loss ")[1].split()[0]) for ln in lines
              if ln.startswith("epoch ")]
    assert len(losses) == epochs and losses[-1] < losses[0] - 0.2, text
    final = [ln for ln in lines if ln.startswith("final train loss")]
    assert final and "accuracy" in final[0], text
    assert ("replica consistency check passed" in lines) == (
        mode != "compiled"), text


@pytest.mark.parametrize("mode,rings", [
    ("compiled", True), ("eager_sync", False), ("eager_async", True),
    ("compiled", False)],
    ids=["compiled", "eager_sync", "eager_async", "compiled-gspmd"])
def test_example_runs_in_every_mode(pool, mode, rings):
    """Each mode with the knob as the example set it before it followed the
    knob, and compiled with the knob off (the JAX example's default: GSPMD,
    no ring)."""
    res = pool.run(_example_job, _example_argv(mode), rings)
    _check_lines(res[0]["stdout"], mode)
    assert (res[0]["rings"] > 0) == rings
    assert res[0]["accuracy"] > 0.95 and res[0]["steps"] == 32
    for k in res[0]["params"]:
        np.testing.assert_array_equal(res[0]["params"][k],
                                      res[1]["params"][k])
    stage = res[0]["stage"]
    if mode == "compiled":
        # The 16 training batches of the last epoch, this rank's 64 rows
        # each: 784 f32 and one int64 label a row.
        assert stage["batches"] == 16
        assert stage["staged_bytes"] == 16 * 64 * (784 * 4 + 8)
    else:
        assert stage is None


def test_example_resumes_from_its_checkpoint(pool, tmp_path):
    argv = _example_argv("compiled", 2)
    whole = pool.run(_example_job, argv, True)
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "5"]
    pool.run(_example_job, _example_argv("compiled", 1, *ck), True)
    resumed = pool.run(_example_job, _example_argv("compiled", 2, *ck), True)
    assert "resumed from step 16" in resumed[0]["stdout"]
    assert resumed[0]["steps"] == 32
    assert resumed[0]["losses"] == whole[0]["losses"][16:]
    for k, v in whole[0]["params"].items():
        np.testing.assert_array_equal(resumed[0]["params"][k], v)


def test_example_command_line_on_the_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "torchmpi_tpu_torch.examples.mnist_allreduce",
         "--nproc", "2", *_example_argv("eager_async")],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    _check_lines(res.stdout, "eager_async")
    assert res.stdout.count("[proc ") == 2


def test_example_refuses_the_cpu_unless_asked(monkeypatch, capsys):
    from torchmpi_tpu_torch.examples import mnist_allreduce

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mnist_allreduce.main(["--data", "synthetic"]) != 0
    assert "--device cpu" in capsys.readouterr().err


# ------------------------------------------------------------- the surface

PORTED = ["start", "stop", "started", "rank", "size", "barrier",
          "process_rank", "process_count", "stack", "config", "sync_handle",
          "sync_handles", "sync_all", "push_communicator", "allreduce",
          "broadcast", "reduce", "allgather", "reduce_scatter",
          "sendreceive", "allreduce_scalar", "async_", "Communicator",
          "SynchronizationHandle", "__version__"]
ITEM_4 = {"allgatherv": (torch.zeros(2),), "alltoall": (torch.zeros(2),),
          "broadcast_scalar": (1.0,), "reduce_scalar": (1.0,),
          "sendreceive_scalar": (1.0, 0, 1), "set_communicator": (0,),
          "set_collective_span": (0, 1), "collective_availability": ()}


def test_surface_has_the_jax_packages_names():
    import torchmpi_tpu as jmpi

    for name in PORTED + list(ITEM_4):
        assert hasattr(mpi, name), name
        assert hasattr(jmpi, name), name


@pytest.mark.parametrize("name", list(ITEM_4))
def test_item_4_names_raise(name):
    """Item 4's names are ported: with no world started each raises the
    error the JAX package's raises (the empty stack's), never
    ``NotImplementedError``, and ``collective_availability`` returns the
    JAX package's table."""
    import torchmpi_tpu as jmpi
    from torchmpi_tpu.collectives import selector as jselector
    from torchmpi_tpu.runtime import config as jconfig

    jconfig.reset()
    jselector.configure()
    mpi.config.reset()
    args = ITEM_4[name]
    jargs = tuple(a.numpy() if isinstance(a, torch.Tensor) else a
                  for a in args)
    outcomes = []
    for fn, a in ((getattr(mpi, name), args), (getattr(jmpi, name), jargs)):
        try:
            outcomes.append(("returned", fn(*a)))
        except Exception as e:  # noqa: BLE001 - compared below
            assert not isinstance(e, NotImplementedError), e
            outcomes.append(("raised", type(e)))
    assert outcomes[0] == outcomes[1]


def _surface_job():
    mpi.start(device="cpu")
    try:
        r, p = mpi.rank(), mpi.size()
        x = torch.tensor([float(r + 1), 10.0 * r])
        out = {
            "rank_size": (r, p, mpi.process_rank(), mpi.process_count()),
            "allreduce": mpi.allreduce(x).tolist(),
            "mean": mpi.allreduce(x, op="mean").tolist(),
            "broadcast": mpi.broadcast(x, root=1).tolist(),
            "reduce": mpi.reduce(x, root=0).tolist(),
            "allgather": mpi.allgather(x).tolist(),
            "reduce_scatter": mpi.reduce_scatter(x).tolist(),
            "sendreceive": mpi.sendreceive(x, src=1, dst=0).tolist(),
            "scalar": mpi.allreduce_scalar(r + 0.5),
            "async": mpi.sync_handle(mpi.async_.allreduce(x)).tolist(),
            "async_all": [t.tolist() for t in mpi.sync_handles(
                [mpi.async_.broadcast(x), mpi.async_.allgather(x)])],
        }
        mpi.barrier()
        mpi.push_communicator(lambda q: q)      # two intra groups of one
        out["split"] = mpi.allreduce(x).tolist()
        return out
    finally:
        mpi.stop()


def test_surface_collectives_over_the_current_communicator(pool):
    res = pool.run(_surface_job)
    for r, out in enumerate(res):
        assert out["rank_size"] == (r, 2, r, 2)
        assert out["allreduce"] == [3.0, 10.0]
        assert out["mean"] == [1.5, 5.0]
        assert out["broadcast"] == [2.0, 10.0]
        assert out["reduce"] == ([3.0, 10.0] if r == 0 else [2.0, 10.0])
        assert out["allgather"] == [[1.0, 0.0], [2.0, 10.0]]
        assert out["reduce_scatter"] == [[3.0], [10.0]][r]
        assert out["sendreceive"] == [2.0, 10.0]
        assert out["scalar"] == 2.0
        assert out["async"] == [3.0, 10.0]
        assert out["async_all"] == [[1.0, 0.0], [[1.0, 0.0], [2.0, 10.0]]]
        assert out["split"] == [float(r + 1), 10.0 * r]


# ------------------------------------------- the slice-16 examples (2 ranks)

def _assert_converged(epoch_losses, accuracy, min_acc=0.30, min_drop=0.2):
    """The JAX package's bar for these examples (``tests/test_examples.py``
    ``_assert_converged``): the loss falls by ``min_drop`` over the epochs
    and the accuracy beats ``min_acc``."""
    assert len(epoch_losses) >= 2, epoch_losses
    assert epoch_losses[-1] < epoch_losses[0] - min_drop, epoch_losses
    assert accuracy > min_acc, accuracy


def _captured(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def _modelparallel_job(argv):
    from torchmpi_tpu_torch.examples import mnist_modelparallel as ex

    return _captured(ex.run, ex.parse_args(argv))


def test_modelparallel_example(pool):
    res = pool.run(_modelparallel_job, [
        "--device", "cpu", "--limit", "1024", "--epochs", "2", "--hidden",
        "128"])
    (r0, text), (r1, _) = res
    assert "model parallel over tp=2" in text
    assert "final accuracy" in text
    _assert_converged(r0["epoch_losses"], r0["accuracy"])
    # The output is replicated: both ranks see the same losses.
    assert r0["epoch_losses"] == r1["epoch_losses"]
    assert r0["devices"] == ["cpu"]


@pytest.mark.parametrize("rule", ["downpour", "easgd"])
def test_parameterserver_example_replays_bit_for_bit(rule):
    """The worker in this process with 4 shard servers: it converges, and
    the shards end equal, bit for bit, to a replay of the 'add' rule over
    every vector the worker pushed, from the values it registered."""
    from torchmpi_tpu_torch.examples import mnist_parameterserver as ex

    record = []
    out, text = _captured(ex.run, ex.parse_args([
        "--device", "cpu", "--data", "synthetic", "--limit", "1024",
        "--epochs", "2", "--rule", rule]), record)
    assert "parameter server: 4 shard servers" in text
    _assert_converged(out["epoch_losses"], out["accuracy"])
    kinds = [k for k, _ in record]
    assert kinds[0] == "seed" and kinds.count("add") == out["stats"][
        "cycles"] >= 3
    replay = [t.numpy().copy() for t in record[0][1]]
    for _, deltas in record[1:]:
        for v, d in zip(replay, deltas):
            v += d.numpy()
    from torchmpi_tpu_torch.utils import tree as ttree

    center = ttree.leaves(out["center"])
    for v, c in zip(replay, center):
        assert v.tobytes() == c.numpy().tobytes()
    assert out["counters"]["retry"] == out["counters"]["crc_failure"] == 0


def _easgd_dp_job(argv, world_ports, group_ports, eps):
    from torchmpi_tpu_torch.examples import (
        mnist_parameterserver_easgd_dataparallel as ex)

    return _captured(ex.worker, ex.parse_args(argv), world_ports,
                     group_ports, eps)


def test_easgd_dataparallel_example(pool):
    """Both ranks in one DP group (so the DP plane and its replica checks
    run), one EASGD client: the replicas agree after every integration."""
    from torchmpi_tpu_torch import parameterserver as tps
    from torchmpi_tpu_torch.collectives.hostcomm import free_ports
    from torchmpi_tpu_torch.parameterserver import native

    L = native.lib()
    sids = [L.tmpi_ps_server_start(0) for _ in range(2)]
    try:
        eps = [("127.0.0.1", L.tmpi_ps_server_port(s)) for s in sids]
        ports = free_ports(4)
        res = pool.run(_easgd_dp_job, [
            "--device", "cpu", "--nproc", "2", "--div", "2", "--epochs",
            "2", "--limit", "1024", "--batch", "32", "--init-delay", "2"],
            ports[:2], ports[2:], eps)
    finally:
        for s in sids:
            L.tmpi_ps_server_stop(s)
        tps.shutdown()
    (r0, text), (r1, _) = res
    assert "group 0: replica consistency check passed" in text
    assert [r0["client"], r1["client"]] == [True, False]
    assert r0["replica_checks"] == r1["replica_checks"] >= 3
    _assert_converged(r0["epoch_losses"], r0["accuracy"])


def _train_llama_job(argv):
    from torchmpi_tpu_torch.examples import train_llama

    torch.set_num_threads(2)
    out = _captured(train_llama._run, train_llama.parse_args(argv))
    torch.set_num_threads(2)
    return out


def test_train_llama_moe_on_ep(pool):
    res = pool.run(_train_llama_job, [
        "--device", "cpu", "--moe-experts", "4", "--ep", "2", "--steps",
        "4", "--generate", "2"])
    text = res[0][1]
    assert "'ep': 2" in text and "moe=4x top-2" in text, text
    assert "generation legality" in text
