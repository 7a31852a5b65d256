"""Failure detection and elastic recovery of the port
(``torchmpi_tpu_torch/runtime/failure.py``) held against the JAX package's
``runtime/failure.py`` on the CPU.

* ``is_device_failure`` on one table of exceptions: where both packages
  have the type, the same answer; then the port's own faults (the ring's
  ``RingTimeout``, gloo's peer-loss messages, ``DistNetworkError``)
  recoverable, and a sticky CUDA error not (ROADMAP §C: in JAX a device
  marker in its text would make it recoverable).
* ``FaultInjector``: the same steps fail in the same order.
* ``HeartbeatMonitor``: a JAX monitor and a port monitor in this process
  see each other alive and each detects the other's stop exactly once; a
  foreign job token is never heard.
* ``Watchdog`` fires through its ``_on_expire`` seam and stays quiet while
  kicked; ``abort_on_peer_failure`` exits with 43 (a subprocess).
* ``cuda_ring.release_local`` closes the peers' mappings at once and keeps
  this rank's blocks until ``free_retired``.
* ``python -m torchmpi_tpu_torch.examples.mnist_elastic --device cpu
  --nproc 4 --survivors 2 --steps 30 --fail-at 12`` prints the lines JAX's
  example test reads.
* ``run_elastic`` against JAX's on the same data, from ``from_jax_params``
  weights (the MLP at hidden (64, 32), GSPMD, global batch 64, a fault at
  step 7, a checkpoint every 4 steps): JAX on devices 0-3 of the virtual
  mesh shrinking to 0-1, the port on 4 gloo ranks shrinking to 2.  Every
  step's loss within 1e-5, the resumed step, ``restarts`` and
  ``steps_run`` equal.  Then the restart budget, a programming error
  re-raising, and a rank SIGKILLed mid-step: the survivors re-form at p =
  3 with no barrier on it and end as one replica.

One pool of 4 spawned gloo ranks (``runtime.launch.Pool``), whose setup
starts nothing: each job starts its world on a ``file://`` rendezvous of
its own, as a re-form does.  The kill case runs last: it leaves the pool a
rank short.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from torchmpi_tpu.runtime import failure as jfailure
from torchmpi_tpu_torch.collectives import cuda_ring
from torchmpi_tpu_torch.runtime import failure as tfailure

ROOT = Path(__file__).resolve().parents[1]
HIDDEN, GLOBAL_BATCH, LR = (64, 32), 64, 0.1
N_STEPS, CKPT_EVERY, FAIL_AT = 12, 4, 7
LOSS_RTOL = 1e-5


def _wait_until(pred, timeout=10.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


# ------------------------------------------------------------ the classifier

class XlaRuntimeError(RuntimeError):
    """Named like jaxlib's: both classifiers read the type's name."""


def _shared_cases(mod):
    """(label, exception) in ``mod``'s own classes."""
    return [
        ("injected", mod.InjectedFault("chip 5 lost")),
        ("hostcomm_timeout", mod.HostcommTimeout("rank 1 recv 0 bytes")),
        ("hostcomm_crc", mod.HostcommCorruption("crc mismatch")),
        ("ps_transport", mod.PSTransportError("retry budget spent")),
        ("ps_fence", mod.PSFenceError("nacked")),
        ("deadline", RuntimeError("DEADLINE_EXCEEDED: collective")),
        ("unavailable", OSError("UNAVAILABLE: socket closed")),
        ("aborted", RuntimeError("ABORTED: barrier")),
        ("data_loss", RuntimeError("DATA_LOSS: torn")),
        ("halted", RuntimeError("device halted")),
        ("invalid_state", RuntimeError("device is in an invalid state")),
        ("xla_named", XlaRuntimeError("UNAVAILABLE: chip lost")),
        ("xla_internal", XlaRuntimeError("INTERNAL: compiler bug")),
        ("no_space", OSError("No space left on device")),
        ("wrong_device", RuntimeError("tensor on wrong device")),
        ("oom", RuntimeError("RESOURCE_EXHAUSTED: out of memory")),
        ("type", TypeError("programming error")),
        ("value", ValueError("shape mismatch")),
        ("key", KeyError("UNAVAILABLE")),
    ]


def test_is_device_failure_agrees_with_jax_on_shared_types():
    jcases, tcases = _shared_cases(jfailure), _shared_cases(tfailure)
    got = {label: tfailure.is_device_failure(e) for label, e in tcases}
    want = {label: jfailure.is_device_failure(e) for label, e in jcases}
    assert got == want
    assert sum(want.values()) == 12      # the table has both answers


@pytest.mark.parametrize("label,exc,want", [
    ("ring_timeout", cuda_ring.RingTimeout(
        "allreduce on rank 0 of 4 gave up at call 7"), True),
    ("ring_cuda_call", cuda_ring.RingError(
        "staging cudaMalloc failed: CUDA error 2"), False),
    ("gloo_closed", RuntimeError(
        "[../third_party/gloo/gloo/transport/tcp/pair.cc:553] Connection "
        "closed by peer [127.0.0.1]:40123"), True),
    ("gloo_reset", RuntimeError(
        "[pair.cc:537] Read error [127.0.0.1]:40123: Connection reset by "
        "peer"), True),
    ("gloo_timeout", RuntimeError(
        "[pair.cc:598] Timed out waiting 30000ms for recv operation to "
        "complete"), True),
    ("store_network", torch.distributed.DistNetworkError(
        "failed to connect to the store"), True),
    ("sticky_cuda", RuntimeError(
        "CUDA error: an illegal memory access was encountered"), False),
    ("sticky_cuda_marker", RuntimeError("CUDA error: UNAVAILABLE"), False),
    ("word_device", RuntimeError("expected all tensors on the same device"),
     False),
], ids=lambda v: v if isinstance(v, str) else "")
def test_is_device_failure_port_cases(label, exc, want):
    assert tfailure.is_device_failure(exc) is want


def test_sticky_cuda_is_the_one_divergence():
    """JAX reads a device marker in any RuntimeError; the port refuses a
    CUDA error whatever else it says (the context is poisoned)."""
    e = RuntimeError("CUDA error: UNAVAILABLE")
    assert jfailure.is_device_failure(e) and not tfailure.is_device_failure(e)


# -------------------------------------------------------------- the injector

@pytest.mark.parametrize("spec", [[3], [3, 3, 5], {2: "rank 5 lost", 4: "x"},
                                  []], ids=["one", "repeat", "dict", "none"])
def test_fault_injector_sequences_equal_jax(spec):
    def trace(mod):
        inj = mod.FaultInjector(spec)
        seen = []
        for step in [0, 1, 2, 3, 3, 3, 4, 5, 5, 2, 4]:
            try:
                inj.maybe_fail(step)
                seen.append((step, None))
            except mod.InjectedFault as e:
                seen.append((step, str(e)))
        return seen, list(inj.fired)

    assert trace(tfailure) == trace(jfailure)


# -------------------------------------------------------------- the heartbeat

@pytest.mark.parametrize("who_stops", ["jax", "port"])
def test_heartbeat_between_jax_and_port(who_stops):
    eps = [("127.0.0.1", p) for p in tfailure.free_udp_ports(2)]
    deaths = {"jax": [], "port": []}
    kw = dict(interval=0.05, timeout=0.4, startup_grace=5.0)
    mons = {"jax": jfailure.HeartbeatMonitor(
                0, eps, on_failure=deaths["jax"].append, **kw),
            "port": tfailure.HeartbeatMonitor(
                1, eps, on_failure=deaths["port"].append, **kw)}
    try:
        assert mons["jax"].token == mons["port"].token
        assert _wait_until(lambda: mons["jax"].heard_peers() == [1]
                           and mons["port"].heard_peers() == [0])
        time.sleep(0.6)           # past the timeout: both still alive
        assert mons["jax"].dead_peers() == mons["port"].dead_peers() == []
        other = "port" if who_stops == "jax" else "jax"
        mons[who_stops].stop()
        dead = 1 if who_stops == "port" else 0
        assert _wait_until(lambda: mons[other].dead_peers() == [dead])
        time.sleep(0.4)           # later sweeps call back no more
        assert deaths[other] == [dead] and deaths[who_stops] == []
    finally:
        for m in mons.values():
            m.stop()


def test_heartbeat_rejects_a_foreign_token():
    eps = [("127.0.0.1", p) for p in tfailure.free_udp_ports(2)]
    j = jfailure.HeartbeatMonitor(0, eps, interval=0.05, token=1)
    t = tfailure.HeartbeatMonitor(1, eps, interval=0.05, token=2)
    try:
        time.sleep(0.5)
        assert j.heard_peers() == [] and t.heard_peers() == []
    finally:
        j.stop()
        t.stop()


# ---------------------------------------------------- watchdog and the abort

def test_watchdog_fires_through_the_seam_and_not_while_kicked():
    fired = threading.Event()
    wd = tfailure.Watchdog(0.3, rank=3, _on_expire=fired.set)
    try:
        for _ in range(16):       # 0.8 s of kicks, each well inside 0.3 s
            wd.kick()
            time.sleep(0.05)
        assert not fired.is_set()
        assert fired.wait(5.0)    # no kick: expires
    finally:
        wd.stop()


def test_abort_on_peer_failure_exits_43():
    code = ("from torchmpi_tpu_torch.runtime.failure import "
            "abort_on_peer_failure; abort_on_peer_failure(0)(1); "
            "raise SystemExit(0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, timeout=120,
                       capture_output=True)
    assert r.returncode == tfailure.EXIT_PEER_FAILURE == 43


# ------------------------------------------------------------ the example

def test_release_local_keeps_own_blocks_until_the_next_world(monkeypatch):
    """``release_local`` closes this rank's mappings of the peers' blocks
    at once but frees its own only at ``free_retired``: a slower survivor
    may still read this rank's error word inside the aborted call."""
    log = []

    class FakeState:
        def __init__(self, name):
            self.name = name

        def unmap(self):
            log.append(("unmap", self.name))

        def free(self):
            log.append(("free", self.name))

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: log.append("sync"))
    monkeypatch.setattr(cuda_ring, "_states",
                        {1: FakeState("a"), 2: FakeState("b")})
    monkeypatch.setattr(cuda_ring, "_retired", [])
    cuda_ring.release_local()
    assert log == ["sync", ("unmap", "a"), ("unmap", "b")]
    assert not cuda_ring._states and len(cuda_ring._retired) == 2
    cuda_ring.free_retired()
    assert log[3:] == [("free", "a"), ("free", "b")]
    assert not cuda_ring._retired


def test_mnist_elastic_example_on_the_cpu(tmp_path):
    """The port's ``mnist_elastic`` end to end on 4 gloo ranks: the lines
    JAX's example test reads (``tests/test_examples.py``), with ranks in
    place of devices."""
    r = subprocess.run(
        [sys.executable, "-m", "torchmpi_tpu_torch.examples.mnist_elastic",
         "--device", "cpu", "--nproc", "4", "--survivors", "2", "--steps",
         "30", "--fail-at", "12", "--ckpt-dir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout
    assert "restart 1: InjectedFault" in out
    assert "(re)built over 2 ranks from checkpoint" in out
    assert "1 restart(s)" in out
    assert out.count("left the world") == 2


# ------------------------------------------------------------ run_elastic

def _dataset():
    from torchmpi_tpu_torch.utils.data import synthetic_mnist

    return synthetic_mnist(n=1024, seed=5)


@pytest.fixture(scope="module")
def init():
    import jax

    from torchmpi_tpu.models import mlp as jmlp

    return jax.tree.map(np.asarray,
                        jmlp.init(jax.random.PRNGKey(0), hidden=HIDDEN))


@pytest.fixture(scope="module")
def jax_elastic(init, tmp_path_factory):
    """JAX's run_elastic: the engine over devices 0-3, then 0-1."""
    import jax

    import torchmpi_tpu as jmpi
    from torchmpi_tpu.engine import AllReduceSGDEngine
    from torchmpi_tpu.models import mlp as jmlp
    from torchmpi_tpu.utils.checkpoint import CheckpointManager
    from torchmpi_tpu.utils.data import ShardedIterator

    ds = _dataset()
    losses = []

    def build(devices, restored):
        if jmpi.started():
            jmpi.stop()
        jmpi.start(with_tpu=False, devices=list(devices))
        comm = jmpi.stack.world()
        p = comm.size
        engine = AllReduceSGDEngine(jmlp.loss_fn, lr=LR, comm=comm,
                                    mode="compiled")
        batches = list(ShardedIterator(ds, global_batch=GLOBAL_BATCH,
                                       num_shards=p, seed=3))
        params = (restored["params"] if restored is not None else init)

        def step_fn(state, step):
            out = engine.train(state["params"],
                               [batches[step % len(batches)]])
            losses.append((step, p, float(out["loss"])))
            return {"params": out["params"], "loss": out["loss"]}

        return {"params": params, "loss": np.inf}, step_fn

    devs = jax.devices()[:4]
    pool = {"devices": list(devs)}

    def healthy():
        pool["devices"] = pool["devices"][:2]
        return pool["devices"]

    mgr = CheckpointManager(str(tmp_path_factory.mktemp("jax_elastic")),
                            save_interval=CKPT_EVERY)
    try:
        out = jfailure.run_elastic(
            build, mgr, n_steps=N_STEPS, devices=devs,
            injector=jfailure.FaultInjector([FAIL_AT]),
            healthy_devices=healthy)
    finally:
        jmpi.stop()
    return {"losses": losses, "restarts": out["restarts"],
            "steps_run": out["steps_run"]}


def _setup():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pool():
    from torchmpi_tpu_torch.runtime import launch

    pl = launch.Pool(4, setup=_setup, timeout_s=180.0)
    yield pl
    pl.close()


def _start(directory, name):
    from torchmpi_tpu_torch.runtime import lifecycle

    lifecycle.start("cpu", rank=int(os.environ["RANK"]), world_size=4,
                    init_method="file://" + os.path.join(directory, name),
                    timeout_s=60.0)


def _elastic_job(directory, init, mode):
    """One rank of the port's run_elastic: ``mode`` "shrink" (the parity
    run), "budget" (a fault every step), "typeerror" or "kill" (rank 3
    dies mid-step at FAIL_AT)."""
    from torchmpi_tpu_torch import config
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import mlp
    from torchmpi_tpu_torch.runtime import lifecycle, stack
    from torchmpi_tpu_torch.utils.checkpoint import CheckpointManager
    from torchmpi_tpu_torch.utils.data import ShardedIterator

    config.reset(use_pallas_collectives=mode == "kill")
    _start(directory, f"world-{mode}")
    me = lifecycle.rank()
    ds = _dataset()
    losses = []

    def build(ranks, restored):
        comm = stack.world()
        p = comm.size
        engine = AllReduceSGDEngine(mlp.loss_fn, lr=LR, comm=comm,
                                    mode="compiled",
                                    sync_parameters_on_start=False)
        batches = list(ShardedIterator(ds, global_batch=GLOBAL_BATCH
                                       - GLOBAL_BATCH % p, num_shards=p,
                                       seed=3))
        params = ({k: v for k, v in restored["params"].items()}
                  if restored is not None
                  else mlp.from_jax_params(init, device="cpu"))

        def step_fn(state, step):
            if mode == "typeerror":
                raise TypeError("programming error")
            if mode == "kill" and me == 3 and step == FAIL_AT:
                os.kill(os.getpid(), signal.SIGKILL)
            out = engine.train(state["params"],
                               [batches[step % len(batches)]])
            losses.append((step, p, float(out["loss"])))
            return {"params": out["params"], "loss": out["loss"]}

        return {"params": params, "loss": np.inf}, step_fn

    survivors = {"shrink": [0, 1], "budget": [0, 1, 2, 3],
                 "typeerror": [0, 1, 2, 3], "kill": [0, 1, 2]}[mode]
    inj = {"shrink": [FAIL_AT], "budget": [1, 2, 3]}.get(mode)
    mgr = CheckpointManager(os.path.join(directory, f"ckpt-{mode}"),
                            save_interval=CKPT_EVERY)
    try:
        out = tfailure.run_elastic(
            build, mgr, n_steps=N_STEPS,
            injector=tfailure.FaultInjector(inj) if inj else None,
            healthy_ranks=lambda: survivors)
    except Exception as e:  # noqa: BLE001 - the budget and typeerror cases
        lifecycle.stop()
        if mode in ("shrink", "kill"):
            raise
        return {"raised": type(e).__name__}
    res = {"losses": losses, "restarts": out["restarts"],
           "steps_run": out["steps_run"], "departed": out["departed"]}
    if not out["departed"]:
        res["params"] = {k: v.clone() for k, v in
                         out["state"]["params"].items()}
        res["size"] = lifecycle.size()
    lifecycle.stop()
    return res


def test_run_elastic_equals_jax(pool, init, jax_elastic, tmp_path):
    res = pool.run(_elastic_job, str(tmp_path), init, "shrink")
    assert [r["departed"] for r in res] == [False, False, True, True]
    got = res[0]["losses"]
    want = jax_elastic["losses"]
    assert [(s, p) for s, p, _ in got] == [(s, p) for s, p, _ in want]
    for (s, p, a), (_, _, b) in zip(got, want):
        assert abs(a - b) <= LOSS_RTOL * max(1.0, abs(b)), (s, p, a, b)
    resumed = next(s for s, p, _ in got if p == 2)
    assert resumed == next(s for s, p, _ in want if p == 2) == \
        (FAIL_AT - 1) // CKPT_EVERY * CKPT_EVERY + 1
    assert res[0]["restarts"] == jax_elastic["restarts"] == 1
    assert res[0]["steps_run"] == jax_elastic["steps_run"]
    assert res[1]["losses"] == got
    for k, v in res[0]["params"].items():
        assert torch.equal(v, res[1]["params"][k])


def test_run_elastic_restart_budget_and_non_device_errors(pool, init,
                                                          tmp_path):
    res = pool.run(_elastic_job, str(tmp_path), init, "budget")
    assert [r["raised"] for r in res] == ["InjectedFault"] * 4
    res = pool.run(_elastic_job, str(tmp_path), init, "typeerror")
    assert [r["raised"] for r in res] == ["TypeError"] * 4


def _run_survivors(pool, fn, args, ranks, timeout_s=180.0):
    """``fn(*args)`` in every rank of ``pool``; the results of ``ranks``
    (the others die on purpose)."""
    import queue as _queue

    for jq in pool._jobs:
        jq.put((fn, args))
    got, deadline = {}, time.monotonic() + timeout_s
    while set(got) != set(ranks):
        assert time.monotonic() < deadline, f"only {sorted(got)} answered"
        try:
            rank, ok, value = pool._q.get(timeout=0.5)
        except _queue.Empty:
            continue
        assert ok, value
        got[rank] = value
    return [got[r] for r in ranks]


def test_rank_killed_mid_step_survivors_reform(pool, init, tmp_path):
    """Last in the file: rank 3 SIGKILLs itself inside step FAIL_AT.  The
    survivors fail in the ring, tear down with no barrier on the dead,
    re-form at p = 3, resume from the agreed checkpoint and end as one
    replica."""
    res = _run_survivors(pool, _elastic_job, (str(tmp_path), init, "kill"),
                         [0, 1, 2])
    assert _wait_until(lambda: not pool._procs[3].is_alive(), 30)
    assert pool._procs[3].exitcode == -signal.SIGKILL
    resumed = (FAIL_AT - 1) // CKPT_EVERY * CKPT_EVERY + 1
    for r in res:
        assert r["restarts"] == 1 and r["size"] == 3
        assert [s for s, p, _ in r["losses"] if p == 3][0] == resumed
        assert [s for s, p, _ in r["losses"]][-1] == N_STEPS - 1
    for k, v in res[0]["params"].items():
        assert all(torch.equal(v, r["params"][k]) for r in res[1:])
