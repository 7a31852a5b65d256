"""Failure and membership, end to end: config 1 surviving a lost rank and
growing and shrinking live.

    python -m torchmpi_tpu_torch.tools.elastic_drill [--device cpu]

Six processes are spawned (on the card every one binds ``cuda:0``: the
ranks share it), run config 1 (the MNIST MLP 784-1024-1024-10 in f32,
global batch 128, ``compiled`` with ``use_pallas_collectives`` on, so the
gradients go through three ring allreduces a step; at p = 3 the global
batch is 126, the largest multiple of p, so the shards stay equal) and go
through four legs in order:

* ``a``, an injected fault: ``examples/mnist_elastic``'s flow on W0-W3,
  a checkpoint every ``A_CKPT`` steps, a ``FaultInjector`` firing at
  ``A_FAIL_AT`` on every rank; ``run_elastic`` restores and re-forms on
  W0-W1 (W2 and W3 leave).  Then W0-W1 run the same steps again in a
  fresh world started alone from the same checkpoint.
* ``b``, a real death: W0-W3 in a fresh world under ``run_elastic`` with
  heartbeat monitors; W2 kills itself with SIGKILL at step ``B_KILL_AT``.
  The survivors see the ring give up on it, tear down locally, re-form at
  p = 3 over the monitors' verdict and resume from the agreed checkpoint;
  the first step at p = 3 holds its three rings, bit for bit, against
  B1's plain version over the three ranks' gradients.
* ``c``, a live resize: W0-W1 train under ``ResizeController`` (the host
  control ring, ``resize_enabled``) with the engine's step boundary; a
  grow whose state ship to J4 crosses a blackholing ``ChaosProxy``
  aborts; a clean retry grows to 4 (J4, J5 receive the card's parameters
  and put them on their cards); a drain removes J5 (p = 3).
* ``d``, election: a planned ``handoff`` evicts W0; the new leader W1
  grows W3 in; then W1 proposes a drain and kills itself with SIGKILL
  inside the window; J4 and W3 fail over (``/healthz`` probes), resolve
  the window to one verdict and train on at p = 2; ``POST /resize`` to
  W3 answers a 307 naming J4.

Every process journals into one directory, which ``obs/rca.analyze``
reads at the end.  :func:`run` returns every leg's record; :func:`checks`
lists what failed (launch counts only where the ring kernels ran, that
is, on the card).  Prints one JSON line with both.  Every wait is
bounded, and every spawned process is joined or killed before it
returns.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import signal
import sys
import tempfile
import time
import traceback
from typing import Any, Dict, List

BATCH = 128
LR = 0.1
SEED = 0
A_STEPS, A_CKPT, A_FAIL_AT = 30, 10, 20
B_STEPS, B_CKPT, B_KILL_AT = 20, 5, 12
C_CHAOS_AT, C_GROW_AT, C_DRAIN_AT = 3, 5, 9
D_HANDOFF_AT, D_GROW_AT, D_KILL_AT, D_END = 12, 14, 17, 21
RINGS_PER_STEP = 3
PG_TIMEOUT_S = 120.0          # every op of a drill world, rendezvous too
HB_INTERVAL_S, HB_TIMEOUT_S = 0.2, 2.0
JOIN_TIMEOUT_S = 60.0
CHAOS_JOIN_TIMEOUT_S = 8.0    # the blackholed joiner's wait
SHIP_DEADLINE_MS = 2000       # resize_io_deadline_ms: the ship's bound
HC_DEADLINE_MS = 20000        # every control-ring wait
MEM_SLACK_GB = 0.25
WALL_S = 420.0
ROLES = ("W0", "W1", "W2", "W3", "J4", "J5")


# --------------------------------------------------------------- helpers

def _digest(params) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(params[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _launches() -> int:
    from ..collectives import cuda_ring

    return cuda_ring.ring_allreduce_launches


def _mem_gb(device) -> float:
    import torch

    gc.collect()
    if device.type != "cuda":
        return 0.0
    torch.cuda.synchronize(device)
    return torch.cuda.memory_allocated(device) / 1e9


def _held_step(step_fn, state, s, held):
    """Step ``s`` with every ring allreduce held, bit for bit, against
    B1's plain version over every rank's input (gathered through the
    host); ``held`` counts the rings, the unequal ones and the largest
    error."""
    import torch
    import torch.distributed as dist

    from ..collectives import cuda_ring

    ring = cuda_ring.inner_ring_allreduce

    def checked(x, p, **kw):
        comm = kw["comm"]
        xs = [torch.empty_like(x, device="cpu") for _ in range(p)]
        dist.all_gather(xs, x.detach().cpu(), group=comm.group)
        out = ring(x, p, **kw)
        want = cuda_ring._oneshot_allreduce_plain(
            [t.to(x.device) for t in xs],
            mean=kw.get("mean", False))[comm.rank]
        held["rings"] += 1
        held["unequal"] += not bool(torch.equal(out.view(torch.int32),
                                                want.view(torch.int32)))
        held["max_abs_err"] = max(held["max_abs_err"], float(
            (out.double() - want.double()).abs().max()))
        return out

    cuda_ring.inner_ring_allreduce = checked
    try:
        return step_fn(state, s)
    finally:
        cuda_ring.inner_ring_allreduce = ring


def _probe(params, probe) -> float:
    """The loss of ``params`` on the fixed probe batch, computed locally:
    equal parameters give the same bits on every rank."""
    import torch

    from ..models import mlp

    with torch.no_grad():
        return float(mlp.loss_fn(params, probe))


def _setup(role: str, cfg: Dict[str, Any]):
    import torch

    from ..runtime import config

    if cfg["device"] == "cpu":
        torch.set_num_threads(2)
        dev = torch.device("cpu")
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"])
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    config.set("use_pallas_collectives", True)
    config.set("data_pipeline", "off")
    config.set("journal_enabled", True)
    config.set("journal_dir", os.path.join(cfg["dir"], "journal"))
    config.set("resize_enabled", True)
    config.set("resize_io_deadline_ms", SHIP_DEADLINE_MS)
    return dev


def _data(device):
    """The dataset and a fixed probe batch on ``device``."""
    import torch

    from ..utils.data import synthetic_mnist

    ds = synthetic_mnist(n=8192)
    probe = (torch.from_numpy(ds.x[:BATCH]).to(device),
             torch.from_numpy(ds.y[:BATCH]).long().to(device))
    return ds, probe


def _start(device, rank: int, size: int, name: str, cfg):
    from ..runtime import lifecycle

    return lifecycle.start(device, rank=rank, world_size=size,
                           init_method="file://" + os.path.join(
                               cfg["dir"], name),
                           timeout_s=PG_TIMEOUT_S)


# ------------------------------------------------------------------ leg a

def _leg_a(role, cfg, device, put):
    """The example's flow on W0-W3, then W0-W1 alone from the same
    checkpoint."""
    from ..examples import mnist_elastic
    from ..utils import checkpoint as ckpt
    from ..utils.data import synthetic_mnist

    d = os.path.join(cfg["dir"], "a")
    args = mnist_elastic.parse_args(
        ["--steps", str(A_STEPS), "--fail-at", str(A_FAIL_AT),
         "--survivors", "2", "--ckpt-every", str(A_CKPT), "--ckpt-dir", d,
         "--batch", str(BATCH), "--lr", str(LR), "--seed", str(SEED)]
        + (["--device", "cpu"] if cfg["device"] == "cpu" else []))
    steps: List[Dict[str, Any]] = []
    mark = {"n": _launches()}

    def on_step(step, state, p):
        n = _launches()
        steps.append({"step": step, "p": p, "loss": float(state["loss"]),
                      "launches": n - mark["n"], "wall": time.time()})
        mark["n"] = n

    t0 = time.perf_counter()
    out = mnist_elastic.run(args, on_step=on_step)
    rec = {"steps": steps, "departed": out["departed"],
           "restarts": out["restarts"],
           "seconds": time.perf_counter() - t0}
    if out["departed"]:
        put("a", rec)
        return
    rec["digest"] = _digest(out["params"])
    rec["steps_run"] = out["steps_run"]
    # The reference: a 2-rank world started alone from the checkpoint
    # the restart resumed from, over the same steps.
    resumed = next(s["step"] for s in steps if s["p"] == 2)
    _start(device, int(role[1]), 2, "world-a-alone", cfg)
    try:
        template = {"params": {k: v for k, v in out["params"].items()},
                    "loss": 0.0}
        restored, _ = ckpt.restore(d, template, step=resumed - 1)
        build = mnist_elastic.make_build(args, synthetic_mnist(n=8192),
                                         device)
        state, step_fn = build([0, 1], restored)
        n0 = _launches()
        for step in range(resumed, A_STEPS):
            state = step_fn(state, step)
        rec["alone_launches"] = _launches() - n0
        rec["alone_digest"] = _digest(state["params"])
        rec["alone_from"] = resumed - 1
    finally:
        from ..runtime import lifecycle

        lifecycle.stop()
    put("a", rec)


# ------------------------------------------------------------------ leg b

def _leg_b(role, cfg, device, put):
    """W0-W3 under ``run_elastic``; W2 dies at B_KILL_AT."""
    from ..collectives import cuda_ring
    from ..examples import mnist_elastic
    from ..runtime import failure, lifecycle
    from ..utils.checkpoint import CheckpointManager
    from ..utils.data import synthetic_mnist

    me = int(role[1])
    d = os.path.join(cfg["dir"], "b")
    _start(device, me, 4, "world-b", cfg)
    args = mnist_elastic.parse_args(
        ["--batch", str(BATCH), "--lr", str(LR), "--seed", str(SEED)])
    hb = failure.HeartbeatMonitor(me, [tuple(e) for e in cfg["udp"]],
                                  interval=HB_INTERVAL_S,
                                  timeout=HB_TIMEOUT_S, startup_grace=60.0)
    # Every monitor must have heard every peer before the death: a peer
    # never heard from is judged on the long startup grace instead.
    deadline = time.monotonic() + 30.0
    while len(hb.heard_peers()) < 3 and time.monotonic() < deadline:
        time.sleep(HB_INTERVAL_S)
    steps: List[Dict[str, Any]] = []
    box = {"n": _launches(), "mem_before": None, "t_detect": None,
           "t_resume": None, "t_first_done": None}
    held = {"rings": 0, "unequal": 0, "max_abs_err": 0.0}

    def on_step(step, state, p):
        n = _launches()
        now = time.time()
        steps.append({"step": step, "p": p, "loss": float(state["loss"]),
                      "launches": n - box["n"], "wall": now})
        box["n"] = n
        if step == B_KILL_AT - 1 and box["mem_before"] is None:
            box["mem_before"] = _mem_gb(device)
        if box["t_detect"] is not None and box["t_first_done"] is None:
            box["t_first_done"] = now

    inner = mnist_elastic.make_build(args, synthetic_mnist(n=8192), device,
                                     on_step)

    def build(ranks, restored):
        state, step_fn = inner(ranks, restored)

        def step(state, s):
            if me == 2 and s == B_KILL_AT:
                _die(cfg, "b")
            if box["t_detect"] is not None and box["t_resume"] is None:
                box["t_resume"] = time.time()
                box["resumed_at"] = s
                # The first step at p = 3: its rings against the plain
                # version.
                return _held_step(step_fn, state, s, held)
            return step_fn(state, s)

        return state, step

    def healthy():
        deadline = time.monotonic() + 10 * HB_TIMEOUT_S
        while not hb.dead_peers() and time.monotonic() < deadline:
            time.sleep(HB_INTERVAL_S)
        return [r for r in range(4) if r not in hb.dead_peers()]

    def on_restart(n, exc):
        box["t_detect"] = time.time()
        box["fault"] = f"{type(exc).__name__}: {str(exc)[:300]}"
        box["recoverable"] = failure.is_device_failure(exc)

    t0 = time.perf_counter()
    try:
        out = failure.run_elastic(
            build, CheckpointManager(d, save_interval=B_CKPT),
            n_steps=B_STEPS, healthy_ranks=healthy, on_restart=on_restart,
            max_restarts=1)
        kill = json.load(open(os.path.join(cfg["dir"], "killed-b.json")))
        rec = {"steps": steps, "restarts": out["restarts"],
               "ranks": out["ranks"], "size": lifecycle.size(),
               "digest": _digest(out["state"]["params"]),
               "fault": box.get("fault"),
               "recoverable": box.get("recoverable"),
               "resumed_at": box.get("resumed_at"),
               "kill_to_detect_s": box["t_detect"] - kill["wall"],
               "detect_to_resume_s": box["t_resume"] - box["t_detect"],
               "detect_to_first_step_s": box["t_first_done"]
               - box["t_detect"],
               "mem_before_gb": box["mem_before"],
               "mem_after_gb": _mem_gb(device),
               "held_rings": held,
               # The old world's blocks, kept by the local teardown until
               # the new world's start.
               "retired_left": len(cuda_ring._retired),
               "dead": hb.dead_peers()}
    finally:
        hb.stop()
    rec["seconds"] = time.perf_counter() - t0
    lifecycle.stop()
    put("b", rec)


def _die(cfg, leg: str) -> None:
    """SIGKILL this process, its kill journaled first (``chaos.fault``,
    so the journals name their own cause) and its wall time left for the
    survivors."""
    from ..obs import journal

    now = time.time()
    with open(os.path.join(cfg["dir"], f"killed-{leg}.json"), "w") as f:
        json.dump({"wall": now, "pid": os.getpid()}, f)
    journal.emit("chaos.fault", fault="kill", pid=os.getpid(), leg=leg)
    os.kill(os.getpid(), signal.SIGKILL)


# -------------------------------------------------------------- legs c, d

class _Member:
    """One member's training under the resize and election planes: the
    engine's step boundary consults the controller; a commit or a
    failover ends ``train`` and the engine is rebuilt over the re-formed
    world."""

    def __init__(self, role, cfg, device, ds, probe, ctl, params, t, put):
        from ..runtime import election

        self.role, self.cfg, self.device = role, cfg, device
        self.ds, self.probe, self.ctl, self.put = ds, probe, ctl, put
        self.params, self.t = params, t
        self.steps: List[Dict[str, Any]] = []
        self.probes: List[Dict[str, Any]] = []
        self.windows: List[Dict[str, Any]] = []
        self.failover: Dict[str, Any] = {}
        det = election.HealthzDetector(
            {tuple(cfg["ring"][r]): tuple(cfg["http"][r]) for r in ROLES},
            timeout_s=0.75)
        self.coord = election.ElectionCoordinator(ctl, detector=det)
        orig = self.coord.on_boundary_fault

        def on_fault(exc):
            t0 = time.time()
            before = {"epoch": self.ctl.membership.epoch,
                      "aborted": dict(self.ctl.last_aborted or {}),
                      "fault": type(exc).__name__}
            out = orig(exc)
            self.failover = {**before, "after_epoch":
                             self.ctl.membership.epoch,
                             "size": self.ctl.membership.size,
                             "seconds": time.time() - t0,
                             "detect_wall": t0}
            return out

        self.coord.on_boundary_fault = on_fault
        self._pre = None
        orig_boundary = ctl.step_boundary

        def boundary():
            from ..runtime import resize

            epoch0 = ctl.membership.epoch
            out = orig_boundary()
            if out != resize.CONTINUE:
                self.windows.append({
                    "outcome": out, "from_epoch": epoch0,
                    "to_epoch": ctl.membership.epoch, "at": self.t,
                    "pause_ms": ctl.last_pause_s * 1e3,
                    "leader_probe_before": self._pre})
            self._pre = None
            return out

        ctl.step_boundary = boundary
        self.mark = _launches()
        self.record_probe("start")

    def record_probe(self, why: str) -> None:
        self.probes.append({"why": why, "epoch": self.ctl.membership.epoch,
                            "t": self.t,
                            "probe": _probe(self.params, self.probe)})

    def state(self) -> Dict[str, Any]:
        """What the leader ships to a joiner: the card's parameters on the
        host, and the next step."""
        import numpy as np

        out = {k: v.detach().cpu().numpy() for k, v in self.params.items()}
        out["t"] = np.array([self.t], np.int64)
        return out

    def run(self, until: int, actions) -> str:
        """Train to step ``until``; ``actions[t]`` runs on the leader at
        step t's boundary (before the controller's poll).  Returns
        ``"done"`` or ``"departed"``."""
        from ..engine import AllReduceSGDEngine
        from ..models import mlp
        from ..runtime import stack
        from ..utils.data import ShardedIterator

        while self.t < until:
            comm = stack.world()
            p = comm.size
            engine = AllReduceSGDEngine(mlp.loss_fn, lr=LR, comm=comm,
                                        mode="compiled",
                                        sync_parameters_on_start=False)
            engine.resize_controller = self.ctl
            engine.election_coordinator = self.coord
            batches = list(ShardedIterator(self.ds, global_batch=BATCH
                                           - BATCH % p, num_shards=p,
                                           seed=3))

            def on_update(state, p=p):
                n = _launches()
                self.params, self.t = state["params"], state["t"]
                now = time.time()
                self.steps.append({
                    "step": state["t"] - 1, "p": p,
                    "epoch": self.ctl.membership.epoch,
                    "loss": float(state["loss"]),
                    "launches": n - self.mark, "wall": now})
                self.mark = n
                act = actions.get(state["t"] - 1)
                if act is not None and self.ctl.is_leader:
                    self._pre = _probe(self.params, self.probe)
                    act(self)

            engine.hooks = {"on_update": on_update}
            it = (batches[s % len(batches)] for s in range(self.t, until))
            state = engine.train(self.params, it, start_step=self.t)
            self.params, self.t = state["params"], state["t"]
            if state.get("departed"):
                return "departed"
            if state.get("resized"):
                self.record_probe(f"epoch {self.ctl.membership.epoch}")
        return "done"

    def report(self, **extra) -> Dict[str, Any]:
        return {"steps": self.steps, "probes": self.probes,
                "windows": self.windows, "failover": self.failover,
                "epoch": self.ctl.membership.epoch,
                "rank": self.ctl.rank, "size": self.ctl.membership.size,
                "leader": self.ctl.leader_rank,
                "digest": _digest(self.params), **extra}


def _controller(cfg, members: List[str], epoch: int, me: str, device,
                state_of):
    from ..collectives.hostcomm import HostCommunicator
    from ..runtime import resize

    eps = [tuple(cfg["ring"][r]) for r in members]
    comm = HostCommunicator(members.index(me), len(eps), eps,
                            timeout_ms=30000, io_deadline_ms=HC_DEADLINE_MS)
    return resize.ResizeController(
        comm, resize.Membership(epoch, eps), state_provider=state_of,
        ring_factory=_ring_factory,
        world_hook=resize.card_world_hook(cfg["dir"], device,
                                          timeout_s=PG_TIMEOUT_S))


def _ring_factory(rank, endpoints, timeout_ms=30000):
    from ..collectives.hostcomm import HostCommunicator

    return HostCommunicator(rank, len(endpoints), list(endpoints),
                            timeout_ms=timeout_ms,
                            io_deadline_ms=HC_DEADLINE_MS)


def _wait(events, name: str, timeout_s: float = JOIN_TIMEOUT_S) -> None:
    if not events[name].wait(timeout_s):
        raise TimeoutError(f"event {name} was never set")


def _actions(cfg, events):
    """The leader's scripted proposals, by the step whose boundary runs
    them."""
    from ..runtime import chaos

    def chaos_grow(m):
        _wait(events, "j4_first")
        target = tuple(cfg["sync"]["J4"][0])
        proxy = chaos.ChaosProxy(
            target, chaos.FaultSpec(blackhole_after_bytes=4096), seed=0)
        m.proxy = proxy
        m.ctl.propose(join=[{"ring": cfg["ring"]["J4"],
                             "sync": proxy.endpoint}])

    def grow(m):
        m.proxy.close()
        _wait(events, "j4_retry")
        _wait(events, "j5_first")
        m.ctl.propose(join=[
            {"ring": cfg["ring"]["J4"], "sync": cfg["sync"]["J4"][1]},
            {"ring": cfg["ring"]["J5"], "sync": cfg["sync"]["J5"][0]}])

    def drain(m):
        m.ctl.propose(drain=[3])

    def handoff(m):
        m.coord.handoff(reason="drill")

    def grow_w3(m):
        _wait(events, "w3_first")
        m.ctl.propose(join=[{"ring": cfg["ring"]["W3"],
                             "sync": cfg["sync"]["W3"][0]}])

    def die_in_window(m):
        m.put("d_leader", m.report(killed=True))

        def phase(name, proposal):
            if name == "verdict":
                _die(cfg, "d")

        m.ctl._phase = phase
        m.ctl.propose(drain=[m.ctl.membership.size - 1])

    return {C_CHAOS_AT: chaos_grow, C_GROW_AT: grow, C_DRAIN_AT: drain,
            D_HANDOFF_AT: handoff, D_GROW_AT: grow_w3,
            D_KILL_AT: die_in_window}


def _serve(cfg, role):
    from ..obs import metrics, serve

    return serve.ObsHTTPServer(port=cfg["http"][role][1],
                               registry=metrics.Registry(),
                               health=serve.HealthState())


def _founder(role, cfg, device, put, events):
    """W0 and W1: the 2-rank loop of leg c, then leg d."""
    from ..runtime import lifecycle

    ds, probe = _data(device)
    srv = _serve(cfg, role)
    try:
        lifecycle.start(device, rank=int(role[1]), world_size=2,
                        init_method="file://" + os.path.join(
                            cfg["dir"], "world-c"),
                        timeout_s=PG_TIMEOUT_S)
        events["c_started"].set()
        from ..models import mlp

        box = {}
        ctl = _controller(cfg, ["W0", "W1"], 0, role, device,
                          lambda: box["m"].state())
        m = box["m"] = _Member(role, cfg, device, ds, probe, ctl,
                               mlp.init(SEED, device=device), 0, put)
        outcome = m.run(D_END, _actions(cfg, events))
        put("cd", m.report(outcome=outcome))
    finally:
        srv.close()
        lifecycle.stop()


def _joiner(role, cfg, device, put, events):
    """J4, J5 (leg c) and W3 (leg d): listen, receive the state behind the
    fence, join the card's world and train on."""
    import torch

    from ..runtime import lifecycle, resize

    ds, probe = _data(device)
    srv = _serve(cfg, role)
    try:
        box: Dict[str, Any] = {}
        hook = resize.card_world_hook(cfg["dir"], device,
                                      timeout_s=PG_TIMEOUT_S)
        aborted = None
        if role == "J4":
            _wait(events, "c_started", WALL_S)
            li = resize.JoinListener(port=cfg["sync"]["J4"][0][1])
            events["j4_first"].set()
            try:
                li.wait(timeout_s=CHAOS_JOIN_TIMEOUT_S,
                        ring_factory=_ring_factory)
                raise AssertionError("the blackholed ship committed")
            except resize.ResizeAborted as e:
                aborted = f"{type(e).__name__}: {e}"
            port = cfg["sync"]["J4"][1][1]
            flag = "j4_retry"
        else:
            if role == "J5":
                _wait(events, "c_started", WALL_S)
            port = cfg["sync"][role][0][1]
            flag = f"{role.lower()}_first"
        li = resize.JoinListener(port=port)
        events[flag].set()
        ctl, state = li.wait(timeout_s=JOIN_TIMEOUT_S + 60,
                             ring_factory=_ring_factory,
                             state_provider=lambda: box["m"].state(),
                             world_hook=hook)
        t = int(state.pop("t")[0])
        params = {k: torch.from_numpy(v).to(device) for k, v in state.items()}
        m = box["m"] = _Member(role, cfg, device, ds, probe, ctl, params, t,
                               put)
        outcome = m.run(D_END, _actions(cfg, events))
        extra = {"outcome": outcome, "chaos_abort": aborted}
        if outcome == "done" and m.ctl.rank != 0:
            extra["post_resize_non_leader"] = _post_resize(srv.url)
        put("cd", m.report(**extra))
    finally:
        srv.close()
        lifecycle.stop()


def _post_resize(url: str) -> Dict[str, Any]:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url + "/resize", data=b'{"drain": [1]}',
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return {"code": r.status, "body": json.loads(r.read())}
    except urllib.error.HTTPError as e:
        return {"code": e.code, "body": json.loads(e.read()),
                "location": e.headers.get("Location")}


def _proc_main(role, cfg, events, q):
    os.environ.update(cfg["env"][role])

    def put(leg, rec):
        q.put((role, leg, True, rec))

    try:
        device = _setup(role, cfg)
        if role in ("W0", "W1", "W2", "W3"):
            _leg_a(role, cfg, device, put)
            _leg_b(role, cfg, device, put)
            if role in ("W0", "W1"):
                _founder(role, cfg, device, put, events)
            else:
                _joiner(role, cfg, device, put, events)
        else:
            _joiner(role, cfg, device, put, events)
        q.put((role, "end", True, None))
    except BaseException:  # noqa: BLE001 - sent to the parent
        q.put((role, "error", False, traceback.format_exc()))


# ----------------------------------------------------------------- driver

def _free_ports(n: int, kind) -> List[int]:
    import socket

    socks = [socket.socket(socket.AF_INET, kind) for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def run(device: str = "cuda", directory: str = None) -> Dict[str, Any]:
    """Spawn the six processes, run the four legs, collect every record;
    then the journals' root-cause analysis."""
    import multiprocessing as mp
    import queue as _queue
    import socket

    from ..obs import rca

    own = directory is None
    directory = directory or tempfile.mkdtemp(prefix="elastic_drill_")
    tcp = _free_ports(15, socket.SOCK_STREAM)
    udp = _free_ports(4, socket.SOCK_DGRAM)
    ep = [("127.0.0.1", p) for p in tcp]
    cfg = {"device": device, "dir": os.path.abspath(directory),
           "udp": [("127.0.0.1", p) for p in udp],
           "ring": {r: ep[i] for i, r in enumerate(ROLES)},
           "http": {r: ep[6 + i] for i, r in enumerate(ROLES)},
           "sync": {"J4": [ep[12], ep[13]], "J5": [ep[14]],
                    "W3": [("127.0.0.1", _free_ports(
                        1, socket.SOCK_STREAM)[0])]},
           "env": {}}
    master = _free_ports(1, socket.SOCK_STREAM)[0]
    for i, r in enumerate(ROLES):
        cfg["env"][r] = {"RANK": str(i), "WORLD_SIZE": "4",
                         "LOCAL_RANK": str(i), "LOCAL_WORLD_SIZE": "6",
                         "MASTER_ADDR": "127.0.0.1",
                         "MASTER_PORT": str(master)}
    ctx = mp.get_context("spawn")
    events = {n: ctx.Event() for n in ("c_started", "j4_first", "j4_retry",
                                       "j5_first", "w3_first")}
    q = ctx.Queue()
    procs = {r: ctx.Process(target=_proc_main, args=(r, cfg, events, q),
                            daemon=True) for r in ROLES}
    t0 = time.perf_counter()
    for pr in procs.values():
        pr.start()
    recs: Dict[str, Dict[str, Any]] = {r: {} for r in ROLES}
    errors: Dict[str, str] = {}
    # W1 and W2 die by design; every other role sends "end".
    expect = {"W0", "W3", "J4", "J5"}
    deadline = time.monotonic() + WALL_S
    try:
        while not expect <= set(r for r in ROLES if "end" in recs[r]):
            if errors or time.monotonic() > deadline:
                break
            try:
                role, leg, ok, rec = q.get(timeout=0.5)
            except _queue.Empty:
                dead = [r for r in expect if not procs[r].is_alive()
                        and "end" not in recs[r]]
                if dead:
                    errors.update({r: "exited without finishing"
                                   for r in dead})
                continue
            if not ok:
                errors[role] = rec
            else:
                recs[role][leg] = rec
    finally:
        for pr in procs.values():
            pr.join(timeout=10)
        for pr in procs.values():
            if pr.is_alive():
                pr.kill()
                pr.join()
    seconds = time.perf_counter() - t0
    report = rca.analyze(os.path.join(directory, "journal"), top=10)
    journal = _journal_counts(os.path.join(directory, "journal"))
    out = {"device": device, "seconds": seconds, "errors": errors,
           "records": recs, "http": {r: list(e) for r, e in
                                     cfg["http"].items()}, "rca": [v["rule"] for v in report["verdicts"]],
           "journal": journal,
           "exitcodes": {r: procs[r].exitcode for r in ROLES}}
    if own:
        import shutil

        shutil.rmtree(directory, ignore_errors=True)
    return out


def _journal_counts(directory: str) -> Dict[str, Any]:
    from ..obs import journal

    recs = journal.load_dir(directory)
    kinds: Dict[str, int] = {}
    for r in recs:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    resolve = [r["data"] for r in recs if r["kind"] == "election.resolve"]
    return {"kinds": kinds, "resolve": resolve}


# ----------------------------------------------------------------- checks

def _steps(recs, role, leg):
    return recs[role].get(leg, {}).get("steps", [])


def _restart_s(steps) -> float:
    i = next(i for i, s in enumerate(steps) if s["p"] == 2)
    return steps[i]["wall"] - steps[i - 1]["wall"]


def summary(out: Dict[str, Any]) -> Dict[str, Any]:
    """The drill's numbers: the launches of the ring kernel by leg and
    p, the restart and detection seconds, ``scale.pause_ms``."""
    recs = out["records"]
    by_p: Dict[str, Dict[int, int]] = {}
    total = 0
    for role in ROLES:
        for leg in ("a", "b", "cd", "d_leader"):
            for s in _steps(recs, role, leg):
                key = by_p.setdefault("cd" if leg == "d_leader" else leg, {})
                key[s["p"]] = key.get(s["p"], 0) + s["launches"]
                total += s["launches"]
    total += sum(recs[r].get("a", {}).get("alone_launches", 0)
                 for r in ("W0", "W1"))
    b = [recs[r]["b"] for r in ("W0", "W1", "W3") if "b" in recs[r]]
    windows = [w for r in ROLES for leg in ("cd", "d_leader")
               for w in recs[r].get(leg, {}).get("windows", [])]
    fo = [recs[r]["cd"]["failover"] for r in ("J4", "W3")
          if recs[r].get("cd", {}).get("failover")]
    return {
        "seconds": out["seconds"], "ring_allreduce_launches": total,
        "launches_by_leg_and_p": by_p,
        "a_seconds": max((recs[r]["a"]["seconds"] for r in ROLES[:4]
                          if "a" in recs[r]), default=None),
        # The injected fault to the end of the first step after it: the
        # last step at p = 4 to the first at p = 2.
        "a_restart_s": max((_restart_s(recs[r]["a"]["steps"])
                            for r in ("W0", "W1") if "a" in recs[r]),
                           default=None),
        "b_kill_to_detect_s": max((r["kill_to_detect_s"] for r in b),
                                  default=None),
        "b_detect_to_resume_s": max((r["detect_to_resume_s"] for r in b),
                                    default=None),
        "b_detect_to_first_step_s": max(
            (r["detect_to_first_step_s"] for r in b), default=None),
        "b_mem_delta_gb": max((r["mem_after_gb"] - r["mem_before_gb"]
                               for r in b), default=None),
        "scale_pause_ms": max((w["pause_ms"] for w in windows),
                              default=None),
        "pauses_ms": {f"{w['outcome']} {w['from_epoch']}->{w['to_epoch']}":
                      w["pause_ms"] for w in windows},
        "failover_s": max((f["seconds"] for f in fo), default=None),
        "rca": out["rca"]}


def checks(out: Dict[str, Any]) -> List[str]:
    """What failed, one line each (empty when the drill passed)."""
    from ..collectives.cuda_ring import RING_TIMEOUT_S

    bad: List[str] = []
    recs = out["records"]
    cuda = out["device"] != "cpu"

    def need(ok, what):
        if not ok:
            bad.append(what)

    def launches_ok(steps, ps):
        return all(s["launches"] == (RINGS_PER_STEP if s["p"] > 1 else 0)
                   for s in steps if s["p"] in ps) and \
            {s["p"] for s in steps} >= set(ps)

    need(not out["errors"], f"process errors: {out['errors']}")
    need(out["exitcodes"].get("W1") == -signal.SIGKILL
         and out["exitcodes"].get("W2") == -signal.SIGKILL,
         f"the killed ranks' exit codes: {out['exitcodes']}")
    # a: the injected fault.
    a = {r: recs[r].get("a") for r in ROLES[:4]}
    if all(a.values()):
        need(not a["W0"]["departed"] and not a["W1"]["departed"]
             and a["W2"]["departed"] and a["W3"]["departed"],
             "a: W0-W1 survive, W2-W3 leave")
        steps = a["W0"]["steps"]
        resumed = next((s["step"] for s in steps if s["p"] == 2), None)
        want = (A_FAIL_AT - 1) // A_CKPT * A_CKPT + 1
        need(resumed == want, f"a: resumed at {resumed}, expected {want}")
        losses = [s["loss"] for s in steps]
        need(all(x == x and abs(x) != float("inf") for x in losses)
             and losses[-1] < losses[0], f"a: losses {losses}")
        need(a["W0"]["digest"] == a["W1"]["digest"],
             "a: the replicas differ after the restart")
        need(a["W0"]["alone_digest"] == a["W0"]["digest"]
             and a["W1"]["alone_digest"] == a["W1"]["digest"],
             "a: the 2-rank run started alone from the checkpoint differs")
        need(a["W0"]["restarts"] == 1, "a: restarts != 1")
        if cuda:
            need(launches_ok(steps, (4, 2)),
                 "a: ring launches are not 3 a step at p = 4 and 2")
    else:
        bad.append("a: records missing")
    # b: the real death.
    b = {r: recs[r].get("b") for r in ("W0", "W1", "W3")}
    if all(b.values()):
        want = (B_KILL_AT - 1) // B_CKPT * B_CKPT + 1
        for r, x in b.items():
            need(x["restarts"] == 1 and x["size"] == 3 and x["recoverable"]
                 and x["ranks"] == [0, 1, 3] and x["resumed_at"] == want,
                 f"b {r}: {x['fault']} restarts {x['restarts']} size "
                 f"{x['size']} ranks {x['ranks']} resumed {x['resumed_at']}")
            need(x["kill_to_detect_s"] <= RING_TIMEOUT_S + 5.0,
                 f"b {r}: detection took {x['kill_to_detect_s']:.1f} s")
            need(x["mem_after_gb"] - x["mem_before_gb"] <= MEM_SLACK_GB,
                 f"b {r}: card memory {x['mem_before_gb']:.3f} -> "
                 f"{x['mem_after_gb']:.3f} GB")
            losses = [s["loss"] for s in x["steps"]]
            need(all(v == v and abs(v) != float("inf") for v in losses)
                 and losses[-1] < losses[0], f"b {r}: losses {losses}")
            need(not x["retired_left"],
                 f"b {r}: {x['retired_left']} ring blocks of the old world "
                 f"left unfreed")
            held = x["held_rings"]
            need(held["rings"] == RINGS_PER_STEP and not held["unequal"],
                 f"b {r}: the first step at p = 3 against B1's plain "
                 f"version: {held}")
            if cuda:
                need("RingTimeout" in (x["fault"] or ""),
                     f"b {r}: the fault was {x['fault']}")
                need(launches_ok(x["steps"], (4, 3)),
                     f"b {r}: ring launches not 3 a step at p = 4 and 3")
        need(len({x["digest"] for x in b.values()}) == 1,
             "b: the survivors' replicas differ")
    else:
        bad.append("b: records missing")
    # c and d: resize and election.
    cd = {r: recs[r].get("cd") for r in ("W0", "J4", "J5", "W3")}
    lead = recs["W1"].get("d_leader")
    if all(cd.values()) and lead:
        w0 = cd["W0"]
        outcomes = [(w["outcome"], w["from_epoch"], w["to_epoch"])
                    for w in w0["windows"]]
        need(outcomes[:4] == [("aborted", 0, 0), ("committed", 0, 1),
                              ("committed", 1, 2), ("departed", 2, 3)],
             f"c/d: W0's windows {outcomes}")
        need(cd["J4"]["chaos_abort"] is not None,
             "c: the blackholed joiner did not abort")
        ab = [s for s in w0["steps"] if s["epoch"] == 0]
        need(ab and ab[-1]["step"] >= C_GROW_AT,
             "c: the old ring did not train on after the abort")
        # Continuity: the leader's probe loss just before each commit is
        # every member's just after it, to the bit.
        probes = {}
        for r in ("W0", "J4", "J5", "W3"):
            for pr in cd[r]["probes"]:
                probes.setdefault(pr["epoch"], set()).add(pr["probe"])
        for pr in lead["probes"]:
            probes.setdefault(pr["epoch"], set()).add(pr["probe"])
        for w in w0["windows"] + lead["windows"]:
            if w["outcome"] == "committed" and w["leader_probe_before"]:
                seen = probes.get(w["to_epoch"], set())
                need(seen == {w["leader_probe_before"]},
                     f"c/d: epoch {w['to_epoch']}: probe losses {seen}, "
                     f"the leader's before {w['leader_probe_before']}")
        need(cd["J5"]["outcome"] == "departed",
             "c: the drained joiner did not depart")
        steps = w0["steps"] + cd["J4"]["steps"]
        if cuda:
            need(launches_ok(steps, (2, 4, 3)),
                 "c: ring launches not 3 a step at p = 2, 4 and 3")
        fo = [cd[r]["failover"] for r in ("J4", "W3")]
        need(all(f and f["epoch"] == fo[0]["epoch"]
                 and f["aborted"] == fo[0]["aborted"] and f["aborted"]
                 and f["after_epoch"] == f["epoch"] + 1 and f["size"] == 2
                 for f in fo), f"d: failover records {fo}")
        need(cd["J4"]["rank"] == 0 and cd["W3"]["rank"] == 1
             and cd["J4"]["outcome"] == cd["W3"]["outcome"] == "done"
             and cd["J4"]["digest"] == cd["W3"]["digest"],
             "d: the survivors did not finish as one 2-rank replica")
        post = cd["W3"].get("post_resize_non_leader") or {}
        from_j4 = list(out.get("http", {}).get("J4", []))
        need(post.get("code") == 307
             and post.get("body", {}).get("leader_endpoint") == from_j4,
             f"d: POST /resize to a non-leader: {post}")
        kinds = out["journal"]["kinds"]
        need(kinds.get("election.claim") == 1,
             f"d: {kinds.get('election.claim')} epoch claims")
        need([r.get("verdict") for r in out["journal"]["resolve"]]
             == ["aborted"], f"d: resolved {out['journal']['resolve']}")
    else:
        bad.append("c/d: records missing")
    for rule in ("aborted_resize", "leader_failover"):
        need(rule in out["rca"], f"rca: {rule} not named ({out['rca']})")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="'cpu' or 'cuda'")
    ap.add_argument("--dir", default=None,
                    help="keep the journals and checkpoints here")
    args = ap.parse_args(argv)
    if args.device != "cpu":
        from .. import _build

        _build.build("ring")
    out = run(args.device, args.dir)
    failed = checks(out)
    print(json.dumps({"summary": summary(out), "failed": failed}),
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
