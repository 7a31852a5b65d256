"""Elastic resize, leader election and the root-cause reader of the port
(``runtime/{resize,election}.py``, ``obs/rca.py``) held against the JAX
package's on the CPU, in threads of this process over loopback rings.

* **The mixed ring.**  A control ring whose members are a JAX
  ``ResizeController`` (over JAX's ``HostCommunicator``) and a port one
  (over the port's): the leader of either package grows it by a JAX and a
  port joiner and drains it back.  Every member reaches the same epochs
  and ranks, the state each joiner receives equals the shipped arrays
  bit for bit, and every ring after a commit sums right.
* **Each leg alone**, port only: proposal validation, no proposal, two
  grows to epochs 1 then 2, a stale request rejected at pop, the joiner's
  fence, drain and evict, a blackholed ship that aborts with the epoch
  unchanged (and a clean retry), a member killed in quiesce.
* **Election**: ``successor``, one claim per epoch, a handoff with its
  replayed inbox, a failover after the leader dies at each phase of the
  window (one resolved verdict), and ``HealthzDetector`` over live
  ``/healthz`` endpoints.
* **The route**: ``POST /resize`` and its typed 307 answer as JAX's, in
  code, body and ``Location``.
* **RCA**: a journal directory both packages wrote (a JAX chaos-aborted
  ship, a port failover): both packages' ``analyze`` name the same rules,
  ``aborted_resize`` and ``leader_failover`` among them.

Every wait is bounded (rings wire within 30 s, every result within 90 s,
``urlopen`` 5 s).
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from torchmpi_tpu.collectives import hostcomm as jhc
from torchmpi_tpu.obs import journal as jjournal
from torchmpi_tpu.obs import metrics as jmetrics
from torchmpi_tpu.obs import rca as jrca
from torchmpi_tpu.obs import serve as jserve
from torchmpi_tpu.runtime import chaos as jchaos
from torchmpi_tpu.runtime import config as jconfig
from torchmpi_tpu.runtime import election as jelection
from torchmpi_tpu.runtime import resize as jresize
from torchmpi_tpu_torch.collectives import hostcomm as thc
from torchmpi_tpu_torch.obs import journal as tjournal
from torchmpi_tpu_torch.obs import metrics as tmetrics
from torchmpi_tpu_torch.obs import rca as trca
from torchmpi_tpu_torch.obs import serve as tserve
from torchmpi_tpu_torch.runtime import chaos as tchaos
from torchmpi_tpu_torch.runtime import config as tconfig
from torchmpi_tpu_torch.runtime import election as telection
from torchmpi_tpu_torch.runtime import resize as tresize
from torchmpi_tpu_torch.runtime.failure import InjectedFault

WALL = 90.0
PKG = {"jax": (jhc, jresize, jelection), "port": (thc, tresize, telection)}


@pytest.fixture(autouse=True)
def _fresh():
    for cfg, rz, el in ((jconfig, jresize, jelection),
                        (tconfig, tresize, telection)):
        cfg.reset()
        rz._clear_requests()
        el.reset()
    yield
    for cfg, rz, el in ((jconfig, jresize, jelection),
                        (tconfig, tresize, telection)):
        rz._clear_requests()
        el.reset()
        cfg.reset()


def _endpoints(n):
    return [("127.0.0.1", p) for p in thc.free_ports(n)]


def _wire(kinds, eps, io_deadline_ms=0):
    """One ring over ``eps``: rank r a ``kinds[r]`` ("jax" or "port")
    ``HostCommunicator``."""
    n = len(eps)
    with ThreadPoolExecutor(n) as ex:
        futs = [ex.submit(PKG[k][0].HostCommunicator, r, n, eps, 30000, None,
                          io_deadline_ms) for r, k in enumerate(kinds)]
        return [f.result(timeout=60) for f in futs]


def _kind(ctl):
    return "port" if isinstance(ctl, tresize.ResizeController) else "jax"


def _controllers(kinds, eps, comms, **kw):
    return [PKG[k][1].ResizeController(c, PKG[k][1].Membership(0, eps), **kw)
            for k, c in zip(kinds, comms)]


def _boundaries(ctls, listeners=(), timeout_s=30.0):
    with ThreadPoolExecutor(len(ctls) + len(listeners)) as ex:
        bf = [ex.submit(c.step_boundary) for c in ctls]
        jf = [ex.submit(li.wait, timeout_s) for li in listeners]
        res = []
        for f in bf + jf:
            try:
                res.append(f.result(timeout=WALL))
            except Exception as e:  # noqa: BLE001 — asserted by callers
                res.append(e)
    return res[:len(ctls)], res[len(ctls):]


def _close_all(ctls):
    for c in ctls:
        try:
            c.comm.close()
        except Exception:  # noqa: BLE001 — already closed
            pass


def _allreduce_check(ctls):
    """Every member's ring sums right, in its own package's array type."""
    n = len(ctls)

    def work(c):
        if _kind(c) == "jax":
            a = np.full((16,), float(c.rank + 1), np.float32)
            c.comm.allreduce(a)
            return float(a[0])
        return float(c.comm.allreduce(torch.full((16,), float(c.rank + 1)))[0])

    with ThreadPoolExecutor(n) as ex:
        vals = list(ex.map(work, ctls))
    assert vals == [float(sum(range(1, n + 1)))] * n


# --------------------------------------------------------- the mixed ring

STATE = {"w0": np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
         "b0": np.linspace(-1, 1, 5).astype(np.float32),
         "t": np.array([41], np.int64)}


@pytest.mark.parametrize("kinds", [["jax", "port"], ["port", "jax"]],
                         ids=["jax_leads", "port_leads"])
def test_mixed_ring_grows_and_drains_as_one(kinds):
    eps = _endpoints(2)
    ctls = _controllers(kinds, eps, _wire(kinds, eps),
                        state_provider=lambda: dict(STATE))
    joiners = []
    try:
        lis = [jresize.JoinListener(), tresize.JoinListener()]
        ring = _endpoints(2)
        ctls[0].propose(join=[{"ring": ring[0], "sync": lis[0].endpoint},
                              {"ring": ring[1], "sync": lis[1].endpoint}])
        outs, joins = _boundaries(ctls, lis)
        assert outs == ["committed", "committed"], outs
        for ctl, shipped in joins:
            joiners.append(ctl)
            assert sorted(shipped) == sorted(STATE)
            for k, v in STATE.items():
                assert shipped[k].dtype == v.dtype
                assert shipped[k].tobytes() == v.tobytes()
        members = ctls + joiners
        assert [c.rank for c in members] == [0, 1, 2, 3]
        assert [_kind(c) for c in joiners] == ["jax", "port"]
        assert {c.membership.epoch for c in members} == {1}
        assert len({c.membership.endpoints for c in members}) == 1
        _allreduce_check(members)
        # Drain the JAX joiner (rank 2): the port joiner renumbers to 2.
        ctls[0].propose(drain=[2])
        outs, _ = _boundaries(members)
        assert outs == ["committed", "committed", "departed", "committed"]
        survivors = ctls + [joiners[1]]
        assert [c.rank for c in survivors] == [0, 1, 2]
        assert {c.membership.epoch for c in members} == {2}
        _allreduce_check(survivors)
    finally:
        _close_all(ctls + joiners)


# --------------------------------------------------------------- each leg

def _port(n, **kw):
    eps = _endpoints(n)
    kinds = ["port"] * n
    return eps, _controllers(kinds, eps, _wire(kinds, eps), **kw)


def test_propose_validation():
    eps, ctls = _port(2)
    try:
        with pytest.raises(tresize.ResizeRejected):
            ctls[1].propose(drain=[1])              # not the leader
        with pytest.raises(tresize.ResizeRejected):
            ctls[0].propose(drain=[0])              # the leader itself
        assert ctls[0].propose(evict=[0], handoff=True)
        ctls[0]._pending.clear()
        with pytest.raises(tresize.ResizeRejected):
            ctls[0].propose(drain=[5])              # unknown rank
        with pytest.raises(tresize.ResizeRejected):
            ctls[0].propose(join=[{"ring": eps[1], "sync": eps[0]}])
        with pytest.raises(tresize.ResizeRejected):
            ctls[0].propose(drain=[1], target_epoch=0)
        outs, _ = _boundaries(ctls)
        assert outs == ["continue", "continue"]
    finally:
        _close_all(ctls)


def test_epochs_monotonic():
    """Two grows commit as epochs 1 then 2; each joiner is out of its
    fence once it holds the committed membership."""
    _, ctls = _port(2, state_provider=lambda: {"w": np.arange(4.0)})
    try:
        for want in (1, 2):
            li = tresize.JoinListener()
            ctls[0].propose(join=[{"ring": _endpoints(1)[0],
                                   "sync": li.endpoint}])
            outs, joins = _boundaries(ctls, [li])
            assert all(o == "committed" for o in outs), outs
            ctl, state = joins[0]
            assert not li.fenced and not ctl.fenced
            assert list(state) == ["w"]
            ctls.append(ctl)
            assert {c.membership.epoch for c in ctls} == {want}
        _allreduce_check(ctls)
    finally:
        _close_all(ctls)


def test_join_fence_discards_the_state_on_abort():
    """A joiner that received the state, when the ship to another joiner
    fails, hears ABORT: it stays fenced and raises, the state unused."""
    tconfig.set("resize_io_deadline_ms", 1500)
    _, ctls = _port(2, state_provider=lambda: {"w": np.zeros(1 << 18)})
    good, bad = tresize.JoinListener(), tresize.JoinListener()
    proxy = tchaos.ChaosProxy(bad.endpoint,
                              tchaos.FaultSpec(blackhole_after_bytes=0))
    ring = _endpoints(2)
    try:
        ctls[0].propose(join=[{"ring": ring[0], "sync": good.endpoint},
                              {"ring": ring[1], "sync": proxy.endpoint}])
        outs, joins = _boundaries(ctls, [good])
        assert outs == ["aborted", "aborted"]
        assert isinstance(joins[0], tresize.ResizeAborted)
        assert "fence holds" in str(joins[0]) and good.fenced
        assert {c.membership.epoch for c in ctls} == {0}
    finally:
        proxy.close()
        bad.close()
        _close_all(ctls)


def test_stale_request_rejected_at_pop():
    _, ctls = _port(3)
    try:
        ctls[0].propose(drain=[2])
        ctls[0].propose(drain=[2])    # stale once the first commits
        outs, _ = _boundaries(ctls)
        assert outs[2] == "departed"
        outs, _ = _boundaries(ctls[:2])
        assert outs == ["continue", "continue"]
        assert {c.membership.epoch for c in ctls[:2]} == {1}
    finally:
        _close_all(ctls)


@pytest.mark.parametrize("how", ["drain", "evict_request"])
def test_drain_and_evict_renumber(how):
    _, ctls = _port(3)
    try:
        if how == "drain":
            ctls[0].propose(drain=[1])
        else:
            tconfig.set("resize_enabled", True)
            assert tresize.enqueue_request({"action": "evict",
                                            "rank": 1}) == 1
        outs, _ = _boundaries(ctls)
        assert outs == ["committed", "departed", "committed"]
        assert [ctls[0].rank, ctls[2].rank] == [0, 1]
        assert {c.membership.epoch for c in ctls} == {1}
        assert tresize.pending_requests() == 0
        _allreduce_check([ctls[0], ctls[2]])
    finally:
        _close_all(ctls)


def test_blackholed_ship_aborts_then_retry_commits():
    tconfig.set("resize_io_deadline_ms", 1500)
    _, ctls = _port(2, state_provider=lambda: {"w": np.zeros(1 << 18)})
    li = tresize.JoinListener()
    proxy = tchaos.ChaosProxy(li.endpoint,
                              tchaos.FaultSpec(blackhole_after_bytes=0),
                              seed=7)
    ring = _endpoints(1)[0]
    try:
        ctls[0].propose(join=[{"ring": ring, "sync": proxy.endpoint}])
        outs, _ = _boundaries(ctls)
        assert outs == ["aborted", "aborted"]
        assert {c.membership.epoch for c in ctls} == {0}
        assert proxy.stats["blackholes"] >= 1
        _allreduce_check(ctls)                  # the old ring trains on
        li2 = tresize.JoinListener()
        ctls[0].propose(join=[{"ring": ring, "sync": li2.endpoint}])
        outs, joins = _boundaries(ctls, [li2])
        assert outs == ["committed", "committed"]
        ctls.append(joins[0][0])
        assert {c.membership.epoch for c in ctls} == {1}
        _allreduce_check(ctls)
    finally:
        proxy.close()
        li.close()
        _close_all(ctls)


class _DiesInQuiesce(tresize.ResizeController):
    """This member is killed inside the window, before the quiesce
    barrier."""

    def _run_proposal(self, proposal, cfg):
        self.comm.close()
        raise InjectedFault("killed mid-quiesce")


def test_member_killed_in_quiesce_aborts_with_the_epoch_unchanged():
    eps = _endpoints(3)
    comms = _wire(["port"] * 3, eps, io_deadline_ms=3000)
    m = tresize.Membership(0, eps)
    ctls = [tresize.ResizeController(comms[0], m),
            tresize.ResizeController(comms[1], m),
            _DiesInQuiesce(comms[2], m)]
    li = tresize.JoinListener()
    try:
        ctls[0].propose(join=[{"ring": _endpoints(1)[0],
                               "sync": li.endpoint}])
        outs, _ = _boundaries(ctls)
        assert isinstance(outs[2], InjectedFault)
        assert all(isinstance(o, tresize.ResizeAborted) for o in outs[:2])
        assert {c.membership.epoch for c in ctls} == {0}
        assert all(c.last_aborted["target_epoch"] == 1 for c in ctls[:2])
    finally:
        li.close()
        _close_all(ctls)


# --------------------------------------------------------------- election

def test_successor_and_the_fence():
    m = tresize.Membership(3, [("h", 1), ("h", 2), ("h", 3), ("h", 4)])
    assert telection.successor(m, dead=[0]) == (1, ("h", 2))
    assert telection.successor(m, dead=[2]) == (0, ("h", 1))
    with pytest.raises(telection.ElectionFenced):
        telection.successor(m, dead=[0, 1, 2, 3])
    telection.claim_epoch(1, term=1, leader=1)
    with pytest.raises(telection.ElectionFenced):
        telection.claim_epoch(1, term=1, leader=2)
    telection.note_epoch(5)
    with pytest.raises(telection.ElectionFenced):
        telection.claim_epoch(5, term=2, leader=0)
    telection.claim_epoch(6, term=2, leader=0)


def test_handoff_transfers_the_role_and_replays_the_inbox():
    tconfig.set("resize_enabled", True)
    _, ctls = _port(3)
    try:
        tresize.enqueue_request({"action": "drain", "rank": 1})
        telection.ElectionCoordinator(ctls[0]).handoff(reason="test")
        assert tresize.pending_requests() == 0
        outs, _ = _boundaries(ctls)
        assert outs == ["departed", "committed", "committed"]
        survivors = ctls[1:]
        assert [c.rank for c in survivors] == [0, 1]
        assert survivors[0].is_leader
        assert tresize.pending_requests() == 1   # the replay, re-queued
        info = telection.leader_info()
        assert info["rank"] == 0 and info["epoch"] == 1
        outs, _ = _boundaries(survivors)
        assert outs == ["committed", "departed"]
    finally:
        _close_all(ctls)


class _LeaderDiesAt(tresize.ResizeController):
    die_at = "quiesce"

    def _phase(self, name, proposal):
        if name == self.die_at:
            self.comm.close()
            raise InjectedFault(f"leader killed at {name}")


@pytest.mark.parametrize("die_at", ["quiesce", "verdict"])
def test_failover_after_the_leader_dies_in_the_window(die_at, tmp_path):
    tconfig.set("journal_enabled", True)
    tconfig.set("journal_dir", str(tmp_path))
    tjournal.reset()
    eps = _endpoints(3)
    comms = _wire(["port"] * 3, eps, io_deadline_ms=3000)
    m = tresize.Membership(0, eps)
    leader = _LeaderDiesAt(comms[0], m)
    leader.die_at = die_at
    ctls = [leader] + [tresize.ResizeController(c, m) for c in comms[1:]]

    class _Det:
        def dead_ranks(self, m):
            return {0}

    try:
        leader.propose(drain=[2])
        outs, _ = _boundaries(ctls)
        assert isinstance(outs[0], InjectedFault)
        assert all(isinstance(o, tresize.ResizeAborted) for o in outs[1:])
        coords = [telection.ElectionCoordinator(c, detector=_Det())
                  for c in ctls[1:]]
        with ThreadPoolExecutor(2) as ex:
            res = [f.result(timeout=WALL) for f in
                   [ex.submit(co.on_boundary_fault, outs[1])
                    for co in coords]]
        assert res == ["committed", "committed"]
        survivors = ctls[1:]
        assert [c.rank for c in survivors] == [0, 1]
        assert all(c.membership.epoch == 1 for c in survivors)
        _allreduce_check(survivors)
        recs = tjournal.load_dir(str(tmp_path))
        kinds = [r["kind"] for r in recs]
        assert kinds.count("election.claim") == 1
        resolves = [r["data"] for r in recs
                    if r["kind"] == "election.resolve"]
        assert [(r["verdict"], r["target_epoch"]) for r in resolves] == \
            [("aborted", 1)]
        assert "election.resume" in kinds
    finally:
        _close_all(ctls)
        tjournal.reset()


def test_healthz_detector_over_live_endpoints():
    reg = tmetrics.Registry()
    ring_a, ring_b = ("127.0.0.1", 1001), ("127.0.0.1", 1002)
    with tserve.ObsHTTPServer(registry=tmetrics.Registry(),
                              health=tserve.HealthState(),
                              scrape=False) as srv:
        det = telection.HealthzDetector(
            {ring_a: srv.address, ring_b: ("127.0.0.1",
                                           thc.free_ports(1)[0])},
            timeout_s=1.0, registry=reg)
        assert det.alive(ring_a) is True
        assert det.alive(ring_b) is False
        assert det.alive(("127.0.0.1", 9)) is None
        m = tresize.Membership(0, [ring_a, ring_b])
        assert det.dead_ranks(m) == {1}
        assert det.probe_leader(m, 0) is True
        assert reg.peek("tmpi_leader_missing").value() == 0.0
        assert det.probe_leader(m, 1) is False
        assert reg.peek("tmpi_leader_missing").value() == 1.0
        assert telection.control_endpoint(ring_a) == tuple(srv.address)


# -------------------------------------------------------------- the route

def _post(url, body):
    req = urllib.request.Request(url + "/resize", data=body, method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=5) as r:
            return r.status, json.loads(r.read()), r.headers.get("Location")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers.get("Location")


def _route_script(serve, metrics, config, resize, election):
    srv = serve.ObsHTTPServer(registry=metrics.Registry(),
                              health=serve.HealthState(), scrape=False)
    try:
        out = [_post(srv.url, b'{"action": "drain"}')]        # unarmed
        config.set("resize_enabled", True)
        out.append(_post(srv.url, b'{"action": "drain"}'))    # queued
        out.append(_post(srv.url, b"not json"))
        out.append(_post(srv.url, b"[1]"))
        election.publish_leader(2, is_self=False,
                                endpoint=("127.0.0.1", 8123), epoch=4)
        out.append(_post(srv.url, b'{"action": "drain"}'))    # the 307
        out.append(resize.pending_requests())
    finally:
        srv.close()
    return out


def test_resize_route_answers_as_jax():
    got = _route_script(tserve, tmetrics, tconfig, tresize, telection)
    want = _route_script(jserve, jmetrics, jconfig, jresize, jelection)
    assert got == want
    assert [r[0] for r in got[:5]] == [409, 200, 400, 400, 307]
    assert got[4][1]["leader_endpoint"] == ["127.0.0.1", 8123]
    assert got[4][2] == "http://127.0.0.1:8123/resize"


# ------------------------------------------------------------------- RCA

def test_rca_names_the_chains_from_both_packages_journals(tmp_path):
    """A JAX chaos-aborted ship and a port failover journal into one
    directory; both packages' ``analyze`` name the same verdicts."""
    jconfig.set("journal_enabled", True)
    jconfig.set("journal_dir", str(tmp_path))
    jconfig.set("resize_io_deadline_ms", 1000)
    jjournal.reset()
    eps = _endpoints(2)
    ctls = _controllers(["jax"] * 2, eps, _wire(["jax"] * 2, eps),
                        state_provider=lambda: {"w": np.zeros(1 << 18)})
    li = jresize.JoinListener()
    proxy = jchaos.ChaosProxy(li.endpoint,
                              jchaos.FaultSpec(blackhole_after_bytes=0))
    try:
        ctls[0].propose(join=[{"ring": _endpoints(1)[0],
                               "sync": proxy.endpoint}])
        outs, _ = _boundaries(ctls)
        assert outs == ["aborted", "aborted"]
    finally:
        proxy.close()
        li.close()
        _close_all(ctls)
        jjournal.reset()
        jconfig.reset()
    test_failover_after_the_leader_dies_in_the_window("verdict", tmp_path)
    got = [v["rule"] for v in trca.analyze(str(tmp_path), top=10)
           ["verdicts"]]
    want = [v["rule"] for v in jrca.analyze(str(tmp_path), top=10)
            ["verdicts"]]
    assert got == want
    assert {"aborted_resize", "leader_failover"} <= set(got)


# ------------------------------------------------------ the engine's boundary

class _StubController:
    def __init__(self, after, outcome):
        self.after, self.outcome, self.calls = after, outcome, 0
        self.membership = tresize.Membership(7, [("127.0.0.1", 1)])

    def step_boundary(self):
        self.calls += 1
        return self.outcome if self.calls >= self.after else "continue"


@pytest.mark.parametrize("outcome,after", [("departed", 3),
                                           ("committed", 2)])
def test_engine_boundary_ends_train(outcome, after):
    """As JAX's engine: DEPARTED ends ``train`` with ``departed``,
    COMMITTED with ``resized`` = the new epoch, for the caller to rebuild
    over the re-formed world; ``on_end`` does not run."""
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.runtime import lifecycle

    def loss(params, batch):
        xb, yb = batch
        return torch.mean((xb @ params["w"] - yb) ** 2)

    lifecycle.start(device="cpu")
    try:
        ended = []
        eng = AllReduceSGDEngine(loss, lr=0.01, mode="compiled",
                                 hooks={"on_end": ended.append})
        stub = eng.resize_controller = _StubController(after, outcome)
        rng = np.random.default_rng(0)
        it = [(rng.normal(size=(1, 2, 4)).astype(np.float32),
               rng.normal(size=(1, 2)).astype(np.float32))] * 6
        state = eng.train({"w": torch.zeros(4)}, it)
    finally:
        lifecycle.stop()
    assert stub.calls == after and state["t"] == after and not ended
    if outcome == "departed":
        assert state["departed"] is True and "resized" not in state
    else:
        assert state["resized"] == 7 and "departed" not in state
