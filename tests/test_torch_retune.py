"""Parity of the port's retune controller (``collectives/retune.py``) with
the JAX package's, and its wiring into the port.

Every lifecycle scenario of the JAX package's own tests runs through both
controllers under the same stub alert engine, stub history store and
clock: the state after every boundary, the journal's ``retune.*`` kinds
and their flips, priors and restores, the knobs after, the retune and
revert counts and the probes launched must all be equal (exact: states,
names and knob values).  Also: the ``autotune_mix_drift`` rule's level
from ``retune_mix_threshold`` and a seeded drift firing the real rule,
as in JAX; ``GET /retune`` answering as JAX's; the gate on
``retune_enabled``.

On the port alone, in one spawned gloo pool of 2 ranks on the CPU: the
engine consults the controller at the step boundary; with ``comm=`` only
rank 0's alert engine fires, and both ranks apply the same flips at the
same step, with the same boundary-pass doc installed and a
``retune.pause`` journaled on each.  In threads of this process: a resize
commit re-keys the winner cache.
"""

from __future__ import annotations

import json
import urllib.request

import pytest

from torchmpi_tpu.collectives import autotune as jautotune
from torchmpi_tpu.collectives import retune as jretune
from torchmpi_tpu.obs import alerts as jalerts
from torchmpi_tpu.obs import history as jhistory
from torchmpi_tpu.obs import journal as jjournal
from torchmpi_tpu.runtime import config as jconfig

from torchmpi_tpu_torch.collectives import autotune as tautotune
from torchmpi_tpu_torch.collectives import retune as tretune
from torchmpi_tpu_torch.obs import alerts as talerts
from torchmpi_tpu_torch.obs import history as thistory
from torchmpi_tpu_torch.obs import journal as tjournal
from torchmpi_tpu_torch.obs import metrics as tmetrics
from torchmpi_tpu_torch.obs import serve as tserve
from torchmpi_tpu_torch.runtime import config as tconfig

PKGS = {"jax": (jretune, jconfig, jjournal, jautotune),
        "port": (tretune, tconfig, tjournal, tautotune)}


@pytest.fixture(autouse=True)
def _fresh():
    for ret, cfg, jr, at in PKGS.values():
        cfg.reset()
        at.clear()
        at.clear_compiled()
        ret.uninstall()
        jr.reset()
    yield
    for ret, cfg, jr, at in PKGS.values():
        ret.uninstall()
        at.clear()
        at.clear_compiled()
        cfg.reset()
        jr.reset()


class StubAlertEngine:
    def __init__(self):
        self.rules = []

    def fire(self, *names):
        self.rules = [{"name": n, "severity": "warning", "since": 0.0,
                       "phase": "engine", "annotation": "stub"} for n in names]

    def firing(self):
        return self.rules


class StubStore:
    def __init__(self, r=10.0):
        self.r = r

    def rate(self, name, window, now=None):
        return self.r


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _controller(pkg, bench, rate=10.0, **cfg_over):
    ret = PKGS[pkg][0]
    eng, store, clock = StubAlertEngine(), StubStore(rate), Clock()
    cfg = ret.retune_config()
    cfg.update({"enabled": True, "debounce_s": 5.0, "cooldown_s": 60.0,
                "revert_window_s": 30.0, "revert_drift": 0.9,
                "poll_interval_steps": 1}, **cfg_over)
    ctl = ret.RetuneController(alert_engine=eng, store=store, now_fn=clock,
                               bench_fn=bench, cfg=cfg)
    return ctl, eng, store, clock


def _drive_to_apply(ctl, eng, clock, states, rule="step_rate_sag"):
    eng.fire(rule)
    states.append(ctl.step_boundary())
    clock.t += 6.0
    states.append(ctl.step_boundary())
    ctl.join()
    states.append(ctl.step_boundary())


def _doc(at):
    fp = {"version": 1, "device_count": 2, "knobs": {}}
    key = at.cell_key("allreduce", "float32", "4KiB", "tpu", "singlenode")
    return {"version": 1, "fingerprint": fp,
            "digest": at.fingerprint_digest(fp),
            "cells": {key: {"op": "allreduce", "dtype": "float32",
                            "bytes": 4096, "bucket": "4KiB",
                            "placement": "tpu", "scope": "singlenode",
                            "winner": "xla", "default": "pallas",
                            "ms": {"xla": 1.0, "pallas": 2.0}}}}


def _run(pkg, scenario, tmp_path, monkeypatch):
    """One scenario through one package's controller: what it did."""
    ret, cfg, jr, at = PKGS[pkg]
    cfg.set("journal_enabled", True)
    cfg.set("journal_dir", str(tmp_path / pkg))
    jr.reset()
    calls = []
    states = []

    def counted(res):
        def bench():
            calls.append(1)
            if isinstance(res, Exception):
                raise res
            return res() if callable(res) else res
        return bench

    over = {}
    if scenario == "poll_interval":
        over["poll_interval_steps"] = 3
    bench = {
        "barrier_win": {"overlap": {"win": -0.2}},
        "wash": {"overlap": {"win": 0.01}},
        "bench_error": RuntimeError("wire fell over"),
        "mix_drift": (lambda: {"pass_doc": _doc(at)}),
    }.get(scenario, {"overlap": {"win": 0.3}})
    ctl, eng, store, clock = _controller(pkg, counted(bench), **over)
    if scenario == "frozen":
        def frozen_set(k, v):
            raise RuntimeError("constants are frozen")
        monkeypatch.setattr(ret.config, "set", frozen_set)
    if scenario == "flap":
        eng.fire("step_rate_sag")
        states.append(ctl.step_boundary())
        eng.fire()
        clock.t += 2.0
        states.append(ctl.step_boundary())
        clock.t += 10.0
        states.append(ctl.step_boundary())
    elif scenario == "poll_interval":
        eng.fire("step_rate_sag")
        for _ in range(9):
            states.append(ctl.step_boundary())
            clock.t += 3.0
            ctl.join()
    else:
        rule = {"barrier_win": "overlap_collapse",
                "mix_drift": "autotune_mix_drift"}.get(scenario,
                                                       "step_rate_sag")
        _drive_to_apply(ctl, eng, clock, states, rule)
    if scenario == "cooldown":
        for _ in range(5):
            clock.t += 10.0
            states.append(ctl.step_boundary())
        clock.t += 15.0
        states.append(ctl.step_boundary())
        states.append(ctl.step_boundary())
        clock.t += 6.0
        states.append(ctl.step_boundary())
        ctl.join()
        states.append(ctl.step_boundary())
    elif scenario in ("revert", "drift_boundary"):
        store.r = 5.0 if scenario == "revert" else 9.0
        clock.t += 10.0
        states.append(ctl.step_boundary())
    elif scenario == "clean_window":
        store.r = 11.0
        clock.t += 31.0
        states.append(ctl.step_boundary())
        store.r = 1.0
        clock.t += 5.0
        states.append(ctl.step_boundary())
    monkeypatch.undo()
    events = [(e["kind"], {k: e["data"].get(k) for k in (
        "action", "flips", "applied", "priors", "restored",
        "reinstalled_cache", "rules") if k in e["data"]},
        "wire fell over" in str(e["data"].get("error")),
        "frozen" in str(e["data"].get("refused")))
        for e in jr.tail(256) if e["kind"].startswith("retune.")]
    active = at.active()
    snap = ctl.snapshot()
    return {"states": states, "events": events, "probes": len(calls),
            "retunes": ctl.retunes, "reverts": ctl.reverts,
            "knobs": (cfg.get("engine_async_drain"),
                      cfg.get("gradient_bucket_bytes")),
            "active_cells": sorted((active or {}).get("cells", {})),
            "snapshot": {k: snap[k] for k in ("state", "steps", "retunes",
                                              "reverts", "evidence_rules",
                                              "probe_in_flight",
                                              "cooldown_until")},
            "applied": snap["applied"]}


SCENARIOS = ["ready_win", "barrier_win", "wash", "flap", "cooldown",
             "bench_error", "frozen", "revert", "clean_window",
             "drift_boundary", "mix_drift", "poll_interval"]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_lifecycle_parity(scenario, tmp_path, monkeypatch):
    want = _run("jax", scenario, tmp_path, monkeypatch)
    got = _run("port", scenario, tmp_path, monkeypatch)
    assert got == want
    if scenario == "ready_win":
        assert want["knobs"] == ("ready", 16 << 20)
        assert [e[0] for e in want["events"]] == [
            "retune.probe", "retune.decision", "retune.apply",
            "retune.cooldown"]


def test_retune_config_reads_the_same_knobs():
    assert tretune.retune_config() == jretune.retune_config()
    for k in ("retune_debounce_s", "retune_mix_threshold",
              "autotune_trials", "autotune_online_min_samples"):
        assert tconfig.get(k) == jconfig.get(k)


def test_step_boundary_never_raises():
    ctl, *_ = _controller("port", lambda: {})
    ctl._tick = None
    assert ctl.step_boundary() == tretune.IDLE


@pytest.mark.parametrize("pass_kw, ops", [
    ({}, ("allreduce", "reduce_scatter", "allgather")),
    ({"placement": "cpu"}, tuple(jautotune.DEFAULT_OPS)),
    ({"ops": ("broadcast",)}, ("broadcast",)),
], ids=["device", "host", "named"])
def test_boundary_pass_times_the_ops_with_a_choice(pass_kw, ops,
                                                   monkeypatch):
    """Unless ``pass_kw`` names the ops, the boundary pass skips the cells
    of one candidate (broadcast and reduce ride gloo alone on the device
    column), and it runs at every applying boundary that has a world."""
    seen = []
    monkeypatch.setattr(tautotune, "run_pass",
                        lambda **kw: seen.append(kw) or {"cells": {}})
    ctl = tretune.RetuneController(alert_engine=StubAlertEngine(),
                                   store=StubStore(), comm=object(),
                                   pass_kw=pass_kw)
    out = ctl._pass_pause()
    assert out == {"pass_doc": {"cells": {}}}
    assert seen[0]["ops"] == ops and seen[0]["install"] is False
    assert ctl.last_pause_ms is not None


def test_maybe_install_gated_on_the_knob():
    assert tretune.maybe_install() is None and tretune.installed() is None
    tconfig.set("retune_enabled", True)

    class Eng:
        retune_controller = None

    eng = Eng()
    ctl = tretune.maybe_install(engine=eng, alert_engine=StubAlertEngine(),
                                store=StubStore())
    assert eng.retune_controller is ctl and tretune.installed() is ctl


@pytest.mark.parametrize("level", [0.5, 0.7])
def test_mix_drift_rule_level_is_the_knob(level):
    for cfg in (jconfig, tconfig):
        cfg.set("retune_mix_threshold", level)
    [j] = [r for r in jalerts.default_rules() if r.name == "autotune_mix_drift"]
    [t] = [r for r in talerts.default_rules() if r.name == "autotune_mix_drift"]
    assert t.value == j.value == level


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_seeded_drift_fires_the_real_rule(pkg):
    alerts, history = ((jalerts, jhistory) if pkg == "jax"
                       else (talerts, thistory))
    st = history.HistoryStore(interval_s=1.0)
    eng = alerts.build_engine(
        store=st, cfg={"enabled": True, "default_pack": True,
                       "rules_path": "", "eval_every": 1, "for_s": 3.0,
                       "flight": False})
    for i in range(10):
        st.record(1000.0 + i, {"tmpi_autotune_mix_drift": 0.8})
        eng.evaluate(now=1000.0 + i)
    assert "autotune_mix_drift" in [f["name"] for f in eng.firing()]


def test_retune_route_serves_the_installed_snapshot():
    srv = tserve.ObsHTTPServer(registry=tmetrics.Registry(),
                               health=tserve.HealthState(), scrape=False)
    try:
        def get():
            with urllib.request.urlopen(srv.url + "/retune",
                                        timeout=10) as r:
                return json.loads(r.read())

        assert get() == {"enabled": False}
        tconfig.set("retune_enabled", True)
        ctl = tretune.maybe_install(alert_engine=StubAlertEngine(),
                                    store=StubStore())
        ctl.step_boundary()
        doc = get()
        assert doc["enabled"] is True and doc["state"] == "idle"
        assert doc["steps"] == 1 and doc["rank"] == 0
        assert set(jretune.RetuneController(
            alert_engine=StubAlertEngine(), store=StubStore()).snapshot()
        ) <= set(doc)
    finally:
        srv.close()


def test_resize_commit_rekeys_the_winner_cache(tmp_path):
    """A drain from 2 members to 1 commits on both controllers; the cache
    keyed at 2 processes does not survive it."""
    from concurrent.futures import ThreadPoolExecutor

    from torchmpi_tpu_torch.collectives import hostcomm
    from torchmpi_tpu_torch.runtime import election, resize

    tconfig.set("journal_enabled", True)
    tconfig.set("journal_dir", str(tmp_path))
    tjournal.reset()
    eps = [("127.0.0.1", q) for q in hostcomm.free_ports(2)]
    with ThreadPoolExecutor(2) as ex:
        comms = [f.result(timeout=60) for f in [
            ex.submit(hostcomm.HostCommunicator, r, 2, eps, 30000, None,
                      20000) for r in range(2)]]
    ctls = [resize.ResizeController(c, resize.Membership(0, eps))
            for c in comms]
    doc = _doc(tautotune)
    doc["fingerprint"] = tautotune.fingerprint(process_count=2)
    doc["digest"] = tautotune.fingerprint_digest(doc["fingerprint"])
    tautotune._install(doc)
    try:
        ctls[0].propose(drain=[1])
        with ThreadPoolExecutor(2) as ex:
            outs = [f.result(timeout=60) for f in
                    [ex.submit(c.step_boundary) for c in ctls]]
        assert outs == ["committed", "departed"]
        assert tautotune.active() is None
        assert any(e["kind"] == "autotune.cache"
                   and e["data"]["result"] == "rekey"
                   for e in tjournal.tail(256))
    finally:
        for c in ctls:
            try:
                c.comm.close()
            except Exception:  # noqa: BLE001 — already closed
                pass
        # The commit moved this process's fence and leader view.
        resize._clear_requests()
        election.reset()


# ------------------------------------------------------- a pool of 2 ranks

def _setup():
    import os

    import torch
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

    pl = launch.Pool(2, setup=_setup, timeout_s=180)
    yield pl
    pl.close()


def _agreement_job(directory: str) -> dict:
    """Config 1's MLP at a small width in eager_async, 8 steps, with an
    agreeing controller on every rank: only rank 0's alert engine fires.
    Records the bucket knob each step saw and what each rank installed."""
    import numpy as np

    from torchmpi_tpu_torch.collectives import autotune, retune
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import mlp
    from torchmpi_tpu_torch.obs import journal
    from torchmpi_tpu_torch.runtime import communicator, config

    comm = communicator.stack.world()
    config.set("journal_enabled", True)
    config.set("journal_dir", directory)
    config.set("retune_enabled", True)
    journal.reset()
    eng_stub, clock = StubAlertEngine(), Clock()
    if comm.rank == 0:
        eng_stub.fire("step_rate_sag")
    rng = np.random.default_rng(5)
    batches = [(rng.random((2, 4, 784), np.float32),
                rng.integers(0, 10, (2, 4)).astype(np.int64))
               for _ in range(8)]
    seen = []

    def on_sample(state):
        seen.append((config.get("gradient_bucket_bytes"),
                     config.get("engine_async_drain")))

    def on_update(state):
        clock.t += 1.0
        ctl = retune.installed()
        if ctl.state == retune.PROBING:
            ctl.join()

    eng = AllReduceSGDEngine(mlp.loss_fn, lr=0.05, mode="eager_async",
                             hooks={"on_sample": on_sample,
                                    "on_update": on_update})
    config.set("engine_async_drain", "barrier")
    ctl = retune.maybe_install(
        engine=eng, alert_engine=eng_stub, store=StubStore(), now_fn=clock,
        bench_fn=lambda: {"overlap": {"win": 0.3}},
        pass_kw={"ops": ("allreduce",), "sizes": (1 << 10,), "trials": 1},
        cfg={"debounce_s": 2.0, "cooldown_s": 3.0}, comm=comm)
    eng.train(mlp.init(0, hidden=(32,), device="cpu"), batches)
    doc = autotune.active()
    kinds = [e["kind"] for e in journal.tail(256)
             if e["kind"].startswith("retune.")]
    return {"seen": seen, "retunes": ctl.retunes, "state": ctl.state,
            "steps": ctl.snapshot()["steps"], "kinds": kinds,
            "doc": None if doc is None else {k: doc[k] for k in
                                             ("digest", "cells")},
            "pause_ms": ctl.last_pause_ms}


def test_every_rank_applies_the_same_flips_at_the_same_step(pool, tmp_path):
    res = pool.run(_agreement_job, str(tmp_path))
    a, b = res
    assert a["seen"] == b["seen"]
    assert a["seen"][0] == (32 << 20, "barrier")
    # Evidence at the first boundary, the probe at the third (the 2 s
    # debounce), applied at the fourth: steps 5 on run on the flips.
    assert a["seen"][4:] == [(16 << 20, "ready")] * 4, a["seen"]
    assert a["retunes"] == b["retunes"] == 1
    assert a["doc"] == b["doc"] and a["doc"]["cells"]
    assert a["state"] == b["state"] and a["steps"] == b["steps"] == 8
    assert a["pause_ms"] > 0 and b["pause_ms"] > 0
    # The leader alone probes; every rank pauses for the pass and applies.
    applied = ["retune.pause", "retune.decision", "retune.apply",
               "retune.cooldown"]
    assert a["kinds"] == ["retune.probe"] + applied
    assert b["kinds"] == applied


def _probe_job() -> dict:
    """The engine consults an installed controller once per step."""
    import numpy as np

    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import mlp

    calls = []

    class Probe:
        def step_boundary(self):
            calls.append(1)

    rng = np.random.default_rng(1)
    batches = [(rng.random((2, 4, 784), np.float32),
                rng.integers(0, 10, (2, 4)).astype(np.int64))
               for _ in range(3)]
    eng = AllReduceSGDEngine(mlp.loss_fn, lr=0.05, mode="compiled")
    eng.retune_controller = Probe()
    eng.train(mlp.init(0, hidden=(16,), device="cpu"), batches)
    return len(calls)


def test_engine_consults_at_the_step_boundary(pool):
    assert pool.run(_probe_job) == [3, 3]
