"""Parity of the port's telemetry plane with the JAX package's.

The same calls go through both packages' ``obs`` modules: the metrics
registry's Prometheus exposition and JSON snapshot must be equal byte for
byte; ``HealthState.evaluate`` must give the same verdict under the same
marks, counters and flags on an injected clock; ``HistoryStore`` series,
rates and drifts must agree (rates and drifts within 1e-12 relative);
``AlertEngine`` must walk the same state sequence for the same samples on
a fake clock; ``merge_ranks``, ``flow_join_report``, ``collective_skew``
and ``skew_report`` must be equal on the same synthetic obsdumps.  Then
the port's own pieces: the device lane of ``export.chrome_trace`` from a
``torch.profiler`` Chrome trace, clock alignment over the port's host
ring, the feeds the registry unblocks (``publish_input`` from the device
stage, the parameter server's client counters) and the typed waits for
items 16-18.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from torchmpi_tpu.obs import aggregate as jaggregate
from torchmpi_tpu.obs import alerts as jalerts
from torchmpi_tpu.obs import export as jexport
from torchmpi_tpu.obs import history as jhistory
from torchmpi_tpu.obs import journal as jjournal
from torchmpi_tpu.obs import metrics as jmetrics
from torchmpi_tpu.obs import native as jnative
from torchmpi_tpu.obs import serve as jserve
from torchmpi_tpu.obs import tracer as jtracer
from torchmpi_tpu.runtime import config as jconfig

from torchmpi_tpu_torch.obs import aggregate as taggregate
from torchmpi_tpu_torch.obs import alerts as talerts
from torchmpi_tpu_torch.obs import clocksync as tclocksync
from torchmpi_tpu_torch.obs import export as texport
from torchmpi_tpu_torch.obs import history as thistory
from torchmpi_tpu_torch.obs import journal as tjournal
from torchmpi_tpu_torch.obs import metrics as tmetrics
from torchmpi_tpu_torch.obs import native as tnative
from torchmpi_tpu_torch.obs import serve as tserve
from torchmpi_tpu_torch.obs import tracer as ttracer
from torchmpi_tpu_torch.runtime import config as tconfig

JAX = {"metrics": jmetrics, "serve": jserve, "history": jhistory,
       "alerts": jalerts, "export": jexport, "aggregate": jaggregate,
       "native": jnative, "config": jconfig, "journal": jjournal}
PORT = {"metrics": tmetrics, "serve": tserve, "history": thistory,
        "alerts": talerts, "export": texport, "aggregate": taggregate,
        "native": tnative, "config": tconfig, "journal": tjournal}


@pytest.fixture(autouse=True)
def _fresh():
    for m in (JAX, PORT):
        m["config"].reset()
        m["journal"].reset()
        m["alerts"].reset()
        m["history"].reset()
    yield
    for m in (JAX, PORT):
        m["config"].reset()
        m["journal"].reset()
        m["alerts"].reset()
        m["history"].reset()


class FakeClock:
    """``time.monotonic`` of both packages' modules (they read it through
    the shared ``time`` module), moved by hand."""

    def __init__(self, t: float = 5000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# ------------------------------------------------------------- metrics

def _registry_script(metrics):
    """One registry driven through every metric kind, label escaping,
    set_to, replace/clear and both fold helpers."""
    reg = metrics.Registry()
    c = reg.counter("tmpi_req_total", "requests by outcome")
    c.inc(labels={"outcome": "done"})
    c.inc(2.5, labels={"outcome": 'sh"ed\\x\nline'})
    c.set_to(7, labels={"outcome": "done"})
    c.set_to(3, labels={"outcome": "done"})        # never goes back
    reg.counter("tmpi_bare_total").inc()
    reg.counter("tmpi_bare_total", "help arrives late")
    g = reg.gauge("tmpi_level", "a gauge\nwith a newline \\ and slash")
    g.set(1.25)
    g.set(-3.0, labels={"rank": "1", "plane": "ps"})
    info = reg.gauge("tmpi_info", "info gauge")
    info.set(1.0, labels={"cache": "a"})
    info.replace(1.0, labels={"cache": "b"})
    reg.gauge("tmpi_cleared", "cleared").set(4.0)
    reg.gauge("tmpi_cleared").clear()
    h = reg.histogram("tmpi_lat_seconds", "latency", buckets=(0.01, 0.1, 1))
    for v in (0.005, 0.05, 0.5, 5.0, 0.1):
        h.observe(v, labels={"op": "allreduce"})
    h.observe(0.2)
    spans = [{"name": "hostcomm.allreduce", "t0_ns": 0, "t1_ns": 3_000_000,
              "attrs": {"bytes": 4096}},
             {"name": "ps.push", "t0_ns": 10, "t1_ns": 5_000_010,
              "attrs": {"bytes": 70_000}},
             {"name": "hostcomm.barrier", "t0_ns": 5, "t1_ns": 5,
              "attrs": {}},
             {"name": "engine.step", "t0_ns": 0, "t1_ns": 9_000_000,
              "attrs": {}}]
    reg.observe_spans(spans)
    reg.observe_collectives(spans)
    return reg


def test_exposition_is_byte_equal():
    j, t = _registry_script(jmetrics), _registry_script(tmetrics)
    assert t.to_prometheus() == j.to_prometheus()
    assert t.to_json() == j.to_json()
    fams = t.collect() + t.collect()            # federation-style chunks
    assert t.to_prometheus(fams) == j.to_prometheus(j.collect() + j.collect())
    assert t.snapshot() == j.snapshot()


@pytest.mark.parametrize("n", [-1, 0, 1, 2, 63, 64, 65, 4095, 4097, 1 << 20,
                               (1 << 30) + 1, "x", None])
def test_bytes_bucket_matches_jax(n):
    assert tmetrics.bytes_bucket(n) == jmetrics.bytes_bucket(n)


@pytest.mark.parametrize("v", ["plain", 'q"uote', "back\\slash", "new\nline",
                               "\\n literal", 'all\\"\n'])
def test_label_escaping_matches_jax_and_round_trips(v):
    esc = tmetrics.escape_label_value(v)
    assert esc == jmetrics.escape_label_value(v)
    assert tmetrics.unescape_label_value(esc) == v


def test_kind_clash_raises_as_in_jax():
    for metrics in (jmetrics, tmetrics):
        reg = metrics.Registry()
        reg.counter("x")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("x")
        with pytest.raises(ValueError, match="only go up"):
            reg.counter("x").inc(-1)


def test_scrape_native_families_match_jax():
    """Both scrapes fill the same families (names, kinds, help, label
    sets), whether or not a PS engine is loaded in this process."""
    def shape(metrics):
        reg = metrics.Registry()
        reg.scrape_native()
        return [(f["name"], f["kind"], f["help"],
                 [k for k, _ in f["values"]]) for f in reg.collect()]

    assert shape(tmetrics) == shape(jmetrics)


# ----------------------------------------------------- health verdicts

def _health_script(serve, metrics, clock):
    """Marks, watched counters, the drain and diverged flags, a watchdog
    and an alert provider, evaluated at each step on the injected clock."""
    reg = metrics.Registry()
    h = serve.HealthState(error_window_s=10.0, name="h")
    out = []

    def ev():
        v = h.evaluate(registry=reg)
        for k in ("pid", "t_mono_ns", "planes"):
            v.pop(k)
        out.append(v)

    ev()                                             # empty: healthy
    h.note("engine_step")
    h.monitor("io", degraded_after_s=2.0, stalled_after_s=5.0)
    ev()
    clock.t += 3.0
    ev()                                             # io degraded
    clock.t += 3.0
    ev()                                             # io stalled
    h.note("io")
    reg.counter("tmpi_ps_failover_total", "f").inc()  # baseline
    ev()
    reg.counter("tmpi_ps_failover_total").inc()       # moved: degraded
    clock.t += 1.0
    ev()
    clock.t += 20.0                                  # out of the window
    h.note("io")
    h.note("engine_step")
    ev()
    h.set_draining(True)
    ev()
    h.set_diverged("layers.wq", step=7, outlier_ranks=[2], detail="x")
    clock.t += 1.5
    ev()                                             # diverged > draining
    h.clear_diverged()
    h.set_draining(False)
    h.register_watchdog(8.0)                         # 2 s / 4 s thresholds
    clock.t += 2.5
    ev()
    h.attach_alerts(lambda: [{"name": "step_rate_sag", "severity":
                              "warning", "phase": "data_wait"}])
    h.note("engine_step")
    h.note("io")
    h.note("watchdog")
    ev()                                             # alert: degraded
    h.attach_alerts(lambda: 1 / 0)                   # a failing provider
    ev()
    h.unregister_watchdog()
    h.clear("io")
    h.attach_alerts(None)
    clock.t += 200.0
    ev()                                             # engine_step stalled
    h.clear("engine_step")
    ev()
    out.append(h.mark_ages())
    return out


def test_health_verdicts_match_jax(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(time, "monotonic", clock)
    ref = _health_script(jserve, jmetrics, clock)
    clock.t = 5000.0
    got = _health_script(tserve, tmetrics, clock)
    assert got == ref
    assert [v["state"] for v in ref[:-1]] == [
        "healthy", "healthy", "degraded", "stalled", "healthy", "degraded",
        "healthy", "draining", "diverged", "degraded", "degraded",
        "healthy", "stalled", "healthy"]


def test_health_precedence_and_singletons_match_jax():
    for serve, metrics in ((jserve, jmetrics), (tserve, tmetrics)):
        reg = metrics.Registry()
        serve.health.reset()
        try:
            serve.begin_drain("handoff")
            assert serve.health.evaluate(registry=reg)["state"] == "draining"
            serve.health.monitor("engine_step", degraded_after_s=0.0,
                                 stalled_after_s=1e-9)
            time.sleep(0.002)
            assert serve.health.evaluate(registry=reg)["state"] == "stalled"
            serve.health.clear("engine_step")
            serve.end_drain()
            assert serve.health.evaluate(registry=reg)["state"] == "healthy"
        finally:
            serve.health.reset()


# ------------------------------------------------------ publish feeds

@pytest.mark.parametrize("phases", [None, {"data_wait": 0.01,
                                           "dispatch": 0.02,
                                           "collective": 0.03,
                                           "optimizer": 0.0, "ps": 0.004}])
def test_publish_step_and_input_match_jax(phases):
    def run(serve, metrics):
        reg = metrics.Registry()
        for t in range(3):
            serve.publish_step(step_s=0.25 + t, examples=64,
                               staged_bytes=1 << 20, overlap_fraction=1.4,
                               step=t, registry=reg, phases=phases)
            serve.publish_input(staged_bytes=4096, stage_s=0.002 * t,
                                wait_s=0.001, overlap_fraction=-0.5,
                                registry=reg)
        return reg.to_prometheus()

    assert run(tserve, tmetrics) == run(jserve, jmetrics)


def test_publish_step_numerics_waits_for_item_17():
    """``publish_step(numerics=...)`` records the sentinels
    (``obs/numerics.record_sentinels``): the same stats give the same
    exposition byte for byte in both packages, and the step gauges beside
    them."""
    from torchmpi_tpu.obs import numerics as jnumerics
    from torchmpi_tpu_torch.obs import numerics as tnumerics

    rng = np.random.default_rng(21)
    steps = [{"bucket_grad_norms": rng.uniform(1e-3, 50, 3).astype(
                  np.float32),
              "grad_norm": np.float32(rng.uniform(0.1, 10)),
              "nonfinite_count": np.int32(n),
              "update_ratio": np.float32(rng.uniform(1e-4, 1e-2))}
             for n in (0, 3, 0)]

    def run(serve, metrics, numerics, convert):
        numerics.reset()
        reg = metrics.Registry()
        for t, st in enumerate(steps):
            serve.publish_step(0.1, 32, 4096, 0.9, step=t, registry=reg,
                               numerics={k: convert(v)
                                         for k, v in st.items()})
        hist = [{k: v for k, v in r.items() if k != "wall_time"}
                for r in numerics.history()]
        numerics.reset()
        return reg.to_prometheus(), hist

    got = run(tserve, tmetrics, tnumerics,
              lambda v: torch.as_tensor(np.asarray(v)))
    want = run(jserve, jmetrics, jnumerics, lambda v: v)
    assert got == want
    assert "tmpi_numerics_nonfinite_total 3" in got[0]
    assert "tmpi_engine_steps_total 3" in got[0]


def test_metrics_feed_gate_matches_jax_without_numerics():
    """The feed gate's four clauses (endpoint, its knob, tracing, a
    sentinel mode of the numerics plane) in both packages, and the
    planes' knob reads."""
    for m in (JAX, PORT):
        assert m["serve"].metrics_feed() is False
        m["config"].set("obs_trace", True)
        assert m["serve"].metrics_feed() is True
        m["config"].reset()
        m["config"].set("obs_http", True)
        assert m["serve"].metrics_feed() is True
        m["config"].reset()
        for mode, fed in (("off", False), ("sentinel", True),
                          ("audit", True)):
            m["config"].set("numerics_mode", mode)
            assert m["serve"].metrics_feed() is fed
        m["config"].reset()
    assert tnative.serve_config() == jnative.serve_config()
    assert tnative.cluster_config() == jnative.cluster_config()


# ------------------------------------------------------------- history

def _rows(n=150, seed=0):
    rs = np.random.RandomState(seed)
    steps = np.cumsum(rs.uniform(0.5, 2.0, n))
    rows = []
    for i in range(n):
        row = {"tmpi_engine_steps_total": float(steps[i]),
               "tmpi_level": float(rs.uniform(-1, 1)),
               'tmpi_x{rank="0"}': float(i * 0.1)}
        if i % 7:
            row["tmpi_sparse"] = float(i)
        rows.append(row)
    return rows


def _history_script(history):
    st = history.HistoryStore(interval_s=0.5, tier_len=16, downsample=4)
    for i, row in enumerate(_rows()):
        st.record(1000.0 + 0.5 * i, row)
    out = {"tiers": st.tiers(), "keys": st.keys(),
           "all_keys": st.all_keys(), "newest": st.newest_t(),
           "absent": st.absent_before("tmpi_sparse", 1000.0 + 0.5 * 14),
           "doc": st.to_doc()}
    nums = {}
    for key in ("tmpi_engine_steps_total", "tmpi_level", "tmpi_sparse"):
        for w in (3.0, 20.0, 60.0, 500.0):
            out[("series", key, w)] = st.series(key, w)
            nums[("rate", key, w)] = st.rate(key, w)
            nums[("drift", key, w)] = st.drift(key, w / 4, 3 * w / 4)
            nums[("drift_rate", key, w)] = st.drift(key, w / 4, 3 * w / 4,
                                                     of_rate=True)
            nums[("rate_past", key, w)] = st.rate(key, w, now=1040.0)
    back = history.HistoryStore.from_doc(json.loads(json.dumps(st.to_doc())))
    out["roundtrip"] = back.to_doc() == json.loads(json.dumps(st.to_doc()))
    fl = history.flatten_families(_registry_script(
        tmetrics if history is thistory else jmetrics).collect())
    return out, nums, fl


def test_history_store_matches_jax():
    ref, ref_nums, ref_flat = _history_script(jhistory)
    got, got_nums, got_flat = _history_script(thistory)
    assert got == ref
    assert got_flat == ref_flat
    assert got_nums.keys() == ref_nums.keys()
    assert any(v is not None for v in ref_nums.values())
    for k, v in ref_nums.items():
        if v is None:
            assert got_nums[k] is None, k
        else:
            assert got_nums[k] == pytest.approx(v, rel=1e-12, abs=0.0), k


def test_history_persist_and_sampler(tmp_path):
    reg = tmetrics.Registry()
    reg.counter("tmpi_engine_steps_total", "s").inc(3)
    st = thistory.HistoryStore(interval_s=0.01, tier_len=8, downsample=2)
    s = thistory.Sampler(st, registry=reg, interval_s=0.01,
                         directory=str(tmp_path), rank=3, scrape=False)
    try:
        s.sample_once()
        reg.counter("tmpi_engine_steps_total").inc()
        s.sample_once()
    finally:
        s.stop()
    assert st.samples_total >= 2
    back = thistory.load(str(tmp_path / "history-3.json"))
    assert back is not None and back.samples_total == st.samples_total
    assert jhistory.HistoryStore.from_doc(back.to_doc()).keys() == st.keys()


def test_history_and_alerts_maybe_start_follow_their_knobs():
    assert thistory.maybe_start() is None and thistory.store() is None
    tconfig.set("history_enabled", True)
    tconfig.set("history_interval_s", 0.01)
    tconfig.set("alert_enabled", True)
    try:
        sampler = thistory.maybe_start(rank=0)
        assert sampler is not None and thistory.maybe_start() is sampler
        eng = talerts.engine()
        assert eng is not None and sampler.alert_engine is eng
        assert {r.name for r in eng.rules} == {
            r.name for r in jalerts.default_rules()}
        deadline = time.monotonic() + 5.0
        while thistory.store().samples_total < 2:
            assert time.monotonic() < deadline, "sampler never sampled"
            time.sleep(0.01)
    finally:
        thistory.reset()
    assert talerts.engine() is None and thistory.store() is None


# -------------------------------------------------------------- alerts

def _alert_specs():
    return [
        {"name": "hot", "kind": "threshold", "metric": "tmpi_level",
         "op": "gt", "value": 0.5, "window_s": 10.0, "for_s": 2.0},
        {"name": "dark", "kind": "absence", "metric": "tmpi_sparse",
         "window_s": 3.0, "for_s": 0.0, "severity": "critical"},
        {"name": "fast", "kind": "rate", "metric": "tmpi_engine_steps_total",
         "op": "gt", "value": 1.5, "window_s": 8.0, "for_s": 1.0},
        {"name": "sag", "kind": "drift", "metric": "tmpi_engine_steps_total",
         "of_rate": True, "op": "le", "value": 0.8, "window_s": 20.0,
         "for_s": 0.0, "phase": "auto"},
        {"name": "moved", "kind": "movement",
         "metric": ["tmpi_ps_failover_total", "tmpi_ps_promote_total"],
         "op": "ge", "value": 1.0, "window_s": 6.0, "for_s": 0.0,
         "summary": "moved {value:.0f}"},
        {"name": "skew", "kind": "share",
         "metric": "tmpi_rank_skew_attributed_seconds", "op": "ge",
         "value": 0.6, "window_s": 10.0, "for_s": 0.0, "phase": "collective"},
        {"name": "wd", "kind": "mark_age", "metric": "watchdog", "op": "ge",
         "value": 0.75, "for_s": 0.0, "severity": "critical"},
    ]


def _alert_script(alerts, history, serve, metrics, clock):
    rs = np.random.RandomState(1)
    st = history.HistoryStore(interval_s=1.0, tier_len=64, downsample=4)
    health = serve.HealthState()
    reg = metrics.Registry()
    rules = [alerts.AlertRule(s) for s in _alert_specs()]
    rules += alerts.default_rules(default_for_s=2.0)
    eng = alerts.AlertEngine(rules, store=st, health=health, registry=reg,
                             flight_on_critical=False)
    health.register_watchdog(8.0)
    seq = []
    steps, fail, skew = 0.0, 0.0, [0.0, 0.0]
    for i in range(90):
        t = 2000.0 + i
        clock.t = 100.0 + i
        steps += 2.0 if i < 40 else 0.5
        if i in (30, 31, 70):
            fail += 1
        skew[i % 2 if i < 50 else 1] += 0.05
        row = {"tmpi_engine_steps_total": steps,
               "tmpi_level": float(rs.uniform(0, 1)),
               "tmpi_ps_failover_total": fail,
               'tmpi_rank_skew_attributed_seconds{rank="0"}': skew[0],
               'tmpi_rank_skew_attributed_seconds{rank="1"}': skew[1],
               'tmpi_step_phase_seconds{phase="data_wait"}':
                   0.01 if i < 45 else 0.05,
               'tmpi_step_phase_seconds{phase="collective"}': 0.02}
        if i < 20 or i > 60:
            row["tmpi_sparse"] = float(i)
        if i % 10 == 0:
            health.note("watchdog")
        st.record(t, row)
        for tr in eng.evaluate(now=t):
            seq.append((i, tr))
    snap = eng.snapshot()
    # The engine's own gauges, its evaluation seconds (a timing) aside.
    own = [ln for ln in reg.to_prometheus().split("\n")
           if not ln.startswith("tmpi_alert_eval_seconds_total ")]
    return seq, snap, eng.firing(), own


def test_alert_state_sequences_match_jax(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(time, "monotonic", clock)
    ref = _alert_script(jalerts, jhistory, jserve, jmetrics, clock)
    got = _alert_script(talerts, thistory, tserve, tmetrics, clock)
    assert got[0] == ref[0]
    assert got[1] == ref[1]
    assert got[2] == ref[2]
    fired = {tr["rule"] for _, tr in ref[0] if tr["to"] == "firing"}
    assert {"hot", "dark", "fast", "sag", "moved", "skew", "wd",
            "ps_storm"} <= fired
    assert got[3] == ref[3]


def test_alert_rules_validate_and_load_as_in_jax(tmp_path):
    bad = [{"name": "k", "kind": "nope", "metric": "m"},
           {"name": "m", "kind": "threshold"},
           {"name": "o", "kind": "threshold", "metric": "m", "op": "eq"},
           {"name": "s", "kind": "threshold", "metric": "m",
            "severity": "page"}]
    for spec in bad:
        for alerts in (jalerts, talerts):
            with pytest.raises(ValueError):
                alerts.AlertRule(spec)
    path = tmp_path / "rules.json"
    path.write_text(json.dumps({"rules": [
        {"name": "step_rate_sag", "kind": "threshold", "metric": "g",
         "value": 9.0}]}))
    for m in (JAX, PORT):
        m["config"].set("alert_rules_path", str(path))
    cfg_j, cfg_t = jalerts.alerts_config(), talerts.alerts_config()
    assert cfg_t == cfg_j
    ej, et = jalerts.build_engine(cfg=cfg_j), talerts.build_engine(cfg=cfg_t)
    assert [r.to_doc() for r in et.rules] == [r.to_doc() for r in ej.rules]
    assert talerts.DEFAULT_PACK == jalerts.DEFAULT_PACK


def test_phase_seconds_match_jax():
    spans = [{"name": "engine.step", "t0_ns": 0, "t1_ns": 100},
             {"name": "engine.stage", "t0_ns": 0, "t1_ns": 10},
             {"name": "engine.dispatch", "t0_ns": 10, "t1_ns": 40},
             {"name": "hostcomm.allreduce", "t0_ns": 40, "t1_ns": 70},
             {"name": "ps.push", "t0_ns": 70, "t1_ns": 80},
             {"name": "engine.optimizer", "t0_ns": 80, "t1_ns": 99},
             {"name": "other", "t0_ns": 1, "t1_ns": 2},
             {"name": "engine.sync", "t0_ns": 90, "t1_ns": 200}]
    assert talerts.phase_seconds(spans) == jalerts.phase_seconds(spans)
    assert talerts.phase_seconds([]) == jalerts.phase_seconds([])


# ------------------------------------------------ export and aggregate

def _events(rank, t0, corr_base):
    rows = []
    for k in range(4):
        t = t0 + k * 1_000_000
        corr = corr_base + k if k < 3 else 0
        for phase, dt in ((0, 0), (1, 10_000), (2, 50_000), (4, 90_000)):
            rows.append({"t_ns": t + dt, "correlation": corr,
                         "bytes": 4096 * (k + 1), "rank": rank, "plane": 0,
                         "op": 1 if k % 2 == 0 else 5, "phase": phase})
    rows.append({"t_ns": t0 + 5_000_000, "correlation": 9, "bytes": 8,
                 "rank": rank, "plane": 1, "op": 2, "phase": 1})
    rows.append({"t_ns": t0 + 5_100_000, "correlation": 9, "bytes": 8,
                 "rank": rank, "plane": 1, "op": 2, "phase": 3})
    return rows


def _dumps(cluster_ids: bool):
    dumps = []
    for r in range(3):
        base = (1 << 63) | 0x100 if cluster_ids else ((r + 1) << 40)
        t0 = 10_000_000 + 333_000 * r
        spans = [{"name": "engine.step", "correlation": base + k,
                  "t0_ns": t0 + k * 1_000_000 - 5_000,
                  "t1_ns": t0 + k * 1_000_000 + 95_000, "thread": 77 + r,
                  "attrs": {"step": k, "obj": "x"}} for k in range(3)]
        clock = {"offset_ns": 250_000 * r, "uncertainty_ns": 1000 * r,
                 "applied": r == 2}
        dumps.append({"schema": "tmpi-obsdump-v1", "rank": r,
                      "spans": spans, "clock": clock,
                      "events": _events(r, t0, base)})
    return dumps


@pytest.mark.parametrize("cluster_ids", [True, False])
def test_merge_ranks_and_skew_match_jax(cluster_ids):
    dumps = _dumps(cluster_ids)
    ref = jexport.merge_ranks(dumps)
    got = texport.merge_ranks(dumps)
    assert got == ref
    assert texport.flow_join_report(got) == jexport.flow_join_report(ref)
    assert texport.merge_ranks(dumps, flows=False) == jexport.merge_ranks(
        dumps, flows=False)
    recs = taggregate.collective_skew(dumps)
    assert recs == jaggregate.collective_skew(dumps)
    assert recs and recs[0]["matched_by"] == (
        "correlation" if cluster_ids else "occurrence")
    rep = taggregate.skew_report(dumps, top=3)
    assert rep == jaggregate.skew_report(dumps, top=3)
    assert taggregate.format_report(rep) == jaggregate.format_report(rep)
    regs = []
    for aggregate, metrics in ((jaggregate, jmetrics),
                               (taggregate, tmetrics)):
        reg = metrics.Registry()
        aggregate.fold_skew_into_registry(recs, registry=reg)
        regs.append(reg.to_prometheus())
    assert regs[1] == regs[0]


def test_chrome_trace_and_join_rate_match_jax():
    rows = _events(0, 1_000_000, 0x500)
    ev_j = jaggregate.rows_to_events(rows)
    ev_t = taggregate.rows_to_events(rows)
    assert ev_t.tobytes() == ev_j.tobytes()
    spans = [{"name": "s", "correlation": 0x500 + k, "t0_ns": 900_000 + k,
              "t1_ns": 2_000_000, "thread": 3, "attrs": {"a": [1]}}
             for k in range(2)]
    assert texport.chrome_trace(spans, ev_t) == jexport.chrome_trace(
        spans, ev_j)
    assert texport.span_join_rate(spans, ev_t) == jexport.span_join_rate(
        spans, ev_j)
    assert taggregate.events_to_rows(ev_t) == jaggregate.events_to_rows(ev_j)
    assert taggregate.json_attrs({"a": 1, "b": (1,)}) == \
        jaggregate.json_attrs({"a": 1, "b": (1,)})


def test_device_lane_reads_a_torch_profiler_trace(tmp_path):
    """The one format that differs from JAX: the device lane comes from
    ``torch.profiler``'s Chrome trace.  A synthetic trace's kernels land
    one pid a device and one tid a stream, shifted to start at 0; a real
    CPU trace has no device work and adds no events."""
    trace = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 500.0, "dur": 4.0,
         "args": {"device": 0, "stream": 7}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 510.0,
         "dur": 2.0, "args": {"device": 0, "stream": 9}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 503.0, "dur": 0.0,
         "args": {"device": 1, "stream": 7}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1.0,
         "dur": 3.0}]}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(trace))
    out = texport.chrome_trace([], np.empty((0,), tnative.EVENT_DTYPE),
                               device_trace=str(path))
    dev = [e for e in out["traceEvents"] if e.get("cat") == "device"]
    assert [(e["name"], e["pid"] - texport._PID_DEVICE, e["tid"], e["ts"])
            for e in dev] == [("k1", 0, 7, 0.0), ("Memcpy HtoD", 0, 9, 10.0),
                              ("k2", 1, 7, 3.0)]
    assert dev[2]["dur"] > 0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.ones(4) @ torch.ones(4)
    real = tmp_path / "prof"
    real.mkdir()
    prof.export_chrome_trace(str(real / "cpu.json"))
    assert texport._device_events(str(real), 0.0) == []
    saved = texport.save(str(tmp_path / "m.json"), out)
    assert json.loads(open(saved).read()) == json.loads(json.dumps(out))


def test_obsdump_bundle_round_trips_through_both_merges(tmp_path):
    ttracer.drain()
    tconfig.set("obs_trace", True)
    with ttracer.span("engine.step",
                      correlation=ttracer.cluster_correlation("s", 1)):
        pass
    assert ttracer.cluster_correlation("a", 2) == \
        jtracer.cluster_correlation("a", 2)
    path = taggregate.write_obsdump(str(tmp_path), rank=4,
                                    clock={"offset_ns": 0})
    loaded = taggregate.load_obsdumps(str(tmp_path))
    assert [d["rank"] for d in loaded] == [4]
    assert loaded[0]["schema"] == jaggregate.SCHEMA
    assert path.endswith("obsdump-4.json")
    assert jexport.merge_ranks(loaded) == texport.merge_ranks(loaded)
    assert "tmpi_span_seconds" in loaded[0]["metrics"]


# ------------------------------------------------------------ clocksync

def test_clockmap_and_sampling_match_jax():
    from torchmpi_tpu.obs import clocksync as jclocksync

    for size in (1, 2, 5, 17):
        for k in (0, 1, 3, 40):
            assert tclocksync.sample_peers(size, k) == \
                jclocksync.sample_peers(size, k)
    cm = tclocksync.ClockMap([0, 5, -7], [1, 2, 3], rounds=4)
    d = cm.to_dict()
    assert d == jclocksync.ClockMap([0, 5, -7], [1, 2, 3],
                                    rounds=4).to_dict()
    assert tclocksync.ClockMap.from_dict(d).to_dict() == d
    assert repr(cm) == repr(jclocksync.ClockMap.from_dict(d))


def test_align_over_the_host_ring_recovers_a_planted_skew():
    """Two ranks of the port's host ring in one process (a thread each,
    every wait bounded): rank 1's clock runs 5 ms ahead; align recovers
    the offset within its published uncertainty, on both ranks, and
    apply/clear move the tracer's stamps."""
    from torchmpi_tpu_torch.collectives import hostcomm

    eps = [("127.0.0.1", p) for p in hostcomm.free_ports(2)]
    skew = 5_000_000
    out, errs = [None, None], []

    def rank(r):
        try:
            with hostcomm.HostCommunicator(r, 2, eps, io_deadline_ms=10000,
                                           timeout_ms=20000) as c:
                clock = (lambda: time.monotonic_ns() + skew) if r else \
                    time.monotonic_ns
                out[r] = tclocksync.align(c, rounds=4, clock=clock)
        except BaseException as e:  # noqa: BLE001 - reported below
            errs.append(e)

    ts = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts), "align did not finish"
    assert not errs, errs
    assert out[0].to_dict() == out[1].to_dict()
    off, unc = out[0].offset_ns[1], out[0].uncertainty_ns[1]
    assert abs(off - skew) <= unc + 1000
    assert out[0].offset_ns[0] == 0
    cal = tclocksync.last_calibration()
    assert cal["applied"] is False
    try:
        assert tclocksync.apply(out[1], 1) == off
        assert ttracer.clock_offset() == off
        assert abs(ttracer.now_ns() - (time.monotonic_ns() - off)) < 10**8
        assert tclocksync.last_calibration()["applied"] == (
            tclocksync._last_rank == 1)
    finally:
        tclocksync.clear()
    assert ttracer.clock_offset() == 0


# ------------------------------------------- the feeds the registry unblocks

def test_device_stage_publishes_the_input_feed():
    from torchmpi_tpu_torch.data.device import DeviceStage

    reg = tmetrics.registry
    before = reg.counter("tmpi_data_batches_total").value()
    staged = reg.counter("tmpi_data_staged_bytes_total").value()
    x = np.zeros((2, 3, 4), np.float32)
    y = np.zeros((2, 3), np.int32)
    batches = [(x, y)] * 3
    assert len(list(DeviceStage(batches, "cpu", 1))) == 3   # gate shut
    assert reg.counter("tmpi_data_batches_total").value() == before
    out = list(DeviceStage(batches, "cpu", 1, publish=True))
    assert len(out) == 3
    assert reg.counter("tmpi_data_batches_total").value() == before + 3
    assert reg.counter("tmpi_data_staged_bytes_total").value() > staged
    frac = reg.gauge("tmpi_data_input_overlap_fraction").value()
    assert 0.0 <= frac <= 1.0
    assert "tmpi_data_stage_seconds_count" in reg.to_prometheus()


def test_parameterserver_client_counters_live_in_the_registry():
    import torchmpi_tpu_torch.parameterserver as tps

    name = "tmpi_ps_test_only_total"
    c = tps._metric(name, "a counter of this test")
    c.inc()
    c.inc()
    assert tps.client_counters()[name] == 2
    assert tmetrics.registry.counter(name).value() == 2.0
    assert all(isinstance(v, int) for v in tps.client_counters().values())


def test_flight_bundle_carries_the_registry_and_segment(tmp_path):
    from torchmpi_tpu_torch.obs import flight

    tconfig.set("journal_enabled", True)
    tconfig.set("journal_dir", str(tmp_path / "j"))
    tjournal.emit("test.event", x=1)
    seg = tjournal.active_segment()
    assert seg is not None and seg.startswith(str(tmp_path / "j"))
    path = flight.dump("unit", directory=str(tmp_path))
    doc = json.loads(open(path).read())
    assert doc["journal_segment"] == seg
    assert "tmpi_obs_span_dropped_total" in doc["metrics"]
    assert doc["dropped"]["spans"] == ttracer.dropped()
    tjournal.set_rank(5)
    assert tjournal.rank() == 5
    tjournal.reset()
    tjournal.set_rank(0)
    assert tjournal.active_segment() is None
