"""Parity of the port's cluster federation (``obs/cluster.py``) with the JAX
package's.

The same exposition documents, written by the port's metrics registry
(counters, labelled gauges, a ``rank``-labelled skew gauge, a histogram,
escaped label values and help text), go through both packages:
``parse_prometheus`` equal, ``federate`` byte-equal flat and as a tree
(fan-in 2), ``merge_federated`` of shard documents equal to the flat merge,
and ``job_view`` over the same sweep results equal field for field at one
injected clock.  Then live: four of the port's endpoints (one diverged,
one closed) swept by both packages' ``fetch``, ``fetch_journal`` and
``fetch_alerts`` give the same views; ``top`` renders one sweep.  Exact
equality throughout: the modules share their text handling.
"""

from __future__ import annotations

import io
import socket
import time

import pytest

from torchmpi_tpu.obs import cluster as jcluster
from torchmpi_tpu.runtime import config as jconfig

from torchmpi_tpu_torch.obs import cluster as tcluster
from torchmpi_tpu_torch.obs import metrics as tmetrics
from torchmpi_tpu_torch.obs import serve as tserve
from torchmpi_tpu_torch.runtime import config as tconfig


@pytest.fixture(autouse=True)
def _fresh():
    for c in (jconfig, tconfig):
        c.reset()
    yield
    for c in (jconfig, tconfig):
        c.reset()


def _registry(rank: int, steps: int, mfu=None, skew=None):
    reg = tmetrics.Registry()
    reg.counter("tmpi_engine_steps_total",
                "engine steps completed by this process").inc(steps)
    reg.gauge("tmpi_engine_step_seconds",
              "wall time of the most recent engine step").set(
                  0.01 * (rank + 1))
    reg.gauge("tmpi_engine_examples_per_sec", "throughput").set(
        3200.0 / (rank + 1))
    reg.gauge("tmpi_engine_overlap_fraction", "overlap").set(0.75)
    reg.gauge("tmpi_step_flops", "flops").set(3.06e8)
    if mfu is not None:
        reg.gauge("tmpi_mfu_estimate", "mfu").set(mfu)
    if skew:
        g = reg.gauge("tmpi_rank_skew_attributed_seconds",
                      'skew "attributed" \\ to a rank')
        for who, secs in skew.items():
            g.set(secs, labels={"rank": str(who)})
    reg.counter("tmpi_ps_failover_total", "failovers").inc(rank)
    h = reg.histogram("tmpi_numerics_bucket_grad_norm", "norms",
                      buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5 * (rank + 1), 20.0):
        h.observe(v)
    reg.gauge("tmpi_label_escape", "odd labels").set(
        1.0, labels={"path": 'a"b\\c\nd'})
    return reg


def _texts(n=5):
    return {r: _registry(r, 10 * r + 3, mfu=0.1 * r if r % 2 else None,
                         skew={1: 0.5, 2: 0.01} if r == 0 else None
                         ).to_prometheus() for r in range(n)}


def test_parse_prometheus_matches_jax():
    for text in _texts().values():
        assert tcluster.parse_prometheus(text) == jcluster.parse_prometheus(
            text)


@pytest.mark.parametrize("fanout", [None, 2, 1])
def test_federate_is_byte_equal_to_jax(fanout):
    texts = _texts()
    got = tcluster.federate(texts, fanout=fanout)
    assert got == jcluster.federate(texts, fanout=fanout)
    assert got == tcluster.federate(texts)           # the tree = the flat
    assert got.count("# TYPE tmpi_engine_steps_total counter") == 1
    samples = tcluster.parse_prometheus(got)["samples"]
    assert all("rank" in s["labels"] for s in samples)
    assert {s["labels"]["source_rank"] for s in samples
            if "source_rank" in s["labels"]} == {"1", "2"}


def test_merge_federated_of_shards_matches_jax_and_the_flat_merge():
    texts = _texts(6)
    shards = [tcluster.federate({r: texts[r] for r in (0, 1, 2)}),
              tcluster.federate({r: texts[r] for r in (3, 4, 5)})]
    got = tcluster.merge_federated(shards)
    assert got == jcluster.merge_federated(shards)
    assert got == tcluster.federate(texts, fanout=64)


def _results():
    texts = _texts(5)
    states = ["healthy", "degraded", "diverged", "healthy", None]
    out = []
    for r, state in enumerate(states):
        if state is None:
            out.append({"endpoint": f"http://h:{r}", "reachable": False,
                        "health": {"state": "unreachable"},
                        "error": "URLError: refused"})
            continue
        out.append({"endpoint": f"http://h:{r}", "reachable": True,
                    "health": {"state": state, "reasons": [
                        {"code": f"why{r}"}]},
                    "metrics_text": texts[r],
                    "history": {"rate": 1.5 + r, "drift": 0.9},
                    "alerts": {"firing": [{"name": "numerics_divergence",
                                           "phase": None}]
                               if state == "diverged" else []}})
    return out


def test_job_view_matches_jax(monkeypatch):
    monkeypatch.setattr(time, "monotonic", lambda: 1000.0)
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    results = _results()
    got = tcluster.job_view(results)
    assert got == jcluster.job_view(results)
    assert got["verdict"] == "diverged"
    assert [r["rank"] for r in got["ranks"] if r["state"] == "diverged"] \
        == [2]
    assert got["straggler"] == 1 and got["ranks"][1]["mfu"] == 0.1
    prev = dict(got, polled_mono=990.0)
    assert tcluster.job_view(results, prev) == jcluster.job_view(results,
                                                                  prev)
    for fanout in (2,):
        tconfig.set("obs_federation_fanout", fanout)
        jconfig.set("obs_federation_fanout", fanout)
        got = tcluster.job_view(results)
        assert got == jcluster.job_view(results)
        assert got["shards"]["unreachable_total"] == 1
    assert tcluster.render_table(got) == jcluster.render_table(got)


def test_endpoints_from_ring_matches_jax():
    ring = [("a", 9000), ("a", 9001), ("b", 9000)]
    for stride in (0, 1, 3):
        assert tcluster.endpoints_from_ring(ring, 8780, stride) == \
            jcluster.endpoints_from_ring(ring, 8780, stride)


def _strip(view):
    return {k: v for k, v in view.items()
            if k not in ("polled_mono", "polled_at")}


def test_live_sweeps_match_jax():
    regs = [_registry(r, 5 + r, mfu=0.2) for r in range(3)]
    health = [tserve.HealthState() for _ in range(3)]
    health[2].set_diverged(leaf="['w1']", step=8, outlier_ranks=[2])
    servers = [tserve.ObsHTTPServer(registry=regs[r], health=health[r],
                                    scrape=False, rank=r) for r in range(3)]
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    closed = f"http://127.0.0.1:{dead.getsockname()[1]}"
    dead.close()                               # nothing listens there
    eps = [s.url for s in servers] + [closed]
    try:
        t0 = time.monotonic()
        got = tcluster.fetch(eps, timeout_s=2.0)
        assert time.monotonic() - t0 < 2.0 * 3 + 2
        want = jcluster.fetch(eps, timeout_s=2.0)
        assert [r["reachable"] for r in got] == [True, True, True, False]
        gv, wv = tcluster.job_view(got), jcluster.job_view(want)
        assert _strip(gv) == _strip(wv)
        assert gv["verdict"] == "diverged"
        assert [r["state"] for r in gv["ranks"]] == [
            "healthy", "healthy", "diverged", "unreachable"]
        assert tcluster.fetch_journal(eps, limit=8, timeout_s=2.0) == \
            jcluster.fetch_journal(eps, limit=8, timeout_s=2.0)
        assert tcluster.fetch_alerts(eps, timeout_s=2.0) == \
            jcluster.fetch_alerts(eps, timeout_s=2.0)
        out = io.StringIO()
        view = tcluster.top(eps[:3], iterations=1, timeout_s=2.0, out=out,
                            clear=False)
        assert view["verdict"] == "diverged"
        assert "torchmpi_tpu_torch.obs top — 3 rank(s)" in out.getvalue()
        assert "job verdict: diverged" in out.getvalue()
    finally:
        for s in servers:
            s.close()
