"""Parity of the port's HTTP planes with the JAX package's, and the slice
end to end.

Both packages' ``ObsHTTPServer`` and ``ServeFrontend`` run the same
request script over a ``StubRunner`` engine with a private registry and
health state: every status code, ``Retry-After`` header and JSON body must
be equal, ports, paths and timings aside (the typed 503s, the 404 route
lists, ``/retune``'s and ``/resize``'s answers at default knobs: the
unarmed resize inbox's 409 in the same words).  ``ServeRouter.route`` must give
the same slot for 1,000 keys, with and without a draining slot.  The
slice as a whole: the JAX frontend over a tiny JAX ``LlamaRunner`` and
the port's over the port's runner on the CPU (weights through
``from_jax_params``) give the same tokens over HTTP.  Then the port's
router across two replicas (drain cutover, failover), and the runtime's
wiring: ``lifecycle.start`` with ``obs_http`` and ``history_enabled``
serves the engine's per-step feed.

Every ``urlopen`` has a timeout of at most 10 s, every join a bound, and
every server is closed in a ``finally``.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import torchmpi_tpu.serving as jserving
from torchmpi_tpu.obs import alerts as jalerts
from torchmpi_tpu.obs import history as jhistory
from torchmpi_tpu.obs import journal as jjournal
from torchmpi_tpu.obs import metrics as jmetrics
from torchmpi_tpu.obs import serve as jserve
from torchmpi_tpu.obs import tracer as jtracer
from torchmpi_tpu.runtime import config as jconfig
from torchmpi_tpu.serving import engine as jengine
from torchmpi_tpu.serving import kvcache as jkv
from torchmpi_tpu.serving.frontend import ServeFrontend as JFrontend
from torchmpi_tpu.serving.router import NoReplicas as JNoReplicas
from torchmpi_tpu.serving.router import ServeRouter as JRouter

import torchmpi_tpu_torch.serving as tserving
from torchmpi_tpu_torch.models import llama as tl
from torchmpi_tpu_torch.obs import alerts as talerts
from torchmpi_tpu_torch.obs import history as thistory
from torchmpi_tpu_torch.obs import journal as tjournal
from torchmpi_tpu_torch.obs import metrics as tmetrics
from torchmpi_tpu_torch.obs import serve as tserve
from torchmpi_tpu_torch.obs import tracer as ttracer
from torchmpi_tpu_torch.runtime import config as tconfig
from torchmpi_tpu_torch.serving import engine as tengine
from torchmpi_tpu_torch.serving import kvcache as tkv
from torchmpi_tpu_torch.serving.frontend import ServeFrontend as TFrontend
from torchmpi_tpu_torch.serving.router import NoReplicas as TNoReplicas
from torchmpi_tpu_torch.serving.router import ServeRouter as TRouter

TIMEOUT = 10.0
JAX = dict(engine=jengine, kv=jkv, serving=jserving, metrics=jmetrics,
           serve=jserve, history=jhistory, alerts=jalerts, config=jconfig,
           journal=jjournal, tracer=jtracer, Frontend=JFrontend,
           Router=JRouter, NoReplicas=JNoReplicas)
PORT = dict(engine=tengine, kv=tkv, serving=tserving, metrics=tmetrics,
            serve=tserve, history=thistory, alerts=talerts, config=tconfig,
            journal=tjournal, tracer=ttracer, Frontend=TFrontend,
            Router=TRouter, NoReplicas=TNoReplicas)


@pytest.fixture(autouse=True)
def _fresh():
    for m in (JAX, PORT):
        m["config"].reset()
        m["journal"].reset()
        m["tracer"].drain()
        m["alerts"].reset()
        m["history"].reset()
    yield
    for m in (JAX, PORT):
        m["config"].reset()
        m["journal"].reset()
        m["tracer"].drain()
        m["alerts"].reset()
        m["history"].reset()


def _call(method, url, body=None, raw=None):
    """(status, JSON body or text, headers) of one request."""
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            status, text, headers = r.status, r.read().decode(), r.headers
    except urllib.error.HTTPError as e:
        status, text, headers = e.code, e.read().decode(), e.headers
    try:
        doc = json.loads(text)
    except ValueError:
        doc = text
    return status, doc, headers


#: keys whose values are timings, process ids, paths, or which native
#: engines this test process happens to have loaded (``planes``)
VOLATILE = {"latency_ms", "ttft_ms", "pid", "t_mono_ns", "age_s", "p50_ms",
            "p99_ms", "tokens_per_sec", "iterations", "dropped", "path",
            "generated", "planes"}


def _norm(doc):
    if isinstance(doc, dict):
        return {k: _norm(v) for k, v in doc.items() if k not in VOLATILE}
    if isinstance(doc, list):
        return [_norm(v) for v in doc]
    return doc


def _engine(m, reg, start=True, **over):
    cfg = m["serving"].serve_config()
    cfg.update({"block_size": 4, "kv_blocks": 64, "max_batch": 2,
                "max_queue": 8, "default_deadline_ms": 10000,
                "max_new_tokens": 8, "admission_headroom": 0.0,
                "runner": "stub", "stub_token_s": 0.0})
    cfg.update(over)
    pool = m["kv"].BlockPool(cfg["kv_blocks"], cfg["block_size"],
                             registry=reg)
    eng = m["engine"].ServeEngine(
        runner=m["engine"].StubRunner(cfg["max_batch"],
                                      token_s=cfg["stub_token_s"]),
        pool=pool, registry=reg, cfg=cfg)
    return eng.start() if start else eng


def _store(m):
    st = m["history"].HistoryStore(interval_s=1.0, tier_len=32,
                                   downsample=4)
    for i in range(40):
        st.record(1000.0 + i, {"tmpi_engine_steps_total": 2.0 * i + i * i
                               * 0.01, "g": float(i % 3)})
    return st


def _obs_script(m, tmp_path):
    """The live endpoint's routes, at default knobs and with a private
    history store and alert engine."""
    m["config"].set("obs_flight_dir", str(tmp_path))
    reg = m["metrics"].Registry()
    reg.counter("tmpi_x_total", "x").inc(3, labels={"k": 'a"b'})
    health = m["serve"].HealthState()
    health.note("engine_step")
    out = []
    srv = m["serve"].ObsHTTPServer(registry=reg, health=health, scrape=False,
                                   rank=2)
    st = _store(m)
    eng = m["alerts"].AlertEngine(
        [m["alerts"].AlertRule({"name": "g_hot", "kind": "threshold",
                                "metric": "g", "op": "ge", "value": 2.0,
                                "for_s": 0.0})], store=st, health=health)
    eng.evaluate(now=1039.0)
    leader = {"rank": 1, "is_self": False, "endpoint": ["10.0.0.2", 9100]}
    srv2 = m["serve"].ObsHTTPServer(registry=reg, health=health,
                                    scrape=False, rank=3, history=st,
                                    alerts=eng, leader=lambda: leader)
    try:
        for path in ("/metrics", "/healthz", "/health", "/spans?limit=5",
                     "/spans?limit=x", "/journal?limit=3", "/history",
                     "/history?metric=g", "/alerts", "/retune", "/nope"):
            out.append(("GET", path, _call("GET", srv.url + path)))
        for path, raw in (("/resize", b"not json"), ("/resize", b"[1]"),
                          ("/resize", b'{"drain": [1]}'), ("/nope", b"{}"),
                          ("/flight", b"")):
            out.append(("POST", path,
                         _call("POST", srv.url + path, raw=raw)))
        for path in ("/history", "/history?metric=tmpi_engine_steps_total"
                     "&window_s=20", "/history?metric=g&window_s=x",
                     "/alerts"):
            out.append(("GET2", path, _call("GET", srv2.url + path)))
        out.append(("POST2", "/resize",
                    _call("POST", srv2.url + "/resize", raw=b"{}")))
        health.set_draining(True)
        out.append(("GET", "/healthz", _call("GET", srv.url + "/healthz")))
    finally:
        srv.close()
        srv2.close()
    return out


def test_obs_endpoint_answers_as_jax(tmp_path):
    ref = _obs_script(JAX, tmp_path / "jax")
    got = _obs_script(PORT, tmp_path / "port")
    assert [(a, b, s[0]) for a, b, s in got] == \
        [(a, b, s[0]) for a, b, s in ref]
    for (kind, path, (code, doc, hdr)), (_, _, (_, rdoc, rhdr)) in zip(
            got, ref):
        if kind == "POST" and path == "/resize" and code == 409:
            # Both packages' unarmed resize plane, in the same words.
            assert rdoc["error"].startswith("resize_enabled is off")
        if kind == "POST" and path == "/flight":
            assert code == 200 and doc["path"].endswith(".json")
            continue
        assert _norm(doc) == _norm(rdoc), (kind, path)
        assert hdr.get("Location") == rhdr.get("Location")
        assert hdr.get("Content-Type") == rhdr.get("Content-Type")
    codes = {(k, p): s[0] for k, p, s in got}
    assert codes[("GET", "/retune")] == 200
    assert codes[("POST2", "/resize")] == 307
    assert got[-1][2][1]["state"] == "draining"
    assert got[0][2][1] == ref[0][2][1]                 # /metrics text


def _frontend_script(m):
    """Generation, typed 503s (queue_full, kv_pressure, draining,
    deadline shed) with Retry-After, drain and resume, the 404s."""
    out = []

    def rec(tag, res):
        code, doc, hdr = res
        out.append((tag, code, _norm(doc), hdr.get("Retry-After")))

    reg = m["metrics"].Registry()
    health = m["serve"].HealthState()
    eng = _engine(m, reg)
    obs = m["serve"].ObsHTTPServer(registry=reg, health=health, scrape=False)
    front = m["Frontend"](eng, health=health, replica="r7")
    try:
        url = front.url
        rec("gen", _call("POST", url + "/generate",
                         {"prompt": [1, 2, 3], "max_new": 4}))
        rec("gen_str", _call("POST", url + "/generate", {"prompt": "héllo"}))
        rec("gen_id", _call("POST", url + "/generate",
                            {"prompt": [9], "max_new": 99,
                             "request_id": "mine"}))
        rec("bad", _call("POST", url + "/generate", raw=b"{oops"))
        rec("noprompt", _call("POST", url + "/generate", {"x": 1}))
        rec("serve", _call("GET", url + "/serve"))
        rec("404", _call("GET", url + "/nope"))
        rec("404post", _call("POST", url + "/nope", {}))
        rec("drain", _call("POST", url + "/drain", raw=b"junk"))
        rec("healthz_draining", _call("GET", obs.url + "/healthz"))
        # The engine's drain runs on a thread the POST started: wait for
        # it to close admission (and so not to reopen it after resume).
        deadline = time.monotonic() + TIMEOUT
        while not eng.draining:
            assert time.monotonic() < deadline, "the drain never began"
            time.sleep(0.005)
        rec("gen_draining", _call("POST", url + "/generate",
                                  {"prompt": [1]}))
        rec("serve_draining", _call("GET", url + "/serve"))
        rec("resume", _call("POST", url + "/drain", {"resume": True}))
        rec("healthz", _call("GET", obs.url + "/healthz"))
        rec("gen_again", _call("POST", url + "/generate",
                               {"prompt": [4, 5], "max_new": 3}))
        text = _call("GET", obs.url + "/metrics")[1]
        out.append(("outcomes", [ln for ln in text.splitlines()
                                 if ln.startswith("tmpi_serve_requests")]))
    finally:
        front.close()
        obs.close()
        eng.stop()
    # Engine not started: the queue fills, then the KV pool.
    for tag, over, prompt in (("queue_full", {"max_queue": 1}, [2]),
                              ("kv_pressure", {"kv_blocks": 4}, [3] * 20)):
        eng = _engine(m, m["metrics"].Registry(), start=False, **over)
        front = m["Frontend"](eng, health=m["serve"].HealthState())
        try:
            if tag == "queue_full":
                eng.submit([1], max_new=1)
            rec(tag, _call("POST", front.url + "/generate",
                           {"prompt": prompt, "max_new": 1,
                            "deadline_ms": 50}))
        finally:
            front.close()
            eng.stop()
    # A deadline shed: 50 ms a token against a 120 ms deadline.
    eng = _engine(m, m["metrics"].Registry(), stub_token_s=0.05)
    front = m["Frontend"](eng, health=m["serve"].HealthState())
    try:
        rec("deadline", _call("POST", front.url + "/generate",
                              {"prompt": [1, 2], "max_new": 8,
                               "deadline_ms": 120}))
    finally:
        front.close()
        eng.stop()
    return out


def test_frontend_answers_as_jax():
    ref = _frontend_script(JAX)
    got = _frontend_script(PORT)
    assert got == ref
    by_tag = {r[0]: r for r in got}
    assert by_tag["gen"][1] == 200 and len(by_tag["gen"][2]["tokens"]) == 4
    assert by_tag["queue_full"][1:3] == (503, {
        "error": "admission", "reason": "queue_full",
        "detail": "queue at bound 1", "replica": "r0"})
    assert by_tag["queue_full"][3] == "3"      # 10 s deadline / 4
    assert by_tag["kv_pressure"][2]["reason"] == "kv_pressure"
    assert by_tag["gen_draining"][2]["reason"] == "draining"
    assert by_tag["deadline"][2]["reason"] == "deadline"
    assert by_tag["healthz_draining"][1] == 503
    assert by_tag["404"][2]["routes"] == ["/serve", "POST /generate",
                                          "POST /drain"]


def test_router_assignment_matches_jax():
    urls = {s: f"http://127.0.0.1:{1 + s}" for s in range(4)}
    keys = [f"client-{i}" for i in range(1000)]
    j, t = JRouter(dict(urls)), TRouter(dict(urls))
    assert [t.route(k) for k in keys] == [j.route(k) for k in keys]
    for r in (j, t):
        r.mark_draining(1)
    assert [t.route(k) for k in keys] == [j.route(k) for k in keys]
    assert 1 not in {t.route(k) for k in keys}
    for r in (j, t):
        r.remove_replica(3)
        r.add_replica(7, "http://127.0.0.1:8")
    assert [t.route(k) for k in keys] == [j.route(k) for k in keys]
    assert t.routable() == j.routable() == [0, 2, 7]
    for r in (j, t):
        for s in (0, 2, 7):
            r.mark_draining(s)
    for r, exc in ((j, JNoReplicas), (t, TNoReplicas)):
        with pytest.raises(exc):
            r.route("k")
    with pytest.raises(ValueError):
        TRouter({})


def test_router_cuts_over_and_fails_over_between_port_replicas():
    """Two port replicas behind ``ServeRouter``: keyed dispatch lands on
    ``route(key)``, a drained replica's keys move to the other and come
    back exactly on resume, and a closed replica fails over once."""
    reg = tmetrics.Registry()
    reps = []
    try:
        for r in range(2):
            rreg, health = tmetrics.Registry(), tserve.HealthState()
            eng = _engine(PORT, rreg)
            obs = tserve.ObsHTTPServer(registry=rreg, health=health,
                                       scrape=False, rank=r)
            reps.append((eng, obs, TFrontend(eng, health=health,
                                             replica=f"r{r}")))
        router = TRouter({r: f.url for r, (_, _, f) in enumerate(reps)},
                         probe_urls={r: o.url
                                     for r, (_, o, _) in enumerate(reps)},
                         registry=reg, timeout=TIMEOUT)
        keys = [f"user-{i}" for i in range(16)]
        first = {k: router.route(k) for k in keys}
        assert set(first.values()) == {0, 1}
        toks = {}
        for k in keys:
            code, doc = router.dispatch(k, {"prompt": [7, 8, 9],
                                            "max_new": 3})
            assert code == 200 and doc["replica"] == f"r{first[k]}"
            toks.setdefault(doc["replica"], doc["tokens"])
        assert toks["r0"] == toks["r1"]
        assert _call("POST", reps[1][2].url + "/drain", {})[0] == 200
        assert router.probe() == {0: "healthy", 1: "draining"}
        for k in keys:
            code, doc = router.dispatch(k, {"prompt": [1], "max_new": 1})
            assert code == 200 and doc["replica"] == "r0"
        _call("POST", reps[1][2].url + "/drain", {"resume": True})
        assert router.probe() == {0: "healthy", 1: "healthy"}
        assert {k: router.route(k) for k in keys} == first
        reps[1][2].close()
        k1 = next(k for k in keys if first[k] == 1)
        code, doc = router.dispatch(k1, {"prompt": [1], "max_new": 1})
        assert code == 200 and doc["replica"] == "r0"
        text = reg.to_prometheus()
        assert "tmpi_serve_router_failover_total 1.0" in text
        assert 'tmpi_serve_router_requests_total{replica="1"}' in text
    finally:
        for eng, obs, front in reps:
            front.close()
            obs.close()
            eng.stop()


def test_closed_frontend_frees_its_engine():
    """A closed frontend and its engine free the runner when the caller
    drops them, with the garbage collector off: a strong back reference
    from the HTTP server to the frontend would be a cycle holding the
    runner's weights and KV (on the card, in a real replica) until the
    collector runs."""
    import gc
    import weakref

    gc.collect()
    gc.disable()
    try:
        reg = tmetrics.Registry()
        eng = _engine(PORT, reg)
        front = TFrontend(eng, health=tserve.HealthState())
        try:
            code, doc, _ = _call("POST", front.url + "/generate",
                                 {"prompt": [1, 2, 3], "max_new": 2})
            assert code == 200 and len(doc["tokens"]) == 2
            assert _call("POST", front.url + "/drain", {})[0] == 200
            front._drainer.join(timeout=TIMEOUT)
            assert _call("POST", front.url + "/drain",
                         {"resume": True})[0] == 200
        finally:
            front.close()
            eng.stop()
        runner = weakref.ref(eng.runner)
        del eng, front, reg
        assert runner() is None
    finally:
        gc.enable()


def _llama_over_http(m, runner, prompts):
    cfg = m["serving"].serve_config()
    cfg.update({"max_batch": 3, "max_new_tokens": 8, "block_size": 4,
                "kv_blocks": 64, "admission_headroom": 0.0})
    eng = m["engine"].ServeEngine(runner=runner, cfg=cfg).start()
    front = m["Frontend"](eng, health=m["serve"].HealthState())
    results = [None] * len(prompts)

    def client(i):
        results[i] = _call("POST", front.url + "/generate",
                           {"prompt": prompts[i], "max_new": 5,
                            "deadline_ms": 60000})

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        front.close()
        eng.stop()
    return [(code, doc["tokens"]) for code, doc, _ in results]


def test_llama_tokens_over_http_match_jax():
    """The slice end to end: three concurrent HTTP clients against each
    package's frontend over its Llama runner (tiny width; the port on the
    CPU with the JAX runner's converted weights) get the same tokens."""
    cfg = tl.tiny()
    jr = jengine.LlamaRunner(3, cfg=cfg, max_len=32)
    tr = tengine.LlamaRunner(3, cfg=cfg, max_len=32, device="cpu")
    tr.params = tl.from_jax_params(jax.tree.map(np.asarray, jr.params),
                                   device="cpu")
    prompts = [[int(t) for t in np.random.RandomState(i).randint(0, 256, n)]
               for i, n in enumerate((5, 11, 3))]
    ref = _llama_over_http(JAX, jr, prompts)
    assert [c for c, _ in ref] == [200] * 3
    assert [len(t) for _, t in ref] == [5] * 3
    assert _llama_over_http(PORT, tr, prompts) == ref


def test_runtime_serves_the_engine_feed():
    """``lifecycle.start`` with ``obs_http`` and ``history_enabled`` stands
    the endpoint and the sampler up; the engine's steps publish the
    per-step feed and clear their mark at the end; ``stop`` closes it all
    and leaves the drain flag set."""
    import torch.distributed as dist

    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import mlp
    from torchmpi_tpu_torch.runtime import lifecycle

    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    tconfig.set("obs_http", True)
    tconfig.set("history_enabled", True)
    tconfig.set("history_interval_s", 0.02)
    tconfig.set("data_pipeline", "off")
    torch.set_num_threads(2)
    lifecycle.start(device="cpu")
    try:
        url = tserve.url()
        assert url is not None and thistory.sampler() is not None
        params = mlp.init(0, in_dim=8, hidden=(16,), n_classes=4,
                          device="cpu")
        rs = np.random.RandomState(0)
        batches = [(rs.rand(1, 4, 8).astype(np.float32),
                    rs.randint(0, 4, (1, 4)).astype(np.int32))
                   for _ in range(3)]
        for mode in ("compiled", "eager_sync", "eager_async"):
            AllReduceSGDEngine(mlp.loss_fn, lr=0.1, mode=mode).train(
                params, batches)
        text = _call("GET", url + "/metrics")[1]
        assert "tmpi_engine_steps_total 9.0" in text
        assert 'tmpi_step_phase_seconds{phase="collective"}' in text
        assert "tmpi_engine_examples_total 36.0" in text
        code, doc, _ = _call("GET", url + "/healthz")
        assert code == 200 and doc["state"] == "healthy"
        assert "engine_step" not in doc["marks"]
        code, doc, _ = _call("GET", url + "/history")
        assert code == 200 and doc["enabled"] is True
    finally:
        lifecycle.stop()
    try:
        assert tserve.url() is None and thistory.sampler() is None
        assert tserve.health.draining
    finally:
        tserve.health.reset()
        thistory.reset()
