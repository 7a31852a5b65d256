"""Parity of the port's serving engine with the JAX package's.

The same submit/iteration script runs through both packages'
``ServeEngine``: with ``StubRunner`` it must give the same tokens, states,
typed rejections and shed reasons (queue full, KV pressure, deadline,
draining) and the same spans and journal records; with ``LlamaRunner`` at
``tiny`` width (the port holding the JAX runner's converted parameters,
on the CPU) it must give identical greedy tokens.  Each test resets both
packages' knobs, journal and span buffer.
"""

import time

import jax
import numpy as np
import pytest

import torchmpi_tpu.serving as jserving
from torchmpi_tpu.obs import journal as jjournal, tracer as jtracer
from torchmpi_tpu.runtime import config as jconfig
from torchmpi_tpu.serving import engine as jengine, kvcache as jkv

import torchmpi_tpu_torch.serving as tserving
from torchmpi_tpu_torch.models import llama as tl
from torchmpi_tpu_torch.obs import journal as tjournal, tracer as ttracer
from torchmpi_tpu_torch.runtime import config as tconfig
from torchmpi_tpu_torch.serving import engine as tengine, kvcache as tkv

JAX = (jengine, jkv, jserving, jconfig, jtracer, jjournal)
PORT = (tengine, tkv, tserving, tconfig, ttracer, tjournal)


@pytest.fixture(autouse=True)
def _fresh():
    for mods in (JAX, PORT):
        mods[3].reset()
        mods[5].reset()
        mods[4].drain()
    yield
    for mods in (JAX, PORT):
        mods[3].reset()
        mods[5].reset()
        mods[4].drain()


def _engine(mods, kv_blocks=16, **over):
    engine, kv, serving = mods[:3]
    cfg = serving.serve_config()
    cfg.update({"block_size": 4, "kv_blocks": kv_blocks, "max_batch": 2,
                "max_queue": 3, "default_deadline_ms": 10000,
                "max_new_tokens": 6, "admission_headroom": 0.0,
                "runner": "stub", "stub_token_s": 0.0})
    cfg.update(over)
    pool = kv.BlockPool(cfg["kv_blocks"], cfg["block_size"])
    return engine.ServeEngine(runner=engine.StubRunner(cfg["max_batch"]),
                              pool=pool, cfg=cfg)


def _script(mods):
    """Admission, join/leave, KV-pressure, deadline and drain paths; returns
    every observable outcome in order."""
    engine = mods[0]
    eng = _engine(mods)
    out, reqs = [], []

    def submit(prompt, **kw):
        try:
            r = eng.submit(prompt, **kw)
        except engine.AdmissionRejected as e:
            out.append(("reject", e.reason))
            return
        out.append(("admit", r.id))
        reqs.append(r)

    submit([1, 2, 3], max_new=4)
    submit([4, 5, 6, 7, 8], max_new=6)
    submit([9] * 10, max_new=3)
    submit([2, 2], max_new=5)              # queue at its bound: queue_full
    for _ in range(2):
        out.append(("produced", eng.iteration()))
    submit([7] * 40, max_new=2)            # 11 blocks > free: kv_pressure
    submit([3, 1], max_new=2, deadline_ms=1)
    time.sleep(0.01)
    for _ in range(3):
        out.append(("produced", eng.iteration()))
    submit([5] * 6, max_new=6)
    out.append(("produced", eng.iteration()))
    out.append(("drained_clean", eng.drain(timeout=0.0)))
    submit([1], max_new=1)                 # draining
    out.append(("kv_free", eng.pool.free_blocks()))
    out.extend((r.id, r.state, r.shed_reason, list(r.tokens)) for r in reqs)
    return out


def test_stub_script_matches_jax():
    got, ref = _script(PORT), _script(JAX)
    assert got == ref
    kinds = {o[0] for o in ref}
    assert {"reject", "admit", "produced"} <= kinds
    reasons = {o[1] for o in ref if o[0] == "reject"} | {
        o[2] for o in ref if len(o) == 4 and o[1] == "shed"}
    assert reasons == {"queue_full", "kv_pressure", "deadline", "draining"}


def test_kv_pressure_eviction_mid_decode_matches_jax():
    def run(mods):
        eng = _engine(mods, kv_blocks=6, max_new_tokens=8)
        a = eng.submit([1] * 7, max_new=8, deadline_ms=60000)
        b = eng.submit([2] * 7, max_new=8, deadline_ms=30000)
        for _ in range(10):
            eng.iteration()
        return [(r.state, r.shed_reason, r.tokens) for r in (a, b)]

    ref = run(JAX)
    assert run(PORT) == ref
    assert ("shed", "kv_pressure") in [r[:2] for r in ref]


def test_spans_and_journal_match_jax(tmp_path):
    def run(mods, sub):
        config, tracer, journal = mods[3], mods[4], mods[5]
        config.set("obs_trace", True)
        config.set("journal_enabled", True)
        config.set("journal_dir", str(tmp_path / sub))
        eng = _engine(mods)
        r = eng.submit([1, 2, 3], max_new=2, correlation=77)
        s = eng.submit([4, 5], max_new=3, deadline_ms=1)
        time.sleep(0.01)
        for _ in range(4):
            eng.iteration()
        spans = [(x["name"], x["attrs"].get("outcome"),
                  x["attrs"].get("reason"), x["correlation"] == 77)
                 for x in tracer.drain()]
        recs = [(x["kind"], x["data"].get("reason")) for x in journal.tail()]
        return spans, recs, (r.state, s.state, s.shed_reason)

    ref = run(JAX, "jax")
    got = run(PORT, "port")
    assert got == ref
    assert ("serve.generate", "done", "", True) in ref[0]
    assert ("serve.shed", "deadline") in ref[1]
    assert any(p.name.startswith("journal-r") for p in
               (tmp_path / "port").iterdir())


def test_llama_runner_matches_jax():
    cfg = tl.tiny()
    jr = jengine.LlamaRunner(3, cfg=cfg, max_len=32)
    tr = tengine.LlamaRunner(3, cfg=cfg, max_len=32, device="cpu")
    tr.params = tl.from_jax_params(jax.tree.map(np.asarray, jr.params),
                                   device="cpu")
    prompts = [[int(t) for t in np.random.RandomState(i).randint(0, 256, n)]
               for i, n in enumerate((5, 9, 17, 3))]

    def run(engine, runner):
        ecfg = jserving.serve_config()
        ecfg.update({"max_batch": 3, "max_new_tokens": 8, "block_size": 4,
                     "kv_blocks": 64, "admission_headroom": 0.0})
        eng = engine.ServeEngine(runner=runner, cfg=ecfg)
        # Four requests on three slots: the last one joins the stripe the
        # shortest leaves, over that request's stale cache.
        reqs = [eng.submit(p, max_new=m)
                for p, m in zip(prompts, (6, 4, 8, 5))]
        for _ in range(20):
            if all(r.done.is_set() for r in reqs):
                break
            eng.iteration()
        return [(r.state, r.tokens) for r in reqs]

    ref = run(jengine, jr)
    assert [s for s, _ in ref] == ["done"] * 4
    assert [len(t) for _, t in ref] == [6, 4, 8, 5]
    assert run(tengine, tr) == ref


def test_bucket_len_matches_jax():
    for n in (1, 7, 8, 9, 300, 600, 5000):
        for max_len in (16, 512, 1 << 15):
            assert tengine._bucket_len(n, max_len) \
                == jengine._bucket_len(n, max_len)


def test_make_runner_kinds_match_jax():
    cfg = tserving.serve_config()
    assert isinstance(tengine.make_runner(cfg), tengine.StubRunner)
    with pytest.raises(ValueError):
        tengine.make_runner({**cfg, "runner": "nope"})
    assert tserving.serve_config() == jserving.serve_config()
