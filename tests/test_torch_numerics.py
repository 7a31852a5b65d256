"""Parity of the port's numerics plane (``obs/numerics.py``) with the JAX
package's, and its wiring into the port's engine and tester.

The same seeded numpy inputs go through both packages:

* ``sentinel_stats`` on an MLP tree (several bucket sizes, with and
  without non-finite entries) and on a ``llama.tiny()`` tree in bf16
  (converted through ``from_jax_params``): bucket norms, gradient norm and
  update ratio within 1e-5 relative (both accumulate in f32, in other
  orders), the non-finite count exact.
* ``leaf_digests``, ``tree_digest`` and ``majority_vote``: byte-equal.
* ``record_sentinels``: the registry's exposition byte-equal, the history
  equal but for the wall clock.
* The ``Auditor`` over host rings of threads in one process (p = 3; the
  tie and reference cases at p = 2): every ``AuditResult`` equal to
  JAX's, field for field, as are the health verdicts and counters.
* ``probe_step_flops`` on config 1's MLP step: the analytic count exactly,
  and within 2% of XLA's cost analysis of JAX's step (XLA also counts the
  elementwise work; measured 1.3% above).  The flash formula exactly on
  the plain route, with none of the plain version's products counted.
* The engine in one spawned gloo pool of 2 ranks: ``off`` against
  ``sentinel`` bit for bit (rings and GSPMD), the NaN step flagged, the
  gauges and FLOPs published, zero1's sentinels equal to the replicated
  optimizer's (1e-5), a bad mode refused.
* ``tester.mfu_sweep`` on ``tiny()`` on the CPU.
"""

from __future__ import annotations

import collections
import functools
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchmpi_tpu.collectives import hostcomm as jhostcomm
from torchmpi_tpu.obs import metrics as jmetrics
from torchmpi_tpu.obs import numerics as jnumerics
from torchmpi_tpu.obs import serve as jserve
from torchmpi_tpu.runtime import config as jconfig

from torchmpi_tpu_torch.collectives import hostcomm as thostcomm
from torchmpi_tpu_torch.obs import metrics as tmetrics
from torchmpi_tpu_torch.obs import numerics as tnumerics
from torchmpi_tpu_torch.obs import serve as tserve
from torchmpi_tpu_torch.runtime import config as tconfig

RTOL = 1e-5
FLOPS_VS_XLA = 0.02


@pytest.fixture(autouse=True)
def _fresh():
    for c in (jconfig, tconfig):
        c.reset()
    jnumerics.reset()
    tnumerics.reset()
    yield
    for c in (jconfig, tconfig):
        c.reset()
    jnumerics.reset()
    tnumerics.reset()


def _mlp_tree(seed, widths=(48, 32, 16, 10)):
    rng = np.random.default_rng(seed)
    tree = {}
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        tree[f"w{i}"] = rng.standard_normal((a, b)).astype(np.float32)
        tree[f"b{i}"] = rng.standard_normal((b,)).astype(np.float32)
    return tree


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _stats_close(got, want):
    np.testing.assert_allclose(np.asarray(got["bucket_grad_norms"]),
                               np.asarray(want["bucket_grad_norms"]),
                               rtol=RTOL)
    for k in ("grad_norm", "update_ratio"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL)
    assert int(got["nonfinite_count"]) == int(want["nonfinite_count"])


# ----------------------------------------------------------------- sentinels

@pytest.mark.parametrize("bucket_bytes,bad", [
    (256, 0), (4096, 0), (32 << 20, 0), (4096, 3)])
def test_sentinel_stats_match_jax_on_an_mlp_tree(bucket_bytes, bad):
    for c in (jconfig, tconfig):
        c.set("gradient_bucket_bytes", bucket_bytes)
    params, grads = _mlp_tree(0), _mlp_tree(1)
    updates = {k: -0.01 * v for k, v in grads.items()}
    flat = grads["w1"].reshape(-1)
    flat[:bad] = [np.nan, np.inf, -np.inf][:bad]
    want = jnumerics.sentinel_stats(params, grads, updates)
    got = tnumerics.sentinel_stats(_torch(params), _torch(grads),
                                   _torch(updates))
    assert got["bucket_grad_norms"].dtype == torch.float32
    assert got["nonfinite_count"].dtype == torch.int32
    if bad:
        assert int(got["nonfinite_count"]) == bad
        assert not np.isfinite(float(got["grad_norm"]))
        return
    _stats_close(got, want)
    assert "update_ratio" not in tnumerics.sentinel_stats(
        _torch(params), _torch(grads))


@functools.lru_cache(maxsize=None)
def _llama_trees():
    """``llama.tiny()`` parameters, gradients and updates in bf16 (numpy
    leaves), drawn once for the file."""
    from torchmpi_tpu.models import llama as jllama

    cfg = jllama.tiny()
    init = jax.jit(lambda key: jllama.init(key, cfg, dtype=jnp.bfloat16))
    jp, jg = init(jax.random.PRNGKey(0)), init(jax.random.PRNGKey(1))
    ju = jax.tree.map(lambda g: (-0.01 * g).astype(jnp.bfloat16), jg)
    return tuple(jax.tree.map(np.asarray, t) for t in (jp, jg, ju))


def test_sentinel_stats_match_jax_on_llama_tiny_in_bf16():
    from torchmpi_tpu_torch.models import llama as tllama

    trees = _llama_trees()
    want = jax.jit(jnumerics.sentinel_stats)(*trees)
    conv = [tllama.from_jax_params(t, device="cpu") for t in trees]
    assert conv[1]["layers"]["wq"].dtype == torch.bfloat16
    got = tnumerics.sentinel_stats(*conv)
    assert got["bucket_grad_norms"].numel() == np.asarray(
        want["bucket_grad_norms"]).size
    _stats_close(got, want)


def test_record_sentinels_exposition_and_history_match_jax():
    for c in (jconfig, tconfig):
        c.set("numerics_history", 3)
    rng = np.random.default_rng(5)

    def run(numerics, metrics, convert):
        numerics.reset()
        reg = metrics.Registry()
        for step in range(5):
            stats = {"bucket_grad_norms": rng_vals[step],
                     "grad_norm": np.float32(step + 0.5),
                     "nonfinite_count": np.int32(step % 2),
                     "update_ratio": np.float32(1e-3 * (step + 1))}
            numerics.record_sentinels(step, {k: convert(v) for k, v in
                                             stats.items()}, registry=reg)
        return reg.to_prometheus(), [
            {k: v for k, v in r.items() if k != "wall_time"}
            for r in numerics.history()]

    rng_vals = [rng.uniform(1e-5, 2e3, 4).astype(np.float32)
                for _ in range(5)]
    got = run(tnumerics, tmetrics, lambda v: torch.as_tensor(np.asarray(v)))
    want = run(jnumerics, jmetrics, lambda v: v)
    assert got == want
    assert [r["step"] for r in got[1]] == [2, 3, 4]
    assert tnumerics.history(2) == tnumerics.history()[-2:]
    assert tnumerics.snapshot()["last_audit"] is None


def test_bucket_sq_norms_empty_result_follows_the_leaves():
    from torchmpi_tpu_torch.nn import bucketing

    tree = {"w": torch.zeros(4, device="meta")}
    empty = bucketing.plan_buckets({})
    assert bucketing.bucket_sq_norms(tree, empty).device.type == "meta"
    assert bucketing.bucket_sq_norms({}, empty).device.type == "cpu"


# ------------------------------------------------------------------- digests

def _llama_bf16():
    return _llama_trees()[0]


def _adam_state():
    import optax

    return jax.tree.map(np.asarray, optax.adam(1e-3).init(_mlp_tree(4)))


def _mixed():
    rng = np.random.default_rng(6)
    return {"a": [rng.standard_normal(3).astype(np.float32),
                  (np.arange(4, dtype=np.int32).reshape(2, 2),)],
            "b": {"s": np.float32(2.5), "u": np.array([1, 0], np.int64)}}


def _to_port(tree):
    """The same tree with torch leaves (a bf16 leaf through its words);
    NamedTuples keep their type."""
    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(type(t), "_fields"):
            return type(t)(*(conv(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(conv(v) for v in t)
        a = np.asarray(t)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())

    return conv(tree)


@pytest.mark.parametrize("make", [_mlp_tree, _llama_bf16, _adam_state,
                                  _mixed],
                         ids=["mlp", "llama_bf16", "adam_state", "mixed"])
def test_digests_are_byte_equal_to_jax(make):
    tree = make(0) if make is _mlp_tree else make()
    want_paths, want = jnumerics.leaf_digests(tree)
    got_paths, got = tnumerics.leaf_digests(_to_port(tree))
    assert got_paths == want_paths
    assert got == want
    assert tnumerics.tree_digest(_to_port(tree)) == jnumerics.tree_digest(
        tree)
    assert tnumerics.fold_digests(got, 1, 3) == jnumerics.fold_digests(
        want, 1, 3)


def test_one_element_changes_one_digest():
    t = _torch(_mlp_tree(7))
    _, d1 = tnumerics.leaf_digests(t)
    t["w1"][0, 0] = torch.nextafter(t["w1"][0, 0], torch.tensor(1e9))
    paths, d2 = tnumerics.leaf_digests(t)
    changed = [i for i in range(len(d1)) if d1[i] != d2[i]]
    assert [paths[i] for i in changed] == ["['w1']"]


@pytest.mark.parametrize("digests,reference", [
    ([b"a" * 16, b"b" * 16, b"a" * 16], None),
    ([b"a" * 16, b"b" * 16], None),
    ([b"a" * 16, b"b" * 16], b"a" * 16),
    ([b"c" * 16, b"a" * 16, b"b" * 16, b"a" * 16], None),
    ([b"a" * 16] * 4, None)])
def test_majority_vote_matches_jax(digests, reference):
    assert tnumerics.majority_vote(digests, reference) == \
        jnumerics.majority_vote(digests, reference)


# ------------------------------------------------------------------- auditor

def _rings(module, n):
    eps = [("127.0.0.1", p) for p in module.free_ports(n)]
    with ThreadPoolExecutor(n) as ex:
        futs = [ex.submit(module.HostCommunicator, r, n, eps, 30000,
                          io_deadline_ms=20000)
                for r in range(n)]
        return [f.result(timeout=60) for f in futs]


def _audit_case(trees, reference, port: bool):
    """Every rank's audit of its tree, with fresh health and registries:
    (results as dicts, health states, divergence counters)."""
    numerics, serve, metrics = ((tnumerics, tserve, tmetrics) if port else
                                (jnumerics, jserve, jmetrics))
    comms = _rings(thostcomm if port else jhostcomm, len(trees))
    try:
        hs = [serve.HealthState() for _ in trees]
        regs = [metrics.Registry() for _ in trees]
        auds = [numerics.Auditor(comms[r], health=hs[r], registry=regs[r])
                for r in range(len(trees))]
        for r in range(len(trees)):
            hs[r].evaluate(regs[r])       # baseline the watched counters
        ref = None if reference is None else numerics.leaf_digests(
            _to_port(reference) if port else reference)
        with ThreadPoolExecutor(len(trees)) as ex:
            res = list(ex.map(lambda r: auds[r].audit(
                _to_port(trees[r]) if port else trees[r], step=4,
                reference=ref), range(len(trees))))
        return ([x.to_dict() for x in res],
                [hs[r].evaluate(regs[r])["state"]
                 for r in range(len(trees))],
                [regs[r].counter("tmpi_numerics_divergence_total").value()
                 for r in range(len(trees))])
    finally:
        for c in comms:
            c.close()


def _bump(tree, key, index, by):
    out = {k: v.copy() for k, v in tree.items()}
    out[key][index] += np.float32(by)
    return out


AUDIT_CASES = {
    "clean_p3": lambda b: ([b, b, b], None),
    "seeded_p3": lambda b: ([b, b, _bump(b, "w1", (1, 1), 1e-3)], None),
    "first_of_several_p3": lambda b: (
        [b, _bump(_bump(b, "b0", 0, 1.0), "w2", (0, 0), 1.0), b], None),
    "tie_p2": lambda b: ([b, _bump(b, "w0", (0, 0), 1.0)], None),
    "reference_p2": lambda b: ([_bump(b, "b1", 2, 1.0), b], b),
}


@pytest.mark.parametrize("case", list(AUDIT_CASES))
def test_auditor_matches_jax(case):
    trees, reference = AUDIT_CASES[case](_mlp_tree(10))
    got = _audit_case(trees, reference, port=True)
    want = _audit_case(trees, reference, port=False)
    assert got == want
    results, states, counters = got
    if case == "clean_p3":
        assert all(r["ok"] and r["exchanges"] == 1 for r in results)
        assert states == ["healthy"] * 3
    elif case == "seeded_p3":
        assert results[0]["first_divergent_leaf"] == "['w1']"
        assert results[0]["outlier_ranks"] == [2]
        assert states == ["degraded", "degraded", "diverged"]
        assert counters == [1.0] * 3
    elif case == "first_of_several_p3":
        assert results[0]["first_divergent_leaf"] == "['b0']"
        assert results[0]["outlier_ranks"] == [1]
    elif case == "tie_p2":
        assert results[0]["outlier_ranks"] is None
        assert states == ["diverged", "diverged"]
    else:
        assert results[0]["outlier_ranks"] == [0]


def test_auditor_remaps_hierarchical_group_order():
    D = tnumerics.DIGEST_BYTES
    digs = {r: bytes([r]) * D for r in range(4)}

    class StubHier:
        rank, size = 0, 4
        groups = [[0, 2], [1, 3]]

        def allgather(self, arr):
            assert arr.dtype == torch.int8 and arr.numel() == D
            return torch.frombuffer(bytearray(b"".join(
                digs[r] for r in (0, 2, 1, 3))), dtype=torch.int8)

    got = tnumerics.Auditor(StubHier(), registry=tmetrics.Registry()
                            )._exchange(b"\0" * D)
    assert got == [digs[r] for r in range(4)]


def test_maybe_audit_gated_on_mode_and_interval_and_recovers():
    comms = _rings(thostcomm, 2)
    try:
        base = _torch(_mlp_tree(14))
        hs = [tserve.HealthState() for _ in range(2)]
        auds = [tnumerics.Auditor(comms[r], health=hs[r],
                                  registry=tmetrics.Registry())
                for r in range(2)]
        tconfig.set("numerics_mode", "sentinel")
        assert auds[0].maybe_audit(base, 100) is None
        tconfig.set("numerics_mode", "audit")
        tconfig.set("numerics_audit_interval", 10)
        assert auds[0].maybe_audit(base, 7) is None

        def both(trees, step):
            with ThreadPoolExecutor(2) as ex:
                return list(ex.map(lambda r: auds[r].maybe_audit(
                    trees[r], step), range(2)))

        forked = {k: v.clone() for k, v in base.items()}
        forked["w0"][0, 0] += 1.0
        res = both([base, forked], 20)
        assert not res[0].ok and res[0].outlier_ranks is None
        assert tnumerics.snapshot()["last_audit"]["ok"] is False
        res = both([base, base], 30)
        assert all(r is not None and r.ok for r in res)
        assert all(h.evaluate(tmetrics.Registry())["state"] == "healthy"
                   for h in hs)
    finally:
        for c in comms:
            c.close()


def test_history_ring_survives_concurrent_audits():
    """The history ring and registry take sentinel records from a step
    thread while audits run over the host ring and snapshots read it."""
    comms = _rings(thostcomm, 2)
    stop = threading.Event()
    reg = tmetrics.Registry()
    stats = {"grad_norm": torch.tensor(1.5),
             "nonfinite_count": torch.tensor(0, dtype=torch.int32),
             "bucket_grad_norms": torch.ones(3)}
    count = collections.Counter()

    def step_loop():
        i = 0
        while not stop.is_set():
            tnumerics.record_sentinels(i, stats, registry=reg)
            tnumerics.snapshot()
            i += 1
        count["steps"] = i

    t = threading.Thread(target=step_loop, daemon=True)
    t.start()
    try:
        base = _torch(_mlp_tree(16))
        auds = [tnumerics.Auditor(comms[r], health=tserve.HealthState(),
                                  registry=tmetrics.Registry())
                for r in range(2)]
        for step in range(5):
            with ThreadPoolExecutor(2) as ex:
                res = list(ex.map(lambda r: auds[r].audit(
                    {k: v.clone() for k, v in base.items()}, step=step),
                    range(2)))
            assert all(r.ok for r in res)
    finally:
        stop.set()
        t.join(timeout=10)
        for c in comms:
            c.close()
    assert not t.is_alive() and count["steps"] > 0
    assert len(tnumerics.history()) == min(count["steps"], 64)


# --------------------------------------------------------------------- FLOPs

def test_probe_counts_config_1_step_against_xla_and_analytically():
    from torchmpi_tpu.models import mlp as jmlp
    from torchmpi_tpu_torch.engine import sgdengine
    from torchmpi_tpu_torch.models import mlp as tmlp
    from torchmpi_tpu_torch.tools import numerics_drill

    jp = jax.tree.map(np.asarray, jmlp.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    x = rng.random((32, 784), np.float32)
    y = rng.integers(0, 10, 32).astype(np.int32)

    def jstep(p, x, y):
        loss, g = jax.value_and_grad(jmlp.loss_fn)(p, (x, y))
        return jax.tree.map(lambda a, b: a - 0.1 * b, p, g), loss

    def tstep(p, batch):
        _, g = sgdengine.value_and_grad(tmlp.loss_fn, p, batch)
        return sgdengine.sgd_update(p, g, 0.1)

    want = jnumerics.probe_step_flops(jax.jit(jstep), (jp, x, y))
    got, new = tnumerics.probe_step_flops(tstep, (
        tmlp.from_jax_params(jp, device="cpu"),
        (torch.from_numpy(x), torch.from_numpy(y).long())))
    assert got == numerics_drill.mlp_step_flops(32)
    assert abs(got - want) / want < FLOPS_VS_XLA
    assert set(new) == set(jp)                 # the step's own result
    flops, out = tnumerics.probe_step_flops(lambda: torch.ones(3) + 1, ())
    assert flops is None and out.tolist() == [2.0] * 3


@pytest.mark.parametrize("causal,lq,lk", [(True, 64, 64), (False, 64, 64),
                                          (True, 32, 64)])
def test_flash_formula_is_exact_on_the_plain_route(causal, lq, lk):
    import importlib

    fa = importlib.import_module("torchmpi_tpu_torch.ops.flash_attention")
    g = torch.Generator().manual_seed(1)
    bh, d = 3, 16
    q = torch.randn(bh, lq, d, generator=g)
    k, v = (torch.randn(bh, lk, d, generator=g) for _ in range(2))
    counter = torch.utils.flop_counter.FlopCounterMode(display=False)
    with counter:
        o, lse = fa.flash_fwd_block(q, k, v, causal=causal)
        fa.flash_bwd_block(q, k, v, torch.ones_like(o), lse,
                           torch.ones_like(lse), causal=causal)
    want = (fa.attention_flops(bh, lq, lk, d, causal, "fwd")
            + fa.attention_flops(bh, lq, lk, d, causal, "bwd"))
    # Only the two operators are counted: the plain products are hidden.
    assert set(counter.get_flop_counts()["Global"]) == set(fa.FLASH_OPS)
    assert counter.get_total_flops() == fa.counted_flops(counter) == want
    assert fa.causal_pairs(lq, lk, causal) == (
        sum(min(lk, i + 1) for i in range(lq)) if causal else lq * lk)


def test_device_peak_and_publish_flops(monkeypatch):
    assert tnumerics.device_peak_flops("cpu") is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert tnumerics.device_peak_flops("cuda") == 989.4e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA A100-SXM4-80GB")
    assert tnumerics.device_peak_flops("cuda") is None
    reg = tmetrics.Registry()
    monkeypatch.setattr(tnumerics, "_default_peak", (100.0,))
    tnumerics.publish_flops(50.0, 0.25, registry=reg)
    assert reg.gauge("tmpi_step_flops").value() == 50.0
    assert reg.gauge("tmpi_mfu_estimate").value() == pytest.approx(2.0)
    monkeypatch.setattr(tnumerics, "_default_peak", (None,))
    reg = tmetrics.Registry()
    tnumerics.publish_flops(50.0, 0.25, registry=reg)
    assert "tmpi_mfu_estimate" not in reg.to_prometheus()


def test_mfu_sweep_on_tiny_on_the_cpu(capsys):
    import dataclasses
    import importlib

    from torchmpi_tpu_torch.models import llama
    from torchmpi_tpu_torch.utils import tester

    fa = importlib.import_module("torchmpi_tpu_torch.ops.flash_attention")
    cfg = dataclasses.replace(llama.tiny(seq=64), n_layers=1)
    res = tester.mfu_sweep((1, 2), ("none", "dots"), seq_len=64, iters=1,
                           cfg=cfg, attn="flash", device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert [(r.batch, r.remat) for r in res] == [
        (1, "none"), (2, "none"), (1, "dots"), (2, "dots")]
    assert lines[0].startswith("mfu b=1    L=64   remat=none  t=")
    assert lines[0].endswith("mfu=     n/a")
    head = cfg.d_model * cfg.vocab
    per_layer = sum(v.numel() for k, v in llama.init(
        0, cfg, device="cpu")["layers"].items() if "norm" not in k)
    for r in res:
        attn = cfg.n_layers * (
            {"none": 1, "dots": 2}[r.remat] * fa.attention_flops(
                r.batch * cfg.n_heads, 64, 64, cfg.head_dim, True, "fwd")
            + fa.attention_flops(r.batch * cfg.n_heads, 64, 64,
                                 cfg.head_dim, True, "bwd"))
        assert r.flash_flops == attn
        assert r.step_flops == 6.0 * (per_layer + head) * r.batch * 64 + attn
        assert r.mfu_estimate is None and r.peak_hbm_bytes is None
        assert r.flops_per_s == pytest.approx(r.step_flops / r.mean_seconds)


def test_mfu_sweep_first_loss_equals_full_attention():
    """Each cell's first loss is the flash step's from fresh parameters,
    held against full attention on the same parameters and tokens (f32:
    1e-5 relative, two attention routes summing in another order)."""
    import dataclasses

    from torchmpi_tpu_torch.models import llama
    from torchmpi_tpu_torch.utils import tester

    cfg = dataclasses.replace(llama.tiny(seq=64), n_layers=1)
    res = tester.mfu_sweep((2,), ("none",), seq_len=64, iters=1, cfg=cfg,
                           report=None, attn="flash", device="cpu")
    tokens, targets = tester.sweep_batch(2, 64, cfg.vocab, "cpu")
    assert not torch.equal(tokens, torch.zeros_like(tokens))
    with torch.no_grad():
        ref = float(llama.make_loss_fn(cfg, attn="full")(
            llama.init(0, cfg, device="cpu"), (tokens, targets)))
    assert res[0].first_loss == pytest.approx(ref, rel=1e-5)


# ------------------------------------------------------------------- engine

HIDDEN, PER_RANK, ENGINE_STEPS, NAN_AT = (32, 16), 4, 4, 2


def _setup():
    import os

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

    pl = launch.Pool(2, setup=_setup, timeout_s=120)
    yield pl
    pl.close()


def _engine_job(p: int) -> dict:
    """One rank: off against sentinel (rings and GSPMD), a NaN run, zero1
    against replicated Adam, a bad mode."""
    from torchmpi_tpu_torch import optim
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import mlp
    from torchmpi_tpu_torch.obs import metrics, numerics
    from torchmpi_tpu_torch.runtime import config

    rng = np.random.default_rng(9)
    batches = [(rng.random((p, PER_RANK, 784), np.float32),
                rng.integers(0, 10, (p, PER_RANK)).astype(np.int64))
               for _ in range(ENGINE_STEPS)]
    dirty = [(x.copy(), y) for x, y in batches]
    dirty[NAN_AT][0][1, 0, 5] = np.nan
    out: dict = {}

    def train(mode, data, rings=True, **kw):
        config.set("use_pallas_collectives", rings)
        config.set("numerics_mode", mode)
        numerics.reset()
        eng = AllReduceSGDEngine(mlp.loss_fn, lr=0.05, mode="compiled",
                                 **kw)
        st = eng.train(mlp.init(0, hidden=HIDDEN, device="cpu"), data)
        return ([t.clone() for _, t in sorted(st["params"].items())],
                numerics.history())

    for rings in (True, False):
        off, _ = train("off", batches, rings)
        on, hist = train("sentinel", batches, rings)
        out[f"bit_equal_rings={rings}"] = all(
            torch.equal(a.view(torch.int32), b.view(torch.int32))
            for a, b in zip(off, on))
        out[f"history_rings={rings}"] = [(h["step"], h["nonfinite"])
                                         for h in hist]
    _, hist = train("audit", dirty)
    out["nan"] = [(h["step"], h["nonfinite"]) for h in hist]
    prom = metrics.registry.to_prometheus()
    out["published"] = {name: name in prom for name in (
        "tmpi_numerics_grad_norm", "tmpi_numerics_nonfinite_total",
        "tmpi_numerics_update_ratio", "tmpi_numerics_bucket_grad_norm",
        "tmpi_step_flops", "tmpi_engine_steps_total")}
    out["step_flops"] = metrics.registry.gauge("tmpi_step_flops").value()
    adam = optim.adam(1e-2)
    _, rep = train("sentinel", batches, False, optimizer=adam)
    _, z1 = train("sentinel", batches, False, optimizer=adam, zero1=True)
    out["zero1"] = [[h[k] for k in ("grad_norm", "update_ratio")]
                    + h["bucket_grad_norms"] for h in z1]
    out["replicated"] = [[h[k] for k in ("grad_norm", "update_ratio")]
                         + h["bucket_grad_norms"] for h in rep]
    config.set("numerics_mode", "loud")
    try:
        AllReduceSGDEngine(mlp.loss_fn, mode="compiled").train(
            mlp.init(0, hidden=HIDDEN, device="cpu"), batches[:1])
        out["bad_mode"] = None
    except ValueError as e:
        out["bad_mode"] = str(e)
    config.reset()
    return out


def test_engine_sentinels_in_a_pool_of_two(pool):
    from torchmpi_tpu_torch.tools import numerics_drill

    res = pool.run(_engine_job, 2)
    assert res[0] == res[1]
    for r in res:
        assert r["bit_equal_rings=True"] and r["bit_equal_rings=False"]
        for rings in (True, False):
            assert r[f"history_rings={rings}"] == [
                (s, 0) for s in range(ENGINE_STEPS)]
        assert [s for s, bad in r["nan"] if bad] == list(
            range(NAN_AT, ENGINE_STEPS))
        assert all(r["published"].values()), r["published"]
        assert r["step_flops"] == numerics_drill.mlp_step_flops(
            PER_RANK, (784, *HIDDEN, 10))
        np.testing.assert_allclose(r["zero1"], r["replicated"], rtol=RTOL)
        assert "numerics_mode must be one of" in r["bad_mode"]
