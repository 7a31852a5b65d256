"""Parity of the port's measured collective autotuner
(``collectives/autotune.py``) and the selector's measured cells with the
JAX package's.

The same inputs go through both packages, exactly (everything compared is
a digest, a key, a chosen namespace or a ratio of counts: tolerance 0):

* ``fingerprint_digest`` of the same fingerprint dicts;
* ``cell_key`` and ``_find_cell`` on the same cells (exact and nearest
  buckets, other op, dtype, placement, scope);
* ``_compiled_score`` and ``_knob_winners`` on the same records;
* ``decide`` on the same doc, in ``cache`` and ``online`` mode, with JAX's
  rank-major ``(p, n)`` payload against the port's one-rank ``(n,)``
  tensor of the same per-rank bytes;
* ``mix_drift`` on the same histogram samples;
* ``resolve_wire_dtype("auto")`` and ``compiled_preference`` under the
  same compiled doc.

On the port alone: ``off`` resolves the very function objects of the
static table, with a contrary cache installed; the cache's roundtrip and
staleness; a 2-D payload keyed by its full bytes; named fabrics refused.
In one spawned gloo pool of 4 ranks on the CPU: every rank's pass doc
identical, every candidate of every cell bit-equal to the plain result,
buckets resolved per bucket in the engine with ``off`` and ``cache``
giving the same losses bit for bit, ``bench_section``, rank 0's persisted
caches installed on every rank when only rank 0 can read them, and the
compiled pass over both default programs with its doc agreed and each
variant's first loss equal to full attention's (f32: 1e-5 relative, the
bf16 wire 1e-4).
"""

from __future__ import annotations

import copy
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torchmpi_tpu.collectives import autotune as jautotune
from torchmpi_tpu.collectives import selector as jselector
from torchmpi_tpu.obs import metrics as jmetrics
from torchmpi_tpu.parallel import tp as jtp
from torchmpi_tpu.runtime import config as jconfig

from torchmpi_tpu_torch.collectives import autotune as tautotune
from torchmpi_tpu_torch.collectives import selector as tselector
from torchmpi_tpu_torch.obs import metrics as tmetrics
from torchmpi_tpu_torch.parallel import tp as ttp
from torchmpi_tpu_torch.runtime import config as tconfig
from torchmpi_tpu_torch.runtime import topology as ttopology

P = 4


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """No caches, default knobs and private registries in both packages."""
    for at, sel, cfg in ((jautotune, jselector, jconfig),
                         (tautotune, tselector, tconfig)):
        cfg.reset()
        at.clear()
        at.clear_compiled()
        sel.configure()
    jreg, treg = jmetrics.Registry(), tmetrics.Registry()
    monkeypatch.setattr(jautotune, "_registry", lambda: jreg)
    monkeypatch.setattr(tautotune, "_registry", lambda: treg)
    yield
    for at, sel, cfg in ((jautotune, jselector, jconfig),
                         (tautotune, tselector, tconfig)):
        at.clear()
        at.clear_compiled()
        cfg.reset()
        sel.configure()


def _set(name, value):
    jconfig.set(name, value)
    tconfig.set(name, value)


# --------------------------------------------------------------- pure parts

FINGERPRINTS = [
    {"version": 1, "backend": "cuda", "device_kind": "NVIDIA H100 80GB HBM3",
     "device_count": 2, "process_count": 2, "mesh_shape": [2],
     "knobs": {"manual_wire_dtype": "auto", "obs_trace": False}},
    {"version": 1, "backend": "cpu", "device_kind": "cpu",
     "device_count": 4, "process_count": 4, "mesh_shape": [4],
     "knobs": {k: 0 for k in jautotune.FINGERPRINT_KNOBS}},
    {"knobs": {"b": [1, 2], "a": None}, "z": 1.5},
]


@pytest.mark.parametrize("fp", FINGERPRINTS, ids=["card", "cpu", "odd"])
def test_fingerprint_digest_parity(fp):
    assert (tautotune.fingerprint_digest(fp)
            == jautotune.fingerprint_digest(copy.deepcopy(fp)))
    assert (tautotune.base_digest(fp)
            == jautotune.base_digest(copy.deepcopy(fp)))


def test_fingerprint_keys_and_knobs_follow_jax():
    fp = tautotune.fingerprint()
    assert set(fp) == set(jautotune.fingerprint())
    assert tautotune.FINGERPRINT_KNOBS == jautotune.FINGERPRINT_KNOBS
    d1 = tautotune.fingerprint_digest(fp)
    tconfig.set("manual_wire_dtype", "float32")
    assert tautotune.fingerprint_digest(tautotune.fingerprint()) != d1
    assert tautotune.fingerprint(process_count=3)["process_count"] == 3


def _cell(op, nbytes, winner, ms, dtype="float32", placement="tpu",
          scope="singlenode"):
    bucket = jmetrics.bytes_bucket(nbytes)
    return jautotune.cell_key(op, dtype, bucket, placement, scope), {
        "op": op, "dtype": dtype, "bytes": nbytes, "bucket": bucket,
        "placement": placement, "scope": scope, "winner": winner,
        "default": "pallas", "ms": ms, "reps": 2, "trials": 1}


CELLS = dict([
    _cell("allreduce", 1 << 16, "xla", {"pallas": 0.9, "xla": 0.3}),
    _cell("allreduce", 1 << 20, "pallas", {"pallas": 1.0, "xla": 4.0}),
    _cell("allreduce", 32 << 20, "pallas", {"pallas": 1.1, "xla": 90.0}),
    _cell("allgather", 1 << 20, "xla", {"pallas": 2.0, "xla": 1.5}),
    _cell("allreduce", 1 << 20, "hostcomm",
          {"hostcomm": 3.0, "xla": 9.0, "pallas": 12.0}, placement="cpu"),
    _cell("allreduce", 1 << 20, "xla", {"xla": 1.0}, dtype="bfloat16"),
])

QUERIES = [("allreduce", "float32", n, pl, sc)
           for n in (4, 1 << 12, 1 << 16, 3 << 18, 1 << 20, 6 << 20,
                     25557032 * 4, 32 << 20, 1 << 30)
           for pl, sc in (("tpu", "singlenode"), ("cpu", "singlenode"),
                          ("tpu", "multinode"))] + [
    ("allgather", "float32", 1 << 10, "tpu", "singlenode"),
    ("reduce", "float32", 1 << 20, "tpu", "singlenode"),
    ("allreduce", "bfloat16", 1 << 24, "tpu", "singlenode")]


@pytest.mark.parametrize("q", QUERIES, ids=lambda q: "-".join(map(str, q)))
def test_find_cell_and_cell_key_parity(q):
    op, dtype, nbytes, placement, scope = q
    bucket = jmetrics.bytes_bucket(nbytes)
    assert tmetrics.bytes_bucket(nbytes) == bucket
    assert (tautotune.cell_key(op, dtype, bucket, placement, scope)
            == jautotune.cell_key(op, dtype, bucket, placement, scope))
    assert (tautotune._find_cell(CELLS, *q) == jautotune._find_cell(CELLS, *q))


def _rec(name, ok=True, wall=None, coll=None, hbm=0):
    r = {"program": "p", "variant": name, "compile_ok": ok}
    if wall is not None:
        r["wall_s"] = wall
    if coll is not None:
        r["collectives"] = {"operand_bytes": coll}
        r["memory"] = {"peak_hbm_bytes": hbm}
    return r


RECORDS = [
    _rec("a", wall=0.25), _rec("b", ok=False, wall=0.1),
    _rec("c", coll={"f32": 115332}, hbm=7),
    _rec("d", coll={"f32": 388, "bf16": 57472}, hbm=9), _rec("e", coll={}),
]


@pytest.mark.parametrize("rec", RECORDS, ids=lambda r: r["variant"])
def test_compiled_score_parity(rec):
    assert tautotune._compiled_score(rec) == jautotune._compiled_score(rec)


VARIANTS = (("wire_f32", {"manual_wire_dtype": "float32"}),
            ("wire_bf16", {"manual_wire_dtype": "bfloat16"}),
            ("rings", {"use_pallas_collectives": True,
                       "manual_wire_dtype": "bfloat16"}))
PROG_WINNERS = [
    {"a": "wire_bf16", "b": "wire_bf16"},
    {"a": "wire_bf16", "b": "wire_f32"},
    {"a": "wire_bf16", "b": None, "c": "rings"},
    {"a": None},
    {"a": "rings", "b": "wire_f32", "c": "wire_f32"},
]


@pytest.mark.parametrize("winners", PROG_WINNERS,
                         ids=[str(i) for i in range(len(PROG_WINNERS))])
def test_knob_winners_parity(winners):
    progs = {k: {"winner": w} for k, w in winners.items()}
    assert (tautotune._knob_winners(progs, VARIANTS)
            == jautotune._knob_winners(progs, VARIANTS))


def test_exact_byte_ties_are_no_verdict_and_timed_ties_take_a_margin():
    """HLO-byte scores tie only when equal, as in JAX; timed scores tie
    within COMPILED_TIE_REL (10%) of the best or when their ranges over
    reps and ranks overlap."""
    same = {"x": _rec("x", coll={"f32": 10}), "y": _rec("y", coll={"f32": 10})}
    assert tautotune._compiled_winner(same) is None
    near = {"x": _rec("x", wall=1.0), "y": _rec("y", wall=1.01)}
    assert tautotune._compiled_winner(near) is None
    # The 7.5% by which one wire variant of a step its wire does not move
    # won a run on the card is no verdict.
    noise = {"x": _rec("x", wall=1.0), "y": _rec("y", wall=1.075)}
    assert tautotune._compiled_winner(noise) is None
    far = {"x": _rec("x", wall=1.0), "y": _rec("y", wall=1.5)}
    assert tautotune._compiled_winner(far) == "x"
    spread = {"x": {**_rec("x", wall=1.0), "samples_s": [1.0, 1.3]},
              "y": _rec("y", wall=1.2)}
    assert tautotune._compiled_winner(spread) is None
    # One slow rep of the slower variant (on the card: 1F1B's f32 wire at
    # 1.86-2.55 s against bf16's 1.34-1.49 s) leaves the ranges apart.
    slow_rep = {"x": {**_rec("x", wall=1.34), "samples_s": [1.34, 1.49]},
                "y": {**_rec("y", wall=1.86), "samples_s": [1.86, 2.55]}}
    assert tautotune._compiled_winner(slow_rep) == "x"
    failed = {"x": _rec("x", ok=False), "y": _rec("y", wall=2.0)}
    assert tautotune._compiled_winner(failed) == "y"


# ------------------------------------------------------------ decide parity

def _doc(cells=CELLS, fp=None):
    fp = fp or {"version": 1, "device_count": P, "knobs": {}}
    return {"version": 1, "fingerprint": fp,
            "digest": jautotune.fingerprint_digest(fp), "cells": cells}


DECIDE = [(op, dt, n, pl, mode)
          for op in ("allreduce", "allgather", "broadcast")
          for dt in ("float32", "bfloat16")
          for n in (1 << 10, 1 << 14, 1 << 18, 3 << 19, 1 << 23)
          for pl, mode in (("tpu", "sync"), ("tpu", "async"),
                           ("cpu", "sync"))
          if not (pl == "cpu" and dt == "bfloat16")]


@pytest.mark.parametrize("case", DECIDE, ids=lambda c: "-".join(map(str, c)))
def test_decide_parity_on_the_same_doc(case):
    op, dt, n, placement, mode = case
    _set("autotune_mode", "cache")
    jautotune._install(_doc())
    tautotune._install(_doc())
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
    # JAX: a rank-major (p, n) payload; the port: one rank's (n,) tensor.
    jpay = (jnp.zeros((P, n), jdt) if placement == "tpu"
            else np.zeros(n, np.float32))
    tpay = torch.zeros(n, dtype=tdt)
    for cands in (["pallas", "xla"], ["xla"], ["hostcomm", "xla", "pallas"]):
        want = jautotune.decide(op, placement, "singlenode", mode, jpay,
                                candidates=cands)
        got = tautotune.decide(op, placement, "singlenode", mode, tpay,
                               candidates=cands)
        assert got == want


ONLINE = [(mean, count, min_n) for mean in (1e-4, 1e-2)
          for count in (5, 40) for min_n in (1, 20)]


@pytest.mark.parametrize("case", ONLINE, ids=lambda c: "-".join(map(str, c)))
def test_online_decide_parity_on_the_same_samples(case):
    """A hostcomm production mean replaces the cache's ms once it has the
    samples (a process of its own: the port uses its local means)."""
    mean, count, min_n = case
    _set("autotune_mode", "online")
    _set("autotune_online_min_samples", min_n)
    for at in (jautotune, tautotune):
        at._install(_doc())
        h = at._registry().histogram("tmpi_collective_seconds", "x")
        for _ in range(count):
            h.observe(mean, labels={"op": "allreduce_async",
                                    "plane": "hostcomm",
                                    "bytes_bucket": "1MiB"})
    want = jautotune.decide("allreduce", "cpu", "singlenode", "sync",
                            np.zeros(1 << 18, np.float32),
                            ["hostcomm", "xla", "pallas"])
    got = tautotune.decide("allreduce", "cpu", "singlenode", "sync",
                           torch.zeros(1 << 18), ["hostcomm", "xla", "pallas"])
    assert got == want
    assert (tautotune._online_observations()
            == jautotune._online_observations())


SAMPLES = [
    [],
    [("allreduce", "1MiB", 30)],
    [("allreduce", "1MiB", 5), ("allgather", "8MiB", 15)],
    [("allreduce_async", "64KiB", 3), ("reduce", "4KiB", 9),
     ("allgather", "1MiB", 2)],
]


@pytest.mark.parametrize("samples", SAMPLES,
                         ids=[str(i) for i in range(len(SAMPLES))])
@pytest.mark.parametrize("with_doc", [True, False])
def test_mix_drift_parity_on_the_same_samples(samples, with_doc):
    for at in (jautotune, tautotune):
        if with_doc:
            at._install(_doc())
        h = at._registry().histogram("tmpi_collective_seconds", "x")
        for op, bucket, n in samples:
            for _ in range(n):
                h.observe(1e-3, labels={"op": op, "plane": "hostcomm",
                                        "bytes_bucket": bucket})
    for min_n in (1, 10):
        assert (tautotune.mix_drift(min_samples=min_n)
                == jautotune.mix_drift(min_samples=min_n))
    g = tautotune._registry().peek("tmpi_autotune_mix_drift")
    assert g.value() == jautotune._registry().peek(
        "tmpi_autotune_mix_drift").value()


# ------------------------------------------------------- the compiled doc

def _compiled(kw):
    fp = {"version": 1, "knobs": {}}
    return {"version": 1, "kind": "compiled", "topology": "running",
            "fingerprint": fp, "digest": "d", "base_digest": "b",
            "programs": {}, "knob_winners": kw}


@pytest.mark.parametrize("wire", ["bfloat16", "float32", None])
@pytest.mark.parametrize("mode", ["off", "cache", "online"])
def test_resolve_wire_dtype_auto_under_a_compiled_doc(wire, mode):
    _set("autotune_mode", mode)
    kw = {} if wire is None else {"manual_wire_dtype": wire}
    jautotune.activate_compiled(_compiled(kw), validate=False)
    tautotune.activate_compiled(_compiled(kw), validate=False)
    want = jtp.resolve_wire_dtype()
    got = ttp.resolve_wire_dtype()
    assert str(got).replace("torch.", "") == jnp.dtype(want).name
    # An explicit knob outranks the measurement.
    _set("manual_wire_dtype", "float32")
    assert ttp.resolve_wire_dtype() == torch.float32


@pytest.mark.parametrize("kw", [{"use_pallas_collectives": True},
                                {"use_hierarchical_collectives": True},
                                {"manual_wire_dtype": "bfloat16"}])
@pytest.mark.parametrize("placement", ["tpu", "cpu"])
def test_compiled_preference_parity(kw, placement):
    jautotune.activate_compiled(_compiled(kw), validate=False)
    tautotune.activate_compiled(_compiled(kw), validate=False)
    assert (tautotune.compiled_preference("allreduce", placement,
                                          "singlenode")
            == jautotune.compiled_preference("allreduce", placement,
                                             "singlenode"))


# -------------------------------------------------------- the port alone

def _static():
    out = {}
    for (op, impl, mode) in tselector._DISPATCH:
        for pl in tselector.PLACEMENTS:
            for sc in tselector.SCOPES:
                out[(op, pl, sc, mode)] = tselector.resolve(op, pl, sc, mode)
    return out


@pytest.mark.parametrize("pallas", [False, True])
def test_off_mode_resolves_the_same_function_objects(pallas):
    """With a contrary cache and compiled doc installed, ``off`` hands back
    the very executables of the static table, payload or not."""
    tconfig.set("use_pallas_collectives", pallas)
    static = _static()
    contrary = {}
    for (op, pl, sc, mode), fn in static.items():
        others = [i for i in tselector.preferences(pl, sc, mode)
                  if (op, i, mode) in tselector._DISPATCH
                  and tselector._DISPATCH[(op, i, mode)] is not fn]
        if others:
            k, c = _cell(op, 1 << 12, others[0], {others[0]: 0.0}, placement=pl,
                         scope=sc)
            contrary[k] = c
    tautotune._install(_doc(contrary))
    tautotune.activate_compiled(
        _compiled({"use_pallas_collectives": not pallas}), validate=False)
    pay = torch.zeros(1 << 10)
    for (op, pl, sc, mode), fn in static.items():
        assert tselector.resolve(op, pl, sc, mode, payload=pay) is fn
    # ... and cache mode does take the contrary verdicts.
    tconfig.set("autotune_mode", "cache")
    moved = sum(tselector.resolve(op, pl, sc, mode, payload=pay) is not fn
                for (op, pl, sc, mode), fn in static.items())
    assert moved > 0


def test_a_winner_outside_the_cell_is_never_forced():
    tconfig.set("autotune_mode", "cache")
    k, c = _cell("broadcast", 1 << 12, "pallas", {"pallas": 0.0, "xla": 9.0})
    tautotune._install(_doc({k: c}))
    fn = tselector.resolve("broadcast", "tpu", "singlenode",
                           payload=torch.zeros(1 << 10))
    assert fn is tselector._DISPATCH[("broadcast", "xla", "sync")]


def test_payload_meta_keys_one_ranks_full_bytes():
    """A 2-D tensor whose first dimension equals the rank count is one
    rank's payload all the same."""
    x = torch.zeros((P, 256))
    assert tautotune._payload_meta(x, "tpu", rank_count=P) == (
        "float32", P * 256 * 4)
    assert tautotune._payload_meta(torch.zeros(8, dtype=torch.bfloat16)) == (
        "bfloat16", 16)
    assert tautotune._payload_meta(np.zeros(3, np.float64)) == ("float64", 24)
    assert tautotune._payload_meta([1, 2]) is None


def test_cache_roundtrip_staleness_and_info_gauge(tmp_path):
    path = str(tmp_path / "a" / "autotune.json")
    tconfig.set("autotune_cache_path", path)
    fp = tautotune.fingerprint()
    doc = _doc(CELLS, fp)
    assert tautotune.save_cache(doc) == path
    assert json.load(open(path))["digest"] == doc["digest"]
    got = tautotune.activate()
    assert got["cells"] == CELLS and tautotune.active() is got
    g = tautotune._registry().peek("tmpi_autotune_cache_info")
    assert [dict(k)["digest"] for k, _ in g._items()] == [doc["digest"]]
    # A knob change makes the file stale: never applied.
    tautotune.clear()
    tconfig.set("small_allreduce_size_gpu", 7)
    assert tautotune.load_cache() is None
    reg = tautotune._registry()
    assert reg.counter("tmpi_autotune_cache_stale_total").value() == 1
    # A torn file is a miss.
    open(path, "w").write("{not json")
    assert tautotune.load_cache() is None
    assert reg.counter("tmpi_autotune_cache_miss_total").value() == 1
    tautotune.clear()
    assert not g._items()


def test_rekey_drops_a_cache_of_another_process_count():
    tautotune._install(_doc(CELLS, tautotune.fingerprint(process_count=2)))
    assert tautotune.rekey(process_count=2) is not None
    assert tautotune.rekey(process_count=1) is None
    assert tautotune.active() is None


def test_overlap_ab_answers_as_jax():
    """Both drains over the chaos-delayed loopback ring, their end states
    held equal inside; the record's keys are JAX's (no timing claim)."""
    got = tautotune.overlap_ab(n_buckets=2, bucket_elements=1 << 10,
                               update_passes=2, reps=1, wire_delay_ms=0.5)
    assert set(got) == {"barrier", "ready", "buckets", "bytes_per_bucket",
                        "wire_delay_ms", "win"}
    for d in ("barrier", "ready"):
        assert set(got[d]) == {"ms", "blocked_ms", "overlap_fraction"}
        assert got[d]["ms"] > 0
    assert got["win"] == round(got["ready"]["overlap_fraction"]
                               - got["barrier"]["overlap_fraction"], 4)


def test_named_fabrics_wait_for_item_20():
    with pytest.raises(ttopology.NamedFabricUnavailable, match="item 20"):
        tautotune.fingerprint(topology="v5e-8")
    with pytest.raises(ttopology.NamedFabricUnavailable, match="item 20"):
        tautotune.compiled_pass(topology="v4-32")
    with pytest.raises(ttopology.NamedFabricUnavailable, match="item 20"):
        tautotune.compiled_pass(timed=False)
    assert set(ttopology.PROGRAMS) >= set(tautotune.COMPILED_PROGRAMS)
    assert tautotune.COMPILED_PROGRAMS == jautotune.COMPILED_PROGRAMS
    assert tautotune.COMPILED_VARIANTS == jautotune.COMPILED_VARIANTS


# ------------------------------------------------------- a pool of 4 ranks

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

    pl = launch.Pool(P, setup=_setup, timeout_s=240)
    yield pl
    pl.close()


def _plain(op, rows, me):
    total = sum(rows)
    p = len(rows)
    return {"allreduce": total, "broadcast": rows[0],
            "reduce": total if me == 0 else rows[me],
            "allgather": torch.stack(rows),
            "reduce_scatter": total.view(p, -1)[me]}[op]


def _host_ring(comm):
    """A host ring over the world, its endpoints chosen by rank 0."""
    import torch.distributed as dist

    from torchmpi_tpu_torch.collectives import hostcomm

    box = [[("127.0.0.1", q) for q in hostcomm.free_ports(comm.size)]]
    dist.broadcast_object_list(box, src=0)
    return hostcomm.HostCommunicator(comm.rank, comm.size, box[0],
                                     io_deadline_ms=20000)


def _pass_job() -> dict:
    """The eager pass with the ring namespace first, then every candidate
    of every cell once more against the plain result; a host-column pass
    over an attached host ring."""
    from torchmpi_tpu_torch.collectives import autotune, selector
    from torchmpi_tpu_torch.runtime import communicator, config

    comm = communicator.stack.world()
    config.set("use_pallas_collectives", True)
    config.set("small_allreduce_size_gpu", 64)
    doc = autotune.run_pass(comm=comm, sizes=(256, 1 << 12), trials=1)
    bad = []
    for c in doc["cells"].values():
        n = c["bytes"] // 4
        rows = [autotune.rank_row(r, n, "float32") for r in range(P)]
        want = _plain(c["op"], rows, comm.rank)
        for impl in c["ms"]:
            fn = selector.resolve(c["op"], "tpu", c["scope"], prefer=impl)
            got = fn(comm, rows[comm.rank], **autotune._OP_KWARGS[c["op"]])
            if not torch.equal(got.reshape(want.shape), want):
                bad.append((c["op"], n, impl))
    comm.host_ring = _host_ring(comm)
    try:
        cpu_doc = autotune.run_pass(comm=comm, ops=("allreduce",),
                                    sizes=(1 << 12,), placement="cpu",
                                    trials=1, install=False)
    finally:
        comm.host_ring.close()
        comm.host_ring = None
    sizes = sorted({c["bytes"] for c in autotune.run_pass(
        comm=comm, ops=("broadcast",), trials=1,
        install=False)["cells"].values()})
    return {"doc": {k: doc[k] for k in ("digest", "cells")},
            "active": autotune.active() is doc, "bad": bad,
            "cpu_cells": cpu_doc["cells"], "default_sizes_cpu": sizes}


def test_pass_doc_agreed_and_every_candidate_exact(pool):
    res = pool.run(_pass_job)
    assert all(r["doc"] == res[0]["doc"] for r in res), "docs differ"
    cells = res[0]["doc"]["cells"]
    assert {c["op"] for c in cells.values()} == set(jautotune.DEFAULT_OPS)
    for c in cells.values():
        assert c["winner"] == min(c["ms"], key=c["ms"].get)
        assert c["default"] == (
            "pallas" if c["op"] in ("allreduce", "reduce_scatter",
                                    "allgather") else "xla")
        assert set(c["ms"]) == ({"pallas", "xla"} if c["default"] == "pallas"
                                else {"xla"})
    for r in res:
        assert r["active"] and r["bad"] == []
        assert r["cpu_cells"] == res[0]["cpu_cells"]
        assert r["default_sizes_cpu"] == [(1 << 10) * 4, (1 << 14) * 4]
    [cpu] = res[0]["cpu_cells"].values()
    assert set(cpu["ms"]) == {"hostcomm", "xla", "pallas"}


def _engine_job() -> dict:
    """Config 1's MLP at a small width in eager_async on the ring
    namespace, on ranks 0 and 1 (at p = 2 every namespace sums a + b):
    ``off`` against ``cache`` with a doc whose cells send every bucket to
    gloo, bit for bit, with the decision marks traced."""
    from torchmpi_tpu_torch.collectives import autotune, cuda_ring
    from torchmpi_tpu_torch.engine import AllReduceSGDEngine
    from torchmpi_tpu_torch.models import mlp
    from torchmpi_tpu_torch.obs import tracer
    from torchmpi_tpu_torch.runtime import communicator, config

    me = communicator.stack.world().rank
    comm = communicator.Communicator(range(2), my_rank=me)
    comm.group                      # made on every rank of the world
    if me >= 2:
        return {}
    config.set("use_pallas_collectives", True)
    config.set("small_allreduce_size_gpu", 64)
    config.set("gradient_bucket_bytes", 1 << 14)
    rng = np.random.default_rng(3)
    batches = [(rng.random((2, 4, 784), np.float32),
                rng.integers(0, 10, (2, 4)).astype(np.int64))
               for _ in range(3)]
    doc = autotune.run_pass(comm=comm, ops=("allreduce",),
                            sizes=(1 << 10, 1 << 12), trials=1)
    for c in doc["cells"].values():
        c["winner"], c["ms"] = "xla", {"xla": 0.0, "pallas": 1.0}
    autotune._install(doc)
    out = {}
    for mode in ("off", "cache"):
        config.set("autotune_mode", mode)
        config.set("obs_trace", mode == "cache")
        tracer.drain()
        cuda_ring.ring_allreduce_launches = 0
        losses = []
        eng = AllReduceSGDEngine(
            mlp.loss_fn, lr=0.05, mode="eager_async", comm=comm,
            hooks={"on_update": lambda s: losses.append(float(s["loss"]))})
        st = eng.train(mlp.init(0, hidden=(32,), device="cpu"), batches)
        out[mode] = {"losses": losses,
                     "params": [t.clone() for _, t in
                                sorted(st["params"].items())],
                     "marks": sorted({(s["attrs"]["bytes"],
                                       s["attrs"]["impl"])
                                      for s in tracer.drain()
                                      if s["name"] == "autotune.decision"})}
    config.set("obs_trace", False)
    out["bit_equal"] = all(torch.equal(a, b) for a, b in
                           zip(out["off"].pop("params"),
                               out["cache"].pop("params")))
    out["bench"] = autotune.bench_section(comm=comm, sizes=(1 << 10,),
                                          trials=1, ab_elements=1 << 10,
                                          ab_reps=2)
    out["active_after_bench"] = autotune.active() is doc
    return out


def test_buckets_resolve_per_bucket_and_cache_equals_off(pool):
    res = pool.run(_engine_job)[:2]
    for r in res:
        assert r["bit_equal"]
        assert r["off"]["losses"] == r["cache"]["losses"]
        assert r["cache"]["marks"] and all(
            impl == "xla" for _, impl in r["cache"]["marks"])
        assert r["off"]["marks"] == []
        assert r["active_after_bench"]
        ab = r["bench"]["ab"]
        assert ab["default_ms"] > 0 and ab["autotuned_ms"] > 0
    assert res[0]["off"]["losses"] == res[1]["off"]["losses"]
    assert res[0]["cache"]["marks"] == res[-1]["cache"]["marks"]


def _split_cache_job(root: str) -> dict:
    """Only rank 0 can read the persisted caches (the others' path is
    missing): every rank still resolves rank 0's winner and wire."""
    import os

    import torch.distributed

    from torchmpi_tpu_torch.collectives import autotune, selector
    from torchmpi_tpu_torch.parallel import tp
    from torchmpi_tpu_torch.runtime import communicator, config

    comm = communicator.stack.world()
    config.set("use_pallas_collectives", True)
    config.set("small_allreduce_size_gpu", 64)
    config.set("autotune_cache_path", os.path.join(root, "autotune.json"))
    try:
        doc = autotune.run_pass(comm=comm, ops=("allreduce",),
                                sizes=(1 << 12,), trials=1, install=False)
        for c in doc["cells"].values():
            c["winner"], c["ms"] = "xla", {"xla": 0.0, "pallas": 1.0}
        autotune.save_cache(doc)
        fp = autotune.fingerprint()
        autotune.save_compiled({
            "version": 1, "kind": "compiled", "digest": "split",
            "base_digest": autotune.base_digest(fp), "programs": {},
            "knob_winners": {"manual_wire_dtype": "bfloat16"}})
        torch.distributed.barrier()
        if comm.rank != 0:
            config.set("autotune_cache_path",
                       os.path.join(root, f"missing{comm.rank}.json"))
        autotune.clear()
        autotune.clear_compiled()
        config.set("autotune_mode", "cache")
        fn = selector.resolve("allreduce", payload=torch.zeros(1 << 12))
        names = {selector.resolve("allreduce", prefer=ns): ns
                 for ns in ("xla", "pallas")}
        return {"ns": names.get(fn, repr(fn)),
                "wire": str(tp.resolve_wire_dtype()),
                "digest": (autotune.active() or {}).get("digest")}
    finally:
        config.set("autotune_mode", "off")
        config.set("autotune_cache_path", "")
        autotune.clear()
        autotune.clear_compiled()


def test_ranks_install_rank_0s_cache_when_only_it_can_read_it(pool,
                                                              tmp_path):
    res = pool.run(_split_cache_job, str(tmp_path))
    assert res[0]["digest"] is not None
    for r in res:
        assert r == {"ns": "xla", "wire": "torch.bfloat16",
                     "digest": res[0]["digest"]}


def _compiled_job() -> dict:
    from torchmpi_tpu_torch.collectives import autotune
    from torchmpi_tpu_torch.models import llama
    from torchmpi_tpu_torch.parallel import tp
    from torchmpi_tpu_torch.runtime import config, topology

    doc = autotune.compiled_pass(warmup=1, reps=1, install=True)
    config.set("autotune_mode", "cache")
    wire = tp.resolve_wire_dtype()
    config.set("autotune_mode", "off")
    # The builders' defaults at 4 ranks: llama.tiny(), (B, L) = (4, 32),
    # f32, seed 0, the loss in chunks of 16.
    whole, tokens, targets = topology.program_inputs(
        llama.tiny(), 4, 32, torch.float32, 0)
    with torch.no_grad():
        ref = float(llama.make_loss_fn(llama.tiny(), attn="full",
                                       loss_chunk=16)(whole,
                                                      (tokens, targets)))
    return {"programs": {l: {v: (r["compile_ok"], r.get("wall_s"))
                             for v, r in p["variants"].items()}
                         for l, p in doc["programs"].items()},
            "first_losses": {(l, v): r["first_loss"]
                             for l, p in doc["programs"].items()
                             for v, r in p["variants"].items()},
            "ref": ref,
            "winners": {l: p["winner"] for l, p in doc["programs"].items()},
            "knob_winners": doc["knob_winners"],
            "wire": str(wire), "off_wire": str(tp.resolve_wire_dtype()),
            "knob_after": config.get("manual_wire_dtype")}


def test_compiled_pass_on_the_running_world(pool):
    res = pool.run(_compiled_job)
    for r in res:
        assert r == res[0]
    r = res[0]
    assert set(r["programs"]) == set(tautotune.COMPILED_PROGRAMS)
    for variants in r["programs"].values():
        assert set(variants) == {"wire_f32", "wire_bf16"}
        assert all(ok and wall > 0 for ok, wall in variants.values())
    w = r["knob_winners"].get("manual_wire_dtype")
    assert r["wire"] == {"bfloat16": "torch.bfloat16", None: "torch.float32",
                         "float32": "torch.float32"}[w]
    assert r["off_wire"] == "torch.float32" and r["knob_after"] == "auto"
    # Every variant's first step starts from the same seeded weights: its
    # loss, agreed over the ranks, is full attention's on them (f32; the
    # bf16 wire within 1e-4 relative).
    for (label, variant), (lo, hi) in r["first_losses"].items():
        tol = 1e-4 if variant == "wire_bf16" else 1e-5
        assert lo == pytest.approx(r["ref"], rel=tol), (label, variant)
        assert hi == pytest.approx(r["ref"], rel=tol), (label, variant)
