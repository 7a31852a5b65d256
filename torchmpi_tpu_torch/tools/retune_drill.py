"""The retune drill: an alert-triggered retune happens mid-job, on real
evidence, without breaking the step loop.

    python -m torchmpi_tpu_torch.tools.retune_drill [--device cpu]

Four ranks are spawned (on the card every one binds ``cuda:0``: they share
it), each with the journal on in one directory.  The legs, after
``scripts/retune_drill.py``'s, on the production classes (the default
alert pack over a real ``obs.history.HistoryStore``, the controller, the
autotune passes); only the clock the history and the alerts read is
simulated, so that the pack's wall-time windows hold at drill speed:

* ``alert_retune``: config 1's MLP (784-1024-1024-10, f32, 32 a rank) in
  ``eager_async`` mode on the ring kernels, an agreeing controller on
  every rank (``comm=`` the world) hung on ``engine.retune_controller``.
  After ``N_BASE`` healthy steps a chaos straggler
  (``runtime/chaos.straggler_delay``, journaled) drags every step of rank
  ``STRAGGLER``, and the simulated clock sags the recorded step rate to a
  third: the default pack's ``step_rate_sag`` fires on rank 0, its
  controller debounces and probes (the overlap A/B on its thread), and at
  one boundary every rank runs a fresh eager pass (the measured pause),
  the controller's default one (the ops with a choice of namespace at
  ``autotune.run_pass``'s sizes, ``autotune_trials`` trials), and applies
  the same flips.  ``N_BASE`` healthy
  steps follow.  ``pause_ms`` is the worst step while the probe and apply
  window was open, over the healthy median (injected sleep taken out), as
  JAX's drill takes it: here it holds the boundary pass, timed alone as
  ``boundary_pass_ms`` and bounded by ``PASS_BOUND_MS``, and what lies
  beyond that must stay under JAX's 250 ms.  ``ab_ratio`` is the post over
  the pre median step.
* ``mix_drift_flip``: the winner cache is seeded with each cell's slowest
  measured candidate, and every rank's collective histogram with traffic
  the cache never measured; ``tmpi_autotune_mix_drift`` crosses
  ``retune_mix_threshold``, ``autotune_mix_drift`` fires, and the
  controller's boundary pass (cut to ``PASS_KW``: the flip is the point
  here) reinstalls measured winners: a seeded wrong winner must flip
  back, on every rank alike.
* ``compiled_fabrics``: ``autotune.compiled_pass`` over both default
  programs on the running world (the port has no named fabrics, item 20)
  at Llama-3-8B width cut to ``COMPILED_LAYERS`` layers in bf16 (flash
  attention: B4-B6), one warm-up and ``COMPILED_REPS`` timed calls a
  variant; every variant's first loss within ``COMPILED_LOSS_RTOL`` of
  full attention's on the same seeded weights and tokens, a non-null
  winner on at least one program, the doc agreed on every rank and saved
  to the compiled store by rank 0.

Finally ``obs/rca.py``'s ``perf_retune`` chain must be named from the
drill's journals alone.  :func:`run` returns every rank's record;
:func:`checks` lists what failed; the launch counts, the flip back and
the compiled winner only on the card (on the CPU every candidate rides
the host and their times tie within noise).
Every wait is bounded, and every spawned process is joined or killed
before it returns.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import os
import random
import statistics
import sys
import tempfile
import time
from typing import Any, Dict, List

P = 4
BATCH = 128
LR = 0.05
STRAGGLER = 1
STRAGGLE_MS = 25.0
N_BASE = 20
INCIDENT_CAP = 600
POST_WARM = 3
# JAX's drill bounds its worst pause at 250 ms, the probe's leak onto the
# step loop; the port's pause also holds the boundary pass, timed on its
# own (``boundary_pass_ms``), so that bound applies to what lies beyond it.
PAUSE_BOUND_MS = 250.0
# The boundary pass itself: a controller applies at most once a cooldown
# (``retune_cooldown_s``, 60 s by default), and its pause may take at most
# a tenth of that window.
PASS_BOUND_MS = 6000.0
PASS_KW = {"ops": ("allreduce",), "trials": 1}
PASS_SIZES = {"cuda": (1 << 18, 1 << 21), "cpu": (1 << 10, 1 << 14)}
MIX_ITERS = 400
COMPILED_LAYERS = 2
COMPILED_BATCH, COMPILED_SEQ, COMPILED_CHUNK = 4, 512, 256
COMPILED_REPS = 3
# A variant's first loss against full attention's: the train phase's bf16
# tolerance (a bf16 model on the card, a bf16 wire on the CPU).
COMPILED_LOSS_RTOL = 1e-2
WALL_S = 600.0


def _batches(n: int, seed: int):
    import numpy as np

    from ..utils.data import synthetic_mnist

    ds = synthetic_mnist(n=n * BATCH, seed=seed)
    x = ds.x.reshape(n, P, BATCH // P, -1).astype(np.float32)
    y = ds.y.reshape(n, P, BATCH // P).astype(np.int64)
    return [(x[i], y[i]) for i in range(n)]


def _alert_engine(store):
    from ..obs import alerts

    return alerts.build_engine(store=store, cfg={
        "enabled": True, "default_pack": True, "rules_path": "",
        "eval_every": 0.0, "for_s": 2.0, "flight": False})


def _ring_count() -> int:
    from ..collectives import cuda_ring

    return cuda_ring.ring_allreduce_launches


def _leg_alert_retune(cfg, comm, dev) -> Dict[str, Any]:
    import torch

    from ..collectives import autotune, cuda_ring, retune
    from ..engine import AllReduceSGDEngine
    from ..models import mlp
    from ..obs.history import HistoryStore
    from ..runtime import chaos, config

    store = HistoryStore()
    eng_alerts = _alert_engine(store)
    clock = {"t": 1000.0}
    config.set("engine_async_drain", "barrier")
    config.set("gradient_bucket_bytes", 32 << 20)
    bench_out: Dict[str, Any] = {}

    def bench():
        try:
            out = {"overlap": autotune.overlap_ab(
                n_buckets=8, bucket_elements=1 << 16, reps=1,
                update_passes=600, wire_delay_ms=3.0)}
        except Exception as e:
            import traceback

            bench_out["error"] = (f"{type(e).__name__}: {e}; "
                                  f"{traceback.format_exc()[-1500:]}")
            raise
        bench_out.update(out)
        return out

    rng = random.Random(7)
    spec = chaos.FaultSpec(delay_ms=STRAGGLE_MS)
    data = _batches(4, seed=1)
    walls: List[Any] = []
    fired = set()
    box: Dict[str, Any] = {"phase": "base", "n": 0, "slept": 0.0}
    deadline = time.monotonic() + WALL_S / 2

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def batches():
        post = 0
        while True:
            if box["phase"] == "base" and box["n"] >= N_BASE:
                box["phase"] = "incident"
            if box["phase"] == "incident" and (
                    (ctl.retunes >= 1 and ctl.state != retune.PROBING)
                    or box["n"] >= N_BASE + INCIDENT_CAP):
                box["phase"], box["post_at"] = "post", len(walls)
            if box["phase"] == "post":
                if post >= N_BASE:
                    return
                post += 1
            yield data[box["n"] % len(data)]

    def on_sample(state):
        sync()
        box["slept"] = 0.0
        box["t0"] = time.perf_counter()
        if box["phase"] == "incident" and comm.rank == STRAGGLER:
            box["slept"] = chaos.straggler_delay(spec, rng)

    def on_update(state):
        box["n"] += 1
        clock["t"] += 3.0 if box["phase"] == "incident" else 1.0
        store.record(clock["t"], {"tmpi_engine_steps_total":
                                  float(box["n"])})
        eng_alerts.evaluate(now=clock["t"])
        fired.update(f["name"] for f in eng_alerts.firing())
        if time.monotonic() > deadline:
            raise RuntimeError("alert_retune leg deadline exceeded")

    def on_boundary_done():
        sync()
        walls.append(((time.perf_counter() - box["t0"] - box["slept"]) * 1e3,
                      ctl.state))

    engine = AllReduceSGDEngine(mlp.loss_fn, lr=LR, mode="eager_async",
                                hooks={"on_sample": on_sample,
                                       "on_update": on_update})
    ctl = retune.RetuneController(
        alert_engine=eng_alerts, store=store, bench_fn=bench,
        now_fn=lambda: clock["t"], comm=comm,
        cfg={"enabled": True, "poll_interval_steps": 1, "debounce_s": 4.0,
             "cooldown_s": 60.0, "revert_window_s": 5.0,
             "revert_drift": 0.5, "mix_threshold": 0.5,
             "mix_min_samples": 10_000})

    class Timed:
        """The engine's consult, with each step's wall closed after it."""

        def step_boundary(self):
            out = ctl.step_boundary()
            on_boundary_done()
            return out

    engine.retune_controller = Timed()
    cuda_ring.ring_allreduce_launches = 0
    engine.train(mlp.init(0, device=dev), batches())
    launches = _ring_count()
    post_at = box.get("post_at", len(walls))
    baseline_ms = statistics.median(m for m, _ in walls[1:N_BASE])
    post = [m for m, _ in walls[post_at + POST_WARM:]]
    post_ms = statistics.median(post) if post else None
    # The worst step while the probe ran and the verdict was applied.
    window = [m for m, s in walls[:post_at]
              if s in (retune.PROBING, retune.COOLDOWN)]
    pause_ms = max(0.0, max(window) - baseline_ms) if window else 0.0
    ov = bench_out.get("overlap") or {}
    return {
        "fired": sorted(fired), "retunes": ctl.retunes,
        "reverts": ctl.reverts, "steps": box["n"],
        "applied_at_step": next((i for i, (_, s) in enumerate(walls)
                                 if s == retune.COOLDOWN), None),
        "knobs_after": [config.get("engine_async_drain"),
                        config.get("gradient_bucket_bytes")],
        "overlap_win": ov.get("win"), "overlap": ov,
        "probe_error": bench_out.get("error"),
        "boundary_pass_ms": ctl.last_pause_ms,
        "baseline_step_ms": baseline_ms, "post_step_ms": post_ms,
        "pause_ms": pause_ms,
        "ab_ratio": (post_ms / baseline_ms) if post_ms else None,
        "b1_launches": launches, "final_state": ctl.state,
    }


def _leg_mix_drift(cfg, comm, dev) -> Dict[str, Any]:
    from ..collectives import autotune, retune
    from ..obs import metrics
    from ..obs.history import HistoryStore

    store = HistoryStore()
    eng_alerts = _alert_engine(store)
    clock = {"t": 5000.0}
    pass_kw = {**PASS_KW, "sizes": PASS_SIZES[dev.type]}
    launches0 = _ring_count()
    base = autotune.run_pass(comm=comm, install=False, **pass_kw)
    wrong = copy.deepcopy(base)
    corrupted = []
    for key, cell in wrong["cells"].items():
        ms = cell.get("ms") or {}
        worst = max(ms, key=ms.get) if len(ms) >= 2 else None
        if worst and worst != cell["winner"]:
            cell["winner"] = worst
            corrupted.append(key)
    autotune.activate(wrong)
    h = metrics.registry.histogram(
        "tmpi_collective_seconds",
        "host-plane collective latency from span durations, keyed by "
        "op, plane and power-of-two payload bucket")
    for _ in range(4000):
        h.observe(1e-4, labels={"op": "allgather", "plane": "hostcomm",
                                "bytes_bucket": "8MiB"})
    ctl = retune.RetuneController(
        alert_engine=eng_alerts, store=store, bench_fn=lambda: {},
        now_fn=lambda: clock["t"], comm=comm, pass_kw=pass_kw,
        cfg={"enabled": True, "poll_interval_steps": 1, "debounce_s": 3.0,
             "cooldown_s": 60.0, "revert_window_s": 0.0,
             "revert_drift": 0.5, "mix_threshold": 0.5,
             "mix_min_samples": 8})
    fired = set()
    for _ in range(MIX_ITERS):
        clock["t"] += 1.0
        drift = autotune.mix_drift(min_samples=8)
        store.record(clock["t"], {"tmpi_autotune_mix_drift": drift})
        eng_alerts.evaluate(now=clock["t"])
        fired.update(f["name"] for f in eng_alerts.firing())
        ctl.step_boundary()
        if ctl.state == retune.PROBING:
            ctl.join(timeout=60.0)
        if ctl.retunes >= 1:
            break
    now = autotune.active() or {}
    cells = now.get("cells", {})
    flipped = [k for k in corrupted if cells.get(k, {}).get("winner")
               != wrong["cells"][k]["winner"]]
    return {"fired": sorted(fired), "retunes": ctl.retunes,
            "cells_corrupted": corrupted, "cells_flipped_back": flipped,
            "winners_after": {k: c["winner"] for k, c in cells.items()},
            "ms_after": {k: c["ms"] for k, c in cells.items()},
            "digest_after": now.get("digest"),
            "b1_launches": _ring_count() - launches0,
            "pause_ms": ctl.last_pause_ms,
            "mix_drift_last": autotune.mix_drift(min_samples=8,
                                                 publish=False)}


def _leg_compiled(cfg, comm, dev) -> Dict[str, Any]:
    import importlib

    import torch

    from ..collectives import autotune
    from ..models import llama
    from ..runtime import config, topology

    fa = importlib.import_module("torchmpi_tpu_torch.ops.flash_attention")
    names = ("flash_fwd_launches", "flash_bwd_dq_launches",
             "flash_bwd_dkv_launches")
    for n in names:
        setattr(fa, n, 0)
    if dev.type == "cuda":
        mcfg = dataclasses.replace(llama.llama3_8b(),
                                   n_layers=COMPILED_LAYERS)
        build_kw = {"cfg": mcfg, "batch": COMPILED_BATCH,
                    "seq": COMPILED_SEQ, "dtype": torch.bfloat16,
                    "loss_chunk": COMPILED_CHUNK}
    else:       # the builders' own defaults at P ranks
        build_kw = {"cfg": llama.tiny(), "batch": 4, "seq": 32,
                    "dtype": torch.float32, "loss_chunk": 16}
    t0 = time.perf_counter()
    doc = autotune.compiled_pass(warmup=1, reps=COMPILED_REPS, save=True,
                                 install=True, build_kw=build_kw)
    seconds = time.perf_counter() - t0
    ref = None
    if comm.rank == 0:
        # The programs' first step, through plain full attention on one
        # rank: every build draws the same weights and batch (seed 0).
        whole, tokens, targets = topology.program_inputs(
            build_kw["cfg"], build_kw["batch"], build_kw["seq"],
            build_kw["dtype"], 0, device=dev)
        with torch.no_grad():
            ref = float(llama.make_loss_fn(
                build_kw["cfg"], attn="full",
                loss_chunk=build_kw["loss_chunk"])(whole,
                                                   (tokens, targets)))
        del whole, tokens, targets
    config.set("autotune_mode", "cache")
    from ..parallel import tp

    wire = str(tp.resolve_wire_dtype())
    config.set("autotune_mode", "off")
    try:
        with open(autotune.compiled_cache_path()) as f:
            stored = len(json.load(f).get("fabrics", {}))
    except (OSError, ValueError):
        stored = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"winners": {p: r["winner"] for p, r in doc["programs"].items()},
            "variants": {p: {v: {"ok": x["compile_ok"],
                                 "wall_s": x.get("wall_s"),
                                 "samples_s": x.get("samples_s"),
                                 "first_loss": x.get("first_loss"),
                                 "error": x.get("error")}
                             for v, x in r["variants"].items()}
                         for p, r in doc["programs"].items()},
            "knob_winners": doc["knob_winners"],
            "base_digest": doc["base_digest"], "wire_under_cache": wire,
            "full_attention_loss": ref,
            "fabrics_stored": stored, "seconds": seconds,
            "launches": {n: getattr(fa, n) for n in names},
            "shape": {k: (v if k != "cfg" else {
                "d_model": v.d_model, "n_layers": v.n_layers,
                "vocab": v.vocab}) for k, v in build_kw.items()
                if k != "dtype"}}


def _rank_main(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """One rank: the three legs; returns its record."""
    import torch

    from ..collectives import autotune
    from ..obs import journal
    from ..runtime import communicator, config, lifecycle

    rank = int(os.environ["RANK"])
    if cfg["device"] == "cpu":
        torch.set_num_threads(2)
        dev = torch.device("cpu")
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
        dev = torch.device("cuda", 0)
    config.set("use_pallas_collectives", True)
    config.set("journal_enabled", True)
    config.set("journal_dir", cfg["dir"])
    config.set("autotune_cache_path", os.path.join(cfg["dir"],
                                                   "autotune.json"))
    journal.set_rank(rank)
    journal.reset()
    dev = lifecycle.start(dev if dev.type == "cpu" else None)
    comm = communicator.stack.world()
    rec: Dict[str, Any] = {"rank": rank, "device": str(dev)}
    try:
        t0 = time.perf_counter()
        rec["alert_retune"] = _leg_alert_retune(cfg, comm, dev)
        rec["alert_retune"]["seconds"] = time.perf_counter() - t0
        autotune.clear()
        config.set("engine_async_drain", "ready")
        config.set("gradient_bucket_bytes", 32 << 20)
        t0 = time.perf_counter()
        rec["mix_drift_flip"] = _leg_mix_drift(cfg, comm, dev)
        rec["mix_drift_flip"]["seconds"] = time.perf_counter() - t0
        autotune.clear()
        rec["compiled_fabrics"] = _leg_compiled(cfg, comm, dev)
    finally:
        journal.reset()
        lifecycle.stop()
    return rec


def run(device: str = "cuda", directory: str = None) -> Dict[str, Any]:
    """Spawn the four ranks, collect their records and run the RCA over
    their journals."""
    from ..obs import rca
    from ..runtime import launch

    directory = directory or tempfile.mkdtemp(prefix="retune_drill_")
    cfg = {"device": device, "dir": os.path.abspath(directory)}
    t0 = time.perf_counter()
    recs = launch.spawn(P, _rank_main, (cfg,), timeout_s=WALL_S)
    report = rca.analyze(cfg["dir"], top=8)
    return {"device": device, "seconds": time.perf_counter() - t0,
            "ranks": recs, "dir": cfg["dir"],
            "rca": {"rules_named": sorted({v["rule"]
                                           for v in report["verdicts"]}),
                    "top": [{k: v[k] for k in ("rule", "confidence",
                                               "summary")}
                            for v in report["verdicts"][:4]]}}


def checks(out: Dict[str, Any]) -> List[str]:
    """What failed, by name."""
    failed = []
    card = out["device"] != "cpu"
    ranks = out["ranks"]
    a0, m0, c0 = (ranks[0][k] for k in ("alert_retune", "mix_drift_flip",
                                        "compiled_fabrics"))
    if "step_rate_sag" not in a0["fired"]:
        failed.append(f"alert_retune: step_rate_sag never fired on rank 0 "
                      f"({a0['fired']})")
    for r in ranks:
        me = f"rank{r['rank']}"
        a, m, c = (r[k] for k in ("alert_retune", "mix_drift_flip",
                                  "compiled_fabrics"))
        if a["retunes"] != 1 or a["knobs_after"] != a0["knobs_after"] or \
                a["applied_at_step"] != a0["applied_at_step"]:
            failed.append(f"{me}: alert_retune applied {a['retunes']} at "
                          f"step {a['applied_at_step']} -> "
                          f"{a['knobs_after']} (rank 0: "
                          f"{a0['applied_at_step']} {a0['knobs_after']})")
        if a["steps"] != a0["steps"]:
            failed.append(f"{me}: {a['steps']} steps, rank 0 {a0['steps']}")
        if card and a["b1_launches"] < a["steps"]:
            failed.append(f"{me}: {a['b1_launches']} B1 launches in "
                          f"{a['steps']} steps")
        if m["retunes"] != 1 or (card and not m["cells_flipped_back"]) or \
                m["winners_after"] != m0["winners_after"] or \
                m["digest_after"] != m0["digest_after"]:
            failed.append(f"{me}: mix_drift_flip retunes {m['retunes']} "
                          f"flipped {m['cells_flipped_back']}")
        if c["winners"] != c0["winners"] or \
                c["knob_winners"] != c0["knob_winners"]:
            failed.append(f"{me}: compiled winners differ from rank 0's")
        if card and not all(c["launches"].values()):
            failed.append(f"{me}: compiled leg launches {c['launches']}")
    leak = a0["pause_ms"] - (a0["boundary_pass_ms"] or 0.0)
    if leak >= PAUSE_BOUND_MS:
        failed.append(f"alert_retune: the pause beyond the boundary pass "
                      f"{leak:.1f} ms >= {PAUSE_BOUND_MS}")
    if not a0["boundary_pass_ms"]:
        failed.append("alert_retune: no boundary pass was timed")
    elif a0["boundary_pass_ms"] >= PASS_BOUND_MS:
        failed.append(f"alert_retune: the boundary pass "
                      f"{a0['boundary_pass_ms']:.1f} ms >= {PASS_BOUND_MS}")
    if not a0["knobs_after"] or a0["knobs_after"] == ["barrier", 32 << 20]:
        failed.append(f"alert_retune: no knob moved {a0['knobs_after']} "
                      f"(probe error: {a0['probe_error']})")
    if "autotune_mix_drift" not in m0["fired"]:
        failed.append(f"mix_drift_flip: autotune_mix_drift never fired "
                      f"({m0['fired']})")
    if card and not any(w is not None for w in c0["winners"].values()):
        failed.append(f"compiled_fabrics: no program has a winner "
                      f"{c0['variants']}")
    ref = c0["full_attention_loss"]
    for prog, variants in c0["variants"].items():
        for v, x in variants.items():
            lo, hi = x["first_loss"] or (math.nan, math.nan)
            if not (math.isfinite(lo) and math.isfinite(hi) and all(
                    abs(f - ref) <= COMPILED_LOSS_RTOL * abs(ref)
                    for f in (lo, hi))):
                failed.append(f"compiled_fabrics: {prog} {v} first loss "
                              f"{x['first_loss']} against full "
                              f"attention's {ref}")
    if c0["fabrics_stored"] != 1:
        failed.append(f"compiled_fabrics: {c0['fabrics_stored']} docs "
                      f"stored")
    if "perf_retune" not in out["rca"]["rules_named"]:
        failed.append(f"rca: perf_retune not named "
                      f"({out['rca']['rules_named']})")
    return failed


def summary(out: Dict[str, Any]) -> Dict[str, Any]:
    """The drill's numbers, from rank 0 (every rank agrees on the
    verdicts) and the launch counts over every rank."""
    r0 = out["ranks"][0]
    a, m, c = (r0[k] for k in ("alert_retune", "mix_drift_flip",
                               "compiled_fabrics"))
    return {
        "seconds": out["seconds"],
        "retune": {"pause_ms": a["pause_ms"], "ab": {"ratio": a["ab_ratio"]},
                   "boundary_pass_ms": a["boundary_pass_ms"]},
        "alert_retune": {k: a[k] for k in (
            "fired", "retunes", "steps", "applied_at_step", "knobs_after",
            "overlap_win", "probe_error", "baseline_step_ms",
            "post_step_ms", "seconds")},
        "mix_drift_flip": {k: m[k] for k in (
            "fired", "retunes", "cells_corrupted", "cells_flipped_back",
            "ms_after", "pause_ms", "seconds")},
        "compiled_fabrics": {k: c[k] for k in (
            "winners", "variants", "knob_winners", "wire_under_cache",
            "full_attention_loss", "seconds", "shape")},
        "b1_launches_all_ranks": sum(
            r["alert_retune"]["b1_launches"]
            + r["mix_drift_flip"]["b1_launches"] for r in out["ranks"]),
        "compiled_launches_all_ranks": {
            k: sum(r["compiled_fabrics"]["launches"][k]
                   for r in out["ranks"])
            for k in c["launches"]},
        "rca": out["rca"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dir", default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("retune_drill: no CUDA device; pass --device cpu",
                  file=sys.stderr)
            return 2
        from .. import _build

        _build.build_all()
    out = run(args.device, args.dir)
    failed = checks(out)
    print(json.dumps({"summary": summary(out), "failed": failed},
                     default=str))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
